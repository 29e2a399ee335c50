"""Generate pinned golden framebuffers for the regression tests.

Renders every scene at a small fixed config through the per-bounce
reference integrator on the CPU (the configuration tests/conftest.py sets)
and stores the raw f32 framebuffers in tests/golden/.  The production
regenerating path must match them (tests/test_golden_images.py), and
tests/test_regen.py pins it to the reference directly.

Regenerate ONLY when an intentional change to the estimator lands:
    JAX_PLATFORMS=cpu python tools/gen_goldens.py
and say why in the commit message.
"""

import os
import pathlib
import sys

import numpy as np


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIG = {"width": 64, "height": 64, "spp": 32, "depth": 10, "seed": 0}
SCENES = [
    "cornell_box", "emissive", "balls", "shrek_quads", "rtw_final", "earth",
]


def main() -> None:
    # EXACTLY the tests/conftest.py environment — the virtual device count
    # changes XLA CPU compilation enough to perturb low-order float bits,
    # so goldens must be produced under the same config the suite runs.
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_threefry_partitionable", True)

    import zig_weekend_raytracer_tpu as zwrt

    out_dir = pathlib.Path(__file__).resolve().parent.parent / "tests" / "golden"
    out_dir.mkdir(exist_ok=True)
    # argv selects a subset (e.g. a newly added scene); default: all
    for name in (sys.argv[1:] or SCENES):
        scene = zwrt.models.load_scene(name, seed=CONFIG["seed"])
        r = zwrt.render.Renderer(
            samples_per_pixel=CONFIG["spp"],
            max_ray_bounce_depth=CONFIG["depth"],
            seed=CONFIG["seed"],
        )
        fb = np.asarray(
            r.render_reference(scene, CONFIG["width"], CONFIG["height"])
        )
        assert np.isfinite(fb).all(), name
        np.savez_compressed(
            out_dir / f"{name}.npz", fb=fb.astype(np.float32), **CONFIG
        )
        print(f"{name}: mean={fb.mean():.5f} max={fb.max():.3f}")


if __name__ == "__main__":
    sys.exit(main())
