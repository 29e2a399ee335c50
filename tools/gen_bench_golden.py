"""Generate the device-side correctness reference for bench.py.

Renders the bench scene (cornell_box 400x400) at 128 spp depth 10 through
the per-bounce reference integrator on the CPU (Renderer.render_reference)
and stores coarse region statistics.  bench.py compares the GPU
framebuffer against these after timing: a miscompile that shifted
brightness or broke a region fails the bench, not just eyeballs.

Statistics, not pixels: the bench renders 1024 spp while this reference
uses 128 spp, so per-pixel comparison would be MC-noise-bound; 50x50-pixel
region means average ~320k samples each (relative noise << 1%), making a
2% region tolerance a tight gate that is still sampler-count agnostic.

Usage: JAX_PLATFORMS=cpu python tools/gen_bench_golden.py
Writes tests/golden/bench_cornell_regions.json.
"""

import json
import os
import sys

# The reference MUST come from the CPU per-bounce path.
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()

import numpy as np  # noqa: E402

WIDTH = HEIGHT = 400
SPP = 128
DEPTH = 10
GRID = 8  # GRID x GRID region means
OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden", "bench_cornell_regions.json",
)


def main() -> None:
    import zig_weekend_raytracer_tpu as zwrt
    # The SAME region definition the gate uses — generator/gate divergence
    # would make every regenerated golden mis-scored.
    from zig_weekend_raytracer_tpu.utils.goldengate import region_means

    scene = zwrt.models.load_scene("cornell_box")
    fb = zwrt.render.Renderer(
        samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH, seed=0
    ).render_reference(scene, WIDTH, HEIGHT)
    means = region_means(np.asarray(fb), GRID)
    payload = {
        "scene": "cornell_box",
        "width": WIDTH,
        "height": HEIGHT,
        "spp": SPP,
        "depth": DEPTH,
        "grid": GRID,
        "mean": float(fb.mean()),
        "region_means": [[float(v) for v in row] for row in means],
    }
    with open(OUT, "w") as f:
        json.dump(payload, f, indent=1)
    print("wrote", OUT, "mean", payload["mean"])


if __name__ == "__main__":
    main()
