"""Device-side correctness gate for every golden scene.

Renders every scene on the GPU through the production path at the
committed golden configs and compares region statistics against the CPU
references in tests/golden/scene_regions.json (regenerate with
tools/gen_scene_goldens.py).

Tolerance policy: the calibrated two-tier gate in
zig_weekend_raytracer_tpu/utils/goldengate.py (global mean 1%, hard
per-region 10%+5e-3, soft count >5/64 regions past 2%+1e-3 — see that
module's docstring for the measured justification).

Usage: python tools/golden_check.py [scene ...]   (default: all)
Exit code 0 = all pass; 1 = any scene diverged; 2 = no GPU.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden", "scene_regions.json",
)


def check_scene(name: str, ref: dict) -> str:
    import zig_weekend_raytracer_tpu as zwrt
    from zig_weekend_raytracer_tpu.utils.goldengate import check_framebuffer

    scene = zwrt.models.load_scene(name)
    fb = np.asarray(
        zwrt.render.Renderer(
            samples_per_pixel=ref["spp"],
            max_ray_bounce_depth=ref["depth"],
            seed=0,
        ).render(scene, ref["width"], ref["height"])
    )
    return check_framebuffer(
        fb, ref["mean"], np.asarray(ref["region_means"])
    )


def main() -> int:
    from zig_weekend_raytracer_tpu.utils import device

    print(device.nvidia_smi_name_power())  # before JAX touches the card
    try:
        info = device.require_gpu()
    except device.NoGpuError as e:
        print(f"golden_check: {e}", file=sys.stderr)
        return 2
    print(f"device: {info}")
    with open(GOLDEN) as f:
        golden = json.load(f)
    names = sys.argv[1:] or list(golden["scenes"])
    unknown = [n for n in names if n not in golden["scenes"]]
    if unknown:
        print(
            f"error: unknown scene(s) {unknown}; golden has "
            f"{sorted(golden['scenes'])}", file=sys.stderr,
        )
        return 2
    rc = 0
    for name in names:
        verdict = check_scene(name, golden["scenes"][name])
        print(f"{name}: {verdict}")
        if not verdict.startswith("pass"):
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
