"""CPU stand-in for the reference's multithreaded CPU baseline.

The reference's headline discipline benches a native CPU render at the
canonical config (reference: README.md:36 — cornell_box, 400x400,
128 spp, max depth 10); no Zig toolchain exists in this environment, so
this script times THIS repo's portable XLA-CPU path (the same integrator
semantics, compiled by XLA for the host) at that config instead.

Caveats to record with the number:
  * the host may have few CPU cores; the reference's M1 Pro runs 8-10 threads
    through its thread pool (src/main.zig:62-77) — a like-for-like
    multicore figure would be several times faster;
  * XLA-CPU is a portable vectorizing compiler, not a hand-tuned native
    ray tracer — treat the number as a stand-in ORDER OF MAGNITUDE, not
    as the reference's own performance.

Prints one JSON line; steady-state time excludes compilation (first
render compiles, second render is timed).
"""

import json
import sys
import time

import jax

import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

jax.config.update("jax_platforms", "cpu")


def main() -> int:
    assert jax.devices()[0].platform == "cpu", "must run on the CPU backend"
    import numpy as np

    from zig_weekend_raytracer_tpu.models import load_scene
    from zig_weekend_raytracer_tpu.render.renderer import Renderer

    scene_name = sys.argv[1] if len(sys.argv) > 1 else "cornell_box"
    w, h, spp, depth = (
        int(a) for a in (sys.argv[2:6] or (400, 400, 128, 10))
    )
    scene = load_scene(scene_name)
    renderer = Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth)

    t0 = time.perf_counter()
    fb = renderer.render(scene, w, h)
    cold_s = time.perf_counter() - t0
    _sum0 = float(np.asarray(fb).sum())  # force completion

    t1 = time.perf_counter()
    fb = renderer.render(scene, w, h)
    _sum1 = float(np.asarray(fb).sum())
    steady_s = time.perf_counter() - t1

    paths = w * h * spp
    print(json.dumps({
        "metric": "cpu_standin_mpaths_per_s",
        "scene": scene_name,
        "config": [w, h, spp, depth],
        "cold_s": round(cold_s, 3),
        "steady_s": round(steady_s, 3),
        "value": round(paths / steady_s / 1e6, 4),
        "unit": "Mpaths/s",
        "host_cores": 1,
        "note": (
            "portable XLA-CPU path on ONE core; stand-in for the "
            "reference's multithreaded native CPU baseline (no Zig "
            "toolchain in this environment)"
        ),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
