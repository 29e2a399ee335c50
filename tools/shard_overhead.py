"""Measure shard_map overhead on ONE GPU.

Runs the production path through ``parallel.render_sharded`` with a
1-device mesh and compares it against the direct
``Renderer.render_device`` at the bench config.  The delta prices the
shard_map plumbing (shard_map tracing, psum on the 'samples' mode,
out-spec reassembly) with zero actual communication.  Each timing is the
median of repeated renders, each ending in ``block_until_ready``.

Usage: python tools/shard_overhead.py [w] [h] [spp] [depth] [reps]
Prints one JSON line with the three timings, overhead ratios and the
device; exits 2 without a GPU.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time_median(device, fn, reps):
    device.time_runs(fn, 2)  # compile; drivers that plan on the first call
    times = device.time_runs(fn, reps)
    return device.quartiles(times)["median"], np.asarray(fn())


def main() -> int:
    from zig_weekend_raytracer_tpu.utils import device

    card = device.nvidia_smi_name_power()  # before JAX touches the card
    try:
        info = device.require_gpu()
    except device.NoGpuError as e:
        print(f"shard_overhead: {e}", file=sys.stderr)
        return 2
    import zig_weekend_raytracer_tpu as zwrt
    from zig_weekend_raytracer_tpu.parallel.mesh import make_mesh
    from zig_weekend_raytracer_tpu.parallel.render import render_sharded

    args = sys.argv[1:]
    width = int(args[0]) if len(args) > 0 else 400
    height = int(args[1]) if len(args) > 1 else 400
    spp = int(args[2]) if len(args) > 2 else 1024
    depth = int(args[3]) if len(args) > 3 else 10
    reps = max(5, int(args[4]) if len(args) > 4 else 5)

    scene = zwrt.models.load_scene("cornell_box")
    renderer = zwrt.render.Renderer(
        samples_per_pixel=spp, max_ray_bounce_depth=depth
    )
    mesh = make_mesh(1)

    t_direct, fb_direct = _time_median(
        device, lambda: renderer.render_device(scene, width, height), reps)
    t_samples, fb_samples = _time_median(
        device, lambda: render_sharded(scene, width, height, spp, max_depth=depth,
                               mesh=mesh, shard="samples"), reps)
    t_rows, fb_rows = _time_median(
        device, lambda: render_sharded(scene, width, height, spp, max_depth=depth,
                               mesh=mesh, shard="rows"), reps)

    # The sharded paths agree with the direct render by design
    # (content-addressed RNG); a mismatch means the sharded path diverged.
    agree_samples = bool(np.allclose(fb_direct, fb_samples, atol=1e-5))
    agree_rows = bool(np.allclose(fb_direct, fb_rows, atol=1e-5))

    print(json.dumps({
        "config": f"cornell_box {width}x{height}@{spp}spp d{depth} (1-dev mesh)",
        "direct_s": t_direct,
        "sharded_samples_s": t_samples,
        "sharded_rows_s": t_rows,
        "overhead_samples": t_samples / t_direct - 1.0,
        "overhead_rows": t_rows / t_direct - 1.0,
        "agree_samples": agree_samples,
        "agree_rows": agree_rows,
        "device": info,
        "card": card,
    }))
    return 0 if agree_samples and agree_rows else 1


if __name__ == "__main__":
    sys.exit(main())
