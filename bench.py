"""Benchmark: cornell_box 400x400 @ 1024 spp, depth 10, on one GPU.

Prints ONE JSON line: the device (JAX platform, device_kind, device count,
and the card's name and power limit from nvidia-smi), path throughput in
Mpaths/s (pixels x spp / wall seconds) as the median and quartiles of
repeated renders, each timed with ``block_until_ready`` around the whole
render, compile time (the first render, reported as set-up), peak device
memory, the work counter's mean bounces per path, and the correctness gate.

Steady state: the first render compiles and measures the per-pixel cost
map, the second compiles the cost-sorted plan render
(render/renderer.py:_render_band_sorted_driver); the timed renders reuse
both.

``correctness`` compares the framebuffer against committed CPU region
statistics (tests/golden/bench_cornell_regions.json, regenerate with
tools/gen_bench_golden.py) with the two-tier gate of
utils/goldengate.py: "pass (...)" or "fail:<detail>".

Exit codes: 0 pass; 1 correctness gate failed; 2 no GPU (nothing is
measured and no result is printed).

Usage: python bench.py [--runs=N]
"""

import json
import os
import sys
import time

import numpy as np

WIDTH = HEIGHT = 400
SPP = 1024
DEPTH = 10
RUNS = 5
GOLDEN = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "tests", "golden", "bench_cornell_regions.json",
)


def check_regions(fb: np.ndarray) -> str:
    """Gate the framebuffer against the committed CPU region statistics."""
    from zig_weekend_raytracer_tpu.utils.goldengate import check_framebuffer

    with open(GOLDEN) as f:
        ref = json.load(f)
    return check_framebuffer(fb, ref["mean"], np.asarray(ref["region_means"]))


def measure_iterations_per_path(scene, spp_probe: int = 64) -> float:
    """Mean bounces per path from the regenerating path's work counter
    (the same counter the cost-sorted and balanced drivers use)."""
    import jax.numpy as jnp

    from zig_weekend_raytracer_tpu.render.camera import camera_consts
    from zig_weekend_raytracer_tpu.render.integrator import trace_paths_regen
    from zig_weekend_raytracer_tpu.render.renderer import LANE_BLOCK
    from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind

    cam_c = camera_consts(scene.camera, WIDTH, HEIGHT)
    n_pix = WIDTH * HEIGHT
    n = -(-n_pix // LANE_BLOCK) * LANE_BLOCK
    ys, xs = np.divmod(np.arange(n) % n_pix, WIDTH)
    limit = jnp.where(jnp.arange(n) < n_pix, spp_probe, 0).astype(jnp.int32)
    _, work = trace_paths_regen(
        scene.compiled, cam_c, jnp.uint32(0),
        jnp.asarray(xs.astype(np.int32)), jnp.asarray(ys.astype(np.int32)),
        jnp.zeros((n,), jnp.int32), limit,
        sampler=SamplerKind.SOBOL, width=WIDTH, height=HEIGHT,
        spp=spp_probe, stride=1, max_depth=DEPTH, has_dof=False,
        want_work=True,
    )
    w = np.asarray(work)[:n_pix]
    return float(w.sum()) / (n_pix * spp_probe)


def main(argv) -> int:
    runs = RUNS
    for a in argv:
        if a.startswith("--runs="):
            runs = max(5, int(a.split("=", 1)[1]))
        else:
            print(f"usage: python bench.py [--runs=N]  (unknown {a!r})",
                  file=sys.stderr)
            return 2

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zig_weekend_raytracer_tpu.utils import device

    card = device.nvidia_smi_name_power()  # before JAX touches the card
    try:
        info = device.require_gpu()
    except device.NoGpuError as e:
        print(f"bench: {e}; refusing to measure", file=sys.stderr)
        return 2

    import zig_weekend_raytracer_tpu as zwrt

    scene = zwrt.models.load_scene("cornell_box")
    renderer = zwrt.render.Renderer(
        samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH
    )

    def render():
        return renderer.render_device(scene, WIDTH, HEIGHT)

    t0 = time.perf_counter()
    (setup_s,) = device.time_runs(render, 1)  # compile + cost map
    warm2_s = device.time_runs(render, 1)[0]  # compile the sorted plan
    setup_total_s = time.perf_counter() - t0
    times = device.time_runs(render, runs)
    fb = np.asarray(render())
    correctness = check_regions(fb)
    iters = measure_iterations_per_path(scene)

    paths = WIDTH * HEIGHT * SPP
    rates = [paths / t / 1e6 for t in times]
    out = {
        "metric": f"cornell_box {WIDTH}x{HEIGHT} @{SPP}spp depth{DEPTH} "
                  "path throughput",
        "unit": "Mpaths/s",
        "mpaths_per_s": device.quartiles(rates),
        "render_s": device.quartiles(times),
        "runs": runs,
        "setup_s": {"first_render": setup_s, "second_render": warm2_s,
                    "total": setup_total_s},
        "peak_bytes_in_use": device.peak_bytes_in_use(),
        "iters_per_path": iters,
        "correctness": correctness,
        "device": info,
        "card": card,
    }
    print(json.dumps(out))
    return 1 if correctness.startswith("fail") else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
