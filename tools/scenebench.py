"""Per-scene steady-state throughput microbench (experiment harness).

Usage: python tools/scenebench.py <scene> [w] [h] [spp] [depth] [reps]
                                  [--rr=N] [--clamp=X] [--adaptive[=pilot]]
                                  [--denoise=N] [--shard=samples|rows]
                                  [--supersample=K]

Each rep is timed with ``block_until_ready`` around the whole render and
the median and quartiles are printed with the device (GPU only: without
one the script exits 2).  The optional flags benchmark the
beyond-reference features: Russian roulette from bounce N, the indirect
clamp, adaptive sampling at the same budget, and the AOV-guided denoiser
(timed separately, including its AOV pass).
"""

import sys
import time

import numpy as np

import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from zig_weekend_raytracer_tpu.utils import device

    card = device.nvidia_smi_name_power()  # before JAX touches the card
    try:
        info = device.require_gpu()
    except device.NoGpuError as e:
        print(f"scenebench: {e}", file=sys.stderr)
        return 2
    import zig_weekend_raytracer_tpu as zwrt

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    opts = dict(
        a[2:].split("=", 1) if "=" in a else (a[2:], "1")
        for a in sys.argv[1:] if a.startswith("--")
    )
    unknown = set(opts) - {
        "rr", "clamp", "adaptive", "denoise", "shard", "supersample",
    }
    if unknown:
        raise SystemExit(
            f"unknown flags {sorted(unknown)} "
            "(valid: --rr --clamp --adaptive --denoise --shard "
            "--supersample)"
        )
    scene_name = args[0] if len(args) > 0 else "cornell_box"
    width = int(args[1]) if len(args) > 1 else 400
    height = int(args[2]) if len(args) > 2 else 400
    spp = int(args[3]) if len(args) > 3 else 128
    depth = int(args[4]) if len(args) > 4 else 10
    reps = max(5, int(args[5]) if len(args) > 5 else 5)
    rr = int(opts.get("rr", 0))
    clamp = float(opts.get("clamp", 0.0))
    adaptive = int(opts.get("adaptive", 0))
    denoise_iters = int(opts.get("denoise", 0))
    shard = opts.get("shard", "")  # samples | rows (device-count = all)
    if shard and shard not in ("samples", "rows"):
        raise SystemExit(
            f"--shard={shard!r}: expected 'samples' or 'rows'"
        )
    supersample = int(opts.get("supersample", 1))
    if supersample > 1 and (adaptive or shard):
        raise SystemExit("--supersample combines only with plain renders")

    scene = zwrt.models.load_scene(scene_name)
    renderer = zwrt.render.Renderer(
        samples_per_pixel=spp, max_ray_bounce_depth=depth,
        russian_roulette=rr, clamp_indirect=clamp,
    )
    mesh = None
    if shard:
        from zig_weekend_raytracer_tpu.parallel import make_mesh

        mesh = make_mesh()

    def run():
        if adaptive and shard:
            from zig_weekend_raytracer_tpu.parallel import (
                render_adaptive_sharded,
            )

            out = render_adaptive_sharded(
                scene, width, height, spp, max_depth=depth, mesh=mesh,
                shard=shard, rr=rr, clamp=clamp,
                pilot_spp=adaptive if adaptive >= 2 else 0,
            )
        elif adaptive:
            out = renderer.render_adaptive(
                scene, width, height,
                pilot_spp=adaptive if adaptive >= 2 else 0,
            )
        elif shard:
            from zig_weekend_raytracer_tpu.parallel import render_sharded

            out = render_sharded(
                scene, width, height, spp, max_depth=depth, mesh=mesh,
                shard=shard, rr=rr, clamp=clamp,
            )
        elif supersample > 1:
            out = renderer.render_supersampled(
                scene, width, height, k=supersample
            )
        else:
            out = renderer.render_device(scene, width, height)
        return out

    (warm,) = device.time_runs(run, 1)
    device.time_runs(run, 1)  # drivers that plan on the first call
    times = device.time_runs(run, reps)
    fb_host = np.asarray(run())
    nan = bool(np.isnan(fb_host).any())
    q = device.quartiles(times)
    mp = device.quartiles([width * height * spp / t / 1e6 for t in times])
    tag = "".join(
        [f" rr={rr}" if rr else "", f" clamp={clamp}" if clamp else "",
         " adaptive" if adaptive else "",
         f" shard={shard}" if shard else "",
         f" ss={supersample}" if supersample > 1 else ""]
    )
    print(f"device: {info} card: {card}")
    print(
        f"{scene_name} {width}x{height}@{spp}spp d{depth}{tag}: "
        f"median {q['median']:.4f}s (q1 {q['q1']:.4f}, q3 {q['q3']:.4f}; "
        f"{mp['median']:.2f} Mpaths/s), first call {warm:.1f}s, "
        f"nan={nan}, mean={fb_host.mean():.4f}"
    )

    if denoise_iters:
        from zig_weekend_raytracer_tpu.render.aov import render_aovs
        from zig_weekend_raytracer_tpu.render.denoise import denoise

        # Cold call first (includes XLA compiles), then the steady state;
        # both return host arrays, so the timings include the copies.
        t0 = time.perf_counter()
        aovs = render_aovs(scene, width, height, seed=renderer.seed)
        dn = denoise(fb_host, aovs, iterations=denoise_iters)
        t_cold = time.perf_counter() - t0
        t_aov = device.time_runs(
            lambda: render_aovs(scene, width, height, seed=renderer.seed),
            reps,
        )
        t_dn = device.time_runs(
            lambda: denoise(fb_host, aovs, iterations=denoise_iters), reps
        )
        print(
            f"  denoise({denoise_iters}): aov pass median "
            f"{device.quartiles(t_aov)['median']:.4f}s + filter "
            f"{device.quartiles(t_dn)['median']:.4f}s steady (cold total "
            f"{t_cold:.1f}s), mean={dn.mean():.4f}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
