"""Smoke test of the renderer on a GPU: the main path at real size.

Phases (each must pass; nothing is caught and passed over):

  1. device   — the card's name and power limit (nvidia-smi, read before JAX
                touches the card); JAX's platform must be "gpu".
  2. cli      — ``cli.main`` in this process: cornell_box 400x400, 128 spp,
                depth 10, --stats; the output must be a valid P3 PPM.
  3. scenes   — all six scenes through ``Renderer.render`` at 400x400,
                128 spp, depth 10, each gated against the per-bounce
                reference (``Renderer.render_reference``) rendered on the
                same card.
  4. goldens  — each scene at its golden configuration gated against the
                committed CPU goldens (tests/golden/scene_regions.json,
                tests/golden/bench_cornell_regions.json).
  5. features — on cornell_box 400x400: adaptive sampling conserves the
                sample budget; a progressive render interrupted and resumed
                from its checkpoint equals the uninterrupted one bitwise;
                --supersample=2; AOVs with --denoise; --profile=device
                prints a non-empty device table.

The gate is the two-tier region gate of utils/goldengate.py (global mean
within 1%; no region past 10% and 5e-3; at most 5 regions past 2% and
1e-3), not exact equality: reassociation and FMA contraction differ
between the two programs and from the CPU, which decorrelates a few
chaotic glass or fuzz paths.

``--four`` runs only the four-card phase: ``render_sharded`` in "samples"
and "rows" mode on a 4-device mesh (cornell_box 400x400 1024 spp depth 10,
rtw_final 400x400 64 spp depth 8), each compared with the same render on
one device of this process (samples: rtol 1e-4, atol 1e-6, the psum adds
in another order; rows: rtol 1e-5, each pixel's samples add in the same
order), plus ``render_adaptive_sharded`` in both modes, which must conserve
the budget.  It checks that the shards land on four devices.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU the script exits non-zero and prints no result.

Usage: python chip_smoke.py [--four]
"""

import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

W = H = 400
SPP = 128
DEPTH = 10
SCENES = [
    "cornell_box", "emissive", "shrek_quads", "earth", "balls", "rtw_final",
]
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")


class PhaseFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def gate(fb: np.ndarray, ref: np.ndarray, what: str) -> str:
    """Two-tier region gate of ``fb`` against the reference image ``ref``."""
    from zig_weekend_raytracer_tpu.utils.goldengate import (
        check_framebuffer, region_means,
    )

    verdict = check_framebuffer(fb, float(ref.mean()), region_means(ref, 8))
    expect(verdict.startswith("pass"), f"{what}: {verdict}")
    return verdict


def check_ppm(path: str, width: int, height: int) -> None:
    """A P3 PPM of the given size: header, then width*height lines of
    three integers in [0, 255]."""
    with open(path) as f:
        tokens = f.read().split()
    expect(tokens[:4] == ["P3", str(width), str(height), "255"],
           f"{path}: bad PPM header {tokens[:4]}")
    vals = np.asarray(tokens[4:], np.int64)
    expect(vals.size == width * height * 3,
           f"{path}: {vals.size} values, want {width * height * 3}")
    expect(vals.min() >= 0 and vals.max() <= 255, f"{path}: value range")


def run_cli(args) -> str:
    """``cli.main(args)`` in this process; returns its standard output."""
    from zig_weekend_raytracer_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(args))
    out = buf.getvalue()
    sys.stdout.write(out)
    expect(rc == 0, f"cli {' '.join(args)} -> rc {rc}")
    return out


def phase_cli(tmp: str) -> None:
    out_path = os.path.join(tmp, "cornell.ppm")
    t0 = time.perf_counter()
    out = run_cli([
        "--scene=cornell_box", f"--image_width={W}", f"--image_height={H}",
        f"--samples_per_pixel={SPP}", f"--ray_bounce_max_depth={DEPTH}",
        "--stats=true", f"--image_out_path={out_path}",
    ])
    expect("Mpaths/s" in out, "cli --stats printed no throughput line")
    check_ppm(out_path, W, H)
    log(f"cli: ok ({time.perf_counter() - t0:.2f} s incl. compile)")


def phase_scenes() -> None:
    import zig_weekend_raytracer_tpu as zwrt
    from zig_weekend_raytracer_tpu.utils.device import time_runs

    for name in SCENES:
        scene = zwrt.models.load_scene(name)
        r = zwrt.render.Renderer(
            samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH
        )
        (t_first,) = time_runs(lambda: r.render_device(scene, W, H), 1)
        fb = r.render(scene, W, H)
        (t_ref,) = time_runs(lambda: r.render_reference(scene, W, H), 1)
        ref = np.asarray(r.render_reference(scene, W, H))
        expect(np.isfinite(fb).all() and fb.shape == (H, W, 3),
               f"{name}: non-finite or misshapen image")
        verdict = gate(fb, ref, f"{name} vs per-bounce reference")
        log(f"scene {name}: render {t_first:.3f} s (first call, incl. "
            f"compile), reference {t_ref:.3f} s (first call); vs reference "
            f"{verdict}")


def phase_goldens() -> None:
    import zig_weekend_raytracer_tpu as zwrt
    from zig_weekend_raytracer_tpu.utils.goldengate import check_framebuffer

    with open(os.path.join(GOLDEN_DIR, "scene_regions.json")) as f:
        golden = json.load(f)
    with open(os.path.join(GOLDEN_DIR, "bench_cornell_regions.json")) as f:
        bench = json.load(f)
    cases = [(n, c) for n, c in golden["scenes"].items()]
    cases.append((f"{bench['scene']} (bench)", {**bench, "name": bench["scene"]}))
    for label, c in cases:
        scene = zwrt.models.load_scene(c.get("name", label))
        fb = zwrt.render.Renderer(
            samples_per_pixel=c["spp"], max_ray_bounce_depth=c["depth"],
            seed=0,
        ).render(scene, c["width"], c["height"])
        verdict = check_framebuffer(
            fb, c["mean"], np.asarray(c["region_means"])
        )
        expect(verdict.startswith("pass"), f"golden {label}: {verdict}")
        log(f"golden {label} {c['width']}x{c['height']}@{c['spp']} "
            f"d{c['depth']}: {verdict}")


def phase_features(tmp: str) -> None:
    import zig_weekend_raytracer_tpu as zwrt
    from zig_weekend_raytracer_tpu.render import ProgressiveRenderer
    from zig_weekend_raytracer_tpu.render.aov import render_aovs

    scene = zwrt.models.load_scene("cornell_box")
    r = zwrt.render.Renderer(samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH)
    plain = r.render(scene, W, H)

    # adaptive: same total budget, re-allocated per pixel
    fb, stats = r.render_adaptive(scene, W, H, return_stats=True)
    fb = np.asarray(fb)
    expect(int(stats["n_samples"].sum()) == W * H * SPP,
           "adaptive: sample budget not conserved")
    expect(np.isfinite(fb).all(), "adaptive: non-finite image")
    rel = abs(fb.mean() - plain.mean()) / plain.mean()
    expect(rel < 0.02, f"adaptive: mean off by {rel:.2%}")
    log(f"adaptive: budget {int(stats['n_samples'].sum())} conserved, "
        f"mean {fb.mean():.5f} vs uniform {plain.mean():.5f}")

    # progressive: interrupt after two batches, resume, compare bitwise
    batch, half = SPP // 4, SPP // 2
    ck_full = os.path.join(tmp, "full.npz")
    full = ProgressiveRenderer(r, checkpoint_path=ck_full).render(
        scene, W, H, batch_spp=batch
    )
    ck = os.path.join(tmp, "resume.npz")

    class Interrupt(Exception):
        pass

    def stop_after_two(done, _fb):
        if done >= half:
            raise Interrupt

    try:
        ProgressiveRenderer(r, checkpoint_path=ck).render(
            scene, W, H, batch_spp=batch, on_batch=stop_after_two
        )
    except Interrupt:
        pass
    expect(int(np.load(ck)["samples_done"]) == half,
           "progressive: checkpoint did not record the interruption")
    resumed = ProgressiveRenderer(r, checkpoint_path=ck).render(
        scene, W, H, batch_spp=batch
    )
    expect(np.array_equal(resumed, full),
           "progressive: resumed render differs from uninterrupted "
           f"(max |d| {np.abs(resumed - full).max():.3g})")
    gate(full, plain, "progressive vs one-shot render")
    log(f"progressive: interrupted at {half}/{SPP} spp, resumed render "
        "equals the uninterrupted one bitwise")

    # supersampling: same pixel filter and budget, other sample positions
    ss = np.asarray(r.render_supersampled(scene, W, H, k=2))
    expect(ss.shape == (H, W, 3) and np.isfinite(ss).all(),
           "supersample: bad image")
    rel = abs(ss.mean() - plain.mean()) / plain.mean()
    expect(rel < 0.02, f"supersample: mean off by {rel:.2%}")
    log(f"supersample=2: mean {ss.mean():.5f} vs {plain.mean():.5f}")

    # AOVs and the AOV-guided denoiser through the CLI
    aovs = render_aovs(scene, W, H)
    expect(all(np.isfinite(v).all() for v in aovs.values()),
           "aov: non-finite buffers")
    cov = aovs["coverage"]
    expect(cov.min() >= 0.0 and cov.max() <= 1.0 and cov.mean() > 0.5,
           f"aov: coverage outside [0, 1] or mostly empty ({cov.mean():.3f})")
    out_path = os.path.join(tmp, "denoised.ppm")
    run_cli([
        "--scene=cornell_box", f"--image_width={W}", f"--image_height={H}",
        f"--samples_per_pixel={SPP}", f"--ray_bounce_max_depth={DEPTH}",
        "--denoise=3", f"--image_out_path={out_path}",
    ])
    check_ppm(out_path, W, H)
    log("aov + denoise: ok")

    # device profile through the CLI
    out = run_cli([
        "--scene=cornell_box", f"--image_width={W}", f"--image_height={H}",
        "--samples_per_pixel=16", f"--ray_bounce_max_depth={DEPTH}",
        "--profile=device", f"--image_out_path={os.path.join(tmp, 'p.ppm')}",
    ])
    # the render loop's kernels run once per loop iteration, so at least
    # DEPTH times; copies and one-off set-up kernels do not count
    rows = re.findall(r"^(.+?)\s+(\d+)\s+[\d.]+ms\s+[\d.]+%$", out, re.M)
    loop_kernels = [name for name, n in rows
                    if int(n) >= DEPTH and "memcpy" not in name.lower()]
    expect("device zone" in out and loop_kernels,
           "profile=device: no device table with the render loop's kernels")
    log(f"profile=device: device table printed, {len(loop_kernels)} "
        "render-loop kernels")


def phase_four() -> None:
    import jax

    import zig_weekend_raytracer_tpu as zwrt
    from zig_weekend_raytracer_tpu.parallel import (
        make_mesh, render_adaptive_sharded, render_sharded,
    )

    from zig_weekend_raytracer_tpu.utils.device import quartiles, time_runs

    mesh = make_mesh(4)
    for name, spp, depth in (("cornell_box", 1024, 10), ("rtw_final", 64, 8)):
        scene = zwrt.models.load_scene(name)
        r = zwrt.render.Renderer(
            samples_per_pixel=spp, max_ray_bounce_depth=depth,
        )
        one = np.asarray(r.render_device(scene, W, H))
        time_runs(lambda: r.render_device(scene, W, H), 1)
        t_one = quartiles(
            time_runs(lambda: r.render_device(scene, W, H), 3))["median"]
        log(f"four {name} {W}x{H}@{spp} d{depth} one device: "
            f"{t_one:.4f} s median of 3")
        for shard, rtol, atol in (("samples", 1e-4, 1e-6), ("rows", 1e-5, 0)):
            # rows: one lane per pixel on every device, as on one device,
            # so each pixel's samples add in the same order
            def sharded():
                return render_sharded(
                    scene, W, H, spp, max_depth=depth, mesh=mesh,
                    shard=shard,
                    **({"regen_min_wave": 1} if shard == "rows" else {}),
                )

            t0 = time.perf_counter()
            fb = jax.block_until_ready(sharded())
            dt = time.perf_counter() - t0
            devs = fb.sharding.device_set
            expect(len(devs) == 4, f"{name} {shard}: result on {len(devs)} "
                   "device(s)")
            fb = np.asarray(fb)
            d = np.abs(fb - one)
            ok = np.allclose(fb, one, rtol=rtol, atol=atol)
            expect(ok, f"{name} {shard}: max |d| {d.max():.3g}, max rel "
                   f"{(d / np.maximum(np.abs(one), 1e-30)).max():.3g}")
            time_runs(sharded, 1)  # a sortable scene plans on call 1
            t_sh = quartiles(time_runs(sharded, 3))["median"]
            log(f"four {name} {W}x{H}@{spp} d{depth} shard={shard}: "
                f"matches one device (rtol {rtol}, atol {atol}); max |d| "
                f"{d.max():.3g}; first call {dt:.3f} s, then {t_sh:.4f} s "
                f"median of 3 ({t_one / t_sh:.2f}x one device)")
    scene = zwrt.models.load_scene("cornell_box")
    for shard in ("samples", "rows"):
        fb, st = render_adaptive_sharded(
            scene, W, H, SPP, max_depth=DEPTH, mesh=mesh, shard=shard,
            return_stats=True,
        )
        expect(int(st["n_samples"].sum()) == W * H * SPP,
               f"adaptive {shard}: budget not conserved")
        expect(np.isfinite(np.asarray(fb)).all(), f"adaptive {shard}: NaN")
        log(f"four adaptive shard={shard}: budget "
            f"{int(st['n_samples'].sum())} conserved")
    used = [(dv.memory_stats() or {}).get("peak_bytes_in_use", 0)
            for dv in jax.devices()[:4]]
    expect(all(u > 0 for u in used), f"peak bytes per device {used}")
    log(f"four: peak bytes in use per device {used}")


def main(argv) -> int:
    four = "--four" in argv
    unknown = [a for a in argv if a != "--four"]
    if unknown:
        print(f"usage: python chip_smoke.py [--four] (unknown {unknown})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from zig_weekend_raytracer_tpu.utils import device

    log(device.nvidia_smi_name_power())  # before JAX touches the card
    try:
        info = device.require_gpu(4 if four else 1)
    except device.NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    log(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}")

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if four:
            phases = [("four", phase_four)]
        else:
            phases = [
                ("cli", lambda: phase_cli(tmp)),
                ("scenes", phase_scenes),
                ("goldens", phase_goldens),
                ("features", lambda: phase_features(tmp)),
            ]
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                fn()
            except PhaseFailed as e:
                print(f"chip_smoke: phase {name} FAILED: {e}",
                      file=sys.stderr)
                return 1
            log(f"phase {name}: pass ({time.perf_counter() - t0:.1f} s)")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
