"""Regenerating wavefront vs the per-bounce reference, timed on one GPU.

Timing (default mode): for each configuration, both paths
(``Renderer.render_device``, the production regenerating wavefront, and
``Renderer.render_reference``, the per-bounce integrator) are warmed up,
then timed in alternation, ``--runs`` renders each, every render wrapped in
``block_until_ready``.  Reports the median and quartiles of wall seconds
and Mpaths/s, the first calls (compile, reported as set-up), and the
process's ``peak_bytes_in_use`` at the end (the counter never decreases,
so it is the larger of the two paths' peaks).

Profile (``--profile``): one ``jax.profiler`` window per scene around a
steady-state regenerating render, with XLA's optimized HLO dumped so each
kernel's time can be split by the named scopes of the instructions fused
into it (render/integrator.py: closest_hit, shade, regenerate).  Reports
device busy share over the render's wall time and the split.  The compile
cache is off in this mode, so every program is compiled (and dumped).

Usage:
  python tools/perf_regen.py [--runs=N] [--out=FILE]
  python tools/perf_regen.py --profile [--out=FILE] [scene ...]
Exits 2 without a GPU.
"""

import json
import os
import re
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

W = H = 400
CONFIGS = [
    (name, 128, 10) for name in (
        "cornell_box", "emissive", "shrek_quads", "earth", "balls",
        "rtw_final",
    )
] + [("cornell_box", 1024, 10)]
SCOPES = ("closest_hit", "shade", "regenerate")


def timing(runs: int, device) -> dict:
    import zig_weekend_raytracer_tpu as zwrt

    rows = []
    for name, spp, depth in CONFIGS:
        scene = zwrt.models.load_scene(name)
        r = zwrt.render.Renderer(
            samples_per_pixel=spp, max_ray_bounce_depth=depth
        )
        regen = lambda: r.render_device(scene, W, H)  # noqa: E731
        ref = lambda: r.render_reference(scene, W, H)  # noqa: E731
        first = device.time_runs(regen, 2)  # compile; plan on first call
        first_ref = device.time_runs(ref, 1)
        t_regen, t_ref = [], []
        for _ in range(runs):
            t_regen += device.time_runs(regen, 1)
            t_ref += device.time_runs(ref, 1)
        a, b = np.asarray(regen()), np.asarray(ref())
        paths = W * H * spp
        row = {
            "scene": name, "width": W, "height": H, "spp": spp,
            "depth": depth, "runs": runs,
            "regen_s": device.quartiles(t_regen),
            "reference_s": device.quartiles(t_ref),
            "regen_mpaths_per_s": device.quartiles(
                [paths / t / 1e6 for t in t_regen]),
            "reference_mpaths_per_s": device.quartiles(
                [paths / t / 1e6 for t in t_ref]),
            "regen_first_calls_s": first,
            "reference_first_call_s": first_ref[0],
            "mean_abs_diff": float(np.abs(a - b).mean()),
            "max_abs_diff": float(np.abs(a - b).max()),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return {"rows": rows, "peak_bytes_in_use": device.peak_bytes_in_use()}


# ---------------------------------------------------------------------------
# profile mode: split kernel time by named scope via the optimized HLO
# ---------------------------------------------------------------------------

_COMP_RE = re.compile(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$")
_INSTR_RE = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = ")
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')
_COMMENT_RE = re.compile(r"/\*.*?\*/")


def scope_fractions(hlo_text: str) -> dict:
    """{fusion or instruction name: {scope: fraction}} from an optimized
    HLO module: the share of each fusion's fused instructions (those with an
    op_name) that lie under each named scope, the rest under "other"."""
    comps: dict = {}
    calls: dict = {}
    own: dict = {}
    cur = None
    for line in hlo_text.splitlines():
        line = _COMMENT_RE.sub("", line)
        m = _COMP_RE.match(line)
        if m and "=" not in line.split("{")[0]:
            cur = m.group(1)
            comps[cur] = []
            continue
        if line.strip() == "}":
            cur = None
            continue
        im = _INSTR_RE.match(line)
        if not im or cur is None:
            continue
        op = _OPNAME_RE.search(line)
        comps[cur].append(op.group(1) if op else "")
        c = _CALLS_RE.search(line)
        if c and " fusion(" in line:
            calls[im.group(1)] = c.group(1)
        own[im.group(1)] = op.group(1) if op else ""

    def shares(names):
        cnt = {s: 0 for s in SCOPES}
        cnt["other"] = 0
        for n in names:
            if not n:  # parameters and other ops without metadata
                continue
            hit = [s for s in SCOPES if f"/{s}" in n]
            cnt[hit[-1] if hit else "other"] += 1
        tot = sum(cnt.values())
        if not tot:
            cnt["other"] = tot = 1
        return {k: v / tot for k, v in cnt.items()}

    out = {name: shares(own_names) for name, own_names in
           ((n, [own[n]]) for n in own)}
    for instr, comp in calls.items():
        out[instr] = shares(comps.get(comp, []))
    return out


def _load_dump(dump_dir: str) -> list:
    """[(file name, scope fractions)] of the *after_optimizations.txt
    dumps, newest module first (a module name recurs when a function is
    compiled for several shapes)."""
    files = sorted(
        (fn for fn in os.listdir(dump_dir)
         if fn.endswith("after_optimizations.txt")),
        key=lambda fn: int(re.match(r"module_(\d+)", fn).group(1)),
        reverse=True,
    )
    out = []
    for fn in files:
        with open(os.path.join(dump_dir, fn)) as f:
            out.append((fn, scope_fractions(f.read())))
    return out


def _fractions(mods, ev):
    """Scope fractions of one kernel event: the newest dumped module of the
    event's HLO module that holds the kernel's instruction (kernel names
    use "_N" where HLO instruction names use ".N")."""
    keys = (ev.name, re.sub(r"_(\d+)$", r".\1", ev.name))
    for fn, fr in mods:
        if f".{ev.module}." not in fn:
            continue
        for k in keys:
            if k in fr:
                return fr[k]
    return None


def profile(scenes, dump_dir: str, device) -> list:
    import jax

    import zig_weekend_raytracer_tpu as zwrt
    from zig_weekend_raytracer_tpu.utils import profiler

    rows = []
    for name in scenes:
        scene = zwrt.models.load_scene(name)
        r = zwrt.render.Renderer(samples_per_pixel=128, max_ray_bounce_depth=10)
        device.time_runs(lambda: r.render_device(scene, W, H), 2)
        log_dir = tempfile.mkdtemp(prefix="zwrt_profile_")
        with jax.profiler.trace(log_dir, create_perfetto_trace=True):
            (wall,) = device.time_runs(
                lambda: r.render_device(scene, W, H), 1
            )
        events = profiler.device_events(log_dir)
        mods = _load_dump(dump_dir)
        split = {s: 0.0 for s in SCOPES}
        split.update(other_kernels=0.0, copies=0.0)
        unmatched = 0.0
        missed: dict = {}
        n_d2h = 0
        for ev in events:
            if ev.name.startswith("Memcpy"):
                split["copies"] += ev.dur
                n_d2h += ev.name == "MemcpyD2H"
                continue
            frac = _fractions(mods, ev)
            if frac is None:
                unmatched += ev.dur
                missed[ev.name] = missed.get(ev.name, 0.0) + ev.dur
                split["other_kernels"] += ev.dur
                continue
            for k, v in frac.items():
                split[k if k in SCOPES else "other_kernels"] += ev.dur * v
        busy = profiler.busy_share(events, wall * 1e6)
        total = max(sum(split.values()), 1e-30)
        row = {
            "scene": name, "spp": 128, "depth": 10, "wall_s": wall,
            "device_busy_share": busy,
            "device_time_s": total / 1e6,
            "split_share": {k: v / total for k, v in split.items()},
            "unmatched_kernel_share": unmatched / total,
            "device_events": len(events),
            "d2h_copies": n_d2h,
            "dumped_modules": len(mods),
            "unmatched_kernels": sorted(missed, key=missed.get)[-5:],
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv) -> int:
    opts = dict(a[2:].split("=", 1) if "=" in a else (a[2:], "1")
                for a in argv if a.startswith("--"))
    args = [a for a in argv if not a.startswith("--")]
    out_path = opts.get("out")
    dump_dir = None
    if "profile" in opts:
        dump_dir = tempfile.mkdtemp(prefix="zwrt_hlo_")
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_dump_to={dump_dir} --xla_dump_hlo_as_text"
        )
    from zig_weekend_raytracer_tpu.utils import device

    card = device.nvidia_smi_name_power()  # before JAX touches the card
    try:
        info = device.require_gpu()
    except device.NoGpuError as e:
        print(f"perf_regen: {e}", file=sys.stderr)
        return 2
    print(f"card: {card}; device: {info}", flush=True)
    t0 = time.perf_counter()
    if dump_dir:
        import jax

        jax.config.update("jax_enable_compilation_cache", False)
        result = {"profile": profile(args or ["cornell_box", "rtw_final"],
                                     dump_dir, device)}
    else:
        result = {"timing": timing(max(5, int(opts.get("runs", 5))), device)}
    result.update(card=card, device=info,
                  total_s=time.perf_counter() - t0)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
