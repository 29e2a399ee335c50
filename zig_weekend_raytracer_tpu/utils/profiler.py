"""Profiler zones: the equivalent of the reference's Tracy integration.

The reference instruments hot paths with ``ztracy.ZoneN`` zones that compile
to no-op stubs unless Tracy is enabled at build time
(reference: build.zig:53,69-77; libs/ztracy/src/ztracy.zig:6-23).  Here zones
map to ``jax.profiler`` trace annotations (visible in XProf / TensorBoard /
Perfetto) plus ``jax.named_scope`` so the zone names survive into HLO.  The
same compile-out semantics apply: when profiling is disabled (the default)
``named_zone`` is a no-op context manager.

Zone names mirror the reference's Tracy zone set so traces can be compared
side-by-side: Renderer::render, rayColorLine, rayColor, BVH::hit,
Sphere::hit, AABB::hit, Material::scatter, ImageTexture::value, ...
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple

import jax

_enabled = os.environ.get("ZWRT_PROFILE", "0") not in ("", "0", "false")

# host-side zone accumulator: name -> [count, total_s, min_s, max_s]
# (the Tracy-lite statistics view: per-zone wall clock without a trace
# viewer, the analog of Tracy's live zone table)
_zones: dict = {}


def set_profiling(enabled: bool) -> None:
    global _enabled
    _enabled = bool(enabled)


def profiling_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def named_zone(name: str):
    """Zone annotation; no-op unless profiling is enabled.

    When enabled, also accumulates HOST wall-clock per zone (async device
    work counts only up to dispatch unless the zone blocks on a result —
    same caveat as any host-side profiler around an async runtime)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        with jax.profiler.TraceAnnotation(name), jax.named_scope(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        z = _zones.get(name)
        if z is None:
            _zones[name] = [1, dt, dt, dt]
        else:
            z[0] += 1
            z[1] += dt
            z[2] = min(z[2], dt)
            z[3] = max(z[3], dt)


def zone_summary() -> dict:
    """{zone: (count, total_s, min_s, max_s)} accumulated so far."""
    return {k: tuple(v) for k, v in _zones.items()}


def reset_zones() -> None:
    _zones.clear()


def format_zone_summary() -> str:
    """Tracy-lite per-zone statistics table (sorted by total time)."""
    if not _zones:
        return "no profiler zones recorded (is ZWRT_PROFILE/--profile on?)"
    rows = sorted(_zones.items(), key=lambda kv: -kv[1][1])
    name_w = max(4, max(len(k) for k, _ in rows))
    lines = [
        f"{'zone':<{name_w}}  {'count':>7}  {'total':>10}  "
        f"{'mean':>10}  {'min':>10}  {'max':>10}"
    ]
    for name, (n, tot, mn, mx) in rows:
        lines.append(
            f"{name:<{name_w}}  {n:>7}  {tot * 1e3:>8.2f}ms  "
            f"{tot / n * 1e3:>8.2f}ms  {mn * 1e3:>8.2f}ms  "
            f"{mx * 1e3:>8.2f}ms"
        )
    return "\n".join(lines)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture a device trace for the enclosed block (viewable in
    TensorBoard/Perfetto), the analog of running the reference under the
    Tracy viewer."""
    with jax.profiler.trace(log_dir):
        yield


# ---------------------------------------------------------------------------
# Device-time zone table (--profile=device): per-kernel DEVICE milliseconds
# from a jax.profiler trace, printed without a viewer — the piece of Tracy
# the host-side table can't give (host wall-clock only sees dispatch time
# for async device work).
# ---------------------------------------------------------------------------

# Map raw device op names onto the zone vocabulary the reference uses.
# Two tiers:
#   1. the ``jax.named_scope`` names the integrator always emits
#      (render/integrator.py: closest_hit, shade, regenerate), matched in the
#      event name or in the op's metadata path (event args, _PATH_ARGS);
#   2. otherwise bucket by the leading HLO op KIND token (the instruction
#      name up to its `.N` suffix), never by substring — a fusion whose
#      name merely contains "while" or "gather" is still a fusion.
import re as _re

_DEVICE_ZONE_RULES = tuple(
    (_re.compile(rx), zone)
    for rx, zone in (
        (r"(^|[/\s])closest_hit([/\s]|$)", "closest hit (rayColor / BVH::hit)"),
        (r"(^|[/\s])shade([/\s]|$)", "shading (Material::scatter)"),
        (r"(^|[/\s])regenerate([/\s]|$)", "ray regeneration (sampleRay)"),
    )
)

# HLO op kinds worth naming; everything else shows under its own kind
# token.  Exact-kind match only — "gather.12" buckets here, but
# "fusion.gather_things.3" is a fusion.
_KIND_ZONES = {
    "while": "render loop (while)",
    "copy": "memcpy",
    "copy-start": "memcpy",
    "copy-done": "memcpy",
    "fusion": "XLA fusion",
    "loop_fusion": "XLA fusion",
    "input_fusion": "XLA fusion",
    "gather": "gather op",
    "dynamic-update-slice": "scatter/update op",
    "scatter": "scatter/update op",
    "custom-call": "custom call",
}

# an HLO instruction name is `<kind>`, `<kind>.<uid>`, or
# `<kind>.<label>.<uid>`; kinds are lowercase alnum with dashes
# (e.g. "copy-start", "dynamic-update-slice")
_KIND_RE = _re.compile(r"^([a-z][a-z0-9_-]*?)(?:\..*)?$")

# event args that may carry the op's metadata path (named scopes); on the
# GPU the kernel's ``name`` arg is the op_name path of the fusion's root
_PATH_ARGS = ("name", "tf_op", "long_name")


def _zone_for(op_name: str, path: str = "") -> str:
    low = op_name.lower()
    for text in (low, path.lower()):
        for rx, zone in _DEVICE_ZONE_RULES:
            if text and rx.search(text):
                return zone
    # profiler event names may be bare HLO instruction names OR full
    # metadata paths ("jit(render)/while/body/fusion.3") — the op kind is
    # the LAST path component's leading token
    leaf = low.rsplit("/", 1)[-1]
    m = _KIND_RE.match(leaf)
    if m and m.group(1) in _KIND_ZONES:
        return _KIND_ZONES[m.group(1)]
    return op_name.split(".")[0][:48] or "(unnamed)"


def _trace_files(log_dir: str) -> list:
    """One trace JSON per profiler run directory: the Perfetto export when
    present, else the ``*.trace.json(.gz)`` the profiler wrote."""
    import glob

    runs: dict = {}
    for pattern in ("perfetto_trace.json.gz", "*.trace.json.gz",
                    "*.trace.json"):
        for path in sorted(glob.glob(
            os.path.join(log_dir, "**", pattern), recursive=True
        )):
            runs.setdefault(os.path.dirname(path), path)
    return sorted(runs.values())


class DeviceEvent(NamedTuple):
    name: str      # kernel or copy name
    path: str      # metadata path(s) of the op (named scopes), may be ""
    ts: float      # start, microseconds
    dur: float     # duration, microseconds
    module: str = ""  # HLO module the kernel belongs to


def device_events(log_dir: str) -> list:
    """DeviceEvent of every complete event on a device timeline (a process
    named ``/device:...``) in the traces under ``log_dir``."""
    import gzip
    import json

    out = []
    for path in _trace_files(log_dir):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        events = data.get("traceEvents", []) if isinstance(data, dict) \
            else data
        device_pids = {
            ev.get("pid") for ev in events
            if ev.get("ph") == "M" and ev.get("name") == "process_name"
            and str(ev.get("args", {}).get("name", "")).startswith(
                "/device:"
            )
        }
        for ev in events:
            if ev.get("ph") != "X" or ev.get("pid") not in device_pids:
                continue
            dur_us = ev.get("dur")
            if not dur_us:
                continue
            args = ev.get("args") or {}
            meta = " ".join(
                str(args[k]) for k in _PATH_ARGS if k in args
            )
            out.append(DeviceEvent(
                str(ev.get("name", "")), meta, float(ev.get("ts", 0.0)),
                float(dur_us), str(args.get("hlo_module", "")),
            ))
    return out


def busy_share(events: list, window_us: float) -> float:
    """Fraction of ``window_us`` in which at least one device event runs
    (the union of the events' intervals; overlapping streams count once)."""
    spans = sorted((ev.ts, ev.ts + ev.dur) for ev in events)
    busy = 0.0
    cur_start = cur_end = None
    for a, b in spans:
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy / window_us if window_us > 0 else 0.0


def parse_device_trace(log_dir: str) -> dict:
    """Aggregate DEVICE-side op durations from a ``jax.profiler.trace``
    capture: {zone: (count, total_ms)}.  Parses the trace JSON the
    profiler writes (no TensorBoard needed)."""
    agg: dict = {}
    for ev in device_events(log_dir):
        z = agg.setdefault(_zone_for(ev.name, ev.path), [0, 0.0])
        z[0] += 1
        z[1] += ev.dur / 1e3
    return {k: tuple(v) for k, v in agg.items()}


def format_device_summary(agg: dict) -> str:
    """Per-zone device-time table (sorted by total device ms)."""
    if not agg:
        return (
            "no device trace events captured (CPU backend traces carry no "
            "device timeline; run on a GPU)"
        )
    rows = sorted(agg.items(), key=lambda kv: -kv[1][1])
    name_w = max(4, max(len(k) for k, _ in rows))
    total = sum(v[1] for v in agg.values())
    lines = [
        f"{'device zone':<{name_w}}  {'count':>7}  {'total':>10}  {'share':>6}"
    ]
    for name, (n, ms) in rows:
        lines.append(
            f"{name:<{name_w}}  {n:>7}  {ms:>8.2f}ms  {ms / total:>5.1%}"
        )
    lines.append(f"{'TOTAL':<{name_w}}  {'':>7}  {total:>8.2f}ms")
    return "\n".join(lines)


def run_with_device_trace(fn):
    """Run ``fn()`` under a device trace capture; returns
    (result, {zone: (count, total_ms)}).  The capture directory is
    temporary — use trace_to() to keep a viewable trace."""
    import shutil
    import tempfile

    log_dir = tempfile.mkdtemp(prefix="zwrt_trace_")
    # No Python tracer: a first render compiles inside the window, and the
    # Python call events of tracing and compilation would crowd the
    # device events out of the exported trace.
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    try:
        with jax.profiler.trace(log_dir, create_perfetto_trace=True,
                                profiler_options=opts):
            result = fn()
        return result, parse_device_trace(log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
