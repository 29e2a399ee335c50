"""Host-side zone statistics (the Tracy-lite CLI view).

The reference gets live per-zone stats from the Tracy viewer
(src/render.zig:30 etc.); without a viewer this framework accumulates
host wall-clock per named_zone and prints a table (utils/profiler.py).
"""

import os
import shutil
import time

from zig_weekend_raytracer_tpu.utils import profiler


def setup_function(_fn):
    profiler.reset_zones()
    profiler.set_profiling(True)


def teardown_function(_fn):
    profiler.set_profiling(False)
    profiler.reset_zones()


def test_zone_accumulation_counts_and_times():
    for _ in range(3):
        with profiler.named_zone("unit::fast"):
            pass
    with profiler.named_zone("unit::slow"):
        time.sleep(0.01)
    s = profiler.zone_summary()
    assert s["unit::fast"][0] == 3
    n, tot, mn, mx = s["unit::slow"]
    assert n == 1
    assert tot >= 0.009
    assert mn <= mx <= tot + 1e-9


def test_zones_noop_when_disabled():
    profiler.set_profiling(False)
    with profiler.named_zone("unit::off"):
        pass
    assert "unit::off" not in profiler.zone_summary()


def test_format_table_sorted_by_total():
    with profiler.named_zone("unit::big"):
        time.sleep(0.01)
    with profiler.named_zone("unit::small"):
        pass
    out = profiler.format_zone_summary()
    lines = out.splitlines()
    assert "zone" in lines[0] and "count" in lines[0]
    assert lines[1].startswith("unit::big")
    assert "unit::small" in out


def test_cli_profile_flag_prints_table(tmp_path, capsys):
    from zig_weekend_raytracer_tpu.cli import main

    out_path = tmp_path / "p.ppm"
    rc = main([
        "--image_width=8", "--image_height=8", "--samples_per_pixel=1",
        "--ray_bounce_max_depth=2", "--scene=cornell_box",
        f"--image_out_path={out_path}", "--profile=true",
    ])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "Renderer::render" in captured
    assert "count" in captured


GPU_TRACE = os.path.join(os.path.dirname(__file__), "data", "gpu_trace.json.gz")


def _recorded_trace(tmp_path):
    """A window of three regenerating-loop iterations recorded by
    jax.profiler on an H100 (perfetto export, args trimmed)."""
    d = tmp_path / "plugins" / "profile" / "run1"
    os.makedirs(d)
    shutil.copy(GPU_TRACE, d / "perfetto_trace.json.gz")
    return str(tmp_path)


def test_parse_device_trace_aggregates_device_pids(tmp_path):
    """parse_device_trace sums X-event durations on the /device:GPU:0
    timeline only (the host event is excluded) and maps events onto the
    zone vocabulary: named scopes first, then the HLO op kind."""
    agg = profiler.parse_device_trace(_recorded_trace(tmp_path))
    total_events = sum(n for n, _ in agg.values())
    assert total_events == 34  # device events only
    n_hit, ms_hit = agg["closest hit (rayColor / BVH::hit)"]
    assert n_hit == 3 and abs(ms_hit - (2.015 + 2.016 + 1.952) / 1e3) < 1e-9
    assert agg["ray regeneration (sampleRay)"][0] == 3
    assert agg["MemcpyD2H"][0] == 3  # the while predicate, once per iteration
    table = profiler.format_device_summary(agg)
    assert "closest hit" in table
    assert "TOTAL" in table


def test_device_busy_share_of_recorded_trace(tmp_path):
    """busy_share is the union of device intervals over the window: the
    recorded loop keeps the device busy well under half the time (the
    host round trip of the loop predicate sits between iterations)."""
    events = profiler.device_events(_recorded_trace(tmp_path))
    assert {ev.module for ev in events} == {"jit__render_band_balanced"}
    start = min(ev.ts for ev in events)
    end = max(ev.ts + ev.dur for ev in events)
    share = profiler.busy_share(events, end - start)
    busy = sum(ev.dur for ev in events)  # no overlap on one stream
    assert abs(share - busy / (end - start)) < 1e-9
    assert 0.2 < share < 0.8
    # overlapping intervals count once
    ev = profiler.DeviceEvent
    assert profiler.busy_share(
        [ev("a", "", 0.0, 10.0), ev("b", "", 5.0, 10.0)], 30.0
    ) == 0.5


def test_zone_mapping_no_substring_misattribution():
    """Generic HLO names must bucket by op KIND, never by substring (a
    fusion whose name contains "while"/"gather" is still a fusion)."""
    z = profiler._zone_for
    # a fusion with a suggestive name is still a fusion
    assert z("fusion.gather_things.3") == "XLA fusion"
    assert z("jit(render)/while/body/fusion.7") == "XLA fusion"
    # bare op kinds map to their kind zones (with or without path prefix)
    assert z("while.4") == "render loop (while)"
    assert z("jit(render)/while.4") == "render loop (while)"
    assert z("gather.12") == "gather op"
    assert z("copy-start.2") == "memcpy"
    assert z("dynamic-update-slice.9") == "scatter/update op"
    # the integrator's named scopes match as whole path components, in the
    # event name or in its metadata path
    assert z("loop_select_fusion",
             "jit(f)/while/body/closest_hit") == \
        "closest hit (rayColor / BVH::hit)"
    assert z("jit(f)/while/body/shade/mul") == "shading (Material::scatter)"
    assert z("loop_add_fusion", "jit(f)/while/body/regenerate") == \
        "ray regeneration (sampleRay)"
    assert z("loop_select_fusion", "jit(f)/while/body/shaded") != \
        "shading (Material::scatter)"
    # unknown ops keep their own (truncated) name, not a stolen zone
    assert z("exp.77") == "exp"


def test_cli_profile_device_runs(tmp_path, capsys):
    """--profile=device captures a trace around the render and prints the
    device table (the empty-on-CPU message here — CPU traces carry no
    device timeline)."""
    from zig_weekend_raytracer_tpu.cli import main

    out_path = tmp_path / "p.ppm"
    rc = main([
        "--image_width=8", "--image_height=8", "--samples_per_pixel=1",
        "--ray_bounce_max_depth=2", "--scene=cornell_box",
        f"--image_out_path={out_path}", "--profile=device",
    ])
    assert rc == 0
    captured = capsys.readouterr().out
    assert ("device zone" in captured) or ("no device trace" in captured)
