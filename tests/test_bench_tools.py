"""Helpers of bench.py and tools/perf_regen.py that run without a GPU:
the correctness gate, the work-counter probe and the HLO scope split."""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import bench  # noqa: E402
import perf_regen  # noqa: E402


def _golden_image():
    """A framebuffer whose 8x8 region means equal the bench golden's."""
    with open(bench.GOLDEN) as f:
        ref = json.load(f)
    means = np.asarray(ref["region_means"], np.float32)
    fb = np.kron(means, np.ones((50, 50), np.float32))
    return np.repeat(fb[..., None], 3, axis=2)


def test_bench_gate_passes_golden_and_fails_shift():
    fb = _golden_image()
    assert bench.check_regions(fb).startswith("pass")
    assert bench.check_regions(fb * 1.05).startswith("fail:global-mean")
    assert bench.check_regions(fb * np.nan).startswith("fail:nan")


def test_bench_iterations_probe(monkeypatch):
    """Mean bounces per path from the work counter lies in [1, depth]."""
    import zig_weekend_raytracer_tpu as zwrt

    monkeypatch.setattr(bench, "WIDTH", 8)
    monkeypatch.setattr(bench, "HEIGHT", 8)
    it = bench.measure_iterations_per_path(
        zwrt.models.load_scene("cornell_box"), spp_probe=4
    )
    assert 1.0 <= it <= bench.DEPTH


HLO = """HloModule jit_f

%fused_a (p0: f32[4]) -> f32[4] {
  %p0 = f32[4]{0} parameter(0)
  %m = f32[4]{0} multiply(%p0, %p0), metadata={op_name="jit(f)/while/body/closest_hit/mul"}
  %s = f32[4]{0} sqrt(%m), metadata={op_name="jit(f)/while/body/closest_hit/sqrt"}
  ROOT %a = f32[4]{0} add(%s, %p0), metadata={op_name="jit(f)/while/body/shade/add"}
}

%fused_b (p0: f32[4]) -> f32[4] {
  %p0 = f32[4]{0} parameter(0)
  ROOT %n = f32[4]{0} negate(%p0), metadata={op_name="jit(f)/while/body/regenerate/neg"}
}

ENTRY %main (x: f32[4]) -> f32[4] {
  %x = f32[4]{0} parameter(0)
  %loop_add_fusion = f32[4]{0} fusion(%x), kind=kLoop, calls=%fused_a, metadata={op_name="jit(f)/while/body/shade/add"}
  ROOT %loop_neg_fusion.1 = f32[4]{0} fusion(%loop_add_fusion), kind=kLoop, calls=%fused_b
}
"""


def test_scope_fractions_split_fused_instructions():
    fr = perf_regen.scope_fractions(HLO)
    a = fr["loop_add_fusion"]
    # of the 3 fused instructions with an op_name, 2 are under closest_hit
    # and 1 under shade (the parameter carries none and is not counted)
    assert a["closest_hit"] == 2 / 3 and a["shade"] == 1 / 3
    assert a["other"] == 0.0 and a["regenerate"] == 0.0
    b = fr["loop_neg_fusion.1"]
    assert b["regenerate"] == 1.0 and b["other"] == 0.0
    # an op without metadata counts whole under "other"
    assert fr["x"]["other"] == 1.0 and sum(fr["x"].values()) == 1.0
