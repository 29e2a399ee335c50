"""Unit tests for the two-tier device-side correctness gate
(utils/goldengate.py) — the policy bench.py, chip_smoke.py and
tools/golden_check.py use to compare device renders against CPU region
statistics.

Synthetic scenarios model the failure classes the gate was calibrated on
(utils/goldengate.py docstring): chaotic-path decorrelation must PASS;
systematic brightness shifts, localized pattern breaks, and NaNs must FAIL.
"""

import numpy as np

from zig_weekend_raytracer_tpu.utils.goldengate import (
    check_framebuffer,
    region_means,
)

GRID = 8
H = W = 64  # 8x8 px regions


def make_ref(rng):
    """A reference framebuffer with lit (0.05-1.5) regions plus a few
    near-black ones, and its statistics."""
    region_vals = rng.uniform(0.05, 1.5, size=(GRID, GRID))
    region_vals[0, :3] = 2e-4  # near-black band (shadowed corner)
    fb = np.repeat(
        np.repeat(region_vals, H // GRID, axis=0), W // GRID, axis=1
    )[..., None] * np.ones(3)
    return fb.astype(np.float32), region_vals


def test_region_means_exact():
    rng = np.random.default_rng(0)
    fb, region_vals = make_ref(rng)
    np.testing.assert_allclose(region_means(fb, GRID), region_vals, rtol=1e-6)


def test_identical_passes():
    fb, vals = make_ref(np.random.default_rng(1))
    verdict = check_framebuffer(fb, float(fb.mean()), vals)
    assert verdict == "pass (0 soft-divergent regions)"


def test_chaotic_decorrelation_passes():
    """A few dim regions wobbling by ~1-3e-3 (the measured same-seed
    cross-backend decorrelation scale on rtw_final) must pass."""
    fb, vals = make_ref(np.random.default_rng(2))
    ref_mean = float(fb.mean())
    # Perturb 3 dim regions by 2e-3 absolute (rel > 2% where mean ~0.06).
    vals2 = vals.copy()
    dim = np.argsort(vals, axis=None)[3:6]  # skip the near-black band
    for flat in dim:
        iy, ix = np.unravel_index(flat, vals.shape)
        fb[iy * 8:(iy + 1) * 8, ix * 8:(ix + 1) * 8] += 2e-3
    verdict = check_framebuffer(fb, ref_mean, vals2)
    assert verdict.startswith("pass"), verdict


def test_near_black_relative_noise_passes():
    """Huge RELATIVE error on a near-black region (2e-4 -> 8e-4: 4x) stays
    under the absolute floors and must pass."""
    fb, vals = make_ref(np.random.default_rng(3))
    fb[0:8, 0:24] += 6e-4
    verdict = check_framebuffer(fb, float(fb.mean()), vals)
    assert verdict.startswith("pass"), verdict


def test_systematic_shift_fails_global_mean():
    """A 3% whole-image brightness shift (miscompiled exposure) fails."""
    fb, vals = make_ref(np.random.default_rng(4))
    ref_mean = float(fb.mean())
    verdict = check_framebuffer(fb * 1.03, ref_mean, vals)
    assert verdict.startswith("fail:global-mean"), verdict


def test_distributed_small_shift_fails_soft_count():
    """A +4% shift on a third of the regions with the global mean
    compensated elsewhere (pattern redistribution) trips the soft count."""
    fb, vals = make_ref(np.random.default_rng(5))
    ref_mean = float(fb.mean())
    shifted = fb.copy()
    lit = [np.unravel_index(f, vals.shape)
           for f in np.argsort(vals, axis=None)[::-1][:42]]
    up = lit[:21]
    down = lit[21:]
    for iy, ix in up:
        shifted[iy * 8:(iy + 1) * 8, ix * 8:(ix + 1) * 8] *= 1.04
    # compensate the global mean with a matched down-shift elsewhere
    delta = shifted.mean() - fb.mean()
    per = delta * GRID * GRID / len(down)
    for iy, ix in down:
        shifted[iy * 8:(iy + 1) * 8, ix * 8:(ix + 1) * 8] -= per
    assert abs(shifted.mean() - ref_mean) <= 0.01 * ref_mean
    verdict = check_framebuffer(shifted, ref_mean, vals)
    assert "regions beyond" in verdict, verdict


def test_localized_break_fails_hard():
    """One region 30% dark (a dropped tree subtree) fails the hard tier
    even with the global mean compensated."""
    fb, vals = make_ref(np.random.default_rng(6))
    ref_mean = float(fb.mean())
    iy, ix = np.unravel_index(int(vals.argmax()), vals.shape)
    fb2 = fb.copy()
    fb2[iy * 8:(iy + 1) * 8, ix * 8:(ix + 1) * 8] *= 0.70
    fb2 += (ref_mean - fb2.mean())  # hide from the global-mean gate
    verdict = check_framebuffer(fb2, ref_mean, vals)
    assert verdict.startswith("fail:region"), verdict


def test_nan_fails():
    fb, vals = make_ref(np.random.default_rng(7))
    fb[5, 5, 1] = np.nan
    assert check_framebuffer(fb, float(fb.mean()), vals) == "fail:nan"
