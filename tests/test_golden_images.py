"""Pinned golden-image regressions: exact small renders of all five scenes.

Unlike the statistical composition checks in test_golden.py (region means,
loose thresholds), these compare per-pixel against committed framebuffers
(tests/golden/*.npz, produced by tools/gen_goldens.py on the same CPU/XLA
path CI runs).  A sampler, shading, or estimator regression that shifts
brightness a few percent fails here; the statistical tests stay as a
second tier that localizes WHAT broke.

The goldens come from the per-bounce reference on the CPU; the production
regenerating path must pass them as they stand.

Reference analog: the examples/ artifacts role in
j-helland/zig-weekend-raytracer (README.md:4) — pinned expected output.
"""

import pathlib

import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zwrt

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "golden"
SCENES = [
    "cornell_box", "emissive", "balls", "shrek_quads", "rtw_final", "earth",
]

# Same-platform reruns are bitwise identical; the tolerance budget exists
# only for XLA version-to-version fusion/reassociation drift.  A 10%
# brightness shift or a sampler change is far outside it.
PIXEL_ATOL = 0.02
PIXEL_RTOL = 0.05
MEAN_REL_TOL = 0.02


@pytest.mark.parametrize("name", SCENES)
def test_render_matches_golden(name):
    data = np.load(GOLDEN_DIR / f"{name}.npz")
    ref = data["fb"]
    scene = zwrt.models.load_scene(name, seed=int(data["seed"]))
    r = zwrt.render.Renderer(
        samples_per_pixel=int(data["spp"]),
        max_ray_bounce_depth=int(data["depth"]),
        seed=int(data["seed"]),
    )
    fb = np.asarray(
        r.render(scene, int(data["width"]), int(data["height"]))
    )
    assert np.isfinite(fb).all()
    assert fb.shape == ref.shape

    # global brightness: catches uniform estimator scaling bugs
    rel_mean = abs(fb.mean() - ref.mean()) / max(ref.mean(), 1e-6)
    assert rel_mean < MEAN_REL_TOL, (
        f"{name}: mean brightness drifted {rel_mean:.1%} "
        f"({fb.mean():.5f} vs golden {ref.mean():.5f})"
    )

    # per-pixel: catches pattern/shading/sampler changes that keep the mean
    bad = np.abs(fb - ref) > (PIXEL_ATOL + PIXEL_RTOL * np.abs(ref))
    frac_bad = bad.mean()
    assert frac_bad < 0.005, (
        f"{name}: {frac_bad:.2%} of pixel channels outside tolerance "
        f"(max abs diff {np.abs(fb - ref).max():.4f})"
    )
