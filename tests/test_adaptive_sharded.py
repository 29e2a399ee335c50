"""Sharded adaptive sampling (parallel/render.py:render_adaptive_sharded)
on the virtual 8-device CPU mesh.

shard='samples' psums the pilot noise map, so every device computes the
SAME allocation as the single-device path: the per-pixel sample map must
EQUAL Renderer.render_adaptive's at any device count, and the framebuffer
must match up to f32 psum reassociation.  shard='rows' runs the pipeline
locally per device region: with one device (and band-dividing heights) it
is bitwise-identical to the single-device path; with more devices it is a
different but equally valid equal-budget estimator (allocation locality is
per device region), so the tests pin exact budget conservation and
estimator-level agreement instead of bitwise equality."""

import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zwrt
from zig_weekend_raytracer_tpu.parallel import (
    make_mesh,
    render_adaptive_sharded,
)
from zig_weekend_raytracer_tpu.render import Renderer
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind


SPP, DEPTH, PILOT = 32, 4, 8


@pytest.fixture(scope="module")
def scene():
    return zwrt.models.load_scene("cornell_box")


def _single(scene, seed=0):
    r = Renderer(
        samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH, seed=seed
    )
    return r.render_adaptive(scene, 16, 16, pilot_spp=PILOT,
                             return_stats=True)


def test_samples_mode_matches_single_device_plan(scene):
    """The psum'd noise map reproduces the single-device allocation: the
    per-pixel sample map is EQUAL at every device count, and the image
    agrees to f32-reassociation tolerance (bitwise at n_dev=1)."""
    fb1, st1 = _single(scene)
    fb1 = np.asarray(fb1)
    for n in (1, 2, 4):
        fb, st = render_adaptive_sharded(
            scene, 16, 16, SPP, max_depth=DEPTH, mesh=make_mesh(n),
            shard="samples", seed=0, pilot_spp=PILOT, return_stats=True,
        )
        np.testing.assert_array_equal(st["n_samples"], st1["n_samples"])
        if n == 1:
            np.testing.assert_array_equal(np.asarray(fb), fb1)
        else:
            np.testing.assert_allclose(
                np.asarray(fb), fb1, rtol=1e-4, atol=1e-5
            )


def test_rows_mode_one_device_bitwise(scene):
    fb1, st1 = _single(scene)
    fb, st = render_adaptive_sharded(
        scene, 16, 16, SPP, max_depth=DEPTH, mesh=make_mesh(1),
        shard="rows", seed=0, pilot_spp=PILOT, return_stats=True,
    )
    np.testing.assert_array_equal(st["n_samples"], st1["n_samples"])
    np.testing.assert_array_equal(np.asarray(fb), np.asarray(fb1))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_rows_mode_budget_and_mean(scene, n_dev):
    fb, st = render_adaptive_sharded(
        scene, 16, 16, SPP, max_depth=DEPTH, mesh=make_mesh(n_dev),
        shard="rows", seed=0, pilot_spp=PILOT, return_stats=True,
    )
    fb = np.asarray(fb)
    assert fb.shape == (16, 16, 3)
    assert np.isfinite(fb).all()
    # exact equal-budget conservation, per device region and in total
    counts = st["n_samples"]
    assert counts.sum() == 16 * 16 * SPP
    rows_local = 16 // n_dev
    for d in range(n_dev):
        region = counts[d * rows_local : (d + 1) * rows_local]
        assert region.sum() == rows_local * 16 * SPP
    assert counts.min() >= PILOT
    # unbiased estimator: agrees with the uniform render's mean
    fu = np.asarray(
        Renderer(
            samples_per_pixel=SPP, max_ray_bounce_depth=DEPTH, seed=0
        ).render(scene, 16, 16)
    )
    assert abs(fb.mean() - fu.mean()) < 0.15 * fu.mean()


def test_rows_mode_non_dividing_height(scene):
    """height=13 over 8 devices: the last device's padded rows must get
    zero allocation and be sliced off."""
    fb, st = render_adaptive_sharded(
        scene, 16, 13, SPP, max_depth=DEPTH, mesh=make_mesh(8),
        shard="rows", seed=0, pilot_spp=PILOT, return_stats=True,
    )
    fb = np.asarray(fb)
    assert fb.shape == (13, 16, 3)
    assert np.isfinite(fb).all()
    assert st["n_samples"].shape == (13, 16)
    assert st["n_samples"].sum() == 13 * 16 * SPP


def test_samples_mode_non_dividing_spp_slices(scene):
    """8 devices over a pilot half of 4: most devices render empty pilot
    slices; the psum'd map must still reproduce the single-device plan."""
    fb1, st1 = _single(scene)
    fb, st = render_adaptive_sharded(
        scene, 16, 16, SPP, max_depth=DEPTH, mesh=make_mesh(8),
        shard="samples", seed=0, pilot_spp=PILOT, return_stats=True,
    )
    np.testing.assert_array_equal(st["n_samples"], st1["n_samples"])
    np.testing.assert_allclose(
        np.asarray(fb), np.asarray(fb1), rtol=1e-4, atol=1e-5
    )


def test_stratified_rejected(scene):
    with pytest.raises(ValueError, match="stratified"):
        render_adaptive_sharded(
            scene, 8, 8, 8, mesh=make_mesh(2),
            sampler=SamplerKind.STRATIFIED,
        )


def test_fallback_without_kernel_backend(scene):
    """When the pilot would take the whole budget, sharded adaptive falls
    back to the uniform sharded render, like the single-device path."""
    from zig_weekend_raytracer_tpu.parallel import render_sharded

    fb, st = render_adaptive_sharded(
        scene, 8, 8, 8, max_depth=2, mesh=make_mesh(2), shard="samples",
        seed=3, pilot_spp=8, return_stats=True,
    )
    assert (st["n_samples"] == 8).all()
    fu = render_sharded(
        scene, 8, 8, 8, max_depth=2, mesh=make_mesh(2), shard="samples",
        seed=3,
    )
    np.testing.assert_array_equal(np.asarray(fb), np.asarray(fu))
