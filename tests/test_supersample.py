"""Supersampled rendering (render_supersampled / --supersample).

The estimator keeps the reference's box pixel filter (jitter uniform over
the pixel area, src/render.zig:115-121): rendering k^2 subpixels with
spp/k^2 samples each and box-downsampling stratifies the SAME integral, so
the mean must agree with the plain render and the variance must not
regress.  These tests pin the estimator semantics on the CPU mesh.
"""

import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zwrt
from zig_weekend_raytracer_tpu.render import Renderer
from zig_weekend_raytracer_tpu.scene import Camera, SceneBuilder


@pytest.fixture(scope="module")
def cornell():
    return zwrt.models.load_scene("cornell_box")


def test_emissive_wall_exact():
    """Noise-free geometry pin: an emissive wall fills the view, so EVERY
    sample of EVERY subpixel returns the emit color exactly — plain and
    supersampled renders must be identical constants.  If the k-res
    camera did not tile the base pixels (viewport drift, jitter overreach)
    edge subpixels would see background and this would fail exactly."""
    b = SceneBuilder()
    light = b.diffuse_light(b.solid_color((3.0, 2.0, 1.0)))
    b.add(b.quad((-50, -50, -1), (100, 0, 0), (0, 100, 0), light))
    b.set_background((0, 0, 0))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    scene = b.compile()
    r = Renderer(samples_per_pixel=4, max_ray_bounce_depth=3, seed=0)
    plain = np.asarray(r.render_device(scene, 10, 10))
    ss = np.asarray(r.render_supersampled(scene, 10, 10, k=2))
    np.testing.assert_allclose(plain, np.array([3.0, 2.0, 1.0]) *
                               np.ones((10, 10, 3)), atol=1e-6)
    np.testing.assert_allclose(ss, plain, atol=1e-6)


def test_k1_is_plain_render(cornell):
    r = Renderer(samples_per_pixel=4, max_ray_bounce_depth=3, seed=5)
    np.testing.assert_array_equal(
        np.asarray(r.render_supersampled(cornell, 12, 12, k=1)),
        np.asarray(r.render_device(cornell, 12, 12)),
    )


def test_spp_must_divide(cornell):
    r = Renderer(samples_per_pixel=6, max_ray_bounce_depth=3)
    with pytest.raises(ValueError, match="divisible"):
        r.render_supersampled(cornell, 8, 8, k=2)
    with pytest.raises(ValueError, match=">= 1"):
        r.render_supersampled(cornell, 8, 8, k=0)


def test_sobol_raster_alignment():
    """Sobol pixel offsets live in [0,1) (PBRT raster convention, parity
    with the reference src/math/sampler.zig:222-233), so the pixel-grid
    anchor scales with resolution; render_supersampled compensates with a
    (k-1)/2-subpixel raster shift.  Pin it with a wall covering exactly
    the top half of the view: the boundary row must read ~0.5 coverage in
    BOTH renders (before the fix the supersampled boundary row read 0.75
    — the image sat a quarter base-pixel low, 10x MSE on cornell)."""
    b = SceneBuilder()
    light = b.diffuse_light(b.solid_color((1.0, 1.0, 1.0)))
    b.add(b.quad((-50, 0, -1), (100, 0, 0), (0, 100, 0), light))
    b.set_background((0, 0, 0))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    scene = b.compile()
    r = Renderer(samples_per_pixel=64, max_ray_bounce_depth=2, seed=0)
    plain = np.asarray(r.render_device(scene, 8, 8)).mean((1, 2))
    ss = np.asarray(r.render_supersampled(scene, 8, 8, k=2)).mean((1, 2))
    np.testing.assert_allclose(plain[:3], 1.0, atol=1e-6)
    np.testing.assert_allclose(plain[4:], 0.0, atol=1e-6)
    assert abs(plain[3] - 0.5) < 0.05, plain
    assert abs(ss[3] - 0.5) < 0.05, ss
    np.testing.assert_allclose(ss[:3], 1.0, atol=1e-6)
    np.testing.assert_allclose(ss[4:], 0.0, atol=1e-6)


def test_shape_and_determinism(cornell):
    r = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    fb1 = np.asarray(r.render_supersampled(cornell, 12, 10, k=2))
    fb2 = np.asarray(r.render_supersampled(cornell, 12, 10, k=2))
    assert fb1.shape == (10, 12, 3)
    assert not np.isnan(fb1).any()
    np.testing.assert_array_equal(fb1, fb2)


def test_mean_matches_plain_estimator(cornell):
    """Same box filter, same budget: pooled image means agree within
    sampling noise.  Cornell at this size is heavy-tailed (caustic paths
    to a 15x emitter), so single-seed means scatter ~±10% in BOTH
    directions (measured: ss/plain ratios 0.95-1.13 across samplers and
    seeds); the tolerance is set above that scatter — a geometry bug
    (viewport drift, subpixel overreach) would shift the mean by far more
    and is pinned exactly by test_emissive_wall_exact."""
    w = h = 16
    plain = np.zeros(3)
    ss = np.zeros(3)
    seeds = (0, 1, 2, 3)
    for seed in seeds:
        r = Renderer(samples_per_pixel=16, max_ray_bounce_depth=4,
                     seed=seed)
        plain += np.asarray(r.render_device(cornell, w, h)).mean((0, 1))
        ss += np.asarray(
            r.render_supersampled(cornell, w, h, k=2)
        ).mean((0, 1))
    plain /= len(seeds)
    ss /= len(seeds)
    np.testing.assert_allclose(ss, plain, rtol=0.2)


def test_variance_not_worse(cornell):
    """Subpixel stratification should not LOSE quality at equal budget:
    pooled MSE vs a converged reference stays within noise of the plain
    render's (usually below it)."""
    w = h = 16
    ref = np.asarray(
        Renderer(samples_per_pixel=256, max_ray_bounce_depth=4,
                 seed=99).render_device(cornell, w, h)
    )
    mse_plain = 0.0
    mse_ss = 0.0
    seeds = (0, 1, 2)
    for seed in seeds:
        r = Renderer(samples_per_pixel=16, max_ray_bounce_depth=4,
                     seed=seed)
        fb_p = np.asarray(r.render_device(cornell, w, h))
        fb_s = np.asarray(r.render_supersampled(cornell, w, h, k=2))
        mse_plain += float(((fb_p - ref) ** 2).mean())
        mse_ss += float(((fb_s - ref) ** 2).mean())
    assert mse_ss <= mse_plain * 1.5, (mse_ss, mse_plain)


def test_cli_supersample_end_to_end(cornell, tmp_path):
    """--supersample drives the full CLI; bad combos exit with a clean
    error instead of a traceback."""
    from zig_weekend_raytracer_tpu.cli import main

    out = tmp_path / "ss.ppm"
    rc = main([
        "--image_width=12", "--image_height=12",
        "--samples_per_pixel=8", "--ray_bounce_max_depth=3",
        "--scene=cornell_box", "--supersample=2",
        f"--image_out_path={out}",
    ])
    assert rc == 0
    assert out.stat().st_size > 0

    # spp not divisible by k^2
    assert main([
        "--image_width=8", "--image_height=8", "--samples_per_pixel=6",
        "--scene=cornell_box", "--supersample=2",
        f"--image_out_path={out}",
    ]) == 1
    # rejected combination
    assert main([
        "--image_width=8", "--image_height=8", "--samples_per_pixel=8",
        "--scene=cornell_box", "--supersample=2", "--adaptive=1",
        f"--image_out_path={out}",
    ]) == 1
