"""Integrator tests with closed-form expectations.

These pin the estimator identity of the reference's rayColor
(src/render.zig:188-289) without Monte-Carlo noise: cosine sampling of a
lambertian exactly cancels the cosine scattering PDF, so simple scenes have
deterministic per-sample values.
"""

import numpy as np
import pytest

from zig_weekend_raytracer_tpu.render import Renderer
from zig_weekend_raytracer_tpu.scene import Camera, SceneBuilder


def _render(b, w=8, h=8, spp=4, depth=5):
    scene = b.compile()
    return Renderer(samples_per_pixel=spp, max_ray_bounce_depth=depth).render(
        scene, w, h
    )


def test_miss_returns_background():
    b = SceneBuilder()
    b.set_background((0.25, 0.5, 0.75))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    fb = _render(b)
    np.testing.assert_allclose(fb[..., 0], 0.25, atol=1e-6)
    np.testing.assert_allclose(fb[..., 2], 0.75, atol=1e-6)


def test_emissive_quad_returns_texture():
    """Direct view of a light returns its emission exactly
    (src/render.zig:238-240)."""
    b = SceneBuilder()
    light = b.diffuse_light(b.solid_color((15, 14, 13)))
    b.add(b.quad((-50, -50, -1), (100, 0, 0), (0, 100, 0), light))
    b.set_background((0, 0, 0))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    fb = _render(b)
    np.testing.assert_allclose(fb[..., 0], 15.0, rtol=1e-5)
    np.testing.assert_allclose(fb[..., 1], 14.0, rtol=1e-5)


def test_emissive_backface_is_black():
    """Lights emit nothing from their backface (src/material.zig:93)."""
    b = SceneBuilder()
    light = b.diffuse_light(b.solid_color((15, 15, 15)))
    # normal = u x v points away from camera -> camera sees the backface
    b.add(b.quad((-50, -50, -1), (0, 100, 0), (100, 0, 0), light))
    b.set_background((0, 0, 0))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    fb = _render(b)
    np.testing.assert_allclose(fb, 0.0, atol=1e-7)


def test_lambertian_single_bounce_is_albedo_times_sky():
    """A lambertian wall under a white sky: cosine sampling cancels the
    cosine PDF, so every sample equals albedo * sky exactly — zero variance.
    Pins weight = attenuation * scatteringPdf / samplePdf
    (src/render.zig:280-288)."""
    b = SceneBuilder()
    m = b.lambertian(b.solid_color((0.5, 0.25, 0.125)))
    b.add(b.quad((-500, -500, -2), (1000, 0, 0), (0, 1000, 0), m))
    b.set_background((1.0, 1.0, 1.0))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    fb = _render(b, spp=2, depth=8)
    np.testing.assert_allclose(fb[..., 0], 0.5, rtol=1e-4)
    np.testing.assert_allclose(fb[..., 1], 0.25, rtol=1e-4)
    np.testing.assert_allclose(fb[..., 2], 0.125, rtol=1e-4)


def test_depth_zero_plus_one_semantics():
    """depth=1: one hit allowed; diffuse bounce contributes nothing because
    the recursion budget is exhausted (src/render.zig:199)."""
    b = SceneBuilder()
    m = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
    b.add(b.quad((-500, -500, -2), (1000, 0, 0), (0, 1000, 0), m))
    b.set_background((1.0, 1.0, 1.0))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    fb = _render(b, spp=2, depth=1)
    np.testing.assert_allclose(fb, 0.0, atol=1e-7)


def test_mirror_metal_reflects_background():
    """fuzz=0 metal: specular bypass multiplies the albedo only
    (src/render.zig:243-246)."""
    b = SceneBuilder()
    m = b.metal((0.8, 0.9, 1.0), 0.0)
    b.add(b.quad((-500, -500, -2), (1000, 0, 0), (0, 1000, 0), m))
    b.set_background((1.0, 0.5, 0.25))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    fb = _render(b, spp=2, depth=4)
    np.testing.assert_allclose(fb[..., 0], 0.8 * 1.0, rtol=1e-4)
    np.testing.assert_allclose(fb[..., 1], 0.9 * 0.5, rtol=1e-4)
    np.testing.assert_allclose(fb[..., 2], 1.0 * 0.25, rtol=1e-4)


def test_glass_sphere_conserves_energy_roughly():
    """Dielectric attenuation is (1,1,1): with a uniform sky everything the
    glass does is redirect — every path still ends in the sky, so a deep
    render is ~1 everywhere (up to paths that exceed depth)."""
    b = SceneBuilder()
    b.add(b.sphere((0, 0, 0), 1.0, b.dielectric(1.5)))
    b.set_background((1.0, 1.0, 1.0))
    b.set_camera(Camera(look_from=(0, 0, 4), look_at=(0, 0, 0), vfov_degrees=30))
    fb = _render(b, w=12, h=12, spp=16, depth=32)
    assert fb.mean() == pytest.approx(1.0, abs=0.02)


def test_isotropic_scatters_uniformly():
    """Isotropic material: sphere PDF, weight cancels, paths leave in all
    directions -> white sky comes back (src/material.zig:127-151)."""
    b = SceneBuilder()
    m = b.isotropic(b.solid_color((1.0, 1.0, 1.0)))
    b.add(b.quad((-500, -500, -2), (1000, 0, 0), (0, 1000, 0), m))
    b.set_background((1.0, 1.0, 1.0))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    fb = _render(b, spp=8, depth=16)
    # isotropic can re-hit the plane repeatedly (scatters both hemispheres);
    # with albedo 1 and white sky everything still sums to ~1
    assert fb.mean() == pytest.approx(1.0, abs=0.05)


def test_coplanar_light_zero_pdf_is_finite():
    """Adversarial geometry: a lambertian ground coplanar with a quad light.
    Light-sampled directions lie exactly in the surface plane, so both the
    light PDF and the cosine scattering PDF vanish -> sample_pdf == 0.  The
    0/0 must be guarded (terminate with zero weight, not NaN); the reference
    debug-asserts here (src/render.zig:255-256)."""
    b = SceneBuilder()
    ground = b.lambertian(b.solid_color((0.7, 0.7, 0.7)))
    light = b.diffuse_light(b.solid_color((10, 10, 10)))
    b.add(b.quad((-50, 0, -50), (100, 0, 0), (0, 0, 100), ground))
    lq = b.add(b.quad((200, 0, -5), (10, 0, 0), (0, 0, 10), light))
    b.set_lights([lq])
    b.set_background((0.1, 0.1, 0.1))
    b.set_camera(Camera(look_from=(0, 3, 8), look_at=(0, 0, 0)))
    scene = b.compile()
    fb = Renderer(samples_per_pixel=16, max_ray_bounce_depth=6).render(
        scene, 16, 16
    )
    assert np.isfinite(fb).all()


# (Stream compaction and its invariance test were removed earlier: it was
# measured slower than the dead-ray work it saves on the first
# accelerator; unmeasured on the GPU.)
