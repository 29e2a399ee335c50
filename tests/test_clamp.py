"""Indirect luminance clamp (opt-in firefly control, Renderer.clamp_indirect).

Cycles-style: radiance contributions landed at bounce >= 1 are luminance-
scaled to at most the clamp value; direct light (bounce 0) stays exact.
Biased by construction, default off (reference semantics + goldens).  The
regenerating wavefront gates the clamp on each lane's own bounce index, so
it matches the per-bounce reference contribution-for-contribution."""

import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zwrt
from zig_weekend_raytracer_tpu.render import Renderer
from zig_weekend_raytracer_tpu.scene import Camera, SceneBuilder


@pytest.mark.parametrize("name", ["cornell_box", "emissive", "balls"])
def test_clamp_kernel_matches_xla(name):
    scene = zwrt.models.load_scene(name)
    r = Renderer(
        samples_per_pixel=4, max_ray_bounce_depth=6, seed=0,
        clamp_indirect=0.5,
    )
    fb_kernel = r.render(scene, 16, 16)
    fb_ref = np.asarray(r.render_reference(scene, 16, 16))
    assert np.isfinite(fb_kernel).all()
    np.testing.assert_allclose(fb_kernel, fb_ref, rtol=1e-6, atol=1e-7)


def test_clamp_caps_indirect_and_changes_image():
    """On a caustic-prone config the clamp lowers the brightest pixels and
    never raises any pixel."""
    scene = zwrt.models.load_scene("cornell_box")
    base = Renderer(samples_per_pixel=8, max_ray_bounce_depth=8, seed=0)
    cl = Renderer(
        samples_per_pixel=8, max_ray_bounce_depth=8, seed=0,
        clamp_indirect=0.25,
    )
    fb0 = np.asarray(base.render(scene, 16, 16))
    fb1 = np.asarray(cl.render(scene, 16, 16))
    assert (fb1 <= fb0 + 1e-6).all()  # clamping only removes energy
    assert fb1.sum() < fb0.sum()      # and actually caps something
    # the brightest pixel is the DIRECT view of the light — exempt
    assert fb1.max() == fb0.max()


def test_clamp_preserves_direct_light():
    """A camera looking straight at an emitter reads the full emission even
    under an aggressive clamp (bounce-0 contributions are exempt)."""
    b = SceneBuilder()
    light = b.diffuse_light(b.solid_color((15, 14, 13)))
    b.add(b.quad((-50, -50, -1), (100, 0, 0), (0, 100, 0), light))
    b.set_background((0, 0, 0))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    scene = b.compile()
    fb = Renderer(
        samples_per_pixel=2, max_ray_bounce_depth=4, clamp_indirect=0.05
    ).render(scene, 8, 8)
    np.testing.assert_allclose(fb[..., 0], 15.0, rtol=1e-5)


def test_clamp_ignored_on_image_scenes():
    scene = zwrt.models.load_scene("shrek_quads")
    base = Renderer(samples_per_pixel=2, max_ray_bounce_depth=4, seed=0)
    cl = Renderer(
        samples_per_pixel=2, max_ray_bounce_depth=4, seed=0,
        clamp_indirect=0.1,
    )
    np.testing.assert_array_equal(
        np.asarray(base.render(scene, 12, 12)),
        np.asarray(cl.render(scene, 12, 12)),
    )


def test_clamp_sharded_matches_single_device():
    from zig_weekend_raytracer_tpu.parallel import make_mesh, render_sharded

    scene = zwrt.models.load_scene("cornell_box")
    single = np.asarray(
        Renderer(
            samples_per_pixel=8, max_ray_bounce_depth=4, seed=0,
            clamp_indirect=0.5,
        ).render(scene, 16, 16)
    )
    fb = render_sharded(
        scene, 16, 16, 8, max_depth=4, mesh=make_mesh(4), shard="samples",
        seed=0, clamp=0.5,
    )
    np.testing.assert_allclose(np.asarray(fb), single, rtol=1e-5, atol=1e-6)
