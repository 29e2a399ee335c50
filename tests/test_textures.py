"""Texture evaluation tests (reference: src/texture.zig)."""

import jax.numpy as jnp
import numpy as np
import pytest

from zig_weekend_raytracer_tpu.math.v3 import V3
from zig_weekend_raytracer_tpu.scene import SceneBuilder
from zig_weekend_raytracer_tpu.textures import texture_value


def _point(x, y, z, n=1):
    return V3(jnp.full((n,), x), jnp.full((n,), y), jnp.full((n,), z))


def _tex_scene(build):
    b = SceneBuilder()
    tid = build(b)
    m = b.lambertian(tid)
    b.add(b.sphere((0, 0, 0), 1, m))
    return b.compile().compiled, tid


class TestSolid:
    def test_returns_rgb(self):
        c, tid = _tex_scene(lambda b: b.solid_color((0.2, 0.4, 0.8)))
        t = texture_value(c, jnp.full((1,), tid, jnp.int32), jnp.zeros(1), jnp.zeros(1), _point(0, 0, 0))
        assert float(t.x[0]) == pytest.approx(0.2)
        assert float(t.z[0]) == pytest.approx(0.8)


class TestChecker:
    def _scene(self):
        b = SceneBuilder()
        even = b.solid_color((1, 0, 0))
        odd = b.solid_color((0, 1, 0))
        ch = b.checkerboard(1.0, even, odd)  # inv_scale 1 => unit lattice
        m = b.lambertian(ch)
        b.add(b.sphere((0, 0, 0), 1, m))
        return b.compile().compiled, ch

    def test_lattice_parity(self):
        """floor(x)+floor(y)+floor(z) parity selects even/odd
        (src/texture.zig:111-118)."""
        c, ch = self._scene()
        tid = jnp.full((4,), ch, jnp.int32)
        pts = V3(
            jnp.asarray([0.5, 1.5, 1.5, -0.5]),
            jnp.asarray([0.5, 0.5, 1.5, 0.5]),
            jnp.asarray([0.5, 0.5, 0.5, 0.5]),
        )
        t = texture_value(c, tid, jnp.zeros(4), jnp.zeros(4), pts)
        r = np.asarray(t.x)
        # parities: 0 even, 1 odd, 2 even, (-1+0+0) odd
        np.testing.assert_allclose(r, [1, 0, 1, 0], atol=1e-6)

    def test_scene_scale(self):
        """The reference uses inv_scale=0.32 for ground checkers."""
        b = SceneBuilder()
        even = b.solid_color((1, 0, 0))
        odd = b.solid_color((0, 1, 0))
        ch = b.checkerboard(0.32, even, odd)
        b.add(b.sphere((0, 0, 0), 1, b.lambertian(ch)))
        c = b.compile().compiled
        tid = jnp.full((2,), ch, jnp.int32)
        pts = V3(jnp.asarray([0.0, 3.2]), jnp.zeros(2), jnp.zeros(2))
        t = texture_value(c, tid, jnp.zeros(2), jnp.zeros(2), pts)
        assert float(t.x[0]) == 1.0  # floor(0)=0 even
        assert float(t.x[1]) == 0.0  # floor(1.024)=1 odd


class TestImage:
    def _scene(self):
        img = np.zeros((2, 4, 3), np.uint8)
        img[0, 0] = (255, 0, 0)    # top-left red
        img[1, 3] = (0, 255, 0)    # bottom-right green
        b = SceneBuilder()
        tid = b.image_texture(img)
        b.add(b.sphere((0, 0, 0), 1, b.lambertian(tid)))
        return b.compile().compiled, tid

    def test_uv_lookup_with_v_flip_and_gamma(self):
        c, tid = self._scene()
        t4 = jnp.full((2,), tid, jnp.int32)
        # v=1 -> image row 0 (flip); u=0 -> col 0
        u = jnp.asarray([0.0, 0.999])
        v = jnp.asarray([0.999, 0.0])
        t = texture_value(c, t4, u, v, _point(0, 0, 0, 2))
        # byte 255 -> 1.0 -> linearized 1.0
        assert float(t.x[0]) == pytest.approx(1.0, abs=1e-3)
        assert float(t.y[0]) == pytest.approx(0.0, abs=1e-6)
        assert float(t.y[1]) == pytest.approx(1.0, abs=1e-3)

    def test_uv_clamped(self):
        c, tid = self._scene()
        t1 = jnp.full((1,), tid, jnp.int32)
        t = texture_value(
            c, t1, jnp.asarray([5.0]), jnp.asarray([-3.0]), _point(0, 0, 0)
        )
        # u clamps to 1 -> last col; v clamps to 0 -> flipped to bottom row
        assert float(t.y[0]) == pytest.approx(1.0, abs=1e-3)

    def test_gamma_linearization(self):
        img = np.full((1, 1, 3), 128, np.uint8)
        b = SceneBuilder()
        tid = b.image_texture(img)
        b.add(b.sphere((0, 0, 0), 1, b.lambertian(tid)))
        c = b.compile().compiled
        t = texture_value(
            c, jnp.full((1,), tid, jnp.int32), jnp.zeros(1), jnp.zeros(1),
            _point(0, 0, 0),
        )
        assert float(t.x[0]) == pytest.approx((128 / 255) ** 2, rel=1e-4)


class TestDebugFallback:
    def test_missing_image_is_magenta(self):
        from zig_weekend_raytracer_tpu.io.image import load_image

        img = load_image("/nonexistent/nope.png")
        assert img.shape == (1, 1, 3)
        assert tuple(img[0, 0]) == (255, 0, 255)


class TestCheckerOfImage:
    """Checker children may be image textures (reference recurses into
    arbitrary children, src/texture.zig:111-118: the child samples at the
    hit's u,v).  The denormalized record carries per-parity image ids."""

    def _build(self):
        b = SceneBuilder()
        img = np.zeros((2, 2, 3), np.uint8)
        img[..., 0] = 200  # reddish image
        even = b.image_texture(img)
        odd = b.solid_color((0.0, 0.3, 0.0))
        ch = b.checkerboard(0.5, even, odd)
        m = b.lambertian(ch)
        # big quad facing the camera
        b.add(b.quad((-4, -4, 0), (8, 0, 0), (0, 8, 0), m))
        from zig_weekend_raytracer_tpu.scene import Camera

        b.set_camera(Camera(look_from=(0, 0, 9), look_at=(0, 0, 0), vfov_degrees=60))
        b.set_background((0.8, 0.8, 0.8))
        return b

    def test_flags(self):
        c = self._build().compile().compiled
        assert c.has_image_textures
        assert not c.has_nested_checker

    def test_general_walk_resolves_image_child(self):
        c = self._build().compile().compiled
        # point in an even cell -> image child; u,v anywhere in the texel
        t = texture_value(
            c, jnp.full((1,), 2, jnp.int32), jnp.full((1,), 0.1),
            jnp.full((1,), 0.1), _point(0.5, 0.5, 0.5),
        )
        assert float(t.x[0]) == pytest.approx((200 / 255) ** 2, rel=1e-4)
        assert float(t.y[0]) == pytest.approx(0.0, abs=1e-6)

    def test_render_kernel_matches_xla(self):
        """The regenerating wavefront and the per-bounce reference agree on
        a checker-of-image scene (no magenta substitution)."""
        from zig_weekend_raytracer_tpu.render import Renderer

        scene = self._build().compile()
        r = Renderer(samples_per_pixel=2, max_ray_bounce_depth=3, seed=0)
        fb_kernel = r.render(scene, 16, 16)
        fb_ref = np.asarray(r.render_reference(scene, 16, 16))

        assert np.isfinite(fb_kernel).all()
        # magenta would be pure-red dominant with zero green everywhere
        np.testing.assert_allclose(fb_kernel, fb_ref, rtol=1e-5, atol=1e-6)


class TestNestedChecker:
    """Checker-in-checker nesting can't flatten into one shade record; the
    scene flags it and the integrator evaluates the general texture walk
    (depth 4) instead of substituting a debug color."""

    def _build(self):
        b = SceneBuilder()
        a = b.solid_color((1.0, 0.0, 0.0))
        c2 = b.solid_color((0.0, 1.0, 0.0))
        inner = b.checkerboard(2.0, a, c2)
        outer_odd = b.solid_color((0.0, 0.0, 1.0))
        outer = b.checkerboard(0.25, inner, outer_odd)
        m = b.lambertian(outer)
        b.add(b.quad((-4, -4, 0), (8, 0, 0), (0, 8, 0), m))
        from zig_weekend_raytracer_tpu.scene import Camera

        b.set_camera(Camera(look_from=(0, 0, 9), look_at=(0, 0, 0), vfov_degrees=60))
        b.set_background((1.0, 1.0, 1.0))
        return b

    def test_flag_and_kernel_gate(self):
        """The scene is flagged, and the production (regenerating) render
        equals the per-bounce reference on it."""
        from zig_weekend_raytracer_tpu.render import Renderer

        scene = self._build().compile()
        assert scene.compiled.has_nested_checker
        r = Renderer(samples_per_pixel=2, max_ray_bounce_depth=3, seed=0)
        np.testing.assert_array_equal(
            r.render(scene, 12, 12),
            np.asarray(r.render_reference(scene, 12, 12)),
        )

    def test_walk_resolves_two_levels(self):
        c = self._build().compile().compiled
        outer = 4  # ids in declaration order: a, c2, inner, outer_odd, outer
        # outer parity even at (1,1,1)*0.25 -> inner; inner parity at
        # scale 2: floor(2)+floor(2)+floor(2)=6 even -> red
        t = texture_value(
            c, jnp.full((1,), outer, jnp.int32), jnp.zeros(1), jnp.zeros(1),
            _point(1.0, 1.0, 1.0),
        )
        assert float(t.x[0]) == pytest.approx(1.0)
        # outer parity odd at (5,1,1)*0.25: floor(1.25)+0+0 = 1 -> blue
        t2 = texture_value(
            c, jnp.full((1,), outer, jnp.int32), jnp.zeros(1), jnp.zeros(1),
            _point(5.0, 1.0, 1.0),
        )
        assert float(t2.z[0]) == pytest.approx(1.0)

    def test_render_is_finite_and_pattern_correct(self):
        """A full render of the nested-checker quad is finite and shows all
        three leaf colors (no magenta)."""
        from zig_weekend_raytracer_tpu.render import Renderer

        scene = self._build().compile()
        r = Renderer(samples_per_pixel=4, max_ray_bounce_depth=2, seed=0)
        fb = r.render(scene, 32, 32)
        assert np.isfinite(fb).all()
        # magenta debug color (1, 0, 1) must not appear: wherever red is
        # high, either green is high too (white bg tint) or blue is low
        magenta = (fb[..., 0] > 0.5) & (fb[..., 2] > 0.5) & (fb[..., 1] < 0.1)
        assert not magenta.any()
