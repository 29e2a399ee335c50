"""The regenerating wavefront (integrator.trace_paths_regen), the
production render path, against the per-bounce reference
(integrator.trace_paths via Renderer.render_reference).

Each lane of the regenerating path respawns its next sample when its path
ends and bounces with its own bounce index, while the reference bounces a
whole wavefront of camera rays together.  The content-addressed RNG makes
every path draw the same numbers under both, so on one backend the two
images agree to the last few ulps (the per-pixel sums only group
differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zwrt
from zig_weekend_raytracer_tpu.render import Renderer
from zig_weekend_raytracer_tpu.render.camera import (
    camera_consts,
    camera_params,
    generate_rays,
)
from zig_weekend_raytracer_tpu.render.integrator import (
    PathState,
    bounce_step,
    trace_paths_regen,
)
from zig_weekend_raytracer_tpu.dtypes import real
from zig_weekend_raytracer_tpu.math.v3 import V3
from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind
from zig_weekend_raytracer_tpu.scene import Camera, SceneBuilder

SCENES = [
    "cornell_box", "emissive", "shrek_quads", "earth", "balls", "rtw_final",
]


@pytest.mark.parametrize("name", SCENES)
def test_regen_matches_per_bounce(name):
    """All six built-in scenes: production render == reference render."""
    scene = zwrt.models.load_scene(name)
    r = Renderer(samples_per_pixel=2, max_ray_bounce_depth=3, seed=0)
    fb = r.render(scene, 16, 16)
    ref = np.asarray(r.render_reference(scene, 16, 16))
    assert np.isfinite(fb).all()
    np.testing.assert_allclose(fb, ref, rtol=1e-6, atol=1e-7)


def _lanes(width, height, spp, stride):
    """One group of ``stride`` lanes per pixel; lane k of a pixel starts at
    sample k and renders every stride-th sample below ``limit``."""
    n_pix = width * height
    ys, xs = np.divmod(np.arange(n_pix), width)
    px = np.repeat(xs, stride).astype(np.int32)
    py = np.repeat(ys, stride).astype(np.int32)
    s0 = np.tile(np.arange(stride), n_pix).astype(np.int32)
    lim = np.full(n_pix * stride, spp, np.int32)
    return px, py, s0, lim


def _regen(scene, width, height, spp, stride, px, py, s0, lim, depth=3,
           want_work=False, seed=0):
    return trace_paths_regen(
        scene.compiled, camera_consts(scene.camera, width, height),
        jnp.uint32(seed), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(s0), jnp.asarray(lim),
        sampler=SamplerKind.SOBOL, width=width, height=height, spp=spp,
        stride=stride, max_depth=depth,
        has_dof=scene.camera.has_depth_of_field, want_work=want_work,
    )


def _empty_scene():
    """No geometry: every path misses at bounce 0 and returns the white
    background, so a lane's radiance counts the samples it rendered."""
    b = SceneBuilder()
    b.set_background((1.0, 1.0, 1.0))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    return b.compile()


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_each_sample_rendered_once(stride):
    """Across respawns every (pixel, sample) is rendered exactly once:
    splitting a pixel's samples over ``stride`` lanes gives the reference
    sum over all samples, and on an empty scene each lane counts exactly
    its own samples."""
    W = H = 6
    spp = 7
    scene = zwrt.models.load_scene("cornell_box")
    px, py, s0, lim = _lanes(W, H, spp, stride)
    rad = _regen(scene, W, H, spp, stride, px, py, s0, lim).to_array()
    per_pixel = np.asarray(rad).reshape(W * H, stride, 3).sum(1)
    ref = np.asarray(Renderer(
        samples_per_pixel=spp, max_ray_bounce_depth=3, seed=0,
    ).render_reference(scene, W, H)) * spp
    np.testing.assert_allclose(
        per_pixel.reshape(H, W, 3), ref, rtol=1e-5, atol=1e-5
    )

    # uneven per-lane ranges: lane counts are exact
    rng = np.random.default_rng(stride)
    first = rng.integers(0, 4, px.shape[0]).astype(np.int32)
    limit = rng.integers(0, 12, px.shape[0]).astype(np.int32)
    empty = _empty_scene()
    counts = np.asarray(_regen(
        empty, W, H, 16, stride, px, py, s0 + first, limit,
    ).x)
    start = s0 + first
    expect = np.maximum(0, -(-(limit - start) // stride))
    np.testing.assert_array_equal(counts, expect.astype(np.float32))


def _count_bounces(scene, width, height, spp, depth, seed=0):
    """Independent bounce count: the per-bounce loop written out, counting
    the live lanes entering each bounce; summed per pixel over samples."""
    n_pix = width * height
    ys, xs = np.divmod(np.arange(n_pix * spp) % n_pix, width)
    sidx = np.arange(n_pix * spp) // n_pix
    px, py, sj = (jnp.asarray(a.astype(np.int32)) for a in (xs, ys, sidx))
    rid = ((sj.astype(jnp.uint32) * height + py.astype(jnp.uint32))
           * width + px.astype(jnp.uint32))
    origin, direction, time = generate_rays(
        camera_params(scene.camera, width, height),
        scene.camera.has_depth_of_field, SamplerKind.SOBOL,
        jnp.uint32(seed), rid, px, py, sj, spp, width, height,
    )
    n = origin.x.shape[0]
    st = PathState(
        origin=origin, direction=direction, time=time,
        throughput=V3.full((n,), 1.0, 1.0, 1.0, real),
        radiance=V3.zeros((n,), real), alive=jnp.ones((n,), bool),
        ray_id=rid,
    )
    step = jax.jit(lambda d, st: bounce_step(
        scene.compiled, jnp.uint32(seed), d, st))
    count = np.zeros(n, np.int64)
    for d in range(depth):
        count += np.asarray(st.alive)
        st = step(jnp.int32(d), st)
    return count.reshape(spp, n_pix).sum(0)


@pytest.mark.parametrize("name", ["cornell_box", "balls"])
def test_work_counter_equals_bounces(name):
    """want_work counts exactly the bounces the lane's paths took."""
    W = H = 6
    spp, depth = 4, 5
    scene = zwrt.models.load_scene(name)
    px, py, s0, lim = _lanes(W, H, spp, 1)
    _, work = _regen(scene, W, H, spp, 1, px, py, s0, lim, depth=depth,
                     want_work=True)
    expect = _count_bounces(scene, W, H, spp, depth)
    np.testing.assert_array_equal(np.asarray(work), expect)
    assert (expect >= spp).all() and (expect <= spp * depth).all()


def test_dead_padding_lanes_do_nothing():
    """Lanes whose limit is at or below their first sample never respawn:
    zero radiance and zero work (the padding lanes of every plan)."""
    W = H = 4
    scene = zwrt.models.load_scene("cornell_box")
    px, py, s0, lim = _lanes(W, H, 4, 1)
    lim[::2] = 0
    rad, work = _regen(scene, W, H, 4, 1, px, py, s0, lim, want_work=True)
    assert (np.asarray(rad.to_array())[::2] == 0).all()
    assert (np.asarray(work)[::2] == 0).all()
    assert (np.asarray(work)[1::2] >= 4).all()


@pytest.mark.parametrize("name", ["cornell_box", "earth", "rtw_final"])
def test_lowered_render_has_no_dot(name):
    """The render step contains no matrix product, so TF32 (or any
    matmul precision setting) cannot enter it."""
    from zig_weekend_raytracer_tpu.render.renderer import _render_band_regen

    scene = zwrt.models.load_scene(name)
    W = H = 8
    text = _render_band_regen.lower(
        scene.compiled, jnp.uint32(0), jnp.int32(0), jnp.int32(0),
        width=W, height=H, band_rows=H, s_par=1, spp=2, sample_limit=2,
        max_depth=3, sampler=SamplerKind.SOBOL,
        has_dof=scene.camera.has_depth_of_field,
        cam_consts=camera_consts(scene.camera, W, H),
    ).as_text()
    assert "while" in text  # the loop really was lowered
    assert "dot_general" not in text and "stablehlo.dot " not in text


def test_emissive_image_scene():
    """An emitter textured with an image: the regenerating path renders
    it (equal to the reference), and the emitted colors are the image's."""
    b = SceneBuilder()
    img = np.zeros((2, 2, 3), np.uint8)
    img[:, 0] = (255, 0, 0)
    img[:, 1] = (0, 0, 255)
    light = b.diffuse_light(b.image_texture(img))
    b.add(b.quad((-2, -2, 0), (4, 0, 0), (0, 4, 0), light))
    b.set_background((0, 0, 0))
    b.set_camera(Camera(look_from=(0, 0, 3), look_at=(0, 0, 0),
                        vfov_degrees=40))
    scene = b.compile()
    r = Renderer(samples_per_pixel=2, max_ray_bounce_depth=3, seed=0)
    fb = r.render(scene, 8, 8)
    np.testing.assert_array_equal(
        fb, np.asarray(r.render_reference(scene, 8, 8))
    )
    # left half red, right half blue (u runs with +x); the middle columns
    # straddle the texel edge
    assert (fb[:, :3, 0] > 0.9).all() and (fb[:, :3, 2] < 0.1).all()
    assert (fb[:, 5:, 2] > 0.9).all() and (fb[:, 5:, 0] < 0.1).all()


def test_motion_blur_and_defocus_scene():
    """Moving spheres and a defocus disk: per-lane respawned rays carry
    their own time and lens sample, equal to the reference."""
    b = SceneBuilder()
    m = b.lambertian(b.solid_color((0.7, 0.3, 0.3)))
    g = b.lambertian(b.checkerboard(1.0, b.solid_color((0.9, 0.9, 0.9)),
                                    b.solid_color((0.1, 0.1, 0.1))))
    b.add(b.quad((-20, -1, -20), (40, 0, 0), (0, 0, 40), g))
    b.add(b.moving_sphere((0, 0, 0), (0.5, 0.3, 0), 1.0, m))
    b.set_background((0.6, 0.7, 1.0))
    b.set_camera(Camera(look_from=(0, 1, 6), look_at=(0, 0, 0),
                        defocus_angle_degrees=2.0, focus_dist=6.0))
    scene = b.compile()
    assert scene.compiled.has_moving and scene.camera.has_depth_of_field
    r = Renderer(samples_per_pixel=4, max_ray_bounce_depth=3, seed=1)
    np.testing.assert_allclose(
        r.render(scene, 12, 12),
        np.asarray(r.render_reference(scene, 12, 12)),
        rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("sampler", ["independent", "stratified"])
def test_regen_matches_per_bounce_samplers(sampler):
    """The non-default pixel samplers draw the same camera rays through
    both paths."""
    scene = zwrt.models.load_scene("cornell_box")
    r = Renderer(samples_per_pixel=4, max_ray_bounce_depth=3, seed=0,
                 sampler=SamplerKind(sampler))
    np.testing.assert_allclose(
        r.render(scene, 12, 12),
        np.asarray(r.render_reference(scene, 12, 12)),
        rtol=1e-6, atol=1e-7,
    )


def test_regen_geometry_fills_min_wave():
    """s_par rises until the band holds regen_min_wave lanes, never past
    spp; band rows respect max_rays_per_chunk."""
    r = Renderer(samples_per_pixel=64, regen_min_wave=1 << 12,
                 max_rays_per_chunk=1 << 10)
    assert r.regen_geometry(16, 16, 64) == (16, 4)
    assert r.regen_geometry(16, 16, 4) == (4, 16)
    assert r.regen_geometry(100, 100, 64) == (1, 10)


def test_bounce_step_jits_with_per_lane_depth():
    """bounce_step takes a scalar or a per-lane bounce index; with every
    lane at the same index both give the same state."""
    scene = zwrt.models.load_scene("cornell_box")
    W = H = 4
    n = W * H
    ys, xs = np.divmod(np.arange(n), W)
    px, py = jnp.asarray(xs.astype(np.int32)), jnp.asarray(ys.astype(np.int32))
    sj = jnp.zeros((n,), jnp.int32)
    rid = py.astype(jnp.uint32) * W + px.astype(jnp.uint32)
    o, d, t = generate_rays(
        camera_params(scene.camera, W, H), False, SamplerKind.SOBOL,
        jnp.uint32(0), rid, px, py, sj, 1, W, H,
    )
    st = PathState(o, d, t, V3.full((n,), 1.0, 1.0, 1.0, real),
                   V3.zeros((n,), real), jnp.ones((n,), bool), rid)
    step = jax.jit(lambda depth, st: bounce_step(
        scene.compiled, jnp.uint32(0), depth, st))
    a = step(jnp.int32(2), st)
    b = step(jnp.full((n,), 2, jnp.int32), st)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
