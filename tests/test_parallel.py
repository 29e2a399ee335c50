"""Multi-chip sharding tests on the virtual 8-device CPU mesh: the
distributed analog of golden-image testing.  Content-addressed RNG makes the
sharded render agree with the single-device render bit-for-bit (up to f32
summation order across sample shards)."""

import jax
import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zwrt
from zig_weekend_raytracer_tpu.parallel import make_mesh, render_sharded
from zig_weekend_raytracer_tpu.render import Renderer


@pytest.fixture(scope="module")
def scene():
    return zwrt.models.load_scene("cornell_box")


@pytest.fixture(scope="module")
def single(scene):
    r = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=0)
    return r.render(scene, 16, 16)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sample_sharding_matches_single_device(scene, single):
    mesh = make_mesh(8)
    fb = render_sharded(
        scene, 16, 16, 8, max_depth=3, mesh=mesh, shard="samples", seed=0
    )
    np.testing.assert_allclose(np.asarray(fb), single, rtol=1e-4, atol=1e-6)


def test_row_sharding_matches_single_device(scene, single):
    mesh = make_mesh(8)
    fb = render_sharded(
        scene, 16, 16, 8, max_depth=3, mesh=mesh, shard="rows", seed=0
    )
    np.testing.assert_allclose(np.asarray(fb), single, rtol=1e-4, atol=1e-6)


def test_chip_count_invariance(scene):
    """1-, 2-, 4-, 8-device sample shards all agree."""
    results = []
    for n in (1, 2, 4, 8):
        mesh = make_mesh(n)
        fb = render_sharded(
            scene, 8, 8, 8, max_depth=2, mesh=mesh, shard="samples", seed=1
        )
        results.append(np.asarray(fb))
    for r in results[1:]:
        np.testing.assert_allclose(r, results[0], rtol=1e-4, atol=1e-6)


def test_graft_entry_contract():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (64, 64, 3)
    assert not np.isnan(np.asarray(out)).any()


def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sample_sharding_non_dividing_spp(scene):
    """spp=5 over 8 devices: shards are padded and masked."""
    single = Renderer(samples_per_pixel=5, max_ray_bounce_depth=3, seed=0).render(
        scene, 16, 16
    )
    fb = render_sharded(
        scene, 16, 16, 5, max_depth=3, mesh=make_mesh(8), shard="samples",
        seed=0,
    )
    np.testing.assert_allclose(np.asarray(fb), single, rtol=1e-4, atol=1e-6)


def test_row_sharding_non_dividing_height(scene):
    """height=13 over 8 devices: padded rows are rendered clamped and
    sliced off."""
    single = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=0).render(
        scene, 16, 13
    )
    fb = render_sharded(
        scene, 16, 13, 8, max_depth=3, mesh=make_mesh(8), shard="rows",
        seed=0,
    )
    assert fb.shape == (13, 16, 3)
    np.testing.assert_allclose(np.asarray(fb), single, rtol=1e-4, atol=1e-6)


def test_sample_sharding_image_scene():
    """Sharded rendering of an IMAGE-texture scene (atlas gathers inside
    the shard_map body) matches the single-device render — the sharded
    path must carry the atlas tables into every shard."""
    sc = zwrt.models.load_scene("shrek_quads")
    r = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=0)
    single = r.render(sc, 16, 16)
    fb = render_sharded(
        sc, 16, 16, 8, max_depth=3, mesh=make_mesh(8), shard="samples",
        seed=0,
    )
    assert np.isfinite(np.asarray(fb)).all()
    np.testing.assert_allclose(np.asarray(fb), single, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shard", ["samples", "rows"])
def test_sharded_megakernel_matches_single_device(shard):
    """The production path under shard_map: the regenerating wavefront
    inside the sharded worker must match the single-device per-bounce
    reference render."""
    sc = zwrt.models.load_scene("cornell_box")
    r = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=0)
    single = np.asarray(r.render_reference(sc, 16, 16))
    fb = render_sharded(
        sc, 16, 16, 8, max_depth=3, mesh=make_mesh(4), shard=shard, seed=0
    )
    np.testing.assert_allclose(np.asarray(fb), single, rtol=1e-4, atol=1e-6)


def test_sharded_megakernel_image_scene():
    """Sharded regenerating path for an image scene (atlas lookups inside
    shard_map) matches the single-device per-bounce reference."""
    sc = zwrt.models.load_scene("shrek_quads")
    r = Renderer(samples_per_pixel=4, max_ray_bounce_depth=3, seed=0)
    single = np.asarray(r.render_reference(sc, 16, 16))
    fb = render_sharded(
        sc, 16, 16, 4, max_depth=3, mesh=make_mesh(2), shard="samples",
        seed=0,
    )
    assert np.isfinite(np.asarray(fb)).all()
    np.testing.assert_allclose(np.asarray(fb), single, rtol=1e-4, atol=1e-6)


def test_sharded_fn_is_memoized(scene):
    """Repeated render_sharded calls must reuse ONE jitted shard_map
    closure per (scene, config) -- rebuilding it every call would re-trace
    the whole pipeline.  Different seeds ride the same fn;
    a different config adds exactly one entry."""
    from zig_weekend_raytracer_tpu.parallel import render as prender

    prender._sharded_fn_cache.pop(scene.compiled, None)
    mesh = make_mesh(2)
    a = render_sharded(scene, 16, 16, 8, max_depth=3, mesh=mesh,
                       shard="samples", seed=0)
    per = prender._sharded_fn_cache[scene.compiled]
    assert len(per) == 1
    fn_before = next(iter(per.values()))
    b = render_sharded(scene, 16, 16, 8, max_depth=3, mesh=mesh,
                       shard="samples", seed=1)
    assert next(iter(per.values())) is fn_before and len(per) == 1
    assert not np.allclose(np.asarray(a), np.asarray(b))  # seed did apply
    render_sharded(scene, 16, 16, 8, max_depth=3, mesh=mesh,
                   shard="rows", seed=0)
    assert len(per) == 2


@pytest.mark.parametrize("shard", ["samples", "rows"])
def test_sharded_sorted_plan_matches_first_call(shard):
    """Cost-sorted steady state: the SECOND render_sharded call of a
    sortable config rides cost-sorted plans through the balanced band
    (per-device sample ranges from axis_index in 'samples' mode,
    per-device stacked plans in 'rows' mode) and must agree with the
    first (plain + work-collect) call and the single-device render.
    regen_min_wave=1 forces s_par=1 at test sizes so the sort gate opens."""
    from zig_weekend_raytracer_tpu.parallel import render as prender

    sc = zwrt.models.load_scene("cornell_box")
    prender._sharded_plan_cache.pop(sc.compiled, None)
    kw = dict(max_depth=3, mesh=make_mesh(4), shard=shard, seed=0,
              regen_min_wave=1)
    first = render_sharded(sc, 16, 16, 8, **kw)
    per = prender._sharded_plan_cache[sc.compiled]
    assert any("plans" in e for e in per.values()), "work map not cached"
    second = render_sharded(sc, 16, 16, 8, **kw)
    r = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=0,
                 regen_min_wave=1)
    single = r.render(sc, 16, 16)
    np.testing.assert_allclose(
        np.asarray(second), np.asarray(first), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(second), single,
                               rtol=1e-4, atol=1e-6)


def test_sample_sharding_chunked_no_double_count(scene):
    """When a band does not cover the per-device sample slice evenly, a
    device must stay within its own sample range (a dynamic
    sample_limit), not just below the global spp: the sharded render of
    10 spp on 2 devices with a tiny chunk budget equals the single-device
    one (a double-counted sample inflates the mean ~2%)."""
    single = np.asarray(
        Renderer(
            samples_per_pixel=10, max_ray_bounce_depth=3, seed=0
        ).render(scene, 8, 8)
    )
    fb = np.asarray(render_sharded(
        scene, 8, 8, 10, max_depth=3, mesh=make_mesh(2), shard="samples",
        seed=0, max_rays_per_chunk=192,
    ))
    np.testing.assert_allclose(fb, single, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shard", ["samples", "rows"])
def test_sharded_bvh_scene_matches_reference(shard):
    """A BVH scene (per-lane traversal loops) under shard_map matches the
    single-device per-bounce reference."""
    sc = zwrt.models.load_scene("balls")
    r = Renderer(samples_per_pixel=4, max_ray_bounce_depth=3, seed=0)
    ref = np.asarray(r.render_reference(sc, 16, 12))
    fb = render_sharded(
        sc, 16, 12, 4, max_depth=3, mesh=make_mesh(4), shard=shard, seed=0
    )
    np.testing.assert_allclose(np.asarray(fb), ref, rtol=1e-4, atol=1e-6)
