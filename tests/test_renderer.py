"""Renderer driver tests: plan-cache lifetime/keying, the balanced
estimation-pass clamp, and the coherence-sorted driver."""

import gc
import os

import numpy as np
import pytest

from zig_weekend_raytracer_tpu.render.renderer import Renderer
from zig_weekend_raytracer_tpu.scene import Camera, SceneBuilder


def _small_scene():
    b = SceneBuilder()
    grey = b.lambertian(b.solid_color((0.6, 0.6, 0.6)))
    red = b.lambertian(b.solid_color((0.8, 0.2, 0.2)))
    b.add(b.quad((-50, 0, -50), (100, 0, 0), (0, 0, 100), grey))
    b.add(b.quad((-2, 0, -2), (4, 0, 0), (0, 4, 0), red))
    b.set_background((0.5, 0.7, 0.9))
    b.set_camera(Camera(look_from=(0, 2, 6), look_at=(0, 1, 0)))
    return b.compile()


def test_plan_cache_is_scene_lifetime_bound():
    """The cost-map cache is keyed on the CompiledScene object (weakly):
    a dead scene's entries vanish, so a new same-shape scene can never
    inherit a stale cost map (id() values are reused after GC)."""
    r = Renderer(samples_per_pixel=1, max_ray_bounce_depth=3)

    scene_a = _small_scene()
    fb1 = r.render(scene_a, 16, 16)
    fb2 = r.render(scene_a, 16, 16)  # second render builds + uses the plan
    np.testing.assert_array_equal(fb1, fb2)  # pure pixel permutation
    assert len(r._plan_cache) == 1

    compiled_a = scene_a.compiled
    assert compiled_a in r._plan_cache
    del scene_a, compiled_a
    gc.collect()
    assert len(r._plan_cache) == 0, "dead scene must not pin cache entries"

    # a new same-shape scene starts from a fresh populating pass
    scene_b = _small_scene()
    r.render(scene_b, 16, 16)
    entry = r._plan_cache[scene_b.compiled]
    (cfg_entry,) = entry.values()
    assert "work" in cfg_entry and "plan" not in cfg_entry


def test_plan_cache_config_bound():
    """Per-scene config entries are bounded (FIFO eviction)."""
    r = Renderer(samples_per_pixel=1, max_ray_bounce_depth=3)
    scene = _small_scene()
    cache = r._plan_cache.setdefault(scene.compiled, {})
    for i in range(r._plan_cache_max_configs):
        cache[("fake", i)] = {"work": None}
    r.render(scene, 16, 16)
    assert len(cache) <= r._plan_cache_max_configs
    assert ("fake", 0) not in cache  # oldest evicted


def test_balanced_driver_spp1_not_overbright():
    """With balancing enabled and spp == 1 the estimation pass must not
    render out-of-range sample indices (spp_est = max(2, spp//16) must be
    clamped to spp)."""
    scene = _small_scene()
    plain = Renderer(samples_per_pixel=1, max_ray_bounce_depth=3).render(
        scene, 16, 16
    )
    balanced = Renderer(
        samples_per_pixel=1, max_ray_bounce_depth=3, balance_min_spp=1
    ).render(scene, 16, 16)
    np.testing.assert_allclose(balanced, plain, rtol=1e-6, atol=1e-7)


def _tree_scene(n=72):
    """Enough spheres for the compiled scene to get a BVH."""
    rng = np.random.RandomState(7)
    b = SceneBuilder()
    grey = b.lambertian(b.solid_color((0.6, 0.6, 0.6)))
    b.add(b.quad((-50, 0, -50), (100, 0, 0), (0, 0, 100), grey))
    for i in range(n):
        x, z = rng.uniform(-6, 6, 2)
        mat = b.lambertian(b.solid_color(tuple(rng.uniform(0.2, 0.9, 3))))
        b.add(b.sphere((x, 0.3, z), 0.3, mat))
    b.set_background((0.5, 0.7, 0.9))
    b.set_camera(Camera(look_from=(0, 3, 10), look_at=(0, 0.5, 0)))
    b.use_bvh(True)
    return b.compile()


def test_coherent_driver_matches_plain(monkeypatch):
    """ZWRT_COHERENT packing is a pure pixel permutation: bit-identical
    framebuffer on a BVH scene."""
    scene = _tree_scene()
    assert scene.compiled.has_bvh
    # regen_min_wave=1 forces s_par == 1 (the coherent gate) at this size;
    # coherent packing is DEFAULT ON for BVH scenes, so the plain side
    # opts out explicitly
    monkeypatch.setenv("ZWRT_COHERENT", "0")
    r = Renderer(samples_per_pixel=2, max_ray_bounce_depth=3,
                 regen_min_wave=1)
    plain = r.render(scene, 16, 16)

    monkeypatch.setenv("ZWRT_COHERENT", "1")
    r2 = Renderer(samples_per_pixel=2, max_ray_bounce_depth=3,
                  regen_min_wave=1)
    coherent1 = r2.render(scene, 16, 16)  # builds + uses the plan
    coherent2 = r2.render(scene, 16, 16)  # cached plan
    np.testing.assert_array_equal(coherent1, plain)
    np.testing.assert_array_equal(coherent2, plain)
    # the plan is cached under the coherent key
    entry = r2._plan_cache[scene.compiled]
    assert any(k[0] == "coh" for k in entry)


def test_first_hit_probe_keys():
    """The probe returns the sphere each center pixel's primary ray hits
    (kind >= 0 on hits, -1 on background)."""
    import jax.numpy as jnp

    from zig_weekend_raytracer_tpu.render.camera import camera_params
    from zig_weekend_raytracer_tpu.render.renderer import _first_hit_probe
    from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind

    scene = _tree_scene()
    W = H = 16
    cam = camera_params(scene.camera, W, H)
    ys, xs = np.divmod(np.arange(W * H), W)
    kind, idx = _first_hit_probe(
        scene.compiled, cam, jnp.uint32(0),
        jnp.asarray(xs.astype(np.int32)), jnp.asarray(ys.astype(np.int32)),
        width=W, height=H, spp=2, sampler=SamplerKind.SOBOL, has_dof=False,
    )
    kind = np.asarray(kind)
    assert kind.shape == (W * H,)
    assert (kind >= 0).any(), "some primary rays must hit"
    assert (kind == -1).any(), "sky pixels must miss"
