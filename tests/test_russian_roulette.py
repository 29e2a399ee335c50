"""Russian roulette (opt-in path-tail termination, Renderer.russian_roulette).

The reference has no RR, so the default (0 = off) preserves reference
semantics and every golden.  With RR on the estimator stays unbiased —
continuation probability p = clamp(max(throughput), RR_P_MIN, 1), survivors
weighted 1/p — and the regenerating wavefront draws exactly what the
per-bounce reference draws (per-bounce hashrng site k=3, addressed by each
lane's own bounce index), so the two agree bitwise-closely."""

import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zwrt
from zig_weekend_raytracer_tpu.render import Renderer


@pytest.mark.parametrize("name", ["cornell_box", "emissive", "balls"])
def test_rr_kernel_matches_xla(name):
    """Regenerating wavefront with RR on == per-bounce reference with RR
    on (same stream draws, same kill decisions), brute and BVH scenes."""
    scene = zwrt.models.load_scene(name)
    r = Renderer(
        samples_per_pixel=4, max_ray_bounce_depth=6, seed=0,
        russian_roulette=2,
    )
    fb_kernel = r.render(scene, 16, 16)
    fb_ref = np.asarray(r.render_reference(scene, 16, 16))
    assert np.isfinite(fb_kernel).all()
    np.testing.assert_allclose(fb_kernel, fb_ref, rtol=1e-6, atol=1e-7)


def test_rr_changes_the_sample_set():
    """RR on vs off must actually differ (kills happen) at a depth where
    tails exist — guards against the flag silently not reaching the
    integrator."""
    scene = zwrt.models.load_scene("cornell_box")
    base = Renderer(samples_per_pixel=8, max_ray_bounce_depth=8, seed=0)
    rr = Renderer(
        samples_per_pixel=8, max_ray_bounce_depth=8, seed=0,
        russian_roulette=1,
    )
    fb0 = base.render(scene, 16, 16)
    fb1 = rr.render(scene, 16, 16)
    assert np.isfinite(fb1).all()
    assert np.abs(fb1 - fb0).max() > 1e-4


def test_rr_unbiased_mean():
    """The RR estimator converges to the plain estimator: image means agree
    within MC tolerance at a few hundred samples (an exact-expectation
    test is impossible; a 2% mean band at 256 spp on a 8x8 cornell crop
    catches the classic bugs — missing 1/p, killing before the bounce's
    own radiance, wrong p clamp — which shift the mean 10%+)."""
    scene = zwrt.models.load_scene("cornell_box")
    spp = 256
    base = Renderer(samples_per_pixel=spp, max_ray_bounce_depth=6, seed=0)
    rr = Renderer(
        samples_per_pixel=spp, max_ray_bounce_depth=6, seed=0,
        russian_roulette=2,
    )
    m0 = float(base.render(scene, 8, 8).mean())
    m1 = float(rr.render(scene, 8, 8).mean())
    assert abs(m1 - m0) < 0.02 * m0, (m0, m1)


def test_rr_ignored_on_image_scenes():
    """Image-texture scenes gate RR off: the render is identical to
    rr=0."""
    scene = zwrt.models.load_scene("shrek_quads")
    base = Renderer(samples_per_pixel=2, max_ray_bounce_depth=4, seed=0)
    rr = Renderer(
        samples_per_pixel=2, max_ray_bounce_depth=4, seed=0,
        russian_roulette=2,
    )
    np.testing.assert_array_equal(
        np.asarray(base.render(scene, 12, 12)),
        np.asarray(rr.render(scene, 12, 12)),
    )


@pytest.mark.parametrize("shard", ["samples", "rows"])
def test_rr_sharded_matches_single_device(shard):
    """RR under shard_map: the content-addressed draws keep the render
    identical to the single-device RR render."""
    from zig_weekend_raytracer_tpu.parallel import make_mesh, render_sharded

    scene = zwrt.models.load_scene("cornell_box")
    single = np.asarray(
        Renderer(
            samples_per_pixel=8, max_ray_bounce_depth=4, seed=0,
            russian_roulette=2,
        ).render(scene, 16, 16)
    )
    fb = render_sharded(
        scene, 16, 16, 8, max_depth=4, mesh=make_mesh(4), shard=shard,
        seed=0, rr=2,
    )
    np.testing.assert_allclose(np.asarray(fb), single, rtol=1e-5, atol=1e-6)
