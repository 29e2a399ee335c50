"""Per-lane plans on the regenerating path: the profile-guided balanced
driver and its plan, and the work counter that feeds it.  The
content-addressed RNG makes the image invariant to how samples are
assigned to lanes."""

import jax.numpy as jnp
import numpy as np

import zig_weekend_raytracer_tpu as zwrt
from zig_weekend_raytracer_tpu.render import Renderer


def test_balanced_render_matches_plain():
    """The profile-guided balanced driver (estimation pass + split lane
    plan) produces the same image as the plain regenerating render."""
    scene = zwrt.models.load_scene("cornell_box")
    r_bal = Renderer(
        samples_per_pixel=32, max_ray_bounce_depth=4, balance_min_spp=32
    )
    fb_bal = r_bal.render(scene, 24, 24)

    r_plain = Renderer(samples_per_pixel=32, max_ray_bounce_depth=4)
    fb_plain = r_plain.render(scene, 24, 24)

    assert np.isfinite(fb_bal).all()
    np.testing.assert_allclose(fb_bal, fb_plain, rtol=2e-5, atol=2e-6)


def test_balanced_render_matches_plain_image_scene():
    """Same invariance on an IMAGE scene (atlas lookups on split lanes)."""
    scene = zwrt.models.load_scene("shrek_quads")
    r_bal = Renderer(
        samples_per_pixel=32, max_ray_bounce_depth=4, balance_min_spp=32
    )
    fb_bal = r_bal.render(scene, 24, 24)

    r_plain = Renderer(samples_per_pixel=32, max_ray_bounce_depth=4)
    fb_plain = r_plain.render(scene, 24, 24)

    assert np.isfinite(fb_bal).all()
    np.testing.assert_allclose(fb_bal, fb_plain, rtol=2e-5, atol=2e-6)


def test_balance_plan_covers_each_sample_once():
    """Every (pixel, sample) pair in [spp_est, spp) is owned by exactly one
    lane of the plan; surplus lanes are dead."""
    from zig_weekend_raytracer_tpu.render.renderer import build_balance_plan

    rng = np.random.default_rng(0)
    rows, width, spp_est, spp = 8, 16, 4, 64
    work = rng.integers(1, 50, (rows, width))
    budget = 256
    px, py, s0, s1 = build_balance_plan(work, 2, spp_est, spp, budget, None)
    assert len(px) == budget
    counts = np.zeros((rows, width, spp), np.int32)
    for x, y, a, b in zip(px, py, s0, s1):
        if b > a:
            counts[y - 2, x, a:b] += 1
    assert (counts[:, :, spp_est:] == 1).all()
    assert (counts[:, :, :spp_est] == 0).all()


def test_fused_work_counter():
    """want_work returns per-lane bounce counts consistent with the
    sample budget (>= one bounce per sample, <= max_depth per sample);
    padding lanes do no work."""
    from zig_weekend_raytracer_tpu.render.camera import camera_consts
    from zig_weekend_raytracer_tpu.render.integrator import trace_paths_regen
    from zig_weekend_raytracer_tpu.render.renderer import LANE_BLOCK
    from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind

    scene = zwrt.models.load_scene("cornell_box")
    W = H = 8
    spp, depth = 4, 5
    cam_c = camera_consts(scene.camera, W, H)
    n = -(-W * H // LANE_BLOCK) * LANE_BLOCK
    ys, xs = np.divmod(np.arange(n) % (W * H), W)
    px = jnp.asarray(xs.astype(np.int32))
    py = jnp.asarray(ys.astype(np.int32))
    s0 = jnp.zeros((n,), jnp.int32)
    limit = jnp.where(jnp.arange(n) < W * H, spp, 0).astype(jnp.int32)
    rad, work = trace_paths_regen(
        scene.compiled, cam_c, jnp.uint32(0), px, py, s0, limit,
        sampler=SamplerKind.SOBOL, width=W, height=H, spp=spp, stride=1,
        max_depth=depth, has_dof=False, want_work=True,
    )
    w = np.asarray(work)
    assert (w[: W * H] >= spp).all()
    assert (w[: W * H] <= spp * depth).all()
    assert (w[W * H :] == 0).all()
