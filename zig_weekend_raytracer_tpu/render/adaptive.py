"""Variance-guided adaptive sampling (beyond-reference capability).

The reference renders a fixed ``samples_per_pixel`` for every pixel
(src/render.zig:55-73 hands each thread equal pixel blocks).  This module
keeps the same TOTAL sample budget but re-allocates it per pixel by
measured variance: a cheap pilot pass (whose samples count toward the
image) is rendered as two halves, the per-pixel half-difference estimates
the Monte-Carlo noise level, and the remaining budget is apportioned
proportionally (optimal-allocation rule: samples ~ per-pixel sigma).  The
result is an unbiased per-pixel mean — each pixel averages its OWN sample
count — that concentrates work on caustics/penumbrae instead of flat
walls.

Device mapping: the allocation plan runs through the SAME balanced-plan
regenerating band the profile-guided balancer uses
(renderer._render_band_balanced -> integrator.trace_paths_regen): lanes
carry explicit (pixel, sample-range) work items in tile order, so the
wavefront stays dense regardless of how skewed the allocation is.  The
plan is built on device (render/adaptive_device.py); all rendering stays
on device.

Sampler support: Sobol (any prefix/extension of the per-pixel sequence is
well distributed — the (0,2)-sequence property) and independent.  The
stratified sampler's grid geometry is fixed by ``spp`` at compile time, so
per-pixel counts would leave its strata: it is rejected with a ValueError.

RNG safety: ray ids are sample-major ((sample*H + py)*W + px,
integrator._respawn), so per-pixel sample indices beyond
the nominal spp cannot collide with another pixel's stream; the u32 bound
is re-checked against the adaptive maximum below.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import jax.numpy as jnp

from ..dtypes import LUM_B, LUM_G, LUM_R

log = logging.getLogger(__name__)

# Smoothing kernel half-width for the variance proxy: the half-difference
# of a single pixel is chi-distributed (a lucky agreement reads as zero
# noise), so a 3x3 box average borrows strength from neighbours before
# allocation.
_SMOOTH = 1
# Fraction of the mean weight added to every pixel: keeps true-black and
# lucky-zero pixels from starving entirely (they still converge).
_WEIGHT_FLOOR = 0.05
# Fraction of the post-pilot budget every pixel keeps unconditionally;
# only the remainder moves with the noise map.  Guards the estimator
# against proxy misses on heavy-tailed pixels (a glass-caustic firefly
# landing in a starved pixel costs more MSE than the reallocation saves —
# measured on cornell 16x16@32: reserve 0 regressed 1 seed in 4 by 1.8x).
_RESERVE = 0.5


def variance_weights(half_a: np.ndarray, half_b: np.ndarray) -> np.ndarray:
    """Per-pixel noise proxy from two half-pilot MEANS, (rows, W, 3) each.

    |mean_A - mean_B| has expectation proportional to the pixel's Monte-
    Carlo sigma at the pilot sample count; luminance-weighted and 3x3
    box-smoothed.  Returns (rows, W) float64 >= 0."""
    d = np.abs(half_a.astype(np.float64) - half_b.astype(np.float64))
    lum = (
        float(LUM_R) * d[..., 0] + float(LUM_G) * d[..., 1]
        + float(LUM_B) * d[..., 2]
    )
    p = np.pad(lum, _SMOOTH, mode="edge")
    rows, width = lum.shape
    k = 2 * _SMOOTH + 1
    sm = np.zeros_like(lum)
    for i in range(k):
        for j in range(k):
            sm += p[i : i + rows, j : j + width]
    return sm / (k * k)


def allocate_extra(
    weight: np.ndarray, extra_total: int, cap: int
) -> np.ndarray:
    """Apportion ``extra_total`` samples over pixels proportionally to
    ``weight`` (rows, W), each pixel capped at ``cap``.  Largest-remainder
    rounding conserves the total exactly (unless the cap binds everywhere);
    returns (rows, W) int64 >= 0."""
    w = weight.reshape(-1).astype(np.float64)
    w = w + max(float(w.mean()), 1e-300) * _WEIGHT_FLOOR
    n = np.zeros(w.size, np.int64)
    remaining = int(extra_total)
    # redistribute mass clipped by the cap (terminates: each pass either
    # exhausts the budget or saturates at least one pixel)
    for _ in range(32):
        room = cap - n
        open_w = np.where(room > 0, w, 0.0)
        tot = open_w.sum()
        if remaining <= 0 or tot <= 0.0:
            break
        share = remaining * open_w / tot
        add = np.minimum(np.floor(share).astype(np.int64), room)
        if add.sum() == 0:
            # tail: hand out singles by largest remainder
            frac = np.where(room > 0, share, -1.0)
            order = np.argsort(-frac, kind="stable")[:remaining]
            take = order[room[order] > 0]
            n[take] += 1
            remaining -= take.size
            break
        n += add
        remaining -= int(add.sum())
    return n.reshape(weight.shape)


def build_adaptive_plan(
    n_extra: np.ndarray,   # (rows, W) int extra samples per pixel
    band_y0: int,
    pilot: int,
    tile,
    lane_cap: int,
    sort_lanes: bool = False,
    blk: int = 1024,       # lane padding (renderer.LANE_BLOCK)
):
    """Lane plan for the extra pass: pixel (y, x) renders samples
    [pilot, pilot + n_extra) split across ceil(n/lane_cap) lanes of
    <= lane_cap samples each.  Pixels with n == 0 get no lane.  Returns
    (px, py, s0, s1) i32 arrays padded to a BLK multiple (pad lanes are
    dead: s1 == s0 == 0), matching renderer._render_band_balanced's
    contract.

    Lane order: with ``sort_lanes`` the lanes are ordered by DESCENDING
    sample count (stable over tile order) — adaptive lanes carry wildly
    unequal ranges (1..lane_cap), so similar-length lanes are grouped, the
    same cure as the cost-sorted uniform driver.  BVH scenes keep tile
    order (pure spatial), gated by the caller exactly like render_device
    gates the cost sorter.

    The padded length is quantized to the next power of two (min ``blk``):
    the raw lane count varies with the noise map, i.e. with scene, seed
    and band content, and every distinct length is a distinct XLA shape,
    so unquantized every new seed would recompile the balanced band.  Pad
    lanes are dead from the start."""
    from .renderer import tile_order_lane_index

    rows, width = n_extra.shape
    lane_idx = tile_order_lane_index(width, rows, tile).reshape(-1)
    order = np.argsort(lane_idx, kind="stable")

    n = n_extra.reshape(-1).astype(np.int64)[order]
    ys = (np.repeat(np.arange(rows), width) + band_y0)[order]
    xs = np.tile(np.arange(width), rows)[order]

    live = n > 0
    n, ys, xs = n[live], ys[live], xs[live]
    k = -(-n // lane_cap)  # lanes per pixel
    total = int(k.sum())

    px = np.repeat(xs, k)
    py = np.repeat(ys, k)
    starts = np.cumsum(k) - k
    j = np.arange(total) - np.repeat(starts, k)
    nn = np.repeat(n, k)
    kk = np.repeat(k, k)
    s0 = pilot + (j * nn) // kk
    s1 = pilot + ((j + 1) * nn) // kk

    if sort_lanes and total:
        by_len = np.argsort(-(s1 - s0), kind="stable")
        px, py, s0, s1 = px[by_len], py[by_len], s0[by_len], s1[by_len]

    n_pad = max(blk, -(-max(total, 1) // blk) * blk)
    n_pad = 1 << int(n_pad - 1).bit_length()  # stable XLA shapes
    pad = n_pad - total
    if pad:
        px = np.concatenate([px, np.zeros(pad, np.int64)])
        py = np.concatenate([py, np.full(pad, band_y0, np.int64)])
        s0 = np.concatenate([s0, np.zeros(pad, np.int64)])
        s1 = np.concatenate([s1, np.zeros(pad, np.int64)])
    return (
        px.astype(np.int32), py.astype(np.int32),
        s0.astype(np.int32), s1.astype(np.int32),
    )


import functools

import jax


@functools.partial(
    jax.jit,
    static_argnames=(
        "half", "base", "extra_total", "cap", "band_y0", "pilot",
        "lane_cap", "sort_lanes", "m_lanes", "width", "rows_eff",
    ),
)
def _plan_pipeline(
    sum_a, sum_b, order, *,
    half, base, extra_total, cap, band_y0, pilot, lane_cap,
    sort_lanes, m_lanes, width, rows_eff,
):
    """Variance -> allocation -> lane plan as ONE device program (static
    shapes; see render/adaptive_device.py).  Returns
    (n_extra (rows_eff, W) i32, px, py, s0, s1 (m_lanes,) i32)."""
    from .adaptive_device import (
        allocate_extra_dev, build_adaptive_plan_dev, variance_weights_dev,
    )

    inv = jnp.float32(1.0 / half)
    weight = variance_weights_dev(
        sum_a[:rows_eff] * inv, sum_b[:rows_eff] * inv
    )
    n_extra = jnp.int32(base) + allocate_extra_dev(
        weight, extra_total, cap - base
    )
    band_rows = sum_a.shape[0]
    n_full = jnp.zeros((band_rows, width), jnp.int32).at[:rows_eff].set(
        n_extra
    )
    px, py, s0, s1 = build_adaptive_plan_dev(
        n_full, order, band_y0=band_y0, pilot=pilot, lane_cap=lane_cap,
        sort_lanes=sort_lanes, m_lanes=m_lanes, width=width,
    )
    return n_extra, px, py, s0, s1


def pick_pilot(spp: int) -> int:
    """Default pilot: the largest power of two <= max(4, spp/8), clamped
    to spp/2 — big enough for a usable noise map, small enough to leave
    most of the budget for the adaptive pass."""
    target = max(4, spp // 8)
    pilot = 1 << (int(target).bit_length() - 1)
    return max(2, min(pilot, spp // 2))


def render_adaptive(
    renderer,
    scene,
    width: int,
    height: int,
    *,
    pilot_spp: int = 0,
    return_stats: bool = False,
):
    """Adaptive render at the renderer's ``samples_per_pixel`` BUDGET:
    the image's total sample count equals the uniform render's, but pixels
    receive budget proportional to their measured noise.  Returns the
    averaged (H, W, 3) f32 framebuffer on device (plus a stats dict with
    the per-pixel sample-count map when ``return_stats``)."""
    from ..sampling.sampler import SamplerKind
    from ..dtypes import real
    from .camera import camera_consts
    from .renderer import (
        LANE_BLOCK, _render_band_balanced, _render_band_regen, pick_tile,
    )

    spp = renderer.samples_per_pixel
    if renderer.sampler == SamplerKind.STRATIFIED:
        raise ValueError(
            "adaptive sampling needs per-pixel sample counts; the "
            "stratified sampler's grid is fixed by spp — use sobol or "
            "independent"
        )
    pilot = pilot_spp or pick_pilot(spp)
    pilot = max(2, min(pilot, spp))
    pilot += pilot & 1  # two equal halves
    if pilot >= spp:
        fb = renderer.render_device(scene, width, height)
        if return_stats:
            return fb, {"n_samples": np.full((height, width), spp, np.int64)}
        return fb

    # per-pixel cap keeps the u32 sample-major ray-id space valid and
    # bounds pathological concentration at 64x the mean extra budget
    cap = min(64 * (spp - pilot), (2**32) // (width * height) - pilot - 1)
    if cap < 1:
        raise ValueError(
            f"ray id space {width}x{height}x{spp} leaves no adaptive "
            "headroom; reduce spp or the image size"
        )
    lane_cap = max(8, 2 * (spp - pilot))

    band_rows = max(1, min(height, renderer.max_rays_per_chunk // width))
    n_bands = -(-height // band_rows)
    cam_c = camera_consts(scene.camera, width, height)
    seed = jnp.uint32(renderer.seed)
    sc = scene.compiled
    half = pilot // 2

    # Device-side plan pipeline: the pilot framebuffers never leave the
    # device — variance, allocation and the lane plan are ONE jitted
    # program with static shapes, and only the final image transfers.
    # ZWRT_ADAPTIVE_HOST=1 keeps the reference host path (numpy f64
    # allocation; equal budget, possibly different tie-breaks).
    use_host = bool(os.environ.get("ZWRT_ADAPTIVE_HOST"))
    sort_lanes = not sc.has_bvh
    base = int((spp - pilot) * _RESERVE)
    tile = pick_tile(width, band_rows)

    fb_bands = []
    counts = np.zeros((height, width), np.int64) if return_stats else None
    for b in range(n_bands):
        y0 = b * band_rows
        rows = min(band_rows, height - y0)
        kw = dict(
            width=width, height=height, band_rows=band_rows,
            s_par=1, spp=spp, max_depth=renderer.max_ray_bounce_depth,
            sampler=renderer.sampler, has_dof=scene.camera.has_depth_of_field,
            cam_consts=cam_c, rr=renderer.russian_roulette,
            clamp=renderer.clamp_indirect,
        )
        sum_a = _render_band_regen(
            sc, seed, jnp.int32(y0), jnp.int32(0),
            sample_limit=half, **kw,
        )
        sum_b = _render_band_regen(
            sc, seed, jnp.int32(y0), jnp.int32(half),
            sample_limit=pilot, **kw,
        )

        if use_host:
            sa = np.asarray(sum_a)[:rows]
            sb = np.asarray(sum_b)[:rows]
            weight = variance_weights(sa / half, sb / half)
            n_extra = base + allocate_extra(
                weight, (spp - pilot - base) * rows * width, cap - base
            )
            if band_rows != rows:  # pad rows get nothing
                n_full = np.zeros((band_rows, width), np.int64)
                n_full[:rows] = n_extra
            else:
                n_full = n_extra
            px, py, s0, s1 = build_adaptive_plan(
                n_full, y0, pilot, tile, lane_cap,
                sort_lanes=sort_lanes, blk=LANE_BLOCK,
            )
            px, py, s0, s1 = (
                jnp.asarray(a) for a in (px, py, s0, s1)
            )
            n_extra_dev = jnp.asarray(n_extra.astype(np.int32))
        else:
            from .adaptive_device import (
                build_adaptive_plan_dev, plan_lane_budget,
                variance_weights_dev, allocate_extra_dev,
            )
            from .renderer import tile_order_lane_index

            order = np.argsort(
                tile_order_lane_index(width, band_rows, tile).reshape(-1),
                kind="stable",
            ).astype(np.int32)  # shape-only constant, cheap to rebuild
            m_lanes = plan_lane_budget(band_rows * width, LANE_BLOCK)
            n_extra_dev, px, py, s0, s1 = _plan_pipeline(
                sum_a, sum_b, jnp.asarray(order),
                half=half, base=base,
                extra_total=(spp - pilot - base) * rows * width,
                cap=cap, band_y0=y0, pilot=pilot, lane_cap=lane_cap,
                sort_lanes=sort_lanes, m_lanes=m_lanes, width=width,
                rows_eff=rows,
            )

        extra = _render_band_balanced(
            sc, seed, jnp.int32(y0), px, py, s0, s1,
            width=width, height=height, band_rows=band_rows, spp=spp,
            max_depth=renderer.max_ray_bounce_depth,
            sampler=renderer.sampler,
            has_dof=scene.camera.has_depth_of_field,
            cam_consts=cam_c, rr=renderer.russian_roulette,
            clamp=renderer.clamp_indirect,
        )
        n_pix_dev = jnp.int32(pilot) + n_extra_dev
        band_fb = (
            (sum_a + sum_b + extra)[:rows]
            / n_pix_dev[..., None].astype(real)
        )
        fb_bands.append(band_fb)
        if return_stats:
            counts[y0 : y0 + rows] = np.asarray(n_pix_dev)

    fb_dev = (
        fb_bands[0] if len(fb_bands) == 1
        else jnp.concatenate(fb_bands, axis=0)
    )
    if return_stats:
        return fb_dev, {"n_samples": counts, "pilot": pilot}
    return fb_dev
