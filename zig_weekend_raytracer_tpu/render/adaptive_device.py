"""Device-side adaptive-sampling plan construction.

Building the plan on the host costs two pilot-half device-to-host copies,
numpy variance/allocation, a numpy lane-plan build over every pixel, and
the plan's copy back.  This module is the jnp twin of render/adaptive.py's
variance_weights / allocate_extra / build_adaptive_plan, jitted end to
end so the pilot framebuffers never leave the device and the plan arrays
are born there.  The host fallback remains in adaptive.py (and stays the
reference implementation for the equivalence tests).

Semantics:
  * variance weights: same luminance half-difference + 3x3 box smooth
    (f32 on device vs the host's f64 — allocation may differ in ties;
    both are valid equal-budget plans).
  * allocation: exact-conservation largest-remainder apportionment under
    a per-pixel cap, 4 redistribution passes (the host loop runs to
    convergence; 4 passes suffice unless the cap binds almost everywhere,
    in which case the remainder stays unallocated exactly like the host's
    pass-limit behavior).
  * plan build: identical lane decomposition to adaptive.build_adaptive_plan
    — same tile-order base, same ceil(n/lane_cap) split, same per-lane
    sample ranges, same descending-length sort — verified lane-for-lane
    in tests/test_adaptive_device.py.

Static shapes: the lane budget M is a shape-only bound
(ceil(1.5 * pixels) rounded to a power of two >= blk): sum over pixels of
ceil(n/lane_cap) <= live_pixels + total_extra/lane_cap <= pixels * 1.5
because lane_cap >= 2 * mean-extra by construction (adaptive.py).  One
compiled program serves every seed/noise map.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..dtypes import LUM_B, LUM_G, LUM_R
from .adaptive import _RESERVE, _SMOOTH, _WEIGHT_FLOOR


def variance_weights_dev(half_a, half_b):
    """jnp twin of adaptive.variance_weights: per-pixel noise proxy from
    the two half-pilot means, (rows, W, 3) -> (rows, W) f32."""
    d = jnp.abs(half_a - half_b)
    lum = (
        jnp.float32(LUM_R) * d[..., 0]
        + jnp.float32(LUM_G) * d[..., 1]
        + jnp.float32(LUM_B) * d[..., 2]
    )
    k = 2 * _SMOOTH + 1
    p = jnp.pad(lum, _SMOOTH, mode="edge")
    rows, width = lum.shape
    sm = jnp.zeros_like(lum)
    for i in range(k):
        for j in range(k):
            sm = sm + jax.lax.dynamic_slice(p, (i, j), (rows, width))
    return sm / jnp.float32(k * k)


def allocate_extra_dev(weight, extra_total, cap):
    """jnp twin of adaptive.allocate_extra: apportion ``extra_total``
    samples proportionally to ``weight`` (any shape), per-pixel cap,
    exact conservation via floor + largest-remainder singles, 4 cap-
    redistribution passes.  Returns int32 of weight's shape.

    ``cap`` may be a scalar or a per-pixel array of weight's (flattened)
    shape — the sharded path (parallel/render.py:render_adaptive_sharded)
    uses cap=0 to exclude a device's padded rows from allocation (their
    room is always 0, so neither the floor shares nor the largest-
    remainder singles can reach them)."""
    shape = weight.shape
    w = weight.reshape(-1).astype(jnp.float32)
    w = w + jnp.maximum(w.mean(), jnp.float32(1e-30)) * jnp.float32(
        _WEIGHT_FLOOR
    )
    size = w.shape[0]
    cap = jnp.asarray(cap, jnp.int32).reshape(-1)

    def body(_, carry):
        n, remaining = carry
        room = cap - n
        open_w = jnp.where(room > 0, w, 0.0)
        tot = open_w.sum()
        share = jnp.where(
            tot > 0,
            remaining.astype(jnp.float32) * open_w / jnp.maximum(tot, 1e-30),
            0.0,
        )
        add = jnp.minimum(jnp.floor(share).astype(jnp.int32), room)
        n = n + add
        remaining = remaining - add.sum()
        # largest-remainder singles among pixels with room left
        room2 = cap - n
        frac = jnp.where(room2 > 0, share - jnp.floor(share), -1.0)
        order = jnp.argsort(-frac, stable=True)
        rank = jnp.zeros((size,), jnp.int32).at[order].set(
            jnp.arange(size, dtype=jnp.int32)
        )
        give = ((rank < remaining) & (room2 > 0)).astype(jnp.int32)
        n = n + give
        remaining = remaining - give.sum()
        return n, remaining

    n = jnp.zeros((size,), jnp.int32)
    n, _ = jax.lax.fori_loop(
        0, 4, body, (n, jnp.asarray(extra_total, jnp.int32))
    )
    return n.reshape(shape)


def plan_lane_budget(pixels: int, blk: int) -> int:
    """Static lane-array length M: worst-case ceil-split lane count
    (<= 1.5x pixels, see module docstring) rounded up to a power of two
    that is also a ``blk`` multiple."""
    m = max(blk, -(-3 * pixels // 2))
    m = 1 << int(m - 1).bit_length()
    return max(m, blk)


@functools.partial(
    jax.jit,
    static_argnames=(
        "pilot", "lane_cap", "sort_lanes", "m_lanes", "width",
    ),
)
def build_adaptive_plan_dev(
    n_extra,            # (rows, W) int32 extra samples per pixel (device)
    order,              # (rows*W,) int32 tile-order pixel permutation
    *,
    band_y0,            # int or traced i32 (sharded: axis_index-derived)
    pilot: int,
    lane_cap: int,
    sort_lanes: bool,
    m_lanes: int,
    width: int,
):
    """Device twin of adaptive.build_adaptive_plan: same decomposition,
    static (m_lanes,) output shapes.  ``order`` is the tile-order pixel
    permutation (host-precomputed per shape; pure indices, content-free).
    ``band_y0`` may be a traced scalar: the sharded path derives it from
    ``axis_index`` inside shard_map (it only ever offsets ``py``).
    Returns (px, py, s0, s1) int32 device arrays; dead lanes s1==s0==0."""
    rows = n_extra.shape[0]
    band_y0 = jnp.asarray(band_y0, jnp.int32)
    n = n_extra.reshape(-1).astype(jnp.int32)[order]
    ys = (order // width).astype(jnp.int32) + band_y0
    xs = (order % width).astype(jnp.int32)

    k = -(-n // jnp.int32(lane_cap))  # ceil; 0 lanes for n == 0
    csum = jnp.cumsum(k)
    starts = csum - k
    total = csum[-1]

    lane = jnp.arange(m_lanes, dtype=jnp.int32)
    pix = jnp.searchsorted(csum, lane, side="right").astype(jnp.int32)
    live = lane < total
    pixc = jnp.minimum(pix, jnp.int32(rows * width - 1))

    j = lane - starts[pixc]
    nn = n[pixc]
    kk = jnp.maximum(k[pixc], 1)
    s0 = jnp.int32(pilot) + (j * nn) // kk
    s1 = jnp.int32(pilot) + ((j + 1) * nn) // kk

    px = jnp.where(live, xs[pixc], 0)
    py = jnp.where(live, ys[pixc], band_y0)
    s0 = jnp.where(live, s0, 0)
    s1 = jnp.where(live, s1, 0)

    if sort_lanes:
        by_len = jnp.argsort(-(s1 - s0), stable=True)
        px, py, s0, s1 = px[by_len], py[by_len], s0[by_len], s1[by_len]
    return px, py, s0, s1


def reserve_base(spp: int, pilot: int) -> int:
    """The unconditional per-pixel share of the post-pilot budget (host
    helper shared with the device path)."""
    return int((spp - pilot) * _RESERVE)
