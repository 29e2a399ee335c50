"""Batched ray/parallelogram intersection and light-sampling PDFs (SoA form).

Parity targets in the reference (src/entity.zig:428-531):
  * plane intersect + interior test in the plane basis  :477-501
  * area-based PDF                                      :503-518
  * uniform surface-point sampling                      :520-525
"""

from __future__ import annotations

import jax.numpy as jnp

from ..dtypes import INF, QUAD_PARALLEL_EPS
from ..math import v3
from ..math.v3 import V3


def hit_t(
    start: V3,
    normal: V3,   # unit plane normal
    w: V3,        # basis w = n_raw / |n_raw|^2
    edge_u: V3,
    edge_v: V3,
    offset,       # plane offset = n_unit . start
    origin: V3,
    direction: V3,
    t_min,
    t_max,
):
    """Returns (t, alpha, beta, valid); t is +inf where invalid.  Inclusive
    interval test (``contains``), matching src/entity.zig:485."""
    denom = v3.dot(normal, direction)
    not_parallel = jnp.abs(denom) >= QUAD_PARALLEL_EPS
    t = (offset - v3.dot(normal, origin)) / jnp.where(not_parallel, denom, 1.0)
    in_range = (t >= t_min) & (t <= t_max)
    planar = origin + direction * t - start
    # triple-product rotation of the reference's alpha = w.(p x v),
    # beta = w.(u x p) (src/entity.zig:493-494): p.(v x w) / p.(w x u).
    # The rotated cross products are per-QUAD constants, so XLA hoists
    # them out of the per-ray math — the interior test drops from two in-loop
    # cross products to two dot products.
    alpha = v3.dot(planar, v3.cross(edge_v, w))
    beta = v3.dot(planar, v3.cross(w, edge_u))
    interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
    valid = not_parallel & in_range & interior
    return jnp.where(valid, t, INF), alpha, beta, valid


def pdf_value(
    start: V3, normal: V3, w: V3, edge_u: V3, edge_v: V3, offset, area,
    origin: V3, direction: V3, t_min,
):
    """dist^2 / (cos * area), 0 on miss (src/entity.zig:503-518)."""
    t, _, _, valid = hit_t(
        start, normal, w, edge_u, edge_v, offset,
        origin, direction, t_min, INF,
    )
    dir_len_sq = v3.dot(direction, direction)
    dist_sq = t * t * dir_len_sq
    cos = jnp.abs(v3.dot(direction, normal)) / jnp.sqrt(dir_len_sq)
    val = dist_sq / jnp.maximum(cos * area, 1e-20)
    return jnp.where(valid, val, 0.0)


def sample_direction(start: V3, edge_u: V3, edge_v: V3, origin: V3, u1, u2) -> V3:
    """Uniform point on the parallelogram minus origin
    (src/entity.zig:520-525)."""
    return start + edge_u * u1 + edge_v * u2 - origin
