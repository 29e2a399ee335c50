"""Closest-hit tracing over the compiled scene tables (SoA wavefront form).

Two interchangeable strategies (selected by ``CompiledScene.has_bvh``):

  * **Brute force**: every ray tests every primitive, blocked over the
    primitive axis so transients stay bounded.  This replaces
    ``EntityCollection.hit``'s linear scan
    (reference: src/entity.zig:342-368) for scenes of up to a few hundred
    primitives, whose tables stay in cache.
  * **Stackless BVH traversal**: per-ray node pointers walk the preorder
    skip-link layout built in ``geometry.bvh`` inside one
    ``lax.while_loop``; the loop exits when every ray in the wavefront has
    terminated.  This replaces the recursive ``BVHNodeEntity.hit``
    (reference: src/entity.zig:286-303).

Both return a compact ``Hit`` (t, prim kind, prim index); shading attributes
(point, normal, uv, material/texture record) are fetched once for the single
winning primitive in ``ops.shade.shade_attrs`` — the wavefront analog of the
reference's HitRecord (src/hitrecord.zig:6-21).

Ray vectors are ``math.v3.V3`` (separate x/y/z lanes); every primitive is
tested as broadcast scalars against the (N,) ray lanes, never as an (N, P)
matrix, so XLA fuses the scan into one elementwise loop per ray.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dtypes import INF, real
from ..geometry import quad as quad_g
from ..geometry import sphere as sphere_g
from ..math import v3
from ..math.aabb import aabb_hit
from ..math.v3 import V3
from ..scene import PRIM_QUAD, PRIM_SPHERE, CompiledScene

_NO_HIT = jnp.int32(-1)

# Above this many primitives of one kind, the unrolled brute-force loop
# switches to a fori_loop with dynamic scalar slices (identical math, O(1)
# program size).  Scenes beyond ~this size should be using the BVH anyway.
BRUTE_UNROLL_LIMIT = 192


class Hit(NamedTuple):
    t: jnp.ndarray       # (N,) f32, +inf on miss
    kind: jnp.ndarray    # (N,) i32, PRIM_SPHERE / PRIM_QUAD / -1 miss
    idx: jnp.ndarray     # (N,) i32 primitive index within its table


def _sphere_center_at(scene: CompiledScene, idx, time) -> V3:
    """Animated sphere center lerp (reference: src/entity.zig:653-656)."""
    center = scene.sph_center[idx]
    if scene.has_moving:
        center = center + scene.sph_move[idx] * time
    return center


def closest_hit(
    scene: CompiledScene,
    origin: V3,
    direction: V3,
    time: jnp.ndarray,
    t_min,
    t_max,
    active: jnp.ndarray | None = None,
) -> Hit:
    """Closest hit for a ray wavefront.  ``active`` (bool (N,), optional)
    lets terminated paths skip BVH traversal entirely, shortening the
    lockstep while_loop once most of the wavefront is dead."""
    if scene.has_bvh:
        return _closest_hit_bvh(
            scene, origin, direction, time, t_min, t_max, active
        )
    return _closest_hit_brute(scene, origin, direction, time, t_min, t_max)


# ---------------------------------------------------------------------------
# Brute force
# ---------------------------------------------------------------------------

def _closest_hit_brute(scene, origin, direction, time, t_min, t_max) -> Hit:
    """Linear scan over the primitive tables.

    Each primitive becomes *broadcast scalars* against the (N,) ray lanes —
    never an (N, P) matrix.  Small tables unroll in Python; large ones run
    the identical math in a ``fori_loop`` with dynamically sliced scalars.
    """
    n = origin.shape[0]
    best = Hit(
        t=jnp.full((n,), INF, real),
        kind=jnp.full((n,), _NO_HIT),
        idx=jnp.zeros((n,), jnp.int32),
    )
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, real), (n,))

    def sphere_step(best: Hit, i) -> Hit:
        center = scene.sph_center[i]
        if scene.has_moving:
            center = center + scene.sph_move[i] * time
        t, _ = sphere_g.hit_t(
            center, scene.sph_radius[i], origin, direction, t_min_b, best.t
        )
        closer = t < best.t
        i32 = jnp.asarray(i, jnp.int32)
        return Hit(
            t=jnp.where(closer, t, best.t),
            kind=jnp.where(closer, PRIM_SPHERE, best.kind),
            idx=jnp.where(closer, i32, best.idx),
        )

    def quad_step(best: Hit, i) -> Hit:
        t, _, _, _ = quad_g.hit_t(
            scene.quad_start[i], scene.quad_normal[i], scene.quad_w[i],
            scene.quad_u[i], scene.quad_v[i], scene.quad_offset[i],
            origin, direction, t_min_b, best.t,
        )
        closer = t < best.t
        i32 = jnp.asarray(i, jnp.int32)
        return Hit(
            t=jnp.where(closer, t, best.t),
            kind=jnp.where(closer, PRIM_QUAD, best.kind),
            idx=jnp.where(closer, i32, best.idx),
        )

    def scan(count, step, best):
        if count == 0:
            return best
        if count <= BRUTE_UNROLL_LIMIT:
            for i in range(count):
                best = step(best, i)
            return best
        return jax.lax.fori_loop(0, count, lambda i, b: step(b, i), best)

    best = scan(scene.n_spheres, sphere_step, best)
    best = scan(scene.n_quads, quad_step, best)
    return best


# ---------------------------------------------------------------------------
# Stackless BVH traversal
# ---------------------------------------------------------------------------

class _TraverseState(NamedTuple):
    node: jnp.ndarray
    t: jnp.ndarray
    kind: jnp.ndarray
    idx: jnp.ndarray


def _closest_hit_bvh(
    scene, origin, direction, time, t_min, t_max, active=None
) -> Hit:
    n = origin.shape[0]
    n_nodes = scene.bvh_miss.shape[0]
    inv_dir = V3(1.0 / direction.x, 1.0 / direction.y, 1.0 / direction.z)
    t_min_arr = jnp.broadcast_to(jnp.asarray(t_min, real), (n,))

    start_node = jnp.zeros((n,), jnp.int32)
    if active is not None:
        # dead rays start past the end: they never traverse
        start_node = jnp.where(active, start_node, n_nodes)

    init = _TraverseState(
        node=start_node,
        t=jnp.broadcast_to(jnp.asarray(t_max, real), (n,)).astype(real),
        kind=jnp.full((n,), _NO_HIT),
        idx=jnp.zeros((n,), jnp.int32),
    )

    def cond(st: _TraverseState):
        return jnp.any(st.node < n_nodes)

    def body(st: _TraverseState):
        nd = jnp.minimum(st.node, n_nodes - 1)
        active = st.node < n_nodes
        box_ok = active & aabb_hit(
            scene.bvh_min[nd], scene.bvh_max[nd],
            origin, inv_dir, t_min_arr, st.t,
        )
        count = scene.bvh_leaf_count[nd]
        is_leaf = count > 0

        t_best, kind_best, idx_best = st.t, st.kind, st.idx
        test_leaf = box_ok & is_leaf
        leaf_start = scene.bvh_leaf_start[nd]
        for j in range(scene.max_leaf_size):
            slot_ok = test_leaf & (j < count)
            pi = jnp.minimum(leaf_start + j, scene.bvh_prim_kind.shape[0] - 1)
            kind = scene.bvh_prim_kind[pi]
            idx = scene.bvh_prim_idx[pi]

            # both kinds are evaluated masked; clamp the index into each
            # table explicitly (an idx of one kind is OOB for the other)
            si = jnp.minimum(idx, scene.sph_radius.shape[0] - 1)
            qi = jnp.minimum(idx, scene.quad_offset.shape[0] - 1)
            center = _sphere_center_at(scene, si, time)
            ts, _ = sphere_g.hit_t(
                center, scene.sph_radius[si], origin, direction,
                t_min_arr, t_best,
            )
            tq, _, _, _ = quad_g.hit_t(
                scene.quad_start[qi], scene.quad_normal[qi],
                scene.quad_w[qi], scene.quad_u[qi], scene.quad_v[qi],
                scene.quad_offset[qi], origin, direction,
                t_min_arr, t_best,
            )
            t_hit = jnp.where(kind == PRIM_SPHERE, ts, tq)
            closer = slot_ok & (t_hit < t_best)
            t_best = jnp.where(closer, t_hit, t_best)
            kind_best = jnp.where(closer, kind, kind_best)
            idx_best = jnp.where(closer, idx, idx_best)

        next_node = jnp.where(box_ok & ~is_leaf, nd + 1, scene.bvh_miss[nd])
        next_node = jnp.where(active, next_node, st.node)
        return _TraverseState(
            node=next_node, t=t_best, kind=kind_best, idx=idx_best
        )

    final = jax.lax.while_loop(cond, body, init)
    missed = final.kind == _NO_HIT
    return Hit(
        t=jnp.where(missed, INF, final.t), kind=final.kind, idx=final.idx
    )
