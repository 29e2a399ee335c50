"""BVH: host-side median-split build, flattened to stackless skip-link arrays.

Build algorithm parity with the reference (src/entity.zig:208-304):
  * union AABB of the span, pick the longest axis       :240-244
  * sort prims by AABB min-coordinate on that axis      :212-216, :246
  * split at the median, recurse                        :247-253
  * leaves hold 1..max_leaf_size primitives (the reference stops at spans of
    1-2, :231-236; we allow slightly fatter leaves — better for the batched
    traversal since leaf prims are tested with a static unrolled loop)

The pointer tree the reference walks recursively (:286-303) is linearized in
DFS preorder with *miss links* ("escape indices"): on AABB hit an internal
node falls through to index i+1; on miss (or after a leaf) control jumps to
``bvh_miss[i]``.  That turns traversal into a ``lax.while_loop`` over a
per-ray node pointer — no stack, no recursion.

AABBs are padded against degenerate axes exactly like the reference
(src/math/aabb.zig:103-122) and motion-blurred spheres get the union of their
start/end boxes (src/entity.zig:578-581).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..math.aabb import aabb_pad_to_minimum

PRIM_SPHERE = 0
PRIM_QUAD = 1

_F = np.float32
_I = np.int32


def degenerate_bvh() -> dict:
    """Placeholder arrays keeping the CompiledScene pytree structure stable
    when no BVH is built."""
    return {
        "bvh_min": np.zeros((1, 3), _F),
        "bvh_max": np.zeros((1, 3), _F),
        "bvh_miss": np.ones((1,), _I),
        "bvh_leaf_start": np.zeros((1,), _I),
        "bvh_leaf_count": np.zeros((1,), _I),
        "bvh_prim_kind": np.zeros((1,), _I),
        "bvh_prim_idx": np.zeros((1,), _I),
        "max_leaf_size": 4,
    }


def _prim_bboxes(sph_center, sph_radius, sph_move, quad_start, quad_u, quad_v):
    kinds: List[int] = []
    idxs: List[int] = []
    bmins: List[np.ndarray] = []
    bmaxs: List[np.ndarray] = []

    for i in range(sph_center.shape[0]):
        c = sph_center[i].astype(np.float64)
        r = float(sph_radius[i])
        mv = sph_move[i].astype(np.float64)
        bmin = np.minimum(c - r, c + mv - r)
        bmax = np.maximum(c + r, c + mv + r)
        bmin, bmax = aabb_pad_to_minimum(bmin, bmax)
        kinds.append(PRIM_SPHERE)
        idxs.append(i)
        bmins.append(bmin)
        bmaxs.append(bmax)

    for i in range(quad_start.shape[0]):
        s = quad_start[i].astype(np.float64)
        corners = np.stack(
            [s, s + quad_u[i], s + quad_v[i], s + quad_u[i] + quad_v[i]]
        )
        bmin, bmax = aabb_pad_to_minimum(corners.min(0), corners.max(0))
        kinds.append(PRIM_QUAD)
        idxs.append(i)
        bmins.append(bmin)
        bmaxs.append(bmax)

    return (
        np.array(kinds, _I),
        np.array(idxs, _I),
        np.stack(bmins),
        np.stack(bmaxs),
    )


class _Tree:
    __slots__ = ("bmin", "bmax", "left", "right", "prims", "size")

    def __init__(self, bmin, bmax, left=None, right=None, prims=None):
        self.bmin = bmin
        self.bmax = bmax
        self.left = left
        self.right = right
        self.prims = prims  # list of prim-order indices for leaves
        self.size = 1 + (left.size if left else 0) + (right.size if right else 0)


def build_bvh(
    sph_center, sph_radius, sph_move, quad_start, quad_u, quad_v,
    max_leaf_size: int = 4,
) -> dict:
    kinds, idxs, bmins, bmaxs = _prim_bboxes(
        sph_center, sph_radius, sph_move, quad_start, quad_u, quad_v
    )
    order = np.arange(kinds.shape[0])

    def build(span: np.ndarray) -> _Tree:
        bmin = bmins[span].min(0)
        bmax = bmaxs[span].max(0)
        if span.shape[0] <= max_leaf_size:
            return _Tree(bmin, bmax, prims=list(span))
        axis = int(np.argmax(bmax - bmin))
        key = bmins[span, axis]
        span = span[np.argsort(key, kind="stable")]
        mid = span.shape[0] // 2
        return _Tree(bmin, bmax, left=build(span[:mid]), right=build(span[mid:]))

    root = build(order)

    n_nodes = root.size
    bvh_min = np.zeros((n_nodes, 3), _F)
    bvh_max = np.zeros((n_nodes, 3), _F)
    bvh_miss = np.zeros((n_nodes,), _I)
    leaf_start = np.zeros((n_nodes,), _I)
    leaf_count = np.zeros((n_nodes,), _I)
    prim_kind: List[int] = []
    prim_idx: List[int] = []

    cursor = [0]

    def emit(node: _Tree, miss: int) -> None:
        i = cursor[0]
        cursor[0] += 1
        bvh_min[i] = node.bmin
        bvh_max[i] = node.bmax
        bvh_miss[i] = miss
        if node.prims is not None:
            leaf_start[i] = len(prim_kind)
            leaf_count[i] = len(node.prims)
            for p in node.prims:
                prim_kind.append(int(kinds[p]))
                prim_idx.append(int(idxs[p]))
        else:
            right_index = i + 1 + node.left.size
            emit(node.left, miss=right_index)
            emit(node.right, miss=miss)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n_nodes + 64))
    try:
        emit(root, miss=n_nodes)
    finally:
        sys.setrecursionlimit(old_limit)

    return {
        "bvh_min": bvh_min,
        "bvh_max": bvh_max,
        "bvh_miss": bvh_miss,
        "bvh_leaf_start": leaf_start,
        "bvh_leaf_count": leaf_count,
        "bvh_prim_kind": np.array(prim_kind, _I),
        "bvh_prim_idx": np.array(prim_idx, _I),
        "max_leaf_size": max_leaf_size,
    }
