"""Shading-attribute fetch: everything the integrator needs about a hit.

The reference reads hit attributes through pointers (HitRecord.material ->
IMaterial -> ITexture, src/hitrecord.zig:11).  The wavefront analog is a
gather per field, so scene compilation *denormalizes* the material + texture of every
primitive into a flat per-prim record (``scene.shade_rows``): geometry
columns (center/radius/uv-rotation for spheres; start/edges/normal/w for
quads) and shading columns (material type, texture kind, two RGB slots for
solid/checker, checker scale, image id, fuzz, refraction index).  One row
gather per bounce replaces ~25 per-field gathers.  Scenes under the
threshold keep per-field gathers (cheaper than a row fetch there).

Denormalization covers solid colors, checkerboards with solid OR image
children, and plain image textures.  Checker-in-checker nesting cannot be
flattened into one record; such scenes set ``scene.has_nested_checker``
and the XLA integrator evaluates textures with the general walk
(textures.texture_value, depth 4) instead — matching the reference's
unbounded recursion (src/texture.zig:111-118) for any realistic nesting.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..geometry import sphere as sphere_g
from ..math import v3
from ..math.v3 import V3
from ..scene import PRIM_SPHERE, CompiledScene
from .trace import Hit

# Row-gather pays off above this many primitives of a kind.
ROW_FETCH_MIN_PRIMS = 64

# record column layout (kind-specific geometry, shared shading)
# spheres: 0-2 center, 3-5 move, 6 inv_radius, 7 uv_cos, 8 uv_sin
# quads:   0-2 start, 3-5 normal, 6-8 w, 9-11 edge_u, 12-14 edge_v
_C_MAT = 16       # material type code
_C_TEXKIND = 17   # texture kind code
_C_IMG = 18       # atlas image id: plain image texture, or checker EVEN
                  # child when that child is an image; -1 = none
_C_RGB = 19       # 19-21: solid / checker-even rgb, metal albedo, emission
_C_RGB2 = 22      # 22-24: checker-odd rgb
_C_INVSCALE = 25  # checker inverse scale
_C_FUZZ = 26
_C_REFRACT = 27
_C_IMG2 = 28      # checker ODD child image id (-1 = none)
_C_TEXID = 29     # original texture id (general-walk fallback for scenes
                  # with checker-in-checker nesting)
SHADE_BLOCK = 14  # _C_MAT.._C_TEXID: the per-material shading column span
RECORD_WIDTH = 32


class ShadeAttrs(NamedTuple):
    """Everything the bounce needs about the hit point (all (N,) / V3)."""

    point: V3
    normal: V3            # front-face oriented
    front: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    mat_type: jnp.ndarray
    tex_kind: jnp.ndarray
    img: jnp.ndarray
    img2: jnp.ndarray
    texid: jnp.ndarray
    rgb: V3
    rgb2: V3
    inv_scale: jnp.ndarray
    fuzz: jnp.ndarray
    refract: jnp.ndarray


def build_shade_rows(
    sph_geom: dict, quad_geom: dict, sph_shade: np.ndarray,
    quad_shade: np.ndarray,
) -> np.ndarray:
    """Host-side: pack per-prim records.  ``*_geom`` are dicts of (S,)
    columns; ``*_shade`` are (S, SHADE_BLOCK) shading blocks [mat, texkind,
    img, rgb3, rgb23, inv_scale, fuzz, refract, img2, texid]."""
    s = sph_shade.shape[0]
    q = quad_shade.shape[0]
    rows = np.zeros((s + q, RECORD_WIDTH), np.float32)
    if s:
        rows[:s, 0] = sph_geom["cx"]
        rows[:s, 1] = sph_geom["cy"]
        rows[:s, 2] = sph_geom["cz"]
        rows[:s, 3] = sph_geom["mx"]
        rows[:s, 4] = sph_geom["my"]
        rows[:s, 5] = sph_geom["mz"]
        with np.errstate(divide="ignore"):
            rows[:s, 6] = np.where(
                sph_geom["r"] > 0, 1.0 / np.maximum(sph_geom["r"], 1e-20), 0.0
            )
        rows[:s, 7] = sph_geom["uv_cos"]
        rows[:s, 8] = sph_geom["uv_sin"]
        rows[:s, _C_MAT : _C_MAT + SHADE_BLOCK] = sph_shade
    if q:
        rows[s:, 0] = quad_geom["sx"]
        rows[s:, 1] = quad_geom["sy"]
        rows[s:, 2] = quad_geom["sz"]
        rows[s:, 3] = quad_geom["nx"]
        rows[s:, 4] = quad_geom["ny"]
        rows[s:, 5] = quad_geom["nz"]
        rows[s:, 6] = quad_geom["wx"]
        rows[s:, 7] = quad_geom["wy"]
        rows[s:, 8] = quad_geom["wz"]
        rows[s:, 9] = quad_geom["ux"]
        rows[s:, 10] = quad_geom["uy"]
        rows[s:, 11] = quad_geom["uz"]
        rows[s:, 12] = quad_geom["vx"]
        rows[s:, 13] = quad_geom["vy"]
        rows[s:, 14] = quad_geom["vz"]
        rows[s:, _C_MAT : _C_MAT + SHADE_BLOCK] = quad_shade
    return rows


def _attrs_from_columns(
    hit: Hit, origin: V3, direction: V3, time, col_s, col_q,
) -> ShadeAttrs:
    """Build ShadeAttrs given per-kind column accessors (``col_s(i)`` for
    sphere rows, ``col_q(i)`` for quad rows; identical for the packed
    unified-row path)."""
    is_sphere = hit.kind == PRIM_SPHERE
    safe_t = jnp.where(jnp.isfinite(hit.t), hit.t, 0.0)
    point = origin + direction * safe_t

    # -- sphere geometry --
    center = V3(col_s(0), col_s(1), col_s(2))
    move = V3(col_s(3), col_s(4), col_s(5))
    center = center + move * time
    inv_r = col_s(6)
    n_sph = (point - center) * inv_r
    c_rot = col_s(7)
    s_rot = col_s(8)
    n_obj = V3(
        c_rot * n_sph.x - s_rot * n_sph.z,
        n_sph.y,
        s_rot * n_sph.x + c_rot * n_sph.z,
    )
    u_sph, v_sph = sphere_g.uv(n_obj)

    # -- quad geometry --
    q_start = V3(col_q(0), col_q(1), col_q(2))
    q_normal = V3(col_q(3), col_q(4), col_q(5))
    q_w = V3(col_q(6), col_q(7), col_q(8))
    q_u = V3(col_q(9), col_q(10), col_q(11))
    q_v = V3(col_q(12), col_q(13), col_q(14))
    planar = point - q_start
    alpha = v3.dot(q_w, v3.cross(planar, q_v))
    beta = v3.dot(q_w, v3.cross(q_u, planar))

    outward = V3.where(is_sphere, n_sph, q_normal)
    u = jnp.where(is_sphere, u_sph, alpha)
    v = jnp.where(is_sphere, v_sph, beta)
    front = v3.dot(direction, outward) < 0.0
    normal = V3.where(front, outward, -outward)

    def shade_col(i):
        return jnp.where(is_sphere, col_s(i), col_q(i))

    return ShadeAttrs(
        point=point,
        normal=normal,
        front=front,
        u=u,
        v=v,
        mat_type=shade_col(_C_MAT).astype(jnp.int32),
        tex_kind=shade_col(_C_TEXKIND).astype(jnp.int32),
        img=shade_col(_C_IMG).astype(jnp.int32),
        img2=shade_col(_C_IMG2).astype(jnp.int32),
        texid=shade_col(_C_TEXID).astype(jnp.int32),
        rgb=V3(shade_col(_C_RGB), shade_col(_C_RGB + 1), shade_col(_C_RGB + 2)),
        rgb2=V3(
            shade_col(_C_RGB2), shade_col(_C_RGB2 + 1), shade_col(_C_RGB2 + 2)
        ),
        inv_scale=shade_col(_C_INVSCALE),
        fuzz=shade_col(_C_FUZZ),
        refract=shade_col(_C_REFRACT),
    )


def shade_attrs(
    scene: CompiledScene, hit: Hit, origin: V3, direction: V3, time,
) -> ShadeAttrs:
    """Fetch ShadeAttrs for the winning primitive of each ray."""
    if scene.n_spheres + scene.n_quads >= ROW_FETCH_MIN_PRIMS:
        # big scenes: ONE packed row gather (N, RECORD_WIDTH)
        uidx = jnp.where(
            hit.kind == PRIM_SPHERE, hit.idx, scene.n_spheres + hit.idx
        )
        uidx = jnp.clip(uidx, 0, scene.shade_rows.shape[0] - 1)
        cols = scene.shade_rows[uidx].T
        return _attrs_from_columns(
            hit, origin, direction, time, lambda i: cols[i], lambda i: cols[i]
        )

    # small scenes: per-field gathers from tiny per-kind 1D columns lower to
    # cheap select chains
    n_s = max(scene.n_spheres, 1)
    si = jnp.clip(hit.idx, 0, n_s - 1)
    qi = jnp.clip(hit.idx, 0, max(scene.n_quads, 1) - 1)
    return _attrs_from_columns(
        hit, origin, direction, time,
        lambda i: scene.shade_cols_sph[i][si],
        lambda i: scene.shade_cols_quad[i][qi],
    )
