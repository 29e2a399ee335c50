"""Light-list importance sampling: the batched equivalent of the reference's
PDF framework (src/pdf.zig), SoA form.

  * ``light_pdf_value``      — EntityPdf.value over an entity collection:
    the evenly weighted sum of per-light surface PDFs
    (src/pdf.zig:83-85 -> src/entity.zig:371-378), each of which re-traces
    the ray against that light's geometry (src/entity.zig:503-518, 626-644).
  * ``sample_light_direction`` — EntityPdf.generate: pick a uniformly random
    light, sample a direction toward its surface
    (src/entity.zig:381-386, 520-525, 646-679).

The light list is STATIC scene metadata (``CompiledScene.lights``), so each
slot compiles to exactly its own primitive kind's math — the analog of the
reference's tagged-union dispatch resolving at comptime.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..dtypes import T_MIN_PDF
from ..geometry import quad as quad_g
from ..geometry import sphere as sphere_g
from ..math.v3 import V3
from ..scene import PRIM_SPHERE, CompiledScene


def _slot_pdf(scene, kind, idx, origin, direction):
    if kind == PRIM_SPHERE:
        center = scene.sph_center[idx]
        radius = scene.sph_radius[idx]
        _, valid = sphere_g.hit_t(
            center, radius, origin, direction, T_MIN_PDF, jnp.inf
        )
        return sphere_g.pdf_value(center, radius, origin, direction, valid)
    return quad_g.pdf_value(
        scene.quad_start[idx], scene.quad_normal[idx], scene.quad_w[idx],
        scene.quad_u[idx], scene.quad_v[idx], scene.quad_offset[idx],
        scene.quad_area[idx], origin, direction, T_MIN_PDF,
    )


def light_pdf_value(scene: CompiledScene, origin: V3, direction: V3) -> jnp.ndarray:
    """(N,) mixture-member PDF of the scene's light list.

    NOTE: sphere lights are assumed stationary, matching the reference's
    assert (src/entity.zig:627).
    """
    total = jnp.zeros(origin.shape, dtype=origin.x.dtype)
    for kind, idx in scene.lights:
        total = total + _slot_pdf(scene, kind, idx, origin, direction)
    return total / len(scene.lights)


def sample_light_direction(
    scene: CompiledScene, origin: V3, u_choice, u1, u2
) -> V3:
    """Direction toward a uniformly chosen light."""
    n_l = len(scene.lights)
    chosen = jnp.minimum((u_choice * n_l).astype(jnp.int32), n_l - 1)
    out = V3.zeros(origin.shape)
    for l, (kind, idx) in enumerate(scene.lights):
        if kind == PRIM_SPHERE:
            d = sphere_g.sample_direction(
                scene.sph_center[idx], scene.sph_radius[idx], origin, u1, u2
            )
        else:
            d = quad_g.sample_direction(
                scene.quad_start[idx], scene.quad_u[idx], scene.quad_v[idx],
                origin, u1, u2,
            )
        out = V3.where(chosen == l, d, out) if n_l > 1 else d
    return out
