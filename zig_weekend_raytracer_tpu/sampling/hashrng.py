"""Content-addressed RNG: stateless hash-based uniforms keyed by
(seed, ray_id, stream), vectorized at full lane width.

Why not ``jax.random`` per chunk: folding the chunk coordinates into the key
makes results depend on the chunk/shard decomposition.  Hashing the *global*
ray id instead makes every random draw a pure function of
(seed, pixel, sample, bounce, dim) — renders are bitwise-identical across
chunk sizes, row bands, and device counts (the property the reference gets
from per-pixel Sobol indexing, and the foundation of our
chip-count-invariance tests).

Generator: PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020) — 4-in/4-out u32 mixer with excellent statistical quality at ~25
integer ops for 4 outputs.  Gaussians come from Box-Muller pairs.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..dtypes import real
from ..math.v3 import V3

_U32 = jnp.uint32
# numpy scalars (not jnp): constructing device constants at import time would
# force backend initialization on `import zig_weekend_raytracer_tpu`.
_MUL = np.uint32(1664525)
_ADD = np.uint32(1013904223)
TWO_PI = 6.283185307179586

# Russian-roulette survival floor (the integrator draws u at per-bounce
# site k=3): p = clamp(max(throughput), RR_P_MIN, 1) bounds weight
# amplification at 1/RR_P_MIN.
RR_P_MIN = 0.05


def pcg4d(a, b, c, d) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """PCG4D mix of four u32 arrays -> four u32 arrays."""
    a = a.astype(_U32) * _MUL + _ADD
    b = b.astype(_U32) * _MUL + _ADD
    c = c.astype(_U32) * _MUL + _ADD
    d = d.astype(_U32) * _MUL + _ADD
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    return a, b, c, d


def _to_unit(v: jnp.ndarray) -> jnp.ndarray:
    """u32 -> [0, 1) float32 (24-bit mantissa path, never returns 1.0).

    The value is < 2^24 after the shift, so converting via int32 is exact.
    """
    return (v >> 8).astype(jnp.int32).astype(real) * real(1.0 / (1 << 24))


def uniform4(seed, ray_id, stream) -> Tuple[jnp.ndarray, ...]:
    """Four independent U[0,1) streams for each ray.

    ``seed``: u32 scalar; ``ray_id``: (N,) u32; ``stream``: int (static or
    traced) distinguishing draw sites (bounce*K + site).
    """
    a, b, c, d = pcg4d(
        ray_id,
        jnp.broadcast_to(jnp.asarray(stream, _U32), ray_id.shape),
        jnp.broadcast_to(jnp.asarray(seed, _U32), ray_id.shape),
        jnp.full_like(ray_id, np.uint32(0x9E3779B9)),
    )
    return _to_unit(a), _to_unit(b), _to_unit(c), _to_unit(d)


def uniform1(seed, ray_id, stream) -> jnp.ndarray:
    return uniform4(seed, ray_id, stream)[0]


def gauss3(seed, ray_id, stream) -> V3:
    """Three standard normals per ray via Box-Muller."""
    u1, u2, u3, u4 = uniform4(seed, ray_id, stream)
    r1 = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u1, 1e-10)))
    r2 = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u3, 1e-10)))
    return V3(
        r1 * jnp.cos(TWO_PI * u2),
        r1 * jnp.sin(TWO_PI * u2),
        r2 * jnp.cos(TWO_PI * u4),
    )


def gauss2(seed, ray_id, stream) -> Tuple[jnp.ndarray, jnp.ndarray]:
    u1, u2, _, _ = uniform4(seed, ray_id, stream)
    r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u1, 1e-10)))
    return r * jnp.cos(TWO_PI * u2), r * jnp.sin(TWO_PI * u2)


# -- distribution helpers over V3 (parity: src/math/rng.zig) -----------------

def unit_sphere(g: V3) -> V3:
    """Gaussian-normalize direct sampling (src/math/rng.zig:87-95)."""
    from ..math import v3 as _v3

    norm = jnp.sqrt(jnp.maximum(_v3.dot(g, g), 1e-24))
    return g * (1.0 / norm)


def cosine_direction_z(u1, u2) -> V3:
    """Cosine-weighted hemisphere about +z (src/math/rng.zig:104-114)."""
    phi = TWO_PI * u1
    sq = jnp.sqrt(u2)
    return V3(jnp.cos(phi) * sq, jnp.sin(phi) * sq, jnp.sqrt(1.0 - u2))


def cone_direction_z(u1, u2, cos_theta_max) -> V3:
    """Uniform in the z-cone (sphere-light sampling, src/entity.zig:668-679)."""
    z = 1.0 + u2 * (cos_theta_max - 1.0)
    phi = TWO_PI * u1
    sz2 = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return V3(jnp.cos(phi) * sz2, jnp.sin(phi) * sz2, z)


def unit_disk_xy(u_radius, gx, gy):
    """radius-uniform x normalized 2D gaussian (src/math/rng.zig:71-78)."""
    norm = jnp.sqrt(jnp.maximum(gx * gx + gy * gy, 1e-24))
    return u_radius * gx / norm, u_radius * gy / norm
