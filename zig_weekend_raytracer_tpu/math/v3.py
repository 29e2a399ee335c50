"""SoA 3-vectors: the wavefront's vector representation.

``V3`` stores x/y/z as three independent ``(N,)`` arrays instead of one
``(N, 3)`` array, so every elementwise op works on contiguous full-width
arrays and neighbouring lanes read neighbouring memory — the analog of the
reference's SIMD ``@Vector`` types (src/math/math.zig:40-47), transposed
for wavefront batching.

``V3`` is a registered pytree; scene tables and path state carry V3 fields
directly through ``jit`` / ``shard_map`` / ``lax`` control flow.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

Scalar = Union[float, jnp.ndarray]


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic (elementwise; scalars and (N,) arrays broadcast) --------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- indexing / gather ---------------------------------------------------
    def __getitem__(self, i):
        return V3(self.x[i], self.y[i], self.z[i])

    @property
    def shape(self):
        return jnp.shape(self.x)

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def of(x, y, z) -> "V3":
        return V3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))

    @staticmethod
    def full(shape, vx, vy, vz, dtype=jnp.float32) -> "V3":
        return V3(
            jnp.full(shape, vx, dtype),
            jnp.full(shape, vy, dtype),
            jnp.full(shape, vz, dtype),
        )

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "V3":
        z = jnp.zeros(shape, dtype)
        return V3(z, z, z)

    @staticmethod
    def from_array(a: jnp.ndarray) -> "V3":
        """(..., 3) -> V3 of (...,) components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> jnp.ndarray:
        """V3 -> (..., 3); only for host transfer / image assembly."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    @staticmethod
    def where(mask, a: "V3", b: "V3") -> "V3":
        return V3(
            jnp.where(mask, a.x, b.x),
            jnp.where(mask, a.y, b.y),
            jnp.where(mask, a.z, b.z),
        )


def dot(a: V3, b: V3) -> jnp.ndarray:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length_squared(a: V3) -> jnp.ndarray:
    return dot(a, a)


def length(a: V3) -> jnp.ndarray:
    return jnp.sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    return a * jax.lax.rsqrt(dot(a, a))


def reflect(v: V3, n: V3) -> V3:
    """v - 2 (v.n) n  (reference: src/math/math.zig:270-272)."""
    return v - n * (2.0 * dot(v, n))


def refract(vn: V3, n: V3, index) -> V3:
    """Snell refraction of a unit direction (src/math/math.zig:274-279)."""
    cos_theta = jnp.minimum(dot(-vn, n), 1.0)
    r_out_perp = (vn + n * cos_theta) * index
    r_out_parallel = n * (-jnp.sqrt(jnp.abs(1.0 - dot(r_out_perp, r_out_perp))))
    return r_out_perp + r_out_parallel


def lerp(a: V3, b: V3, t) -> V3:
    return a + (b - a) * t


class OrthoBasisV(NamedTuple):
    u: V3
    v: V3
    w: V3


def ortho_basis(n: V3) -> OrthoBasisV:
    """ONB with w = normalize(n); helper axis choice matches the reference
    (src/math/math.zig:65-73)."""
    w = normalize(n)
    cond = jnp.abs(w.y) > 0.9
    a = V3(
        jnp.where(cond, 1.0, 0.0).astype(w.x.dtype),
        jnp.where(cond, 0.0, 1.0).astype(w.x.dtype),
        jnp.zeros_like(w.x),
    )
    u = normalize(cross(w, a))
    v = cross(w, u)
    return OrthoBasisV(u=u, v=v, w=w)


def onb_transform(b: OrthoBasisV, local: V3) -> V3:
    return b.u * local.x + b.v * local.y + b.w * local.z
