"""Camera ray generation for a wavefront of (pixel, sample) pairs (SoA).

Parity targets in the reference:
  * viewport rasterization (pixel00 / pixel deltas): src/camera.zig:105-157
    (computed host-side in ``scene.Camera.viewport``)
  * per-sample ray generation (sampler jitter, defocus-disk origin for depth
    of field, time in [0,1) for motion blur): src/render.zig:144-185

hashrng stream sites 0..3 are reserved for the camera (pixel jitter, defocus
disk, time); bounce streams start at 8 (see integrator.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..dtypes import real
from ..math.v3 import V3
from ..sampling import hashrng
from ..sampling.sampler import SamplerKind, pixel_offsets
from ..scene import Camera

SITE_PIXEL = 0
SITE_DOF = 1
SITE_TIME = 2


class CameraParams(NamedTuple):
    """Device-side camera constants (V3 of scalars)."""

    position: V3
    pixel00: V3
    delta_u: V3
    delta_v: V3
    defocus_u: V3
    defocus_v: V3


def _v3s(a: np.ndarray) -> V3:
    a = np.asarray(a, np.float32)
    return V3(jnp.asarray(a[0]), jnp.asarray(a[1]), jnp.asarray(a[2]))


def camera_params(camera: Camera, width: int, height: int) -> CameraParams:
    pixel00, du, dv = camera.viewport(width, height)
    dd_u, dd_v = camera.defocus_disk()
    return CameraParams(
        position=_v3s(np.asarray(camera.look_from)),
        pixel00=_v3s(pixel00),
        delta_u=_v3s(du),
        delta_v=_v3s(dv),
        defocus_u=_v3s(dd_u),
        defocus_v=_v3s(dd_v),
    )


def camera_consts(camera: Camera, width: int, height: int):
    """CameraParams as a STATIC nested tuple of floats — the form the
    regenerating wavefront bakes in as compile-time constants (and a valid
    jit static argument)."""
    pixel00, du, dv = camera.viewport(width, height)
    dd_u, dd_v = camera.defocus_disk()
    t3 = lambda a: tuple(float(v) for v in np.asarray(a))
    return (
        t3(camera.look_from), t3(pixel00), t3(du), t3(dv), t3(dd_u), t3(dd_v)
    )


def camera_params_from_consts(consts) -> CameraParams:
    """Static float tuple -> CameraParams of numpy scalars (no device
    constants are created)."""
    s3 = lambda t: V3(np.float32(t[0]), np.float32(t[1]), np.float32(t[2]))
    return CameraParams(*(s3(t) for t in consts))


def generate_rays(
    cam: CameraParams,
    has_dof: bool,
    sampler: SamplerKind,
    seed,                     # u32 scalar
    ray_id: jnp.ndarray,      # (N,) u32 global ray id
    px: jnp.ndarray,          # (N,) i32 pixel column
    py: jnp.ndarray,          # (N,) i32 pixel row
    sample_idx: jnp.ndarray,  # (N,) i32
    spp: int,
    width: int,
    height: int,
):
    """Returns (origin V3, direction V3, time (N,))."""
    ox, oy = pixel_offsets(sampler, seed, ray_id, px, py, sample_idx, spp, width, height)
    sample_pos = (
        cam.pixel00
        + cam.delta_u * (px.astype(real) + ox)
        + cam.delta_v * (py.astype(real) + oy)
    )
    shape = px.shape
    if has_dof:
        ud, g1, g2, _ = hashrng.uniform4(seed, ray_id, SITE_DOF)
        gx, gy = hashrng.gauss2(seed, ray_id, SITE_DOF + 4)
        dx, dy = hashrng.unit_disk_xy(ud, gx, gy)
        origin = cam.position + cam.defocus_u * dx + cam.defocus_v * dy
    else:
        origin = V3(
            jnp.broadcast_to(cam.position.x, shape),
            jnp.broadcast_to(cam.position.y, shape),
            jnp.broadcast_to(cam.position.z, shape),
        )
    direction = sample_pos - origin
    time = hashrng.uniform1(seed, ray_id, SITE_TIME)
    return origin, direction, time
