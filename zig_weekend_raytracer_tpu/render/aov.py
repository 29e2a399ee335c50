"""First-hit AOVs (arbitrary output variables): albedo, normal, depth.

A production framework surface the reference lacks: denoisers (OIDN-class)
and compositing pipelines want the first-hit feature buffers alongside the
beauty image.  One bounce of the existing machinery produces them — camera
rays (render/camera.py:generate_rays, jitter/DoF/motion-time included) ->
closest_hit (the same tracer the integrator uses) ->
shade_attrs + texture_rgb (the denormalized shade record).  No new kernel:
a single-bounce wavefront is trace-dominated and XLA fuses the shading
tail.

Buffers:
  * ``albedo`` (H, W, 3) — texture/material color at the first hit,
    averaged over ALL samples with misses reading the scene background
    (dielectrics read as white — specular transmission carries no
    albedo) — so partially-covered pixels blend toward the background,
    matching what the beauty pass shows there.
  * ``normal`` (H, W, 3) — front-face-oriented shading normal (zero on
    miss; the mean over samples is NOT renormalized, matching denoiser
    convention for pixels with mixed coverage).
  * ``depth``  (H, W) — hit distance t along the (unnormalized) camera
    ray, averaged over hitting samples only; 0 where nothing hits.
  * ``coverage`` (H, W) — fraction of samples that hit anything.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..dtypes import real
from ..math.v3 import V3
from ..ops.shade import shade_attrs
from ..ops.trace import closest_hit
from ..sampling.sampler import SamplerKind
from ..dtypes import INF, T_MIN
from .camera import camera_params, generate_rays
from .integrator import texture_rgb
from .renderer import pick_tile, ray_grid, unflatten_radiance


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "band_rows", "spp", "sampler", "has_dof",
    ),
)
def _aov_band(
    scene, cam, seed, band_y0,
    *,
    width: int,
    height: int,
    band_rows: int,
    spp: int,
    sampler: SamplerKind,
    has_dof: bool,
):
    """One row band of first-hit AOVs; returns per-pixel SUMS over samples
    of (albedo, normal, depth*hit, hit_count), shapes (band_rows, W, 3|1)."""
    from ..scene import MAT_DIELECTRIC

    tile = pick_tile(width, band_rows)
    px, py, sidx, ray_id = ray_grid(
        width, height, band_y0, band_rows, jnp.int32(0), spp, tile
    )
    origin, direction, time = generate_rays(
        cam, has_dof, sampler, seed, ray_id, px, py, sidx,
        spp, width, height,
    )
    hit = closest_hit(scene, origin, direction, time, T_MIN, INF)
    det = shade_attrs(scene, hit, origin, direction, time)
    hitmask = hit.kind >= 0

    alb = texture_rgb(scene, det)
    alb = V3.where(
        det.mat_type == MAT_DIELECTRIC,
        V3.full(alb.x.shape, 1.0, 1.0, 1.0, real), alb,
    )
    alb = V3.where(hitmask, alb, scene.background)
    nrm = V3.where(hitmask, det.normal, V3.zeros(alb.x.shape, real))
    t = jnp.where(hitmask, hit.t, 0.0)

    def _acc(arr3):  # (N, 3) ray-order -> (band_rows, W, 3) pixel sums
        return unflatten_radiance(arr3, width, band_rows, spp, tile).sum(0)

    aux = jnp.stack(
        [t, hitmask.astype(real), jnp.zeros_like(t)], axis=-1
    )
    return (
        _acc(alb.to_array()),
        _acc(nrm.to_array()),
        _acc(aux),
    )


def render_aovs(
    scene,
    width: int,
    height: int,
    *,
    spp: int = 4,
    seed: int = 0,
    sampler: SamplerKind = SamplerKind.SOBOL,
    max_rays_per_chunk: int = 1 << 21,
) -> dict:
    """First-hit AOV buffers for a scene — see the module docstring.
    Returns a dict of numpy arrays: albedo (H, W, 3), normal (H, W, 3),
    depth (H, W), coverage (H, W)."""
    cam = camera_params(scene.camera, width, height)
    band_rows = max(1, min(height, max_rays_per_chunk // (width * spp)))
    n_bands = -(-height // band_rows)
    albedo = np.zeros((height, width, 3), np.float32)
    normal = np.zeros((height, width, 3), np.float32)
    depth = np.zeros((height, width), np.float32)
    coverage = np.zeros((height, width), np.float32)
    for b in range(n_bands):
        y0 = b * band_rows
        rows = min(band_rows, height - y0)
        alb, nrm, aux = _aov_band(
            scene.compiled, cam, jnp.uint32(seed), jnp.int32(y0),
            width=width, height=height, band_rows=band_rows, spp=spp,
            sampler=sampler, has_dof=scene.camera.has_depth_of_field,
        )
        aux = np.asarray(aux)[:rows]
        hits = aux[..., 1]
        safe = np.maximum(hits, 1.0)
        albedo[y0 : y0 + rows] = np.asarray(alb)[:rows] / spp
        normal[y0 : y0 + rows] = np.asarray(nrm)[:rows] / safe[..., None]
        depth[y0 : y0 + rows] = aux[..., 0] / safe
        coverage[y0 : y0 + rows] = hits / spp
    return {
        "albedo": albedo, "normal": normal,
        "depth": depth, "coverage": coverage,
    }


def write_aovs(prefix: str, aovs: dict) -> list:
    """Write AOV buffers as PNGs: ``<prefix>.albedo.png`` (gamma-2 like
    the beauty pass), ``<prefix>.normal.png`` (0.5 + 0.5n remap),
    ``<prefix>.depth.png`` (normalized by the max finite depth).  Returns
    the written paths."""
    from PIL import Image

    from ..io.ppm import encode_pixels

    paths = []

    def _save(name, arr_u8):
        p = f"{prefix}.{name}.png"
        Image.fromarray(arr_u8, "RGB" if arr_u8.ndim == 3 else "L").save(p)
        paths.append(p)

    _save("albedo", encode_pixels(aovs["albedo"]))
    nrm = np.clip(0.5 + 0.5 * aovs["normal"], 0.0, 1.0)
    _save("normal", (nrm * 255.0 + 0.5).astype(np.uint8))
    d = aovs["depth"]
    dmax = float(d.max()) or 1.0
    _save("depth", (np.clip(d / dmax, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
    return paths
