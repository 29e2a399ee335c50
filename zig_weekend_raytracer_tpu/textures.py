"""Device-side texture evaluation over the compiled texture table (SoA).

The reference dispatches ``ITexture.value`` through a tagged union
(src/texture.zig:11-31); here evaluation is branchless over type codes:

  * solid color        (src/texture.zig:80-94)
  * 3D checkerboard    (src/texture.zig:96-119) — lattice parity of the
    scaled hit *point*; children resolved by a fixed-depth redirect loop
    (the reference recurses into two sub-textures; real scenes nest at most
    checker -> solid/image, we allow depth 4)
  * image texture      (src/texture.zig:33-78) — UV clamp, v-flip,
    nearest-neighbor atlas gather, byte -> linear via gamma-2 square

The image atlas is stored as three channel planes (I, H, W) so texel fetch
is three full-lane gathers instead of one (N, 3) gather.
"""

from __future__ import annotations

import jax.numpy as jnp

from .dtypes import real
from .math.v3 import V3
from .scene import TEX_CHECKER, TEX_IMAGE, CompiledScene

_CHECKER_MAX_DEPTH = 4


def _resolve_checker(scene: CompiledScene, tex_id, point: V3):
    """Redirect checker texture ids to the parity-selected child."""
    for _ in range(_CHECKER_MAX_DEPTH):
        is_checker = scene.tex_type[tex_id] == TEX_CHECKER
        inv_scale = scene.tex_inv_scale[tex_id]
        xi = jnp.floor(inv_scale * point.x).astype(jnp.int32)
        yi = jnp.floor(inv_scale * point.y).astype(jnp.int32)
        zi = jnp.floor(inv_scale * point.z).astype(jnp.int32)
        parity = (xi + yi + zi) % 2
        child = jnp.where(
            parity == 0, scene.tex_even[tex_id], scene.tex_odd[tex_id]
        )
        tex_id = jnp.where(is_checker, child, tex_id)
    return tex_id


def atlas_flat_index(image_dims, atlas_hw, img_id, u, v) -> jnp.ndarray:
    """(u, v, image) -> flat index into the packed-atlas plane, from STATIC
    per-image dimensions.  Pure element-wise arithmetic: a static
    select-chain over the tiny image list + clip/mul/cast."""
    ah, aw = atlas_hw
    w = jnp.zeros(jnp.shape(img_id), real)
    h = jnp.zeros(jnp.shape(img_id), real)
    wi = jnp.zeros(jnp.shape(img_id), jnp.int32)
    hi = jnp.zeros(jnp.shape(img_id), jnp.int32)
    for i, (iw, ih) in enumerate(image_dims):
        sel = img_id == i
        w = jnp.where(sel, real(iw), w)
        h = jnp.where(sel, real(ih), h)
        wi = jnp.where(sel, iw, wi)
        hi = jnp.where(sel, ih, hi)
    uc = jnp.clip(u, 0.0, 1.0)
    vc = 1.0 - jnp.clip(v, 0.0, 1.0)  # flip to image coords
    x = jnp.clip((uc * w).astype(jnp.int32), 0, wi - 1)
    y = jnp.clip((vc * h).astype(jnp.int32), 0, hi - 1)
    return (img_id * (ah * aw)) + y * aw + x


def _unpack_texel(packed) -> V3:
    scale = real(1.0 / 255.0)
    texel = V3(
        (packed & jnp.uint32(0xFF)).astype(real) * scale,
        ((packed >> 8) & jnp.uint32(0xFF)).astype(real) * scale,
        ((packed >> 16) & jnp.uint32(0xFF)).astype(real) * scale,
    )
    return texel * texel  # gamma-2 linearize (math.zig:172-174)


def atlas_lookup_flat(scene: CompiledScene, flat) -> V3:
    """Packed-atlas fetch by precomputed flat texel index (from
    ``atlas_flat_index``).  One 1D gather of the r|g<<8|b<<16 texel,
    byte -> linear (gamma 2)."""
    packed = scene.atlas_packed.reshape(-1)[flat]
    return _unpack_texel(packed)


def atlas_lookup(scene: CompiledScene, img_id, u, v) -> V3:
    """Nearest-neighbor atlas fetch, byte -> linear (gamma 2)
    (reference: src/texture.zig:49-77).

    Per-image dimensions are compile-time constants (scene.image_dims), so
    the texel address is ONE flat 1D gather of the packed r|g<<8|b<<16
    texel instead of three channel gathers."""
    n_img, ah, aw = scene.atlas_packed.shape
    flat = atlas_flat_index(scene.image_dims, (ah, aw), img_id, u, v)
    return atlas_lookup_flat(scene, flat)


def checker_parity(inv_scale, point: V3) -> jnp.ndarray:
    """3D lattice parity of the scaled hit point
    (reference: src/texture.zig:111-116).  0 = even, 1 = odd."""
    xi = jnp.floor(inv_scale * point.x).astype(jnp.int32)
    yi = jnp.floor(inv_scale * point.y).astype(jnp.int32)
    zi = jnp.floor(inv_scale * point.z).astype(jnp.int32)
    return (xi + yi + zi) % 2


def texture_value(
    scene: CompiledScene,
    tex_id: jnp.ndarray,  # (N,) i32
    u: jnp.ndarray,
    v: jnp.ndarray,
    point: V3,
) -> V3:
    """Linear-space color per hit."""
    tex_id = _resolve_checker(scene, tex_id, point)
    solid = scene.tex_rgb[tex_id]

    if scene.has_image_textures:
        img_id = scene.tex_img[tex_id]
        w = scene.atlas_wh[img_id, 0]
        h = scene.atlas_wh[img_id, 1]
        uc = jnp.clip(u, 0.0, 1.0)
        vc = 1.0 - jnp.clip(v, 0.0, 1.0)  # flip to image coords
        x = jnp.clip((uc * w.astype(real)).astype(jnp.int32), 0, w - 1)
        y = jnp.clip((vc * h.astype(real)).astype(jnp.int32), 0, h - 1)
        scale = real(1.0 / 255.0)
        texel = V3(
            scene.atlas_r[img_id, y, x].astype(real) * scale,
            scene.atlas_g[img_id, y, x].astype(real) * scale,
            scene.atlas_b[img_id, y, x].astype(real) * scale,
        )
        image = texel * texel  # byte -> linear, gamma 2 (math.zig:172-174)
        is_image = scene.tex_type[tex_id] == TEX_IMAGE
        return V3.where(is_image, image, solid)
    return solid
