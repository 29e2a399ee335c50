"""Sobol quasi-Monte-Carlo sampler, fully vectorized.

Implements the PBRT-style Sobol pixel sampler of the reference
(src/math/sampler.zig:162-300) as batched u32 bit-ops:

  * ``sobol_sample``            — src/math/sampler.zig:249-264
  * ``sobol_interval_to_index`` — src/math/sampler.zig:267-298
  * ``owen_fast_scramble``      — src/math/sampler.zig:39-53 (the
    psychopath.io / PBRT-v4 "better LK hash")
  * ``murmur2_32``              — Zig std.hash.Murmur2_32.hashUint32WithSeed,
    used to derive the per-dimension scramble seed
    (src/math/sampler.zig:241-246)

JAX runs in 32-bit mode by default, so 64-bit quantities (the global sample
index) are carried as (hi, lo) u32 pairs; the van-der-Corput matrices are stored
pre-split the same way.  All loops have static trip counts (52 matrix bits),
so everything stays inside one fused XLA computation.

The direction-number tables are public Joe-Kuo/PBRT data; see
``tools/gen_sobol_data.py`` for provenance.
"""

from __future__ import annotations

import functools
import os

import jax.numpy as jnp
import numpy as np

from ..dtypes import real

N_SOBOL_DIMENSIONS = 1024
SOBOL_MATRIX_SIZE = 52

_U32 = jnp.uint32


@functools.lru_cache(maxsize=1)
def _data():
    path = os.path.join(os.path.dirname(__file__), "sobol_data.npz")
    z = np.load(path)
    return {k: z[k] for k in z.files}


def sobol_matrix(dim: int) -> np.ndarray:
    """The 52 u32 generator-matrix columns for one Sobol dimension."""
    return _data()["sobol32"][dim]


# ---------------------------------------------------------------------------
# u32 bit helpers
# ---------------------------------------------------------------------------

def bit_reverse32(v: jnp.ndarray) -> jnp.ndarray:
    """Reverse the bits of a u32 array (5 masked swaps)."""
    v = v.astype(_U32)
    v = ((v >> 1) & _U32(0x55555555)) | ((v & _U32(0x55555555)) << 1)
    v = ((v >> 2) & _U32(0x33333333)) | ((v & _U32(0x33333333)) << 2)
    v = ((v >> 4) & _U32(0x0F0F0F0F)) | ((v & _U32(0x0F0F0F0F)) << 4)
    v = ((v >> 8) & _U32(0x00FF00FF)) | ((v & _U32(0x00FF00FF)) << 8)
    return (v >> 16) | (v << 16)


def owen_fast_scramble(v: jnp.ndarray, seed) -> jnp.ndarray:
    """Owen-fast hash scrambling (reference: src/math/sampler.zig:39-53).

    u32 arithmetic wraps naturally in XLA, matching the reference's explicit
    wrapping ops.
    """
    v = bit_reverse32(v.astype(_U32))
    seed = jnp.asarray(seed, dtype=_U32)
    v = v ^ (v * _U32(0x3D20ADEA))
    v = v + seed
    v = v * ((seed >> 16) | _U32(1))
    v = v ^ (v * _U32(0x05526C56))
    v = v ^ (v * _U32(0x53A22864))
    return bit_reverse32(v)


def murmur2_32(key, seed) -> jnp.ndarray:
    """Murmur2 hash of a single u32 (Zig std.hash.Murmur2_32.hashUint32WithSeed),
    used for the per-dimension scramble seed (reference: sampler.zig:241)."""
    m = _U32(0x5BD1E995)
    k = jnp.asarray(key, dtype=_U32)
    h = jnp.asarray(seed, dtype=_U32) ^ _U32(4)
    k = k * m
    k = k ^ (k >> 24)
    k = k * m
    h = h * m
    h = h ^ k
    h = h ^ (h >> 13)
    h = h * m
    h = h ^ (h >> 15)
    return h


# ---------------------------------------------------------------------------
# Sobol evaluation
# ---------------------------------------------------------------------------

_F32_ONE_MINUS_EPS = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))


def sobol_sample_u32(idx_hi: jnp.ndarray, idx_lo: jnp.ndarray, dim: int) -> jnp.ndarray:
    """Raw u32 Sobol value for 64-bit sample index (hi, lo) in dimension
    ``dim`` (reference: src/math/sampler.zig:249-264).

    The reference loops while bits remain; here the 52-column XOR is unrolled
    with static matrix-column constants so XLA sees pure vector ops.
    """
    cols = sobol_matrix(dim)
    v = jnp.zeros_like(idx_lo, dtype=_U32)
    for i in range(SOBOL_MATRIX_SIZE):
        c = int(cols[i])
        if c == 0:
            # Columns above the supported index bit-width are zero; XORing
            # them is a no-op, but bits of the index beyond them still are
            # zero in practice (index < 2^52), so skipping is exact.
            continue
        if i < 32:
            bit = (idx_lo >> _U32(i)) & _U32(1)
        else:
            bit = (idx_hi >> _U32(i - 32)) & _U32(1)
        v = v ^ (bit * _U32(c))
    return v


def u32_to_unit_float(v: jnp.ndarray) -> jnp.ndarray:
    """u32 -> [0, 1) float as ``min(v * 2^-32, 1-eps)``
    (reference: src/math/sampler.zig:262-263).

    The u32 is converted via exact 16-bit halves (hi*65536 is a power-of-two
    scaling of an exact integer; the single summation rounding equals the
    direct u32->f32 round-to-nearest) — bit-identical to a plain cast.
    """
    hi = (v >> _U32(16)).astype(jnp.int32).astype(real)
    lo = (v & _U32(0xFFFF)).astype(jnp.int32).astype(real)
    vf = (hi * real(65536.0) + lo) * real(2.0 ** -32)
    return jnp.minimum(vf, real(_F32_ONE_MINUS_EPS))


def sobol_sample(idx_hi, idx_lo, dim: int, scramble_seed=None) -> jnp.ndarray:
    """[0,1) Sobol sample; optionally Owen-fast scrambled."""
    v = sobol_sample_u32(idx_hi, idx_lo, dim)
    if scramble_seed is not None:
        v = owen_fast_scramble(v, scramble_seed)
    return u32_to_unit_float(v)


def sobol_interval_to_index(
    log2_scale: int,
    sample_idx: jnp.ndarray,
    px: jnp.ndarray,
    py: jnp.ndarray,
    max_spp_log2: int = 28,
):
    """Global Sobol index of the ``sample_idx``-th sample landing in pixel
    (px, py), for a sampling domain scaled by 2^log2_scale
    (reference: src/math/sampler.zig:267-298).

    ``log2_scale`` is static (derived from the image size).  Returns the
    64-bit index as a (hi, lo) u32 pair.  ``max_spp_log2`` bounds the unrolled
    loop over sample-index bits (2^28 spp is far beyond any real config).
    """
    sample_idx = sample_idx.astype(_U32)
    px = px.astype(_U32)
    py = py.astype(_U32)

    if log2_scale == 0:
        return jnp.zeros_like(sample_idx), sample_idx

    d = _data()
    vdc_lo = d["vdc_lo"][log2_scale - 1]  # (52,) u32; hi parts are 0 for
    # the pixel-space matrices (they map into 2*log2_scale <= 32 bits for
    # images up to 65536 px — asserted by the builder).
    vdc_inv_hi = d["vdc_inv_hi"][log2_scale - 1]
    vdc_inv_lo = d["vdc_inv_lo"][log2_scale - 1]

    # index = sample_idx << (2 * log2_scale), as (hi, lo).
    shift = 2 * log2_scale
    if shift >= 32:
        idx_hi = sample_idx << _U32(shift - 32)
        idx_lo = jnp.zeros_like(sample_idx)
    else:
        idx_hi = sample_idx >> _U32(32 - shift)
        idx_lo = sample_idx << _U32(shift)

    # delta = XOR of flipped VdC columns selected by sample-index bits.
    delta = jnp.zeros_like(sample_idx)
    for c in range(min(max_spp_log2, SOBOL_MATRIX_SIZE)):
        col = int(vdc_lo[c])
        if col == 0:
            continue
        bit = (sample_idx >> _U32(c)) & _U32(1)
        delta = delta ^ (bit * _U32(col))

    # b = ((px << log2_scale) | py) ^ delta  — fits in u32 for log2_scale<=16.
    b = ((px << _U32(log2_scale)) | py) ^ delta

    # index ^= XOR of inverse-VdC columns selected by bits of b.
    for c in range(2 * log2_scale):
        lo_col = int(vdc_inv_lo[c])
        hi_col = int(vdc_inv_hi[c])
        if lo_col == 0 and hi_col == 0:
            continue
        bit = (b >> _U32(c)) & _U32(1)
        if lo_col:
            idx_lo = idx_lo ^ (bit * _U32(lo_col))
        if hi_col:
            idx_hi = idx_hi ^ (bit * _U32(hi_col))
    return idx_hi, idx_lo


def ceil_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p
