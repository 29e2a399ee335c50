"""Pixel-sampler framework: one enum, three strategies, batched evaluation.

The reference exposes ``ISampler`` as a tagged union over independent /
stratified / Sobol samplers (src/math/sampler.zig:56-84); here the strategy
is a static enum resolved at trace time (each strategy is a different XLA
program — the analog of comptime dispatch).

Semantics matched to the reference's render path (src/render.zig:144-174):
  * independent: offsets uniform in [-0.5, 0.5]^2 (sampleSquareXY,
    src/math/rng.zig:63-69).
  * stratified: jittered sqrt(spp) x sqrt(spp) grid offsets in [-0.5, 0.5]^2
    (src/math/sampler.zig:144-154).
  * sobol: unscrambled dims 0,1 of the global Sobol sequence, remapped to a
    [0, 1)^2 in-pixel offset via sobolIntervalToIndex
    (src/math/sampler.zig:197-234; note getPixel2D uses the *noop*
    randomizer — pixel positions are pure QMC; scrambling applies to
    dimensions >= 2 via ``sample_dimension``).
"""

from __future__ import annotations

import enum
import math as _math

import jax.numpy as jnp

from ..dtypes import real
from . import hashrng
from . import sobol as _sobol

_SITE_PIXEL = 0  # camera stream site for stochastic pixel jitter


class SamplerKind(enum.Enum):
    INDEPENDENT = "independent"
    STRATIFIED = "stratified"
    SOBOL = "sobol"


def pixel_offsets(
    kind: SamplerKind,
    seed,
    ray_id: jnp.ndarray,
    px: jnp.ndarray,
    py: jnp.ndarray,
    sample_idx: jnp.ndarray,
    spp: int,
    width: int,
    height: int,
):
    """Per-ray (ox, oy) sub-pixel offsets, batched over rays."""
    if kind == SamplerKind.INDEPENDENT:
        u1, u2, _, _ = hashrng.uniform4(seed, ray_id, _SITE_PIXEL)
        return u1 - 0.5, u2 - 0.5

    if kind == SamplerKind.STRATIFIED:
        sqrt_spp = max(1, int(_math.sqrt(spp)))
        recip = real(1.0 / sqrt_spp)
        si = (sample_idx // sqrt_spp).astype(real)
        sj = (sample_idx % sqrt_spp).astype(real)
        u1, u2, _, _ = hashrng.uniform4(seed, ray_id, _SITE_PIXEL)
        return (u1 + si) * recip - 0.5, (u2 + sj) * recip - 0.5

    if kind == SamplerKind.SOBOL:
        scale = _sobol.ceil_pow2(max(width, height))
        log2_scale = scale.bit_length() - 1
        idx_hi, idx_lo = _sobol.sobol_interval_to_index(
            log2_scale, sample_idx.astype(jnp.uint32), px, py
        )
        fscale = real(scale)
        sx = _sobol.sobol_sample(idx_hi, idx_lo, 0)
        sy = _sobol.sobol_sample(idx_hi, idx_lo, 1)
        ox = jnp.clip(sx * fscale - px.astype(real), 0.0, _sobol._F32_ONE_MINUS_EPS)
        oy = jnp.clip(sy * fscale - py.astype(real), 0.0, _sobol._F32_ONE_MINUS_EPS)
        return ox, oy

    raise ValueError(f"unknown sampler kind: {kind}")


def sample_dimension(
    idx_hi: jnp.ndarray,
    idx_lo: jnp.ndarray,
    dimension: int,
    seed,
    scramble: bool = True,
) -> jnp.ndarray:
    """Scrambled Sobol sample for dimensions >= 2, API parity with the
    reference's get1D/get2D path (src/math/sampler.zig:203-247): the scramble
    seed is Murmur2(dimension, seed) feeding the Owen-fast hash."""
    dimension = dimension % _sobol.N_SOBOL_DIMENSIONS
    if not scramble:
        return _sobol.sobol_sample(idx_hi, idx_lo, dimension)
    h = _sobol.murmur2_32(jnp.uint32(dimension), seed)
    return _sobol.sobol_sample(idx_hi, idx_lo, dimension, scramble_seed=h)
