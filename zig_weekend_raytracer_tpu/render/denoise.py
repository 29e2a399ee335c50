"""Edge-aware à-trous wavelet denoiser guided by the first-hit AOVs.

A production post-process the reference lacks: low-spp Monte-Carlo noise
is smoothed with an edge-stopping à-trous wavelet filter (Dammertz et al.
2010, the SVGF family's spatial pass) guided by the albedo / normal /
depth buffers from render/aov.py.  Biased (it is a filter), opt-in.

Pipeline per iteration i (hole size 2^i):
  * 5x5 B3-spline taps, dilated by the hole size;
  * each tap weighted by three edge stops against the center pixel —
    normal (dot^sigma_n), depth (exp(-|dz| / (sigma_z * step))), and
    demodulated luminance (exp(-|dl| / sigma_l)) — so energy never leaks
    across geometry or shading discontinuities;
  * weights renormalized per pixel.

The color is DEMODULATED by albedo first (irradiance = color / albedo)
and remodulated after, so texture detail survives arbitrarily aggressive
smoothing — only the lighting is filtered.  The albedo doubles as the
fourth edge stop: it is the only signal separating a flush emitter from
the wall around it (same plane, same depth, equal demodulated
irradiance) — without it the light bleeds onto the ceiling and MSE
DEGRADES with iterations (measured 0.027 -> 0.34 at 4 iters).

Defaults: iterations=3, sigma_l="auto" — the luminance stop scales with
the framebuffer's MEASURED noise level (estimate_noise_sigma x the
calibrated _SIGMA_L_PER_NOISE), so noisy low-spp renders smooth hard
while clean renders keep shading detail.  At the 8-spp cornell anchor
auto lands at ~1.0, the measured best there (MSE 0.0268 -> ~0.0145,
-46%); on clean geometric scenes it backs off (a fixed 1.0 measured MSE
ratio 1.91 vs uniform on balls@32 — worse than no filter).
SVGF-style variance modulation of the luminance stop (local 3x3 sigma of
demodulated luminance) was prototyped and measured WORSE on this
renderer's low-spp output (best 0.0165 vs 0.0154 fixed) — the spatial
variance estimate is itself too noisy at 8 spp; the fixed stop stays.

Device mapping: the filter is 25 shifted multiply-adds per iteration over
(H, W) arrays — elementwise work XLA fuses well; no gathers, no
data-dependent shapes.  Everything runs under jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..dtypes import LUM_B, LUM_G, LUM_R

# 1D B3-spline; the 2D kernel is the outer product
_B3 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
_EPS = 1e-4

# sigma_l="auto" calibration: sigma_l = _SIGMA_L_PER_NOISE * estimated
# noise sigma (estimate_noise_sigma below).  Measured on 32x32 tiles vs
# 512-spp references (MSE ratio vs uniform, lower = better; image quality,
# the same on any backend):
#   cornell@8  (est 0.145): fixed-1.0 best 0.542; k=6 0.559, k=7 0.559-65, k=9 0.565
#   balls@8    (est 0.009): fixed-1.0 0.947;      k=6 0.923, k=7 0.906, k=9 0.882
#   balls@32   (est 0.008): fixed-1.0 1.910 (WORSE than no filter);
#                           k=6 0.941, k=7 0.938, k=9 0.947
# k = 7 is within 4% of each config's own optimum and never regresses.
_SIGMA_L_PER_NOISE = 7.0


def _shift2d(x, dy, dx):
    """Shift a (H, W, C) array by (dy, dx) with edge clamping."""
    h, w = x.shape[0], x.shape[1]
    pad = [(max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0))] + [
        (0, 0)
    ] * (x.ndim - 2)
    xp = jnp.pad(x, pad, mode="edge")
    return jax.lax.dynamic_slice_in_dim(
        jax.lax.dynamic_slice_in_dim(xp, 0 if dy > 0 else -dy, h, 0),
        0 if dx > 0 else -dx, w, 1,
    )


@functools.partial(
    jax.jit,
    static_argnames=("iterations", "sigma_z", "sigma_n", "sigma_a"),
)
def _atrous(color, albedo, normal, depth, sigma_l, *, iterations, sigma_z,
            sigma_n, sigma_a):
    # sigma_l is a TRACED scalar: the auto stop differs per render (it is
    # a measured noise level), and a static arg would recompile the whole
    # filter for every image (~10 s XLA compile each).
    alb = jnp.maximum(albedo, _EPS)
    irr = color / alb
    lum_w = jnp.asarray([LUM_R, LUM_G, LUM_B], color.dtype)

    # The AOV normal is a non-renormalized mean over samples, so edge /
    # partial-coverage pixels have |n| in (0, 1); dot^sigma_n of two such
    # normals collapses (0.8^2)^64 ~ 0 even for PARALLEL normals, killing
    # every tap including self.  Normalize the guide (direction is the
    # edge signal, magnitude is not) and keep a miss mask for |n| ~ 0.
    n_len = jnp.sqrt((normal * normal).sum(-1, keepdims=True))
    miss = n_len < 0.25
    n_hat = normal / jnp.maximum(n_len, _EPS)

    out = irr
    for i in range(iterations):
        step = 1 << i
        lum_c = (out * lum_w).sum(-1, keepdims=True)
        acc = jnp.zeros_like(out)
        wacc = jnp.zeros_like(lum_c)
        for ty in range(-2, 3):
            for tx in range(-2, 3):
                k = _B3[ty + 2] * _B3[tx + 2]
                dy, dx = ty * step, tx * step
                irr_t = _shift2d(out, dy, dx)
                n_t = _shift2d(n_hat, dy, dx)
                m_t = _shift2d(miss.astype(irr.dtype), dy, dx) > 0.5
                z_t = _shift2d(depth[..., None], dy, dx)
                lum_t = (irr_t * lum_w).sum(-1, keepdims=True)

                w_n = jnp.maximum((n_hat * n_t).sum(-1, keepdims=True), 0.0)
                w_n = w_n ** sigma_n
                # miss pixels carry a ~zero normal whose direction is
                # meaningless: let misses mix with misses (w 1) and block
                # hit<->miss entirely.
                w_n = jnp.where(
                    miss | m_t, (miss == m_t).astype(w_n.dtype), w_n
                )
                # RELATIVE depth stop: |dz| scaled by the center depth, so
                # the stop is invariant to the camera-ray parameterization
                # (cornell t ~ 100, wall scenes t ~ 1)
                z_c = depth[..., None]
                w_z = jnp.exp(
                    -jnp.abs(z_c - z_t)
                    / (sigma_z * step * (jnp.abs(z_c) + 1.0) + _EPS)
                )
                w_l = jnp.exp(-jnp.abs(lum_c - lum_t) / (sigma_l + _EPS))
                # albedo stop: blocks mixing across MATERIAL boundaries —
                # critically, a flush emitter vs. the wall around it, which
                # normal and depth cannot separate (demodulation equalizes
                # their irradiance, so w_l cannot either)
                a_t = _shift2d(albedo, dy, dx)
                w_a = jnp.exp(
                    -jnp.abs(albedo - a_t).sum(-1, keepdims=True)
                    / (sigma_a + _EPS)
                )
                w = k * w_n * w_z * w_l * w_a
                acc = acc + irr_t * w
                wacc = wacc + w
        # safety: a pixel whose every tap weight vanished keeps its value
        # instead of renormalizing 0/eps to black
        out = jnp.where(wacc > _EPS, acc / jnp.maximum(wacc, _EPS), out)
    return out * alb


def estimate_noise_sigma(color, aovs: dict) -> float:
    """Global Monte-Carlo noise level of a framebuffer, in demodulated-
    luminance units (host-side numpy, ~ms).

    Immerkaer's high-pass N = [[1,-2,1],[-2,4,-2],[1,-2,1]] annihilates
    constant and linear image content, leaving (for iid pixel noise of
    sigma) a response with sigma_N = 6*sigma.  MC noise is heavy-tailed,
    so the scale comes from the MEDIAN absolute response
    (median|X| = 0.6745*sigma for the Gaussian core) rather than the
    mean.  Geometry/material edges would pollute the high-pass, so
    pixels within 1 px of an AOV discontinuity (albedo step > 0.05,
    relative depth step > 0.02, normal dot < 0.95, hit/miss boundary)
    are masked out; if the mask empties (tiny or all-edge images) the
    estimate falls back to all pixels — median robustness keeps it
    usable."""
    # float32 throughout: the estimate feeds a smooth exp() stop, so the
    # ~1e-7 relative error of f32 accumulation is irrelevant, and the
    # estimator runs on every denoise() call (host numpy).
    fb = np.asarray(color, np.float32)
    alb = np.maximum(np.asarray(aovs["albedo"], np.float32), _EPS)
    irr = fb / alb
    lum = (
        np.float32(LUM_R) * irr[..., 0] + np.float32(LUM_G) * irr[..., 1]
        + np.float32(LUM_B) * irr[..., 2]
    )
    # Immerkaer response, valid interior = [1:-1, 1:-1]
    c = lum[1:-1, 1:-1]
    resp = (
        4.0 * c
        - 2.0 * (lum[:-2, 1:-1] + lum[2:, 1:-1]
                 + lum[1:-1, :-2] + lum[1:-1, 2:])
        + lum[:-2, :-2] + lum[:-2, 2:] + lum[2:, :-2] + lum[2:, 2:]
    )

    def steps(a):  # max abs diff to the 4 neighbours, interior-shaped
        ax = np.abs(np.diff(a, axis=0)), np.abs(np.diff(a, axis=1))
        return np.maximum(
            np.maximum(ax[0][:-1, 1:-1], ax[0][1:, 1:-1]),
            np.maximum(ax[1][1:-1, :-1], ax[1][1:-1, 1:]),
        )

    a_step = steps(np.asarray(aovs["albedo"], np.float32).sum(-1))
    z = np.asarray(aovs["depth"], np.float32)
    z_step = steps(z) / (np.abs(z[1:-1, 1:-1]) + 1.0)
    n = np.asarray(aovs["normal"], np.float32)
    n_len = np.sqrt((n * n).sum(-1))
    miss = n_len < 0.25
    edge = (
        (a_step > 0.05) | (z_step > 0.02)
        | (steps(miss.astype(np.float32)) > 0.0)
    )
    n_hat = n / np.maximum(n_len, _EPS)[..., None]
    n_dot = np.ones_like(n_len)
    for axis in (0, 1):
        d = (np.take(n_hat, range(0, n_hat.shape[axis] - 1), axis) *
             np.take(n_hat, range(1, n_hat.shape[axis]), axis)).sum(-1)
        pad = [(0, 0), (0, 0)]
        pad[axis] = (0, 1)
        n_dot = np.minimum(n_dot, np.pad(d, pad, constant_values=1.0))
        pad[axis] = (1, 0)
        n_dot = np.minimum(n_dot, np.pad(d, pad, constant_values=1.0))
    edge = edge | (n_dot[1:-1, 1:-1] < 0.95) | miss[1:-1, 1:-1]
    # dilate by 1: the high-pass stencil touches neighbours
    ep = np.pad(edge, 1, mode="edge")
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            edge = edge | ep[1 + dy : ep.shape[0] - 1 + dy,
                             1 + dx : ep.shape[1] - 1 + dx]
    flat = np.abs(resp[~edge])
    if flat.size < 16:
        flat = np.abs(resp).reshape(-1)
    if flat.size == 0:
        return 0.0
    return float(np.median(flat) / (0.6745 * 6.0))


def denoise(color, aovs: dict, *, iterations: int = 3,
            sigma_l: "float | str" = "auto",
            sigma_z: float = 0.05, sigma_n: float = 64.0,
            sigma_a: float = 0.1) -> np.ndarray:
    """Denoise a linear (H, W, 3) framebuffer using the AOV dict from
    render/aov.py (albedo, normal, depth).  Returns (H, W, 3) f32.

    ``iterations`` filter passes with doubling hole size (0 = identity);
    ``sigma_l`` luminance edge stop (bigger = smoother lighting) — the
    default ``"auto"`` scales it with the framebuffer's MEASURED noise
    level (estimate_noise_sigma), so a clean 32-spp render keeps its
    shading detail while a noisy 8-spp render smooths hard.  A fixed 1.0
    (tuned on 8-spp cornell) over-smoothed geometry-dense scenes whose
    noise was already low: balls@32 measured MSE ratio 2.18 vs uniform;
    ``sigma_z`` depth edge stop per dilation step; ``sigma_n`` normal
    edge-stop exponent (bigger = stricter geometry edges)."""
    if iterations <= 0:
        return np.asarray(color, np.float32)
    if sigma_l == "auto":
        sigma_l = _SIGMA_L_PER_NOISE * estimate_noise_sigma(color, aovs)
    out = _atrous(
        jnp.asarray(color, jnp.float32),
        jnp.asarray(aovs["albedo"], jnp.float32),
        jnp.asarray(aovs["normal"], jnp.float32),
        jnp.asarray(aovs["depth"], jnp.float32),
        jnp.float32(sigma_l),
        iterations=int(iterations),
        sigma_z=float(sigma_z), sigma_n=float(sigma_n),
        sigma_a=float(sigma_a),
    )
    return np.asarray(out)
