"""Chunked render driver.

The reference fans (row x 32-pixel-block) closures onto a thread pool
(src/render.zig:55-73).  Here the whole (pixel, sample) space is a flat
wavefront, chunked into static-shape batches (row bands, and sample chunks
or per-lane sample ranges) so one jitted program is compiled once and
reused; chunk size bounds transient device memory.  Accumulation happens on
device in f32; there are no races by construction — each chunk owns a
disjoint framebuffer slice, the direct analog of the reference's
partition-by-construction concurrency (src/render.zig:60).

``Renderer.render`` runs the regenerating wavefront
(``integrator.trace_paths_regen``) through one of the band drivers below;
``Renderer.render_reference`` runs the per-bounce integrator
(``integrator.trace_paths``), the plain reference tests compare it with.

Because all randomness is content-addressed by global ray id
(sampling/hashrng.py), the rendered image is bitwise-invariant to the chunk
decomposition.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np

from ..dtypes import real
from ..sampling.sampler import SamplerKind
from ..scene import CompiledScene, Scene
from ..utils.profiler import named_zone
from .camera import CameraParams, camera_consts, camera_params, generate_rays
from .integrator import trace_paths, trace_paths_regen

log = logging.getLogger("zwrt")


TILE = 32  # pixel-block side for tiled ray order

# Lane arrays of the regenerating path (per-lane plans included) are padded
# to a multiple of this, so plan lengths take few distinct shapes.
LANE_BLOCK = 1024


def pick_tile(width: int, band_rows: int) -> int | None:
    """Use tiled ray order when the chunk is big enough for padding to a
    TILE multiple to be negligible; tiny (test-sized) renders stay flat."""
    if width >= 2 * TILE and band_rows >= TILE:
        return TILE
    return None


def ray_grid(width, height, band_y0, band_rows, sample0, spp_chunk, tile=None):
    """(px, py, sample_idx, ray_id) arrays for one chunk.

    The global ray id is ``(sample * height + y) * width + x`` — the RNG
    content address (u32; callers must keep W*H*spp < 2^32).  Because all
    randomness is content-addressed by (sample, y, x), the EMISSION ORDER of
    rays is free: with ``tile`` set, pixels are emitted in (sample, block_y,
    block_x, in_y, in_x) order so every group of tile*tile consecutive rays
    is a compact image block, and neighbouring lanes trace neighbouring
    rays.  ``unflatten_radiance`` undoes the order with
    pure reshapes/transposes (no gathers).  Padded rows/columns are clamped
    to the last valid pixel and sliced away by the caller.
    """
    s = sample0 + jnp.arange(spp_chunk, dtype=jnp.int32)
    if tile is None:
        y = band_y0 + jnp.arange(band_rows, dtype=jnp.int32)
        x = jnp.arange(width, dtype=jnp.int32)
        sg, yg, xg = jnp.meshgrid(s, y, x, indexing="ij")
        px = xg.reshape(-1)
        py = jnp.minimum(yg.reshape(-1), height - 1)  # clamp padded rows
    else:
        rows_p = -(-band_rows // tile) * tile
        width_p = -(-width // tile) * tile
        by = jnp.arange(rows_p // tile, dtype=jnp.int32)
        bx = jnp.arange(width_p // tile, dtype=jnp.int32)
        iy = jnp.arange(tile, dtype=jnp.int32)
        ix = jnp.arange(tile, dtype=jnp.int32)
        sg, byg, bxg, iyg, ixg = jnp.meshgrid(s, by, bx, iy, ix, indexing="ij")
        px = jnp.minimum((bxg * tile + ixg).reshape(-1), width - 1)
        py = jnp.minimum(
            band_y0 + (byg * tile + iyg).reshape(-1), height - 1
        )
        sg = sg
    sidx = sg.reshape(-1)
    ray_id = (
        (sidx.astype(jnp.uint32) * jnp.uint32(height) + py.astype(jnp.uint32))
        * jnp.uint32(width)
        + px.astype(jnp.uint32)
    )
    return px, py, sidx, ray_id


def unflatten_radiance(rad, width, band_rows, spp_chunk, tile):
    """(N, 3) radiance in ray_grid order -> (spp_chunk, band_rows, width, 3)
    (pure reshape/transpose; padded pixels sliced off)."""
    if tile is None:
        return rad.reshape(spp_chunk, band_rows, width, 3)
    rows_p = -(-band_rows // tile) * tile
    width_p = -(-width // tile) * tile
    rad = rad.reshape(
        spp_chunk, rows_p // tile, width_p // tile, tile, tile, 3
    )
    rad = rad.transpose(0, 1, 3, 2, 4, 5).reshape(
        spp_chunk, rows_p, width_p, 3
    )
    return rad[:, :band_rows, :width]


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "band_rows", "spp_chunk", "spp",
        "max_depth", "sampler", "has_dof", "rr", "clamp",
    ),
)
def _render_band(
    scene: CompiledScene,
    cam: CameraParams,
    seed: jnp.ndarray,      # u32 scalar
    band_y0: jnp.ndarray,   # scalar i32
    sample0: jnp.ndarray,   # scalar i32
    *,
    width: int,
    height: int,
    band_rows: int,
    spp_chunk: int,
    spp: int,
    max_depth: int,
    sampler: SamplerKind,
    has_dof: bool,
    sample_limit: int | None = None,
    rr: int = 0,
    clamp: float = 0.0,
) -> jnp.ndarray:
    """Render one (row-band x sample-chunk) wavefront; returns the radiance
    sum over the chunk's samples, shape (band_rows, width, 3).

    ``spp`` is the TOTAL samples-per-pixel of the render — samplers derive
    their stratification geometry from it, so it must be identical across
    chunked/progressive decompositions.  ``sample_limit`` (default ``spp``)
    caps which sample indices contribute; progressive batches pass the end
    of their batch here while keeping ``spp`` at the total.  It is a
    DYNAMIC argument: sharded workers pass a per-device limit derived from
    ``axis_index`` — without it, a device whose chunk grid overshoots its
    sample slice would double-count the neighbour device's first samples
    whenever spp_chunk does not divide the slice."""
    with named_zone("Renderer::render"):
        tile = pick_tile(width, band_rows)
        px, py, sidx, ray_id = ray_grid(
            width, height, band_y0, band_rows, sample0, spp_chunk, tile
        )
        with named_zone("sampleRay"):
            origin, direction, time = generate_rays(
                cam, has_dof, sampler, seed, ray_id, px, py, sidx,
                spp, width, height,
            )
        with named_zone("rayColorLine"):
            radiance = trace_paths(
                scene, origin, direction, time, seed, ray_id, max_depth,
                rr_start=rr, clamp=clamp,
            )
        # Zero padded samples (last chunk when spp % spp_chunk != 0).
        valid = sidx < (spp if sample_limit is None else sample_limit)
        rad = radiance.to_array() * valid[..., None]
        return unflatten_radiance(rad, width, band_rows, spp_chunk, tile).sum(
            axis=0
        )


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "band_rows", "s_par", "spp",
        "max_depth", "sampler", "has_dof", "cam_consts", "want_work", "rr", "clamp",
    ),
)
def _render_band_regen(
    scene: CompiledScene,
    seed: jnp.ndarray,      # u32 scalar
    band_y0: jnp.ndarray,   # scalar i32
    sample0: jnp.ndarray,   # scalar i32
    *,
    width: int,
    height: int,
    band_rows: int,
    s_par: int,             # samples in flight per pixel (slot parallelism)
    spp: int,               # TOTAL spp (sampler stratification geometry)
    sample_limit,           # first sample index NOT rendered (dynamic: the
                            # sharded renderer passes a per-device value)
    max_depth: int,
    sampler: SamplerKind,
    has_dof: bool,
    cam_consts,             # static float tuple (camera_consts)
    want_work: bool = False,
    rr: int = 0,
    clamp: float = 0.0,
):
    """Regenerating-wavefront band render: each of band_rows*width*s_par
    lanes traces its pixel's samples {sample0 + k + j*s_par} < sample_limit
    one after another (integrator.trace_paths_regen).  Returns
    the radiance sum over those samples, (band_rows, width, 3) — plus the
    per-lane traced-call counts (lane order) when ``want_work``, the cost
    signal for the profile-guided balancer."""
    with named_zone("Renderer::render"):
        tile = pick_tile(width, band_rows)
        px, py, sidx, _ = ray_grid(
            width, height, band_y0, band_rows, sample0, s_par, tile
        )
        n = px.shape[0]
        n_pad = -(-n // LANE_BLOCK) * LANE_BLOCK
        limit = jnp.full((n,), sample_limit, jnp.int32)
        if n_pad != n:
            # padding slots get limit 0 -> never respawn
            px = jnp.concatenate([px, jnp.zeros((n_pad - n,), px.dtype)])
            py = jnp.concatenate([py, jnp.zeros((n_pad - n,), py.dtype)])
            sidx = jnp.concatenate(
                [sidx, jnp.zeros((n_pad - n,), sidx.dtype)]
            )
            limit = jnp.concatenate(
                [limit, jnp.zeros((n_pad - n,), limit.dtype)]
            )
        out = trace_paths_regen(
            scene, cam_consts, seed, px, py, sidx, limit,
            sampler=sampler, width=width, height=height, spp=spp,
            stride=s_par, max_depth=max_depth,
            has_dof=has_dof, want_work=want_work, rr_start=rr, clamp=clamp,
        )
        radiance = out[0] if want_work else out
        rad = radiance.to_array()[:n]
        fb = unflatten_radiance(rad, width, band_rows, s_par, tile).sum(
            axis=0
        )
        if want_work:
            return fb, out[1][:n]
        return fb


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "band_rows", "spp", "max_depth", "sampler",
        "has_dof", "cam_consts", "rr", "clamp",
    ),
)
def _render_band_balanced(
    scene: CompiledScene,
    seed: jnp.ndarray,      # u32 scalar
    band_y0: jnp.ndarray,   # scalar i32
    px: jnp.ndarray,        # (M,) i32 per-lane pixel column
    py: jnp.ndarray,        # (M,) i32 per-lane pixel row
    s0: jnp.ndarray,        # (M,) i32 per-lane first sample
    s1: jnp.ndarray,        # (M,) i32 per-lane sample limit (s1 <= s0: dead)
    *,
    width: int,
    height: int,
    band_rows: int,
    spp: int,
    max_depth: int,
    sampler: SamplerKind,
    has_dof: bool,
    cam_consts,
    rr: int = 0,
    clamp: float = 0.0,
) -> jnp.ndarray:
    """Balanced-plan band render: lanes carry explicit (pixel, sample-range)
    work items produced by ``build_balance_plan``; per-lane radiance sums are
    scatter-added into the band framebuffer (each (pixel, sample) pair is
    owned by exactly one lane, so there are no races by construction —
    the balanced analog of the reference's disjoint pixel blocks,
    src/render.zig:55-73)."""
    with named_zone("Renderer::render"):
        radiance = trace_paths_regen(
            scene, cam_consts, seed, px, py, s0, s1,
            sampler=sampler, width=width, height=height, spp=spp,
            stride=1, max_depth=max_depth, has_dof=has_dof, rr_start=rr, clamp=clamp,
        )
        pixflat = (py - band_y0) * width + px
        fb = jnp.zeros((band_rows * width, 3), real)
        fb = fb.at[pixflat].add(radiance.to_array())
        return fb.reshape(band_rows, width, 3)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "sampler", "has_dof"),
)
def _first_hit_probe(
    scene: CompiledScene,
    cam: CameraParams,
    seed: jnp.ndarray,
    px: jnp.ndarray,
    py: jnp.ndarray,
    *,
    width: int,
    height: int,
    spp: int,
    sampler: SamplerKind,
    has_dof: bool,
):
    """First-hit (kind, idx) of each pixel's sample-0 primary ray — the
    ray-coherence key for BVH-scene lane packing (one trace pass, no
    shading)."""
    from ..ops.trace import closest_hit

    sidx = jnp.zeros_like(px)
    ray_id = (
        py.astype(jnp.uint32) * jnp.uint32(width) + px.astype(jnp.uint32)
    )
    origin, direction, time = generate_rays(
        cam, has_dof, sampler, seed, ray_id, px, py, sidx,
        spp, width, height,
    )
    hit = closest_hit(scene, origin, direction, time, 1e-4, jnp.inf)
    return hit.kind, hit.idx


def tile_order_lane_index(width, band_rows, tile):
    """(band_rows, width) array of each pixel's lane index in the tiled
    ray_grid order (s_par=1), accounting for tile padding."""
    if tile is None:
        return np.arange(band_rows * width).reshape(band_rows, width)
    nbx = -(-width // tile)
    y = np.arange(band_rows)[:, None]
    x = np.arange(width)[None, :]
    by, iy = y // tile, y % tile
    bx, ix = x // tile, x % tile
    return (((by * nbx + bx) * tile + iy) * tile) + ix


def build_balance_plan(
    work_px: np.ndarray,   # (rows, width) per-pixel cost from the est pass
    band_y0: int,
    spp_est: int,
    spp: int,
    budget_lanes: int,     # M: total lanes (LANE_BLOCK multiple)
    tile,
):
    """Profile-guided lane plan: split each pixel's remaining samples
    [spp_est, spp) across ~cost-proportional lane counts so every lane
    carries roughly equal predicted work (cost x samples).  Pixels are
    emitted in tile-traversal order (lanes of one pixel adjacent), so
    neighbouring lanes trace neighbouring rays.  Returns (px, py, s0, s1)
    i32 arrays of length ``budget_lanes``; surplus lanes are dead
    (s1 == s0 == 0)."""
    rows, width = work_px.shape
    lane_idx = tile_order_lane_index(width, rows, tile).reshape(-1)
    order = np.argsort(lane_idx, kind="stable")  # pixels in tile order

    cost = np.maximum(work_px.reshape(-1).astype(np.float64), 1.0)[order]
    ys = (np.repeat(np.arange(rows), width) + band_y0)[order]
    xs = np.tile(np.arange(width), rows)[order]

    n_pix = cost.size
    r = spp - spp_est
    extra = max(0, budget_lanes - n_pix)
    share = extra * cost / cost.sum()
    k = 1 + np.floor(share).astype(np.int64)
    rem = budget_lanes - int(k.sum())
    if rem > 0:
        frac_order = np.argsort(-(share - np.floor(share)), kind="stable")
        k[frac_order[:rem]] += 1
    k = np.minimum(k, max(r, 1))  # never more lanes than samples

    total = int(k.sum())
    px = np.repeat(xs, k)
    py = np.repeat(ys, k)
    starts = np.cumsum(k) - k
    j = np.arange(total) - np.repeat(starts, k)
    kk = np.repeat(k, k)
    s0 = spp_est + (j * r) // kk
    s1 = spp_est + ((j + 1) * r) // kk

    pad = budget_lanes - total
    if pad:
        px = np.concatenate([px, np.zeros(pad, np.int64)])
        py = np.concatenate([py, np.full(pad, band_y0, np.int64)])
        s0 = np.concatenate([s0, np.zeros(pad, np.int64)])
        s1 = np.concatenate([s1, np.zeros(pad, np.int64)])
    return (
        px.astype(np.int32), py.astype(np.int32),
        s0.astype(np.int32), s1.astype(np.int32),
    )


@dataclasses.dataclass
class Renderer:
    """User-facing render configuration (reference: Renderer struct,
    src/render.zig:19-27 + UserArgs, src/main.zig:20-28)."""

    samples_per_pixel: int = 10
    max_ray_bounce_depth: int = 20
    sampler: SamplerKind = SamplerKind.SOBOL  # the reference hardcodes Sobol
    # pixel jitter (src/render.zig:115-121); independent/stratified selectable
    seed: int = 0
    # Max rays in flight per chunk; bounds transient device memory.
    max_rays_per_chunk: int = 1 << 21
    # Per-bounce reference on BVH scenes: chunked finer because the BVH
    # while_loop keeps a larger live set per ray.  The value dates from an
    # earlier accelerator; whether the GPU needs it is unmeasured.
    max_rays_per_chunk_bvh: int = 1 << 17
    # Russian roulette from this bounce index (0 = off, the reference
    # semantics).  Unbiased tail cut: from bounce d >= russian_roulette a
    # path continues with p = clamp(max(throughput), RR_P_MIN, 1) and
    # survivors carry the 1/p weight (integrator.bounce_step docstring).
    # Ignored on image-texture scenes.
    russian_roulette: int = 0
    # Indirect luminance clamp (0 = off, the reference semantics): any
    # radiance contribution landed at bounce >= 1 is luminance-scaled to
    # at most this value — biased firefly suppression, Cycles-style
    # (integrator.bounce_step docstring).  Same image-scene gate as RR.
    clamp_indirect: float = 0.0

    def chunk_geometry(self, scene: Scene, width: int, height: int, spp_req: int):
        """(spp_chunk, band_rows) chunk sizing of the per-bounce reference,
        including the BVH wavefront cap."""
        max_rays = (
            self.max_rays_per_chunk_bvh
            if scene.compiled.has_bvh
            else self.max_rays_per_chunk
        )
        # Fit as many samples per chunk as possible, then split rows if a
        # single-sample pass is still too large.
        spp_chunk = max(1, min(spp_req, max_rays // max(width * height, 1)))
        band_rows = max(1, min(height, max_rays // (width * spp_chunk)))
        return spp_chunk, band_rows

    # Minimum lanes in flight on the regenerating path: a render with fewer
    # pixels runs ceil(regen_min_wave / pixels) samples of each pixel side
    # by side.  Beyond it, fewer parallel samples per pixel shorten the
    # straggler tail of long paths (sequential samples average it out).
    # Tuned on an earlier accelerator; unmeasured on the GPU.
    regen_min_wave: int = 1 << 17
    # Profile-guided load balancing (s_par == 1): a cheap estimation pass
    # (spp/16 samples, which still contribute to the image) measures
    # per-pixel path cost; the remaining samples are then split across
    # cost-proportional lane counts so expensive pixels don't make the
    # whole wavefront wait.  Off by default (0): it is for workloads with
    # extreme per-pixel cost skew.  ZWRT_NO_BALANCE=1 force-disables.
    balance_min_spp: int = 0
    balance_overprovision: float = 1.3
    # Temporal cost-map reuse (brute-force scenes): the first render of a
    # given (scene, size, spp) measures per-pixel path cost with the work
    # counter; subsequent renders place similar-cost pixels in neighbouring
    # lanes (a pure pixel permutation — the content-addressed RNG makes the
    # image invariant to it).  Only applied to scenes WITHOUT a BVH, which
    # instead get coherence-sorted lanes.  ZWRT_NO_SORT=1 disables.
    #
    # Keyed on the CompiledScene OBJECT via a WeakKeyDictionary (not id():
    # CPython recycles ids after GC, which could hand a new scene a stale
    # cost map) mapping to a per-scene {config: entry} dict bounded at
    # _plan_cache_max_configs (FIFO eviction).  Entries die with their scene.
    _plan_cache: "weakref.WeakKeyDictionary" = dataclasses.field(
        default_factory=lambda: weakref.WeakKeyDictionary(),
        repr=False, compare=False,
    )
    _plan_cache_max_configs: int = 8

    def regen_geometry(self, width: int, height: int, spp: int):
        """(s_par, band_rows) for the regenerating wavefront: just enough
        samples-in-flight per pixel to reach ``regen_min_wave`` lanes, rows
        capped by the transient-memory budget."""
        pixels = max(width * height, 1)
        s_par = max(1, min(spp, -(-self.regen_min_wave // pixels)))
        band_rows = max(
            1, min(height, self.max_rays_per_chunk // (width * s_par))
        )
        return s_par, band_rows

    def _render_band_balanced_driver(
        self, scene: Scene, seed, band_y0: int, rows_eff: int,
        band_rows: int, width: int, height: int, spp: int, has_dof, cam_c,
    ) -> jnp.ndarray:
        """Two-pass profile-guided band render: estimation pass (first
        spp_est samples; its radiance counts toward the image) measures
        per-pixel cost, then the balanced plan renders the rest."""
        # clamp to spp: with spp <= 2 the estimation pass IS the render
        # (rendering sample indices >= spp would leave Sobol's strata and
        # double-count radiance against the final /spp divide)
        spp_est = min(spp, max(2, spp // 16))
        tile = pick_tile(width, band_rows)
        fb_est, work = _render_band_regen(
            scene.compiled, seed, jnp.int32(band_y0), jnp.int32(0),
            width=width, height=height, band_rows=band_rows, s_par=1,
            spp=spp, sample_limit=spp_est,
            max_depth=self.max_ray_bounce_depth,
            sampler=self.sampler, has_dof=has_dof, cam_consts=cam_c,
            want_work=True, rr=self.russian_roulette, clamp=self.clamp_indirect,
        )
        lane_idx = tile_order_lane_index(width, band_rows, tile)
        work_px = np.asarray(work)[lane_idx.reshape(-1)].reshape(
            band_rows, width
        )[:rows_eff]
        budget = int(self.balance_overprovision * band_rows * width)
        budget = -(-budget // LANE_BLOCK) * LANE_BLOCK
        px, py, s0, s1 = build_balance_plan(
            work_px, band_y0, spp_est, spp, budget, tile
        )
        out = _render_band_balanced(
            scene.compiled, seed, jnp.int32(band_y0),
            jnp.asarray(px), jnp.asarray(py),
            jnp.asarray(s0), jnp.asarray(s1),
            width=width, height=height, band_rows=band_rows, spp=spp,
            max_depth=self.max_ray_bounce_depth, sampler=self.sampler,
            has_dof=has_dof, cam_consts=cam_c, rr=self.russian_roulette, clamp=self.clamp_indirect,
        )
        return fb_est + out

    def _render_band_sorted_driver(
        self, scene: Scene, seed, band_y0: int, rows_eff: int,
        band_rows: int, width: int, height: int, spp: int, has_dof, cam_c,
    ) -> jnp.ndarray:
        """Cost-sorted lane packing with temporal reuse: the FIRST render of
        this (scene, size, config) runs the plain regenerating band with the
        per-lane work counter and caches it; later renders sort pixels by
        that measured cost so neighbouring lanes carry similar work.  A pure
        pixel permutation: bit-identical radiance per pixel, any assignment
        order."""
        scene_cache = self._plan_cache.get(scene.compiled)
        if scene_cache is None:
            scene_cache = self._plan_cache.setdefault(scene.compiled, {})
        key = (
            width, height, band_y0, spp,
            self.max_ray_bounce_depth, self.sampler, self.seed,
        )
        entry = scene_cache.get(key)
        if entry is None:
            fb, work = _render_band_regen(
                scene.compiled, seed, jnp.int32(band_y0), jnp.int32(0),
                width=width, height=height, band_rows=band_rows,
                s_par=1, spp=spp, sample_limit=spp,
                max_depth=self.max_ray_bounce_depth,
                sampler=self.sampler, has_dof=has_dof, cam_consts=cam_c,
                want_work=True, rr=self.russian_roulette, clamp=self.clamp_indirect,
            )
            # keep the cost map on device; converted lazily at plan build
            while len(scene_cache) >= self._plan_cache_max_configs:
                scene_cache.pop(next(iter(scene_cache)))
            scene_cache[key] = {"work": work}
            return fb
        if "plan" not in entry:
            tile = pick_tile(width, band_rows)
            lane_idx = tile_order_lane_index(width, band_rows, tile)
            w = np.asarray(entry["work"])
            cost = w[lane_idx.reshape(-1)].reshape(band_rows, width)[
                :rows_eff
            ].reshape(-1)
            ys, xs = np.divmod(np.arange(cost.size), width)
            order = np.argsort(-cost, kind="stable")
            px = xs[order]
            py = ys[order] + band_y0
            n_pad = -(-cost.size // LANE_BLOCK) * LANE_BLOCK
            pad = n_pad - cost.size
            s1 = np.full(cost.size, spp, np.int64)
            if pad:
                px = np.concatenate([px, np.zeros(pad, np.int64)])
                py = np.concatenate([py, np.full(pad, band_y0, np.int64)])
                s1 = np.concatenate([s1, np.zeros(pad, np.int64)])
            entry["plan"] = tuple(
                jnp.asarray(a.astype(np.int32))
                for a in (px, py, np.zeros(n_pad, np.int64), s1)
            )
            entry.pop("work")
        pxd, pyd, s0d, s1d = entry["plan"]
        return _render_band_balanced(
            scene.compiled, seed, jnp.int32(band_y0), pxd, pyd, s0d, s1d,
            width=width, height=height, band_rows=band_rows, spp=spp,
            max_depth=self.max_ray_bounce_depth, sampler=self.sampler,
            has_dof=has_dof, cam_consts=cam_c, rr=self.russian_roulette, clamp=self.clamp_indirect,
        )

    def _render_band_coherent_driver(
        self, scene: Scene, seed, band_y0: int, rows_eff: int,
        band_rows: int, width: int, height: int, spp: int, has_dof, cam_c,
    ) -> jnp.ndarray:
        """Ray-coherence-sorted lane packing for BVH scenes (on by default;
        ZWRT_COHERENT=0 opts out): pixels are ordered by their primary
        ray's first-hit primitive (kind, idx — primitives are stored in
        Morton order, so nearby idx = nearby in space), ties kept in
        image-tile order, so neighbouring lanes start their walks in the
        same part of the tree.  A pure pixel permutation: bit-identical
        radiance per pixel."""
        scene_cache = self._plan_cache.get(scene.compiled)
        if scene_cache is None:
            scene_cache = self._plan_cache.setdefault(scene.compiled, {})
        key = (
            "coh", width, height, band_y0, spp,
            self.max_ray_bounce_depth, self.sampler, self.seed,
        )
        entry = scene_cache.get(key)
        if entry is None:
            cam = camera_params(scene.camera, width, height)
            ys, xs = np.divmod(np.arange(rows_eff * width), width)
            kind, idx = _first_hit_probe(
                scene.compiled, cam, seed,
                jnp.asarray(xs.astype(np.int32)),
                jnp.asarray((ys + band_y0).astype(np.int32)),
                width=width, height=height, spp=spp,
                sampler=self.sampler, has_dof=has_dof,
            )
            kind = np.asarray(kind).astype(np.int64)
            idx = np.asarray(idx).astype(np.int64)
            hit_key = np.where(kind < 0, -1, (kind << 24) + idx)
            tile = pick_tile(width, band_rows)
            lane_idx = tile_order_lane_index(width, band_rows, tile)
            lane_ord = lane_idx[:rows_eff].reshape(-1)
            order = np.lexsort((lane_ord, hit_key))
            px = xs[order]
            py = ys[order] + band_y0
            n_pad = -(-px.size // LANE_BLOCK) * LANE_BLOCK
            pad = n_pad - px.size
            s1 = np.full(px.size, spp, np.int64)
            if pad:
                px = np.concatenate([px, np.zeros(pad, np.int64)])
                py = np.concatenate([py, np.full(pad, band_y0, np.int64)])
                s1 = np.concatenate([s1, np.zeros(pad, np.int64)])
            while len(scene_cache) >= self._plan_cache_max_configs:
                scene_cache.pop(next(iter(scene_cache)))
            entry = scene_cache[key] = {
                "plan": tuple(
                    jnp.asarray(a.astype(np.int32))
                    for a in (px, py, np.zeros(n_pad, np.int64), s1)
                )
            }
        pxd, pyd, s0d, s1d = entry["plan"]
        return _render_band_balanced(
            scene.compiled, seed, jnp.int32(band_y0), pxd, pyd, s0d, s1d,
            width=width, height=height, band_rows=band_rows, spp=spp,
            max_depth=self.max_ray_bounce_depth, sampler=self.sampler,
            has_dof=has_dof, cam_consts=cam_c, rr=self.russian_roulette,
            clamp=self.clamp_indirect,
        )

    def render(
        self,
        scene: Scene,
        width: int,
        height: int,
    ) -> np.ndarray:
        """Renders and returns the linear-space framebuffer (H, W, 3) f32
        averaged over samples (the analog of Renderer.render,
        src/render.zig:29-74)."""
        return np.asarray(self.render_device(scene, width, height))

    def render_supersampled(
        self,
        scene: Scene,
        width: int,
        height: int,
        k: int = 2,
    ) -> jnp.ndarray:
        """Render at (k*width, k*height) with spp/k^2 samples per subpixel
        and box-downsample to (height, width, 3) on device.

        Estimator: identical box pixel filter as ``render`` — each pixel
        still averages ``samples_per_pixel`` rays uniform over its area
        (src/render.zig:115-121 jitters uniform in-pixel; here the k^2
        subpixels stratify that area), so the result is unbiased for the
        same image and usually LOWER variance (stratification).  It is not
        bitwise-equal to ``render`` (different sample positions).
        """
        if k < 1:
            raise ValueError(f"supersample factor must be >= 1, got {k}")
        if k == 1:
            return self.render_device(scene, width, height)
        spp = self.samples_per_pixel
        if spp % (k * k):
            raise ValueError(
                f"samples_per_pixel={spp} must be divisible by k^2={k * k} "
                "for supersampled rendering (each subpixel renders "
                "spp/k^2 samples)"
            )
        sub = dataclasses.replace(self, samples_per_pixel=spp // (k * k))
        if self.sampler == SamplerKind.SOBOL:
            # Sobol pixel offsets are [0,1) around pixel00 (PBRT raster
            # convention, parity with the reference src/math/sampler.zig:
            # 222-233): pixel p covers [(p+.5)d, (p+1.5)d), a half-pixel
            # anchor that SCALES with resolution.  Shift the k-res grid by
            # (k-1)/2 sub-pixels so the k^2 subpixels tile each base
            # pixel's coverage exactly (without this the image lands
            # (k-1)/2k base pixels off and edges double: measured 10x MSE
            # on cornell before the fix, tests/test_supersample.py).
            s = (k - 1) / 2.0
            scene = dataclasses.replace(
                scene,
                camera=dataclasses.replace(
                    scene.camera,
                    raster_shift=(
                        scene.camera.raster_shift[0] + s,
                        scene.camera.raster_shift[1] + s,
                    ),
                ),
            )
        fb = sub.render_device(scene, width * k, height * k)
        return fb.reshape(height, k, width, k, 3).mean(axis=(1, 3))

    def render_adaptive(
        self,
        scene: Scene,
        width: int,
        height: int,
        *,
        pilot_spp: int = 0,
        return_stats: bool = False,
    ):
        """Variance-guided adaptive render at the same TOTAL sample budget
        as ``render`` (samples_per_pixel x pixels), re-allocated per pixel
        by measured noise — see render/adaptive.py.  Returns the averaged
        (H, W, 3) framebuffer on device."""
        from .adaptive import render_adaptive

        return render_adaptive(
            self, scene, width, height,
            pilot_spp=pilot_spp, return_stats=return_stats,
        )

    def _check_ray_ids(self, width: int, height: int) -> None:
        spp = self.samples_per_pixel
        if self.sampler == SamplerKind.SOBOL and spp & (spp - 1):
            log.warning(
                "Non power of two samples per pixel will perform poorly "
                "with sobol sampling: %d", spp,
            )  # parity: src/math/sampler.zig:184-186
        if width * height * spp >= 2**32:
            # a survivable config error, not an invariant — must hold under
            # python -O too (the u32 ray id is the RNG content address)
            raise ValueError(
                f"ray id space {width}x{height}x{spp} exceeds u32; reduce "
                "spp or render progressively (render/progressive.py)"
            )

    def render_device(
        self,
        scene: Scene,
        width: int,
        height: int,
    ) -> jnp.ndarray:
        """``render`` without the copy to the host: the averaged (H, W, 3)
        framebuffer as a device array.  Regenerating wavefront, one wave
        per row band covering all samples."""
        self._check_ray_ids(width, height)
        spp = self.samples_per_pixel
        has_dof = scene.camera.has_depth_of_field
        seed = jnp.uint32(self.seed)
        s_par, band_rows = self.regen_geometry(width, height, spp)
        balance = (
            s_par == 1
            and self.balance_min_spp > 0
            and spp >= self.balance_min_spp
            and not os.environ.get("ZWRT_NO_BALANCE")
        )
        n_bands = -(-height // band_rows)
        fb = jnp.zeros((n_bands * band_rows, width, 3), real)
        cam_c = camera_consts(scene.camera, width, height)
        has_bvh = scene.compiled.has_bvh
        sortable = (
            s_par == 1
            and not balance
            and not has_bvh
            and not os.environ.get("ZWRT_NO_SORT")
        )
        coherent = (
            s_par == 1
            and not balance
            and has_bvh
            and os.environ.get("ZWRT_COHERENT", "1") not in ("", "0")
        )
        for b in range(n_bands):
            if balance:
                driver = self._render_band_balanced_driver
            elif coherent:
                driver = self._render_band_coherent_driver
            elif sortable:
                driver = self._render_band_sorted_driver
            else:
                driver = None
            if driver is not None:
                out = driver(
                    scene, seed, b * band_rows,
                    min(band_rows, height - b * band_rows),
                    band_rows, width, height, spp, has_dof, cam_c,
                )
            else:
                out = _render_band_regen(
                    scene.compiled, seed,
                    jnp.int32(b * band_rows), jnp.int32(0),
                    width=width, height=height, band_rows=band_rows,
                    s_par=s_par, spp=spp, sample_limit=spp,
                    max_depth=self.max_ray_bounce_depth,
                    sampler=self.sampler, has_dof=has_dof,
                    cam_consts=cam_c, rr=self.russian_roulette,
                    clamp=self.clamp_indirect,
                )
            fb = fb.at[b * band_rows : (b + 1) * band_rows].add(out)
        return fb[:height] / real(spp)

    def render_reference(
        self,
        scene: Scene,
        width: int,
        height: int,
    ) -> jnp.ndarray:
        """The same image through the per-bounce reference integrator
        (``integrator.trace_paths``): camera rays in (row band x sample
        chunk) wavefronts that bounce together.  Same estimator and random
        numbers as ``render_device``; tests compare the two.  Returns the
        averaged (H, W, 3) framebuffer as a device array."""
        self._check_ray_ids(width, height)
        spp = self.samples_per_pixel
        cam = camera_params(scene.camera, width, height)
        has_dof = scene.camera.has_depth_of_field
        seed = jnp.uint32(self.seed)
        spp_chunk, band_rows = self.chunk_geometry(scene, width, height, spp)
        n_bands = -(-height // band_rows)
        h_pad = n_bands * band_rows
        fb = jnp.zeros((h_pad, width, 3), real)
        n_chunks = -(-spp // spp_chunk)
        for b in range(n_bands):
            for c in range(n_chunks):
                out = _render_band(
                    scene.compiled, cam, seed,
                    jnp.int32(b * band_rows), jnp.int32(c * spp_chunk),
                    width=width, height=height, band_rows=band_rows,
                    spp_chunk=spp_chunk, spp=spp,
                    max_depth=self.max_ray_bounce_depth,
                    sampler=self.sampler, has_dof=has_dof,
                    rr=self.russian_roulette, clamp=self.clamp_indirect,
                )
                fb = fb.at[b * band_rows : (b + 1) * band_rows].add(out)
        return fb[:height] / real(spp)
