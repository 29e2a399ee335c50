"""Sharded rendering with ``jax.shard_map`` over a 1-D device mesh.

Because all randomness is content-addressed by global ray id
(sampling/hashrng.py), the sharded render is bitwise-identical to the
single-device render — this is verified by the chip-count-invariance tests
(tests/test_parallel.py), the distributed analog of golden-image testing.

Each device runs the single-device production path inside its shard:
the regenerating wavefront (``renderer._render_band_regen`` and
``renderer._render_band_balanced``).  Per-device transient memory is
bounded exactly like the single-device path — a 400x400 @1000spp render
sharded 8 ways never materializes more than one band of rays per device.  Neither ``spp`` nor ``height`` needs to divide the device count:
shards are padded and the padded samples/rows are masked out (samples) or
sliced off (rows), the multi-chip analog of the reference's arbitrary work
decomposition (src/render.zig:55-73).
"""

from __future__ import annotations

import os
import weakref
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..dtypes import real
from ..render.camera import camera_consts
from ..render.renderer import (
    LANE_BLOCK,
    Renderer,
    _render_band_balanced,
    _render_band_regen,
    pick_tile,
    tile_order_lane_index,
)
from ..sampling.sampler import SamplerKind
from ..scene import Scene
from .mesh import AXIS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# Memoized jitted shard_map closures.  Without this, every render_sharded
# call rebuilt `worker` + jax.jit(shard_map(...)), so repeated calls (e.g.
# progressive sharded renders, or the shard-overhead bench) re-traced the
# whole pipeline each time -- jit's cache is keyed on function identity and
# a fresh closure never hits it.  Keyed on the CompiledScene OBJECT via a
# WeakKeyDictionary (ids are recycled after GC) -> {config key: jitted fn},
# bounded per scene with FIFO eviction like renderer._plan_cache.  All
# values a worker closure bakes in (size/spp/depth/sampler/camera consts/
# mesh devices/shard mode/rr/clamp/chunk budget) appear in the config key.
_sharded_fn_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_SHARDED_CACHE_MAX_CONFIGS = 8


def _memo_sharded(compiled, key, build):
    per = _sharded_fn_cache.get(compiled)
    if per is None:
        per = {}
        _sharded_fn_cache[compiled] = per
    fn = per.get(key)
    if fn is None:
        if len(per) >= _SHARDED_CACHE_MAX_CONFIGS:
            per.pop(next(iter(per)))
        fn = build()
        per[key] = fn
    return fn


# Cost-sorted lane plans for the sharded path, mirroring the single-device
# Renderer._render_band_sorted_driver (renderer.py): the FIRST sharded
# render of a config runs the plain regenerating band with the per-lane
# work counter (psum'd across devices — the total per-pixel cost is the
# right signal for any device's sample/row slice); later renders feed
# cost-sorted (px, py) plans to the balanced band.
_sharded_plan_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _memo_plan_entry(compiled, key):
    per = _sharded_plan_cache.get(compiled)
    if per is None:
        per = {}
        _sharded_plan_cache[compiled] = per
    entry = per.get(key)
    if entry is None:
        while len(per) >= _SHARDED_CACHE_MAX_CONFIGS:
            per.pop(next(iter(per)))
        entry = {}
        per[key] = entry
    return entry


def _sorted_plan(work_lane, width, band_rows, rows_eff, band_y0, n_items):
    """(px, py, live) for one band: pixels sorted by measured cost
    (descending, stable), padded to ``n_items``; ``live`` marks real
    items (padding gets live=0 -> the worker gives them an empty sample
    range).  Same construction as the single-chip sorted driver; the
    per-device sample range is NOT baked here — workers derive (s0, s1)
    from axis_index at trace time, so one plan serves every device."""
    lane_idx = tile_order_lane_index(
        width, band_rows, pick_tile(width, band_rows)
    )
    w = np.asarray(work_lane)
    cost = w[lane_idx.reshape(-1)].reshape(band_rows, width)[
        :max(rows_eff, 0)
    ].reshape(-1)
    ys, xs = np.divmod(np.arange(cost.size), width)
    order = np.argsort(-cost, kind="stable")
    px = xs[order]
    py = ys[order] + band_y0
    pad = n_items - cost.size
    live = np.ones(cost.size, np.int64)
    if pad:
        px = np.concatenate([px, np.zeros(pad, np.int64)])
        py = np.concatenate([py, np.full(pad, band_y0, np.int64)])
        live = np.concatenate([live, np.zeros(pad, np.int64)])
    return tuple(
        jnp.asarray(a.astype(np.int32)) for a in (px, py, live)
    )


def _plan_items(rows: int, width: int, blk: int) -> int:
    return -(-(rows * width) // blk) * blk


def _sortable(compiled, s_par) -> bool:
    # Same gate as render_device: cost-sorting needs s_par == 1 (one lane
    # owns a pixel's whole sample range) and a scene without a BVH.
    return (
        s_par == 1
        and not compiled.has_bvh
        and not os.environ.get("ZWRT_NO_SORT")
    )


def render_sharded(
    scene: Scene,
    width: int,
    height: int,
    samples_per_pixel: int,
    max_depth: int = 20,
    sampler: SamplerKind = SamplerKind.SOBOL,
    mesh: Optional[Mesh] = None,
    shard: str = "samples",
    seed: int = 0,
    max_rays_per_chunk: int = 1 << 21,
    rr: int = 0,
    clamp: float = 0.0,
    regen_min_wave: Optional[int] = None,
    sample0: int = 0,
    sample_count: Optional[int] = None,
    normalize: bool = True,
):
    """Render across a device mesh.  Returns (H, W, 3) f32 averaged samples.

    ``shard='samples'``: every device renders all pixels with a disjoint
    sample slice; framebuffers are summed with one ``psum``.

    ``shard='rows'``: devices render disjoint row bands (zero collectives;
    the direct analog of the reference's pixel-block partitioning,
    src/render.zig:60).

    ``sample0``/``sample_count`` restrict the render to the
    sample-index range [sample0, sample0+sample_count) — the sharded twin
    of render/progressive.py:_render_batch, so progressive checkpoints
    compose with sharding (render_batch_sharded wraps this).  ``sample0``
    is a DYNAMIC scalar input of the compiled pipeline: every progressive
    batch reuses ONE compiled function per (geometry, sample_count)
    instead of recompiling per batch.  ``normalize=False`` returns the
    radiance SUM instead of the spp-average (what a checkpoint
    accumulates).  ``samples_per_pixel`` stays the render TOTAL so
    samplers keep their stratification geometry across batches.
    """
    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh()
    n_dev = mesh.devices.size
    compiled = scene.compiled
    has_dof = scene.camera.has_depth_of_field
    seed_arr = jnp.uint32(seed)
    spp = samples_per_pixel
    spp_now = spp - sample0 if sample_count is None else sample_count
    s_end = min(sample0 + spp_now, spp)
    # dynamic range scalars: shard_map inputs, NOT baked into the closure
    s_base_arr = jnp.int32(sample0)
    s_cap_arr = jnp.int32(s_end)

    def _norm(fb):
        return fb / real(spp) if normalize else fb

    # Per-device chunk geometry (identical on every device; static).
    chunker = Renderer(
        samples_per_pixel=spp, max_rays_per_chunk=max_rays_per_chunk,
        max_ray_bounce_depth=max_depth, sampler=sampler,
        **({"regen_min_wave": regen_min_wave}
           if regen_min_wave is not None else {}),
    )
    cam_c = camera_consts(scene.camera, width, height)
    cfg_key = (
        shard, width, height, spp, spp_now, max_depth, sampler,
        has_dof, rr, clamp, max_rays_per_chunk, regen_min_wave, cam_c,
        tuple(int(d.id) for d in mesh.devices.flat), tuple(mesh.axis_names),
    )

    if shard == "samples":
        # Pad the sample axis: devices own ceil(spp_now / n_dev) sample
        # indices each; indices >= s_end never render (per-lane limit).
        spp_local = _cdiv(spp_now, n_dev)

        s_par, band_rows = chunker.regen_geometry(
            width, height, spp_local
        )
        n_bands = _cdiv(height, band_rows)
        h_pad = n_bands * band_rows
        sortable = _sortable(compiled, s_par)
        plan_entry = (
            _memo_plan_entry(compiled, cfg_key + (seed,))
            if sortable else None
        )

        if sortable and "plans" in plan_entry:
            # Steady state: cost-sorted plans through the balanced
            # kernel; per-device sample range derived from axis_index.
            plans = plan_entry["plans"]

            def worker_sorted(compiled, seed, s_base, s_cap, *plan_flat):
                di = jax.lax.axis_index(AXIS)
                s0 = s_base + (di * spp_local).astype(jnp.int32)
                limit = jnp.minimum(s_cap, s0 + jnp.int32(spp_local))
                fb = jnp.zeros((h_pad, width, 3), real)
                for b in range(n_bands):
                    pxd, pyd, lived = plan_flat[3 * b : 3 * b + 3]
                    out = _render_band_balanced(
                        compiled, seed, jnp.int32(b * band_rows),
                        pxd, pyd,
                        jnp.where(lived > 0, s0, 0),
                        jnp.where(lived > 0, limit, 0),
                        width=width, height=height, band_rows=band_rows,
                        spp=spp, max_depth=max_depth, sampler=sampler,
                        has_dof=has_dof, cam_consts=cam_c,
                        rr=rr, clamp=clamp,
                    )
                    fb = fb.at[b * band_rows : (b + 1) * band_rows].add(
                        out
                    )
                return jax.lax.psum(fb[:height], AXIS)

            flat = tuple(a for p in plans for a in p)
            fn = _memo_sharded(
                compiled, cfg_key + ("sorted",), lambda: jax.jit(
                    jax.shard_map(
                        worker_sorted, mesh=mesh,
                        in_specs=(P(),) * 4 + (P(),) * len(flat),
                        out_specs=P(), check_vma=False,
                    )
                )
            )
            return _norm(fn(compiled, seed_arr, s_base_arr, s_cap_arr,
                            *flat))

        def worker(compiled, seed, s_base, s_cap):
            di = jax.lax.axis_index(AXIS)
            s0 = s_base + (di * spp_local).astype(jnp.int32)
            limit = jnp.minimum(s_cap, s0 + jnp.int32(spp_local))
            fb = jnp.zeros((h_pad, width, 3), real)
            works = []
            for b in range(n_bands):
                out = _render_band_regen(
                    compiled, seed, jnp.int32(b * band_rows), s0,
                    width=width, height=height, band_rows=band_rows,
                    s_par=s_par, spp=spp, sample_limit=limit,
                    max_depth=max_depth, sampler=sampler,
                    has_dof=has_dof, cam_consts=cam_c, rr=rr, clamp=clamp,
                    want_work=sortable,
                )
                if sortable:
                    out, wk = out
                    works.append(wk)
                fb = fb.at[b * band_rows : (b + 1) * band_rows].add(out)
            fbp = jax.lax.psum(fb[:height], AXIS)
            if sortable:
                return fbp, jax.lax.psum(jnp.stack(works), AXIS)
            return fbp

        fn = _memo_sharded(
            compiled, cfg_key + ("work" if sortable else "plain",),
            lambda: jax.jit(
                jax.shard_map(
                    worker, mesh=mesh, in_specs=(P(),) * 4,
                    out_specs=(P(), P()) if sortable else P(),
                    check_vma=False,
                )
            )
        )
        if not sortable:
            return _norm(fn(compiled, seed_arr, s_base_arr, s_cap_arr))
        fb, works = fn(compiled, seed_arr, s_base_arr, s_cap_arr)
        works = np.asarray(works)
        plan_entry["plans"] = [
            _sorted_plan(
                works[b], width, band_rows,
                min(band_rows, height - b * band_rows),
                b * band_rows,
                _plan_items(
                    min(band_rows, height - b * band_rows), width,
                    LANE_BLOCK,
                ),
            )
            for b in range(n_bands)
        ]
        return _norm(fb)

    if shard == "rows":
        # Pad the row axis: devices own ceil(height / n_dev) rows each;
        # ray_grid clamps padded rows and the result is sliced to height.
        rows_local = _cdiv(height, n_dev)

        s_par, band_rows = chunker.regen_geometry(
            width, rows_local, spp_now
        )
        band_rows = min(band_rows, rows_local)
        n_bands = _cdiv(rows_local, band_rows)
        rows_pad = n_bands * band_rows
        sortable = _sortable(compiled, s_par)
        plan_entry = (
            _memo_plan_entry(compiled, cfg_key + (seed,))
            if sortable else None
        )

        if sortable and "plans" in plan_entry:
            # Steady state: per-(device, band) cost-sorted plans.  Row
            # shards see different pixels, so plans are stacked along a
            # leading device axis and sharded in with P(AXIS); every
            # device's slice has the same (full-band) item count.
            plans = plan_entry["plans"]  # [band] -> (px, py, live),
            #                              each (n_dev, n_items)

            def worker_sorted(compiled, seed, s_base, s_cap, *plan_flat):
                di = jax.lax.axis_index(AXIS)
                y0_base = (di * rows_local).astype(jnp.int32)
                fb = jnp.zeros((rows_pad, width, 3), real)
                for b in range(n_bands):
                    pxd, pyd, lived = (
                        a[0] for a in plan_flat[3 * b : 3 * b + 3]
                    )
                    out = _render_band_balanced(
                        compiled, seed,
                        y0_base + jnp.int32(b * band_rows),
                        pxd, pyd,
                        jnp.where(lived > 0, s_base, 0),
                        jnp.where(lived > 0, s_cap, 0),
                        width=width, height=height, band_rows=band_rows,
                        spp=spp, max_depth=max_depth, sampler=sampler,
                        has_dof=has_dof, cam_consts=cam_c,
                        rr=rr, clamp=clamp,
                    )
                    fb = fb.at[b * band_rows : (b + 1) * band_rows].add(
                        out
                    )
                return fb[:rows_local]

            flat = tuple(a for p in plans for a in p)
            fn = _memo_sharded(
                compiled, cfg_key + ("sorted",), lambda: jax.jit(
                    jax.shard_map(
                        worker_sorted, mesh=mesh,
                        in_specs=(P(),) * 4 + (P(AXIS),) * len(flat),
                        out_specs=P(AXIS), check_vma=False,
                    )
                )
            )
            return _norm(fn(
                compiled, seed_arr, s_base_arr, s_cap_arr, *flat
            )[:height])

        def worker(compiled, seed, s_base, s_cap):
            di = jax.lax.axis_index(AXIS)
            y0_base = (di * rows_local).astype(jnp.int32)
            fb = jnp.zeros((rows_pad, width, 3), real)
            works = []
            for b in range(n_bands):
                out = _render_band_regen(
                    compiled, seed,
                    y0_base + jnp.int32(b * band_rows), s_base,
                    width=width, height=height, band_rows=band_rows,
                    s_par=s_par, spp=spp, sample_limit=s_cap,
                    max_depth=max_depth, sampler=sampler,
                    has_dof=has_dof, cam_consts=cam_c, rr=rr, clamp=clamp,
                    want_work=sortable,
                )
                if sortable:
                    out, wk = out
                    works.append(wk)
                fb = fb.at[b * band_rows : (b + 1) * band_rows].add(out)
            fbd = fb[:rows_local]
            if sortable:
                return fbd, jnp.stack(works)[None]
            return fbd

        fn = _memo_sharded(
            compiled, cfg_key + ("work" if sortable else "plain",),
            lambda: jax.jit(
                jax.shard_map(
                    worker, mesh=mesh, in_specs=(P(),) * 4,
                    out_specs=(P(AXIS), P(AXIS)) if sortable else P(AXIS),
                    check_vma=False,
                )
            )
        )
        if not sortable:
            return _norm(
                fn(compiled, seed_arr, s_base_arr, s_cap_arr)[:height]
            )
        fb, works = fn(compiled, seed_arr, s_base_arr, s_cap_arr)
        works = np.asarray(works)  # (n_dev, n_bands, n_lanes)
        n_items = _plan_items(band_rows, width, LANE_BLOCK)
        plans = []
        for b in range(n_bands):
            per_dev = []
            for d in range(n_dev):
                y0 = d * rows_local + b * band_rows
                per_dev.append(_sorted_plan(
                    works[d, b], width, band_rows,
                    min(band_rows, height - y0), y0, n_items,
                ))
            plans.append(tuple(
                jnp.stack([p[i] for p in per_dev]) for i in range(3)
            ))
        plan_entry["plans"] = plans
        return _norm(fb[:height])

    raise ValueError(f"unknown shard mode: {shard}")


def render_batch_sharded(
    scene: Scene,
    width: int,
    height: int,
    total_spp: int,
    sample0: int,
    spp_now: int,
    max_depth: int = 20,
    sampler: SamplerKind = SamplerKind.SOBOL,
    mesh: Optional[Mesh] = None,
    shard: str = "samples",
    seed: int = 0,
    max_rays_per_chunk: int = 1 << 21,
    rr: int = 0,
    clamp: float = 0.0,
    regen_min_wave: Optional[int] = None,
):
    """Radiance SUM over samples [sample0, sample0+spp_now) across a
    device mesh — the sharded twin of render/progressive.py:_render_batch,
    so progressive checkpoint/resume composes with ``--shard``.

    A thin delegation to :func:`render_sharded`.  ``sample0`` is a
    dynamic input there, so all of a progressive render's full batches
    share ONE compiled pipeline (the final partial batch, if any, adds a
    second), and sortable scenes get the cost-sorted steady state.
    Because the RNG is content-addressed by global ray id, the result is
    independent of the device decomposition up to f32 summation order."""
    return render_sharded(
        scene, width, height, total_spp, max_depth=max_depth,
        sampler=sampler, mesh=mesh, shard=shard, seed=seed,
        max_rays_per_chunk=max_rays_per_chunk, rr=rr, clamp=clamp,
        regen_min_wave=regen_min_wave, sample0=sample0,
        sample_count=spp_now, normalize=False,
    )


def render_adaptive_sharded(
    scene: Scene,
    width: int,
    height: int,
    samples_per_pixel: int,
    max_depth: int = 20,
    sampler: SamplerKind = SamplerKind.SOBOL,
    mesh: Optional[Mesh] = None,
    shard: str = "samples",
    seed: int = 0,
    max_rays_per_chunk: int = 1 << 21,
    rr: int = 0,
    clamp: float = 0.0,
    pilot_spp: int = 0,
    return_stats: bool = False,
):
    """Variance-guided adaptive sampling across a device mesh.

    ``shard='samples'``: the pilot halves are rendered as disjoint sample
    slices and ``psum``'d, so every device sees the SAME global noise map
    and computes the SAME allocation as the single-device path
    (render/adaptive.py) — bitwise-identical plan; each adaptive lane's
    sample range is then ceil-split across devices and the extra pass is
    ``psum``'d too.  Three collectives per band, estimator identical to
    single-device adaptive up to f32 summation order.

    ``shard='rows'``: devices own disjoint row regions and run the WHOLE
    adaptive pipeline (pilot, allocation, extra pass) locally — zero
    collectives.  Allocation locality is per-device-band instead of
    per-band: the sample budget is conserved within each device's rows
    (total image budget still exactly ``W*H*spp``), the same locality
    class as the single-device path's per-band allocation.  With one
    device and band-dividing heights the result is bitwise-identical to
    ``Renderer.render_adaptive``.

    Returns the (H, W, 3) f32 framebuffer (plus a stats dict with the
    per-pixel sample map when ``return_stats``)."""
    from ..render.adaptive import _plan_pipeline, pick_pilot
    from ..render.adaptive_device import (
        allocate_extra_dev,
        build_adaptive_plan_dev,
        plan_lane_budget,
        reserve_base,
        variance_weights_dev,
    )

    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh()
    if shard not in ("samples", "rows"):
        raise ValueError(f"unknown shard mode: {shard}")
    if sampler == SamplerKind.STRATIFIED:
        raise ValueError(
            "adaptive sampling needs per-pixel sample counts; the "
            "stratified sampler's grid is fixed by spp — use sobol or "
            "independent"
        )
    spp = samples_per_pixel

    def _uniform(pixels_spp):
        fb = render_sharded(
            scene, width, height, spp, max_depth=max_depth, sampler=sampler,
            mesh=mesh, shard=shard, seed=seed,
            max_rays_per_chunk=max_rays_per_chunk, rr=rr, clamp=clamp,
        )
        if return_stats:
            return fb, {
                "n_samples": np.full((height, width), pixels_spp, np.int64)
            }
        return fb

    pilot = pilot_spp or pick_pilot(spp)
    pilot = max(2, min(pilot, spp))
    pilot += pilot & 1
    if pilot >= spp:
        return _uniform(spp)

    cap = min(64 * (spp - pilot), (2**32) // (width * height) - pilot - 1)
    if cap < 1:
        raise ValueError(
            f"ray id space {width}x{height}x{spp} leaves no adaptive "
            "headroom; reduce spp or the image size"
        )
    lane_cap = max(8, 2 * (spp - pilot))
    base = reserve_base(spp, pilot)
    half = pilot // 2

    n_dev = mesh.devices.size
    compiled = scene.compiled
    sort_lanes = not compiled.has_bvh
    has_dof = scene.camera.has_depth_of_field
    cam_c = camera_consts(scene.camera, width, height)
    seed_arr = jnp.uint32(seed)

    cfg_key = (
        "adaptive", shard, width, height, spp, max_depth, sampler, has_dof,
        rr, clamp, max_rays_per_chunk, pilot, cam_c,
        tuple(int(d.id) for d in mesh.devices.flat), tuple(mesh.axis_names),
    )

    if shard == "samples":
        # Full-height bands (single-device geometry); pilot + extra passes
        # each sample-sliced per device and psum'd.
        band_rows = max(1, min(height, max_rays_per_chunk // width))
        n_bands = _cdiv(height, band_rows)
        h_pad = n_bands * band_rows
        tile = pick_tile(width, band_rows)
        order = np.argsort(
            tile_order_lane_index(width, band_rows, tile).reshape(-1),
            kind="stable",
        ).astype(np.int32)
        m_lanes = plan_lane_budget(band_rows * width, LANE_BLOCK)
        qa = _cdiv(half, n_dev)  # pilot-half sample slice per device

        def worker(compiled, seed, order):
            di = jax.lax.axis_index(AXIS)
            fb = jnp.zeros((h_pad, width, 3), real)
            cnt = jnp.zeros((h_pad, width), jnp.int32)
            kw = dict(
                width=width, height=height, band_rows=band_rows, s_par=1,
                spp=spp, max_depth=max_depth, sampler=sampler,
                has_dof=has_dof, cam_consts=cam_c, rr=rr, clamp=clamp,
            )
            for b in range(n_bands):
                y0 = jnp.int32(b * band_rows)
                rows_eff = min(band_rows, height - b * band_rows)
                a0 = jnp.minimum(jnp.int32(half), di * qa)
                a1 = jnp.minimum(jnp.int32(half), (di + 1) * qa)
                sum_a = jax.lax.psum(
                    _render_band_regen(
                        compiled, seed, y0, a0.astype(jnp.int32),
                        sample_limit=a1.astype(jnp.int32), **kw,
                    ),
                    AXIS,
                )
                b0 = jnp.int32(half) + jnp.minimum(jnp.int32(half), di * qa)
                b1 = jnp.int32(half) + jnp.minimum(
                    jnp.int32(half), (di + 1) * qa
                )
                sum_b = jax.lax.psum(
                    _render_band_regen(
                        compiled, seed, y0, b0.astype(jnp.int32),
                        sample_limit=b1.astype(jnp.int32), **kw,
                    ),
                    AXIS,
                )
                # every device computes the SAME plan from the psum'd map
                n_extra, px, py, s0, s1 = _plan_pipeline(
                    sum_a, sum_b, order,
                    half=half, base=base,
                    extra_total=(spp - pilot - base) * rows_eff * width,
                    cap=cap, band_y0=b * band_rows, pilot=pilot,
                    lane_cap=lane_cap, sort_lanes=sort_lanes,
                    m_lanes=m_lanes, width=width, rows_eff=rows_eff,
                )
                # ceil-split each lane's sample range across devices
                length = s1 - s0
                q = (length + jnp.int32(n_dev - 1)) // jnp.int32(n_dev)
                d0 = s0 + jnp.minimum(di * q, length)
                d1 = s0 + jnp.minimum((di + 1) * q, length)
                extra = jax.lax.psum(
                    _render_band_balanced(
                        compiled, seed, y0, px, py, d0, d1,
                        width=width, height=height, band_rows=band_rows,
                        spp=spp, max_depth=max_depth, sampler=sampler,
                        has_dof=has_dof, cam_consts=cam_c, rr=rr,
                        clamp=clamp,
                    ),
                    AXIS,
                )
                n_full = jnp.zeros((band_rows, width), jnp.int32).at[
                    :rows_eff
                ].set(n_extra)
                n_pix = jnp.int32(pilot) + n_full
                band_fb = (
                    (sum_a + sum_b + extra)
                    / n_pix[..., None].astype(real)
                )
                fb = fb.at[b * band_rows : (b + 1) * band_rows].set(band_fb)
                cnt = cnt.at[b * band_rows : (b + 1) * band_rows].set(n_pix)
            return fb[:height], cnt[:height]

        fn = _memo_sharded(compiled, cfg_key, lambda: jax.jit(
            jax.shard_map(
                worker, mesh=mesh, in_specs=(P(), P(), P()),
                out_specs=(P(), P()), check_vma=False,
            )
        ))
        fb, cnt = fn(compiled, seed_arr, jnp.asarray(order))
        if return_stats:
            return fb, {
                "n_samples": np.asarray(cnt).astype(np.int64),
                "pilot": pilot,
            }
        return fb

    # shard == "rows": disjoint row regions, fully local pipeline
    rows_local = _cdiv(height, n_dev)
    band_rows = max(1, min(rows_local, max_rays_per_chunk // width))
    n_bands = _cdiv(rows_local, band_rows)
    rows_pad = n_bands * band_rows
    tile = pick_tile(width, band_rows)
    order = np.argsort(
        tile_order_lane_index(width, band_rows, tile).reshape(-1),
        kind="stable",
    ).astype(np.int32)
    m_lanes = plan_lane_budget(band_rows * width, LANE_BLOCK)

    def worker(compiled, seed, order):
        di = jax.lax.axis_index(AXIS)
        y0_base = (di * rows_local).astype(jnp.int32)
        fb = jnp.zeros((rows_pad, width, 3), real)
        cnt = jnp.zeros((rows_pad, width), jnp.int32)
        kw = dict(
            width=width, height=height, band_rows=band_rows, s_par=1,
            spp=spp, max_depth=max_depth, sampler=sampler,
            has_dof=has_dof, cam_consts=cam_c, rr=rr, clamp=clamp,
        )
        inv = jnp.float32(1.0 / half)
        for b in range(n_bands):
            y0 = y0_base + jnp.int32(b * band_rows)
            sum_a = _render_band_regen(
                compiled, seed, y0, jnp.int32(0),
                sample_limit=jnp.int32(half), **kw,
            )
            sum_b = _render_band_regen(
                compiled, seed, y0, jnp.int32(half),
                sample_limit=jnp.int32(pilot), **kw,
            )
            # rows past the image bottom (device/band padding) render
            # clamped duplicates — zero them out of the noise map and give
            # them cap 0 so allocation can't reach them
            valid = (
                y0 + jnp.arange(band_rows, dtype=jnp.int32)
            ) < jnp.int32(height)
            va = valid[:, None, None]
            weight = variance_weights_dev(
                jnp.where(va, sum_a, 0.0) * inv,
                jnp.where(va, sum_b, 0.0) * inv,
            )
            weight = jnp.where(valid[:, None], weight, 0.0)
            n_valid = valid.sum().astype(jnp.int32) * jnp.int32(width)
            extra_total = jnp.int32(spp - pilot - base) * n_valid
            capv = jnp.broadcast_to(
                jnp.where(valid, jnp.int32(cap - base), 0)[:, None],
                (band_rows, width),
            )
            alloc = allocate_extra_dev(weight, extra_total, capv)
            n_extra = jnp.where(valid[:, None], jnp.int32(base) + alloc, 0)
            px, py, s0, s1 = build_adaptive_plan_dev(
                n_extra, order, band_y0=y0, pilot=pilot, lane_cap=lane_cap,
                sort_lanes=sort_lanes, m_lanes=m_lanes, width=width,
            )
            extra = _render_band_balanced(
                compiled, seed, y0, px, py, s0, s1,
                width=width, height=height, band_rows=band_rows, spp=spp,
                max_depth=max_depth, sampler=sampler, has_dof=has_dof,
                cam_consts=cam_c, rr=rr, clamp=clamp,
            )
            n_pix = jnp.int32(pilot) + n_extra
            band_fb = (sum_a + sum_b + extra) / n_pix[..., None].astype(real)
            fb = fb.at[b * band_rows : (b + 1) * band_rows].set(band_fb)
            cnt = cnt.at[b * band_rows : (b + 1) * band_rows].set(n_pix)
        return fb[:rows_local], cnt[:rows_local]

    fn = _memo_sharded(compiled, cfg_key, lambda: jax.jit(
        jax.shard_map(
            worker, mesh=mesh, in_specs=(P(), P(), P()),
            out_specs=(P(AXIS), P(AXIS)), check_vma=False,
        )
    ))
    fb, cnt = fn(compiled, seed_arr, jnp.asarray(order))
    fb, cnt = fb[:height], cnt[:height]
    if return_stats:
        return fb, {
            "n_samples": np.asarray(cnt).astype(np.int64),
            "pilot": pilot,
        }
    return fb
