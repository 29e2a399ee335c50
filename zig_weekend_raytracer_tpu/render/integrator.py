"""The wavefront integrator: iterative, batched, branchless, SoA.

This re-designs the reference's recursive Monte-Carlo estimator
``rayColor`` (src/render.zig:188-289) for a data-parallel device.  The
recursion (two self-calls: specular bypass :245 and PDF-weighted scatter
:280) becomes a ``lax.while_loop`` over bounces carrying SoA path state
(origin/direction/throughput/radiance/alive); the estimator identity

    color = emission + attenuation * scatter_pdf / sample_pdf * L(scattered)

unrolls into a running throughput product.  ``bounce_step`` is one bounce;
``trace_paths`` (per-bounce reference) and ``trace_paths_regen``
(regenerating wavefront, the production path) are two loops around it.

Semantics matched bounce-for-bounce:
  * depth cutoff -> black                              (:199)
  * miss -> background, path ends                      (:215-217)
  * emission with backface culling in the material     (:234, material.zig:93)
  * emissive / absorbed-metal paths end                (:238-240, material.zig:177)
  * specular branch bypasses PDFs, T *= attenuation    (:243-246)
  * diffuse: 50/50 mixture of light-entity PDF and the material scatter PDF
    when the scene has a light list                    (:254-263)
    or the cosine PDF alone otherwise                  (:264-269)
  * weight = attenuation * scatteringPdf / samplePdf   (:280-288)

All randomness is content-addressed (sampling/hashrng.py): a pure function
of (seed, ray_id, bounce, site), so results are bitwise-invariant to chunk
decomposition and device count.

Deviation (documented): paths whose throughput hits exactly zero are
terminated early.  In the reference they keep bouncing with zero weight; the
results are identical except where 0-weight samples would have turned into
NaNs (which the writer scrubs to black anyway, src/writer/writer.zig:83-94).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dtypes import INF, LUM_B, LUM_G, LUM_R, T_MIN, real
from ..materials import schlick_reflectance, scattering_pdf
from ..math import v3
from ..math.v3 import V3
from ..ops.shade import shade_attrs
from ..ops.trace import closest_hit
from ..sampling import hashrng
from ..scene import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_ISOTROPIC,
    MAT_METAL,
    CompiledScene,
)
from ..textures import atlas_lookup, checker_parity, texture_value
from ..utils.profiler import named_zone
from .camera import camera_params_from_consts, generate_rays
from .pdfs import light_pdf_value, sample_light_direction

# hashrng stream-site layout: camera uses sites 0..3 (see camera.py);
# each bounce d uses sites _BOUNCE_BASE + d * _SITES_PER_BOUNCE + k
# (k = 0 scatter, 1 light mixture, 2 gauss triple, 3 Russian roulette).
_BOUNCE_BASE = 8
_SITES_PER_BOUNCE = 4

# Russian-roulette survival floor
RR_P_MIN = hashrng.RR_P_MIN


def texture_rgb(scene, det) -> V3:
    """Texture value at a hit from the denormalized shade record:
    solid -> rgb; checker -> lattice parity picks rgb/rgb2 or an image
    child (src/texture.zig:111-118); image -> atlas fetch.  Checker-in-
    checker nesting can't flatten into one record, so those scenes
    evaluate the general texture walk instead."""
    parity = checker_parity(det.inv_scale, det.point)
    odd = (det.tex_kind == 1) & (parity != 0)
    tex_rgb = V3.where(odd, det.rgb2, det.rgb)
    if scene.has_nested_checker:
        return texture_value(scene, det.texid, det.u, det.v, det.point)
    if scene.has_image_textures:
        img_id = jnp.where(odd, det.img2, det.img)
        img_rgb = atlas_lookup(
            scene, jnp.maximum(img_id, 0), det.u, det.v
        )
        tex_rgb = V3.where(img_id >= 0, img_rgb, tex_rgb)
    return tex_rgb


class PathState(NamedTuple):
    origin: V3
    direction: V3
    time: jnp.ndarray        # (N,)
    throughput: V3
    radiance: V3
    alive: jnp.ndarray       # (N,) bool
    ray_id: jnp.ndarray      # (N,) u32 RNG content address (travels with ray)


def bounce_step(
    scene: CompiledScene,
    seed,                    # u32 scalar
    depth,                   # i32 scalar, or (N,) per-lane bounce index
    st: PathState,
    *,
    terminate_zero_throughput: bool = True,
    rr_start: int = 0,
    clamp: float = 0.0,
) -> PathState:
    """One bounce of the estimator for every lane of ``st``: closest hit,
    emission/background, material scatter.  Dead lanes keep their state.

    ``depth`` is the bounce index each lane's path is at.  ``trace_paths``
    passes one scalar (the whole wavefront bounces together);
    ``trace_paths_regen`` passes each lane's own counter.  It addresses the
    RNG sites and gates the clamp (depth >= 1) and Russian roulette
    (depth >= rr_start), so a path draws the same numbers under both.

    ``rr_start`` > 0 enables Russian roulette from that bounce index: a
    path entering bounce d >= rr_start continues with probability
    p = clamp(max(throughput), RR_P_MIN, 1) and survivors scale throughput
    by 1/p — an unbiased estimator-preserving tail cut (a PBRT-standard
    extension; the reference has no RR, so the default 0 keeps reference
    semantics and all goldens).  Gated OFF on image-texture scenes.

    ``clamp`` > 0 enables the Cycles-style indirect clamp: any radiance
    contribution landed at bounce d >= 1 is luminance-scaled down to at
    most ``clamp`` — biased firefly suppression (direct light and the
    d = 0 background stay exact).  Same image-scene gate as RR."""
    n = st.origin.shape[0]
    rr_on = rr_start > 0 and not scene.has_image_textures
    clamp_on = clamp > 0 and not scene.has_image_textures
    ray_id = st.ray_id
    # Per-bounce decorrelation: the depth folds into the stream index —
    # every draw is a pure function of (seed, ray_id, site).
    site = _BOUNCE_BASE + depth * _SITES_PER_BOUNCE
    u0, u1, u2, u3 = hashrng.uniform4(seed, ray_id, site)
    if scene.has_lights:
        u4, u5, u6, _ = hashrng.uniform4(seed, ray_id, site + 1)
    if scene.needs_gauss:
        # feeds only isotropic/fuzzy-metal; content-addressed draws make
        # skipping it bitwise-safe for scenes with neither
        gauss = hashrng.gauss3(seed, ray_id, site + 2)
    if rr_on:
        u_rr = hashrng.uniform1(seed, ray_id, site + 3)

    with jax.named_scope("closest_hit"), named_zone("rayColor"):
        hit = closest_hit(
            scene, st.origin, st.direction, st.time, T_MIN, INF,
            active=st.alive,
        )
    # ---- shading (reference: src/render.zig:215-288) ----
    with jax.named_scope("shade"):
        det = shade_attrs(scene, hit, st.origin, st.direction, st.time)

        hit_any = hit.kind >= 0
        hitmask = st.alive & hit_any
        missed = st.alive & ~hit_any

        if clamp_on:
            def _clamp_contrib(c: V3) -> V3:
                lum = LUM_R * c.x + LUM_G * c.y + LUM_B * c.z
                s = jnp.where(
                    (depth >= 1) & (lum > clamp),
                    real(clamp) / jnp.maximum(lum, real(1e-20)),
                    real(1.0),
                )
                return c * s
        else:
            def _clamp_contrib(c: V3) -> V3:
                return c

        radiance = st.radiance + V3.where(
            missed,
            _clamp_contrib(st.throughput * scene.background),
            V3.zeros((n,), real),
        )

        mat_type = det.mat_type
        tex_rgb = texture_rgb(scene, det)

        # ---- emission (src/render.zig:232-240) ----
        is_emissive = mat_type == MAT_DIFFUSE_LIGHT
        emits = hitmask & is_emissive & det.front
        radiance = V3.where(
            emits, radiance + _clamp_contrib(st.throughput * tex_rgb),
            radiance,
        )

        # ---- metal (src/material.zig:163-178) ----
        reflected = v3.reflect(st.direction, det.normal)
        if scene.needs_gauss:
            fuzz = jnp.clip(det.fuzz, 0.0, 1.0)
            metal_dir = reflected + hashrng.unit_sphere(gauss) * fuzz
        else:
            metal_dir = reflected
        metal_ok = v3.dot(metal_dir, det.normal) > 0.0

        # ---- dielectric (src/material.zig:190-218) ----
        ri = det.refract
        index = jnp.where(det.front, 1.0 / ri, ri)
        unit_in = v3.normalize(st.direction)
        cos_theta = jnp.minimum(v3.dot(-unit_in, det.normal), 1.0)
        sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
        must_reflect = (index * sin_theta > 1.0) | (
            schlick_reflectance(cos_theta, ri) > u0
        )
        diel_dir = V3.where(
            must_reflect,
            v3.reflect(unit_in, det.normal),
            v3.refract(unit_in, det.normal, index),
        )

        # ---- diffuse sampling (lambertian cosine / isotropic sphere) ----
        basis = v3.ortho_basis(det.normal)
        cosine_dir = v3.onb_transform(basis, hashrng.cosine_direction_z(u1, u2))
        if scene.needs_gauss:
            is_iso = mat_type == MAT_ISOTROPIC
            # disjoint from metal by type
            sphere_dir = hashrng.unit_sphere(gauss)
            mat_sample_dir = V3.where(is_iso, sphere_dir, cosine_dir)
        else:
            mat_sample_dir = cosine_dir

        if scene.has_lights:
            # MixturePdf: 50/50 generator choice + averaged value
            # (src/pdf.zig:92-119, src/render.zig:254-263).
            light_dir = sample_light_direction(scene, det.point, u4, u5, u6)
            use_light = u3 < 0.5
            diff_dir = V3.where(use_light, light_dir, mat_sample_dir)
            mat_pdf = scattering_pdf(mat_type, det.normal, diff_dir)
            l_pdf = light_pdf_value(scene, det.point, diff_dir)
            sample_pdf = 0.5 * l_pdf + 0.5 * mat_pdf
            scatter_pdf = mat_pdf
        else:
            # CosinePdf fallback (src/render.zig:264-269).
            diff_dir = mat_sample_dir
            scatter_pdf = scattering_pdf(mat_type, det.normal, diff_dir)
            sample_pdf = scatter_pdf

        # Guard sample_pdf == 0 (e.g. a light-sampled direction exactly in
        # the plane of a coplanar lambertian: both the light PDF and the
        # cosine PDF vanish).  The reference debug-asserts here
        # (src/render.zig:255-256); we terminate the path with zero weight,
        # which is the correct Monte-Carlo treatment of a zero-probability
        # sample.
        pdf_ok = sample_pdf > 0.0
        diffuse_mult = tex_rgb * jnp.where(
            pdf_ok, scatter_pdf / jnp.where(pdf_ok, sample_pdf, 1.0), 0.0
        )

        # ---- combine by material type ----
        is_metal = mat_type == MAT_METAL
        is_diel = mat_type == MAT_DIELECTRIC
        is_spec = is_metal | is_diel

        new_dir = V3.where(
            is_spec, V3.where(is_metal, metal_dir, diel_dir), diff_dir
        )
        one = V3.full((n,), 1.0, 1.0, 1.0, real)
        mult = V3.where(
            is_metal,
            det.rgb,  # metal albedo lives in the record's rgb slot
            V3.where(is_diel, one, diffuse_mult),
        )

        survives = hitmask & ~is_emissive & ~(is_metal & ~metal_ok)
        throughput = V3.where(survives, st.throughput * mult, st.throughput)
        if terminate_zero_throughput:
            nonzero = (
                (throughput.x != 0.0)
                | (throughput.y != 0.0)
                | (throughput.z != 0.0)
            )
            survives = survives & nonzero
        if rr_on:
            # Russian roulette on the continuation: p from the INCOMING
            # throughput, applied from bounce rr_start on.  This bounce's
            # radiance contributions (emission/background, weighted by
            # incoming throughput) are untouched; survivors carry the 1/p
            # weight forward.
            p_rr = jnp.clip(
                jnp.maximum(
                    st.throughput.x,
                    jnp.maximum(st.throughput.y, st.throughput.z),
                ),
                RR_P_MIN, 1.0,
            )
            apply_rr = st.alive & (depth >= rr_start)
            survives = survives & ~(apply_rr & (u_rr >= p_rr))
            throughput = throughput * jnp.where(apply_rr, 1.0 / p_rr, 1.0)

        return PathState(
            origin=V3.where(hitmask, det.point, st.origin),
            direction=V3.where(hitmask, new_dir, st.direction),
            time=st.time,
            throughput=throughput,
            radiance=radiance,
            alive=survives,
            ray_id=st.ray_id,
        )


def trace_paths(
    scene: CompiledScene,
    origin: V3,
    direction: V3,
    time: jnp.ndarray,
    seed,                    # u32 scalar
    ray_id: jnp.ndarray,     # (N,) u32 global ray ids
    max_depth: int,
    terminate_zero_throughput: bool = True,
    rr_start: int = 0,
    clamp: float = 0.0,
) -> V3:
    """Per-bounce reference integrator: the whole wavefront of camera rays
    bounces together, one ``bounce_step`` per loop iteration, until every
    path has ended or ``max_depth`` bounces are done.  Returns V3 of (N,).
    Options as in ``bounce_step``.

    The production path is ``trace_paths_regen``; this form stays as the
    plain reference that tests compare it against."""
    n = origin.shape[0]
    state = PathState(
        origin=origin,
        direction=direction,
        time=time,
        throughput=V3.full((n,), 1.0, 1.0, 1.0, real),
        radiance=V3.zeros((n,), real),
        alive=jnp.ones((n,), bool),
        ray_id=ray_id,
    )

    # while_loop instead of fori_loop: the wavefront exits as soon as every
    # path has terminated (miss/emissive/absorption), which is typically far
    # before max_depth (the reference's recursion simply unwinds,
    # src/render.zig:199).
    def cond(carry):
        depth, st = carry
        return (depth < max_depth) & jnp.any(st.alive)

    def body(carry):
        depth, st = carry
        return depth + 1, bounce_step(
            scene, seed, depth, st,
            terminate_zero_throughput=terminate_zero_throughput,
            rr_start=rr_start, clamp=clamp,
        )

    _, final = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    return final.radiance


class RegenState(NamedTuple):
    path: PathState
    sample: jnp.ndarray   # (N,) i32 current sample index per lane
    bounce: jnp.ndarray   # (N,) i32 bounce index of the lane's path
    work: jnp.ndarray     # (N,) i32 bounces traced by the lane


def _respawn(
    cam, seed, px, py, limit, st: RegenState, *,
    sampler, width, height, spp, stride, has_dof,
) -> RegenState:
    """Path regeneration: dead lanes whose next sample is below their
    ``limit`` take it and start a fresh camera ray.  The ray id (and so
    every random draw) depends only on (sample, pixel), never on the lane."""
    p = st.path
    next_sample = st.sample + stride
    respawn = ~p.alive & (next_sample < limit)
    sample = jnp.where(respawn, next_sample, st.sample)
    new_rid = (
        sample.astype(jnp.uint32) * jnp.uint32(height)
        + py.astype(jnp.uint32)
    ) * jnp.uint32(width) + px.astype(jnp.uint32)
    o_new, d_new, t_new = generate_rays(
        cam, has_dof, sampler, seed, new_rid, px, py, sample,
        spp, width, height,
    )
    shape = px.shape
    path = PathState(
        origin=V3.where(respawn, o_new, p.origin),
        direction=V3.where(respawn, d_new, p.direction),
        time=jnp.where(respawn, t_new, p.time),
        throughput=V3.where(
            respawn, V3.full(shape, 1.0, 1.0, 1.0, real), p.throughput
        ),
        radiance=p.radiance,
        alive=p.alive | respawn,
        ray_id=jnp.where(respawn, new_rid, p.ray_id),
    )
    return RegenState(
        path=path, sample=sample,
        bounce=jnp.where(respawn, 0, st.bounce), work=st.work,
    )


def trace_paths_regen(
    scene: CompiledScene,
    camera_consts,          # static float tuple (render.camera.camera_consts)
    seed,                   # u32 scalar
    px: jnp.ndarray,        # (N,) i32 per-lane pixel column
    py: jnp.ndarray,        # (N,) i32 per-lane pixel row
    first_sample: jnp.ndarray,  # (N,) i32 per-lane first sample index
    sample_limit: jnp.ndarray,  # (N,) i32 per-lane first sample NOT rendered
    *,
    sampler,
    width: int,
    height: int,
    spp: int,
    stride: int,
    max_depth: int,
    has_dof: bool,
    terminate_zero_throughput: bool = True,
    want_work: bool = False,
    rr_start: int = 0,
    clamp: float = 0.0,
):
    """Regenerating wavefront: each lane owns one pixel and path-traces its
    samples ``first_sample, first_sample + stride, ...`` below its
    ``sample_limit`` one after another.  Each loop iteration first respawns
    the lanes whose path has ended, then runs one ``bounce_step`` with each
    lane's own bounce index, so lanes stay busy instead of idling once
    their path ends (the reference instead gives each CPU thread a
    pixel-block queue, src/render.zig:55-73).

    Returns the per-lane radiance SUM over its samples, plus the per-lane
    count of bounces traced when ``want_work`` (the cost signal of the
    sorted and balanced drivers).  The content-addressed RNG makes each
    path's estimate equal to the one ``trace_paths`` computes for it."""
    n = px.shape[0]
    cam = camera_params_from_consts(camera_consts)
    state = RegenState(
        path=PathState(
            origin=V3.zeros((n,), real),
            direction=V3.full((n,), 0.0, 0.0, 1.0, real),
            time=jnp.zeros((n,), real),
            throughput=V3.full((n,), 1.0, 1.0, 1.0, real),
            radiance=V3.zeros((n,), real),
            alive=jnp.zeros((n,), bool),
            ray_id=jnp.zeros((n,), jnp.uint32),
        ),
        sample=first_sample - stride,  # pre-first: the first step respawns it
        bounce=jnp.zeros((n,), jnp.int32),
        work=jnp.zeros((n,), jnp.int32),
    )

    def cond(st: RegenState):
        return jnp.any(st.path.alive | (st.sample + stride < sample_limit))

    def body(st: RegenState):
        with jax.named_scope("regenerate"):
            st = _respawn(
                cam, seed, px, py, sample_limit, st, sampler=sampler,
                width=width, height=height, spp=spp, stride=stride,
                has_dof=has_dof,
            )
        path = bounce_step(
            scene, seed, st.bounce, st.path,
            terminate_zero_throughput=terminate_zero_throughput,
            rr_start=rr_start, clamp=clamp,
        )
        bounce = st.bounce + 1
        # depth cutoff per path (reference: src/render.zig:199)
        path = path._replace(alive=path.alive & (bounce < max_depth))
        work = st.work
        if want_work:
            work = work + st.path.alive.astype(jnp.int32)
        return RegenState(
            path=path, sample=st.sample, bounce=bounce, work=work
        )

    final = jax.lax.while_loop(cond, body, state)
    if want_work:
        return final.path.radiance, final.work
    return final.path.radiance
