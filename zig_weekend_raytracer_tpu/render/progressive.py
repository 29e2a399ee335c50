"""Progressive rendering with checkpoint / resume.

The reference is one-shot: the framebuffer is written only after all samples
finish, and a crash loses everything (SURVEY.md §5: "Checkpoint/resume:
none").  The wavefront design makes progressive accumulation natural — each
sample batch is an independent estimator, so the framebuffer sum plus the
count of completed samples IS the checkpoint.  This is a capability
*extension* over the reference.

Checkpoints are plain ``.npz`` (framebuffer sum f32, samples-done, config
fingerprint); the content-addressed RNG (sampling/hashrng.py) guarantees a
resumed render produces bitwise the same image as an uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..dtypes import real
from ..scene import Scene
from .camera import camera_consts
from .renderer import Renderer, _render_band_regen

log = logging.getLogger("zwrt")


def _fingerprint(scene: Scene, width, height, renderer: Renderer) -> str:
    # every Renderer knob that changes the ESTIMATOR must be here — a
    # resume under different settings would silently mix two estimators —
    # plus every knob that changes the CHUNK DECOMPOSITION: the estimator is decomposition-independent but the f32
    # summation order is not, and the class promises bitwise resume
    return (
        f"{scene.name}:{width}x{height}:depth{renderer.max_ray_bounce_depth}"
        f":{renderer.sampler.value}:seed{renderer.seed}"
        f":rr{renderer.russian_roulette}:clamp{renderer.clamp_indirect}"
        f":chunk{renderer.max_rays_per_chunk}-{renderer.max_rays_per_chunk_bvh}"
        f"-{renderer.regen_min_wave}"
    )


@dataclasses.dataclass
class ProgressiveRenderer:
    """Renders in sample batches, checkpointing after each batch.

    ``shard`` runs each batch across a device mesh
    (parallel/render.py:render_batch_sharded, modes as in render_sharded);
    the checkpoint fingerprint then pins the mesh size and mode, because
    resuming under a different decomposition would change f32 summation
    order (the estimator is decomposition-independent, the bits are not)."""

    renderer: Renderer
    checkpoint_path: str
    checkpoint_every: int = 1  # batches between checkpoint writes
    shard: str = "none"  # none | samples | rows
    mesh: object = None  # jax.sharding.Mesh (default: all devices)

    def render(
        self,
        scene: Scene,
        width: int,
        height: int,
        batch_spp: int = 16,
        on_batch: Optional[Callable[[int, np.ndarray], None]] = None,
    ) -> np.ndarray:
        """Render ``renderer.samples_per_pixel`` total samples in batches of
        ``batch_spp``, resuming from the checkpoint if one matches."""
        total_spp = self.renderer.samples_per_pixel
        fp = _fingerprint(scene, width, height, self.renderer)
        mesh = self.mesh
        if self.shard != "none":
            if mesh is None:
                from ..parallel import make_mesh

                mesh = make_mesh()
            fp += f":shard-{self.shard}-{mesh.devices.size}"

        fb_sum = np.zeros((height, width, 3), np.float32)
        done = 0
        if os.path.exists(self.checkpoint_path):
            z = np.load(self.checkpoint_path, allow_pickle=False)
            if str(z["fingerprint"]) == fp and int(z["total_spp"]) == total_spp:
                fb_sum = z["fb_sum"].astype(np.float32)
                done = int(z["samples_done"])
                log.info(
                    "resuming render from checkpoint: %d/%d spp done",
                    done, total_spp,
                )
            else:
                log.warning(
                    "checkpoint fingerprint mismatch; starting fresh"
                )

        batch_idx = 0
        while done < total_spp:
            spp_now = min(batch_spp, total_spp - done)
            # Render exactly [done, done+spp_now) using the SAME global
            # sample indices an uninterrupted render would use.  All chunking
            # fields carry over.
            sub = dataclasses.replace(
                self.renderer, samples_per_pixel=total_spp
            )
            if self.shard != "none":
                from ..parallel import render_batch_sharded

                batch = render_batch_sharded(
                    scene, width, height, total_spp, done, spp_now,
                    max_depth=sub.max_ray_bounce_depth, sampler=sub.sampler,
                    mesh=mesh, shard=self.shard, seed=sub.seed,
                    max_rays_per_chunk=sub.max_rays_per_chunk,
                    rr=sub.russian_roulette, clamp=sub.clamp_indirect,
                    regen_min_wave=sub.regen_min_wave,
                )
            else:
                batch = _render_batch(
                    sub, scene, width, height, done, spp_now
                )
            fb_sum += np.asarray(batch)
            done += spp_now
            batch_idx += 1
            if batch_idx % self.checkpoint_every == 0 or done >= total_spp:
                self._save(fb_sum, done, total_spp, fp)
            if on_batch is not None:
                on_batch(done, fb_sum / max(done, 1))
        return fb_sum / total_spp

    def _save(self, fb_sum, done, total_spp, fp) -> None:
        tmp = self.checkpoint_path + ".tmp.npz"
        np.savez(
            tmp,
            fb_sum=fb_sum,
            samples_done=done,
            total_spp=total_spp,
            fingerprint=fp,
        )
        os.replace(tmp, self.checkpoint_path)  # atomic swap


def _render_batch(
    renderer: Renderer, scene: Scene, width, height, sample0: int, spp_now: int
) -> jnp.ndarray:
    """Radiance *sum* over samples [sample0, sample0+spp_now)."""
    has_dof = scene.camera.has_depth_of_field
    seed = jnp.uint32(renderer.seed)
    total_spp = renderer.samples_per_pixel
    s_par, band_rows = renderer.regen_geometry(width, height, spp_now)
    n_bands = -(-height // band_rows)
    fb = jnp.zeros((n_bands * band_rows, width, 3), real)
    cam_c = camera_consts(scene.camera, width, height)
    for b in range(n_bands):
        out = _render_band_regen(
            scene.compiled, seed,
            jnp.int32(b * band_rows), jnp.int32(sample0),
            width=width, height=height, band_rows=band_rows,
            s_par=s_par,
            # spp stays the render TOTAL so samplers (notably STRATIFIED,
            # whose strata geometry is sqrt(spp)) see the same geometry an
            # uninterrupted render would; the batch's end index bounds
            # which samples render instead.
            spp=total_spp,
            sample_limit=min(sample0 + spp_now, total_spp),
            max_depth=renderer.max_ray_bounce_depth,
            sampler=renderer.sampler, has_dof=has_dof,
            cam_consts=cam_c, rr=renderer.russian_roulette,
            clamp=renderer.clamp_indirect,
        )
        fb = fb.at[b * band_rows : (b + 1) * band_rows].add(out)
    return fb[:height]
