"""CLI entry point (reference: src/main.zig).

Same six flags as the reference's UserArgs (src/main.zig:20-28) plus
extensions (sampler strategy, seed, device sharding, ...).  Stage
timings are logged with the same three messages (src/main.zig:94,97,105).

Run:  python -m zig_weekend_raytracer_tpu.cli --image_width=400 --image_height=400
"""

from __future__ import annotations

import dataclasses
import logging
import sys

from .models import DEFAULT_ASSET_DIR, SceneType, load_scene
from .io.ppm import write_image
from .render.renderer import Renderer
from .sampling.sampler import SamplerKind
from .utils.argparser import ArgParser, HelpPassedInArgs, ParseArgsError
from .utils.timer import Timer


@dataclasses.dataclass
class UserArgs:
    image_width: int
    image_height: int
    image_out_path: str = "image.ppm"
    # Kept for CLI parity; rendering runs on the device, so this only sizes
    # the native writer's thread pool.
    thread_pool_size: int = 8
    scene: SceneType = SceneType.EMISSIVE
    samples_per_pixel: int = 10
    ray_bounce_max_depth: int = 20
    # --- extensions beyond the reference flag set ---
    sampler: SamplerKind = SamplerKind.SOBOL
    seed: int = 0
    asset_dir: str = DEFAULT_ASSET_DIR
    # Declarative JSON scene (models/scenefile.py schema); overrides
    # --scene when set.
    scene_file: str = ""
    shard: str = "none"  # none | samples | rows  (multi-chip)
    # Russian roulette start bounce (0 = off, reference semantics).
    # Unbiased path-tail termination; ignored on image-texture scenes
    # (render/integrator.py:bounce_step docstring).
    russian_roulette: int = 0
    # Indirect luminance clamp (0 = off, reference semantics): biased
    # firefly suppression — bounce >= 1 radiance contributions are
    # luminance-scaled to at most this value.  Ignored on image scenes.
    clamp_indirect: float = 0.0
    # Variance-guided adaptive sampling: 1 enables with an auto-sized
    # pilot, N >= 2 pins the pilot spp.  Same TOTAL budget as a uniform
    # --samples_per_pixel render, re-allocated per pixel by measured
    # noise (render/adaptive.py).  Sobol/independent samplers only.
    # Combines with --shard (parallel/render.py:render_adaptive_sharded):
    # 'samples' psums the noise map (single-device-identical allocation),
    # 'rows' allocates per device region.
    adaptive: int = 0
    # Progressive rendering with atomic checkpoint/resume
    # (render/progressive.py): renders in sample batches, checkpointing
    # to this npz path after each; an interrupted render resumes from it
    # bitwise-identically.  Combines with --shard (batches render across
    # the mesh; the checkpoint pins the decomposition for bitwise
    # resume).  Not combinable with --adaptive (the plan depends on the
    # pilot noise map, which the checkpoint cannot reproduce).
    checkpoint: str = ""
    # Samples per progressive batch (with --checkpoint).
    checkpoint_batch_spp: int = 16
    # AOV-guided a-trous wavelet denoise (render/denoise.py): N filter
    # iterations applied to the framebuffer before writing (0 = off).
    # Computes the first-hit AOV buffers if --aov has not already.
    denoise: int = 0
    # Supersampled rendering (1 = off): render at K x the resolution with
    # spp/K^2 samples per subpixel and box-downsample — the same box pixel
    # filter and total sample budget as the plain render (unbiased;
    # subpixel jitter becomes stratification)
    # (renderer.render_supersampled).  spp must divide by K^2.  Not
    # combinable with --adaptive/--checkpoint/--shard.
    supersample: int = 1
    # Print a throughput line after the render: paths traced, wall-clock,
    # Mpaths/s.
    stats: bool = False
    # Also write first-hit AOV buffers (albedo/normal/depth PNGs for
    # denoising/compositing, render/aov.py) next to the image as
    # <image_out_path>.albedo.png etc.
    aov: bool = False
    # Tracy-lite zone tables after the render:
    #   --profile / --profile=host    host wall-clock per named_zone
    #   --profile=device              per-kernel DEVICE ms from a
    #                                 jax.profiler capture (no viewer)
    # ZWRT_PROFILE=1 enables the host accumulation too.
    profile: str = "off"


def normalize_profile_mode(text: str) -> str | None:
    """--profile value -> 'off' | 'host' | 'device', or None if invalid.

    Accepts every legacy bool spelling (the flag predates the host/device
    modes and took utils.argparser._parse_bool values)."""
    mode = text.lower()
    if mode in ("true", "1", "yes", "on"):
        return "host"
    if mode in ("false", "0", "no"):
        return "off"
    return mode if mode in ("off", "host", "device") else None


def parse_user_args(argv) -> UserArgs:
    parser = ArgParser(UserArgs)
    try:
        return parser.parse(argv)
    except HelpPassedInArgs:
        print(parser.usage(), file=sys.stderr)
        raise
    except ParseArgsError:
        print(parser.usage(), file=sys.stderr)
        raise


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    timer = Timer()
    try:
        args = parse_user_args(
            argv if argv is not None else sys.argv[1:]
        )
    except HelpPassedInArgs:
        return 0
    except ParseArgsError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    profile_mode = normalize_profile_mode(args.profile)
    if profile_mode is None:
        print(f"error: unknown --profile mode {args.profile!r} "
              "(off | host | device)", file=sys.stderr)
        return 1
    if profile_mode == "host":
        from .utils.profiler import set_profiling

        set_profiling(True)

    if args.scene_file:
        from .models import load_scene_file

        try:
            scene = load_scene_file(args.scene_file)
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as e:
            print(f"error: --scene_file {args.scene_file}: {e}",
                  file=sys.stderr)
            return 1
    else:
        scene = load_scene(
            args.scene, seed=args.seed, asset_dir=args.asset_dir
        )
    timer.log_info_elapsed("scene initialized")

    if args.checkpoint and args.adaptive:
        # Adaptive's allocation depends on the pilot noise map, so a
        # resumed render could not reproduce the interrupted one's plan
        # from the checkpoint alone — the combination stays rejected.
        print("error: --checkpoint is a uniform render "
              "(drop --adaptive)", file=sys.stderr)
        return 1
    if args.checkpoint and args.checkpoint_batch_spp < 1:
        print("error: --checkpoint_batch_spp must be >= 1",
              file=sys.stderr)
        return 1
    if args.supersample < 1:
        print("error: --supersample must be >= 1", file=sys.stderr)
        return 1
    if args.supersample > 1:
        k2 = args.supersample * args.supersample
        if args.adaptive or args.checkpoint or args.shard != "none":
            # adaptive plans and checkpoint fingerprints are per-pixel at
            # the BASE resolution; sharded supersampling would just be
            # render_sharded at K-res + downsample — not wired yet.
            print("error: --supersample combines only with the plain "
                  "render (drop --adaptive/--checkpoint/--shard)",
                  file=sys.stderr)
            return 1
        if args.samples_per_pixel % k2:
            print(f"error: --samples_per_pixel={args.samples_per_pixel} "
                  f"must be divisible by supersample^2={k2}",
                  file=sys.stderr)
            return 1

    def do_render():
        if args.shard != "none":
            import numpy as np

            if args.checkpoint:
                # Progressive checkpoint/resume with sharded batches
                # (render/progressive.py + render_batch_sharded).
                from .render.progressive import ProgressiveRenderer

                renderer = Renderer(
                    samples_per_pixel=args.samples_per_pixel,
                    max_ray_bounce_depth=args.ray_bounce_max_depth,
                    sampler=args.sampler,
                    seed=args.seed,
                    russian_roulette=args.russian_roulette,
                    clamp_indirect=args.clamp_indirect,
                )
                return ProgressiveRenderer(
                    renderer, checkpoint_path=args.checkpoint,
                    shard=args.shard,
                ).render(
                    scene, args.image_width, args.image_height,
                    batch_spp=args.checkpoint_batch_spp,
                )
            if args.adaptive:
                # Sharded adaptive: shard='samples' psums the
                # pilot noise map so every device computes the single-
                # device allocation and takes a slice of every adaptive
                # lane; shard='rows' runs the whole pipeline locally on
                # disjoint row regions (parallel/render.py).
                from .parallel import render_adaptive_sharded

                return np.asarray(render_adaptive_sharded(
                    scene, args.image_width, args.image_height,
                    args.samples_per_pixel, args.ray_bounce_max_depth,
                    sampler=args.sampler, shard=args.shard, seed=args.seed,
                    rr=args.russian_roulette, clamp=args.clamp_indirect,
                    pilot_spp=args.adaptive if args.adaptive >= 2 else 0,
                ))
            from .parallel import render_sharded

            fb = render_sharded(
                scene, args.image_width, args.image_height,
                args.samples_per_pixel, args.ray_bounce_max_depth,
                sampler=args.sampler, shard=args.shard, seed=args.seed,
                rr=args.russian_roulette, clamp=args.clamp_indirect,
            )
            return np.asarray(fb)
        renderer = Renderer(
            samples_per_pixel=args.samples_per_pixel,
            max_ray_bounce_depth=args.ray_bounce_max_depth,
            sampler=args.sampler,
            seed=args.seed,
            russian_roulette=args.russian_roulette,
            clamp_indirect=args.clamp_indirect,
        )
        if args.adaptive:
            import numpy as np

            return np.asarray(renderer.render_adaptive(
                scene, args.image_width, args.image_height,
                pilot_spp=args.adaptive if args.adaptive >= 2 else 0,
            ))
        if args.checkpoint:
            from .render.progressive import ProgressiveRenderer

            return ProgressiveRenderer(
                renderer, checkpoint_path=args.checkpoint
            ).render(
                scene, args.image_width, args.image_height,
                batch_spp=args.checkpoint_batch_spp,
            )
        if args.supersample > 1:
            import numpy as np

            return np.asarray(renderer.render_supersampled(
                scene, args.image_width, args.image_height,
                k=args.supersample,
            ))
        return renderer.render(scene, args.image_width, args.image_height)

    device_table = None
    import time as _time

    t_render0 = _time.perf_counter()
    if profile_mode == "device":
        from .utils.profiler import format_device_summary, run_with_device_trace

        fb, agg = run_with_device_trace(do_render)
        device_table = format_device_summary(agg)
    else:
        fb = do_render()
    render_s = _time.perf_counter() - t_render0
    timer.log_info_elapsed("scene rendered")

    aovs = None
    aov_s = 0.0
    aov_spp = 0
    if args.aov or args.denoise:
        from .render.aov import render_aovs

        # The AOV pass is a separate primary-visibility render (the
        # regenerating wavefront has no stable per-pixel first-bounce slot
        # to reuse); its cost is timed and its samples are COUNTED in
        # --stats so the throughput line reflects the full budget spent.
        aov_spp = 4
        t_aov0 = _time.perf_counter()
        aovs = render_aovs(
            scene, args.image_width, args.image_height,
            spp=aov_spp, seed=args.seed, sampler=args.sampler,
        )
        aov_s = _time.perf_counter() - t_aov0
        timer.log_info_elapsed(f"aovs rendered ({aov_spp} spp)")
    if args.denoise:
        from .render.denoise import denoise

        fb = denoise(fb, aovs, iterations=args.denoise)
        timer.log_info_elapsed("denoised")

    write_image(args.image_out_path, fb, n_threads=args.thread_pool_size)
    timer.log_info_elapsed("scene written to file")

    if args.aov:
        from .render.aov import write_aovs

        for p in write_aovs(args.image_out_path, aovs):
            logging.info("aov written: %s", p)
        timer.log_info_elapsed("aovs written")

    if args.stats:
        px = args.image_width * args.image_height
        paths = px * args.samples_per_pixel
        total_paths = paths + px * aov_spp
        total_s = render_s + aov_s
        line = (
            f"stats: {total_paths:,} paths in {total_s:.3f} s "
            f"(incl. compile on first run) = "
            f"{total_paths / total_s / 1e6:.2f} Mpaths/s"
        )
        if aov_spp:
            line += (
                f" [beauty {paths:,} paths / {render_s:.3f} s"
                f" + aov pass {px * aov_spp:,} paths / {aov_s:.3f} s]"
            )
        print(line)

    from .utils.profiler import format_zone_summary, profiling_enabled

    if profiling_enabled():
        print(format_zone_summary())
    if device_table is not None:
        print(device_table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
