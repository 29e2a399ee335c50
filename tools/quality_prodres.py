"""Production-resolution quality + overhead for adaptive / denoise.

Tile-scale MSE tests (16x16/32x32) say little about full frames.  This
measures the real thing: 400x400 (configurable),
MSE vs a 512-spp reference of the SAME backend, at 8 and 32 spp, for
uniform / adaptive / denoised-uniform / adaptive+denoise, pooled over
seeds -- plus the wall-clock of each pipeline so the quality-per-second
story is honest (the denoise row includes its AOV pass at spp=4 and the
filter itself, which the CLI's --stats counts too).

Usage: python tools/quality_prodres.py [scene ...] [--size=N] [--spp=8,32]
                                       [--seeds=3]
Prints one JSON line per (scene, spp) with MSE ratios vs uniform and
wall-clock seconds per variant, then one summary line.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _mse(a, b):
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def main() -> None:
    import zig_weekend_raytracer_tpu as zwrt
    from zig_weekend_raytracer_tpu.render.aov import render_aovs
    from zig_weekend_raytracer_tpu.render.denoise import denoise

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    opts = dict(
        a[2:].split("=", 1) if "=" in a else (a[2:], "1")
        for a in sys.argv[1:] if a.startswith("--")
    )
    scenes = args or ["cornell_box", "balls"]
    size = int(opts.get("size", 400))
    spps = [int(s) for s in opts.get("spp", "8,32").split(",")]
    n_seeds = int(opts.get("seeds", 3))
    ref_spp = int(opts.get("ref_spp", 512))

    results = []
    for scene_name in scenes:
        scene = zwrt.models.load_scene(scene_name)
        ref = np.asarray(
            zwrt.render.Renderer(
                samples_per_pixel=ref_spp, max_ray_bounce_depth=10, seed=999,
            ).render_device(scene, size, size)
        )
        for spp in spps:
            mses = {k: [] for k in ("uniform", "adaptive", "denoise", "both")}
            times = {k: [] for k in ("uniform", "adaptive", "denoise", "both")}
            for seed in range(n_seeds):
                r = zwrt.render.Renderer(
                    samples_per_pixel=spp, max_ray_bounce_depth=10, seed=seed,
                )
                t0 = time.time()
                fb_u = np.asarray(r.render_device(scene, size, size))
                t_uniform = time.time() - t0
                t0 = time.time()
                fb_a = np.asarray(r.render_adaptive(scene, size, size))
                t_adaptive = time.time() - t0
                t0 = time.time()
                aovs = render_aovs(scene, size, size, seed=seed)
                t_aov = time.time() - t0
                t0 = time.time()
                fb_ud = denoise(fb_u, aovs)
                t_filter = time.time() - t0
                fb_ad = denoise(fb_a, aovs)
                times["uniform"].append(t_uniform)
                times["adaptive"].append(t_adaptive)
                times["denoise"].append(t_uniform + t_aov + t_filter)
                times["both"].append(t_adaptive + t_aov + t_filter)
                for k, fb in (("uniform", fb_u), ("adaptive", fb_a),
                              ("denoise", fb_ud), ("both", fb_ad)):
                    mses[k].append(_mse(fb, ref))
            base = float(np.mean(mses["uniform"]))
            row = {
                "scene": scene_name, "size": size, "spp": spp,
                "seeds": n_seeds, "ref_spp": ref_spp,
                "mse_uniform": round(base, 6),
                "mse_ratio": {
                    k: round(float(np.mean(v)) / base, 4)
                    for k, v in mses.items()
                },
                "wall_s": {
                    k: round(float(np.median(v)), 3)
                    for k, v in times.items()
                },
            }
            results.append(row)
            print(json.dumps(row))
    print(json.dumps({"summary": "quality_prodres", "rows": len(results)}))


if __name__ == "__main__":
    main()
