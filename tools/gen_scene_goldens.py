"""Generate CPU/XLA region-statistics references for every model-zoo scene.

Companion to tools/gen_bench_golden.py (which covers only the bench's
cornell config): each scene exercises a different part of the compiled
render — cornell/emissive light sampling, balls the DoF + BVH, shrek_quads
image textures on quads, rtw_final BVH + textures + motion blur, earth the
sphere-UV atlas + checker mix — so a per-scene gate catches miscompiles
the cornell-only bench gate cannot see.

The configs are deliberately smaller than the bench (200x200, 32-64 spp):
big enough that 25x25-pixel region means average >= 20k samples (MC-noise
<< the 2% gate — and the content-addressed RNG means the GPU render uses
the SAME sample set, so the only divergence is float-level), small enough
that the CPU/XLA generation pass stays in minutes.

Usage: JAX_PLATFORMS=cpu python tools/gen_scene_goldens.py
Writes tests/golden/scene_regions.json.  Check on the GPU with
tools/golden_check.py.
"""

import json
import os
import sys

# The reference MUST come from the CPU per-bounce path.
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()

import numpy as np  # noqa: E402

GRID = 8
OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden", "scene_regions.json",
)

# (scene, width, height, spp, depth) — depths match the per-scene bench
# configs (BASELINE.json) so the golden covers the same code paths.
CONFIGS = [
    ("cornell_box", 200, 200, 64, 10),
    ("emissive", 200, 200, 64, 10),
    ("balls", 200, 200, 32, 10),
    ("shrek_quads", 200, 200, 64, 10),
    ("rtw_final", 200, 200, 32, 8),
    ("earth", 200, 200, 32, 10),
]


def main() -> None:
    import zig_weekend_raytracer_tpu as zwrt
    # The SAME region definition the gate uses — generator/gate divergence
    # would make every regenerated golden mis-scored.
    from zig_weekend_raytracer_tpu.utils.goldengate import region_means

    # argv selects a subset (e.g. a newly added scene) to regenerate into
    # the existing file; default regenerates everything
    only = set(sys.argv[1:])
    known = {c[0] for c in CONFIGS}
    if only - known:
        raise SystemExit(f"unknown scenes {sorted(only - known)}; "
                         f"valid: {sorted(known)}")
    payload = {"grid": GRID, "scenes": {}}
    if only:
        if not os.path.exists(OUT):
            raise SystemExit(
                f"{OUT} missing: a subset regen would write a partial "
                "golden; run without arguments first"
            )
        with open(OUT) as f:
            payload = json.load(f)
        assert payload.get("grid") == GRID
    for name, w, h, spp, depth in CONFIGS:
        if only and name not in only:
            continue
        scene = zwrt.models.load_scene(name)
        fb = np.asarray(
            zwrt.render.Renderer(
                samples_per_pixel=spp, max_ray_bounce_depth=depth, seed=0
            ).render_reference(scene, w, h)
        )
        payload["scenes"][name] = {
            "width": w,
            "height": h,
            "spp": spp,
            "depth": depth,
            "mean": float(fb.mean()),
            "region_means": region_means(fb, GRID).tolist(),
        }
        print(f"{name}: mean {fb.mean():.4f}")
    with open(OUT, "w") as f:
        json.dump(payload, f, indent=1)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
