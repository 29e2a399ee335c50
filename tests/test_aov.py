"""First-hit AOV buffers (render/aov.py): albedo, normal, depth, coverage.

Beyond-reference capability (denoiser/compositing inputs).  Custom
one-primitive scenes pin exact values; cornell_box smoke-checks the
integration (wall colors land in the albedo buffer)."""

import numpy as np

import zig_weekend_raytracer_tpu as zwrt
from zig_weekend_raytracer_tpu.render.aov import render_aovs, write_aovs
from zig_weekend_raytracer_tpu.scene import Camera, SceneBuilder


def _wall_scene(color=(0.2, 0.5, 0.8)):
    b = SceneBuilder()
    mat = b.lambertian(b.solid_color(color))
    b.add(b.quad((-50, -50, -1), (100, 0, 0), (0, 100, 0), mat))
    b.set_background((0, 0, 0))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    return b.compile()


def test_wall_albedo_normal_depth_exact():
    scene = _wall_scene()
    a = render_aovs(scene, 8, 8, spp=2)
    assert a["coverage"].min() == 1.0  # wall fills the view
    np.testing.assert_allclose(a["albedo"][..., 0], 0.2, atol=1e-6)
    np.testing.assert_allclose(a["albedo"][..., 1], 0.5, atol=1e-6)
    np.testing.assert_allclose(a["albedo"][..., 2], 0.8, atol=1e-6)
    # quad normal u x v = +z, front-face oriented toward the camera
    np.testing.assert_allclose(a["normal"][..., 2], 1.0, atol=1e-6)
    np.testing.assert_allclose(a["normal"][..., :2], 0.0, atol=1e-6)
    # camera rays are unnormalized (pixel point - origin; the viewport
    # sits at the default focus distance 10), so the z=-1 wall at world
    # distance 6 reads t = 6/10 for every pixel of this head-on view
    np.testing.assert_allclose(a["depth"], 0.6, atol=1e-3)


def test_dielectric_albedo_is_white():
    b = SceneBuilder()
    glass = b.dielectric(1.5)
    b.add(b.sphere((0, 0, 0), 2.0, glass))
    b.set_background((0.1, 0.1, 0.1))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    scene = b.compile()
    a = render_aovs(scene, 9, 9, spp=2)
    c = a["albedo"][4, 4]
    assert a["coverage"][4, 4] == 1.0
    np.testing.assert_allclose(c, 1.0, atol=1e-6)


def test_miss_reads_background_and_zeroes():
    b = SceneBuilder()
    b.set_background((0.25, 0.5, 0.75))
    b.set_camera(Camera(look_from=(0, 0, 5), look_at=(0, 0, 0)))
    scene = b.compile()
    a = render_aovs(scene, 6, 6, spp=2)
    assert a["coverage"].max() == 0.0
    np.testing.assert_allclose(a["albedo"][..., 0], 0.25, atol=1e-6)
    np.testing.assert_allclose(a["albedo"][..., 2], 0.75, atol=1e-6)
    np.testing.assert_allclose(a["normal"], 0.0, atol=0)
    np.testing.assert_allclose(a["depth"], 0.0, atol=0)


def test_cornell_walls_in_albedo():
    scene = zwrt.models.load_scene("cornell_box")
    a = render_aovs(scene, 16, 16, spp=2)
    left = a["albedo"][:, :3]
    right = a["albedo"][:, -3:]
    assert left[..., 1].mean() > left[..., 0].mean()   # green wall
    assert right[..., 0].mean() > right[..., 1].mean()  # red wall
    assert np.isfinite(a["depth"]).all()
    hit = a["coverage"] == 1.0
    assert (a["depth"][hit] > 0).all()


def test_write_aovs_pngs(tmp_path):
    from PIL import Image

    scene = _wall_scene()
    a = render_aovs(scene, 8, 8, spp=1)
    paths = write_aovs(str(tmp_path / "out.ppm"), a)
    assert len(paths) == 3
    for p in paths:
        im = np.asarray(Image.open(p))
        assert im.shape[:2] == (8, 8)


def test_aovs_on_kernel_backend_match_xla():
    """The AOV pass through the BVH traversal agrees with the same scene
    traced by the brute-force scan (the two closest-hit strategies of
    ops/trace.py)."""
    from zig_weekend_raytracer_tpu.scene import Camera, SceneBuilder

    def build(bvh):
        rng = np.random.default_rng(3)
        b = SceneBuilder()
        for _ in range(40):
            m = b.lambertian(b.solid_color(tuple(rng.uniform(0.2, 0.9, 3))))
            b.add(b.sphere(rng.uniform(-4, 4, 3), rng.uniform(0.3, 1.0), m))
        b.use_bvh(bvh)
        b.set_camera(Camera(look_from=(0, 0, 14), look_at=(0, 0, 0)))
        b.set_background((0.5, 0.7, 1.0))
        return b.compile()

    tree, flat = build(True), build(False)
    assert tree.compiled.has_bvh and not flat.compiled.has_bvh
    a_kernel = render_aovs(tree, 12, 12, spp=2)
    a_ref = render_aovs(flat, 12, 12, spp=2)

    np.testing.assert_array_equal(a_kernel["coverage"], a_ref["coverage"])
    for key in ("albedo", "normal", "depth"):
        np.testing.assert_allclose(
            a_kernel[key], a_ref[key], rtol=3e-4, atol=1e-3,
        )


def test_cli_stats_counts_aov_pass(tmp_path, capsys):
    """--stats must account for the hidden AOV pass --denoise triggers:
    total paths include the aov spp and the breakdown names both passes
    (honest same-budget accounting)."""
    from zig_weekend_raytracer_tpu.cli import main

    out_path = tmp_path / "s.ppm"
    rc = main([
        "--image_width=8", "--image_height=8", "--samples_per_pixel=2",
        "--ray_bounce_max_depth=2", "--scene=cornell_box",
        f"--image_out_path={out_path}", "--denoise=1", "--stats=true",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    stats = [ln for ln in out.splitlines() if ln.startswith("stats:")]
    assert len(stats) == 1
    # 8*8*2 beauty + 8*8*4 aov = 384 total paths
    assert "384" in stats[0]
    assert "aov pass" in stats[0] and "beauty" in stats[0]


def test_cli_stats_no_aov_line_unchanged(tmp_path, capsys):
    """Without --aov/--denoise the stats line stays the plain single-pass
    form (no breakdown suffix)."""
    from zig_weekend_raytracer_tpu.cli import main

    out_path = tmp_path / "s.ppm"
    rc = main([
        "--image_width=8", "--image_height=8", "--samples_per_pixel=2",
        "--ray_bounce_max_depth=2", "--scene=cornell_box",
        f"--image_out_path={out_path}", "--stats=true",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    stats = [ln for ln in out.splitlines() if ln.startswith("stats:")]
    assert len(stats) == 1
    assert "128" in stats[0]
    assert "aov pass" not in stats[0]
