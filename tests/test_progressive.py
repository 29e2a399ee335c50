"""Progressive checkpoint/resume tests: an interrupted render resumed from
its checkpoint must equal an uninterrupted one bit-for-bit (guaranteed by
the content-addressed RNG)."""

import numpy as np
import pytest

import zig_weekend_raytracer_tpu as zwrt
from zig_weekend_raytracer_tpu.render import ProgressiveRenderer, Renderer


@pytest.fixture(scope="module")
def scene():
    return zwrt.models.load_scene("cornell_box")


def test_progressive_equals_oneshot(scene, tmp_path):
    base = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    oneshot = base.render(scene, 12, 12)

    ck = str(tmp_path / "ck.npz")
    prog = ProgressiveRenderer(renderer=base, checkpoint_path=ck)
    fb = prog.render(scene, 12, 12, batch_spp=3)
    np.testing.assert_allclose(fb, oneshot, rtol=1e-5, atol=1e-7)


def test_progressive_bvh_scene_equals_reference(tmp_path):
    """Progressive batches on a BVH scene sum to the per-bounce reference
    render (the batches start mid-sequence: sample0 > 0)."""
    sc = zwrt.models.load_scene("balls")
    base = Renderer(samples_per_pixel=6, max_ray_bounce_depth=3, seed=1)
    ref = np.asarray(base.render_reference(sc, 12, 10))
    fb = ProgressiveRenderer(
        renderer=base, checkpoint_path=str(tmp_path / "ck.npz")
    ).render(sc, 12, 10, batch_spp=4)
    np.testing.assert_allclose(fb, ref, rtol=1e-5, atol=1e-7)


def test_resume_from_checkpoint(scene, tmp_path):
    base = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    oneshot = base.render(scene, 12, 12)

    ck = str(tmp_path / "ck.npz")

    # Simulate a crash after the first batch: run batches but stop early by
    # raising from the callback.
    class Stop(Exception):
        pass

    prog = ProgressiveRenderer(renderer=base, checkpoint_path=ck)

    def bail(done, _img):
        if done >= 3:
            raise Stop

    with pytest.raises(Stop):
        prog.render(scene, 12, 12, batch_spp=3, on_batch=bail)

    z = np.load(ck)
    assert int(z["samples_done"]) == 3

    # Resume: must complete and match the uninterrupted render.
    prog2 = ProgressiveRenderer(renderer=base, checkpoint_path=ck)
    fb = prog2.render(scene, 12, 12, batch_spp=3)
    np.testing.assert_allclose(fb, oneshot, rtol=1e-5, atol=1e-7)


def test_mismatched_checkpoint_restarts(scene, tmp_path):
    ck = str(tmp_path / "ck.npz")
    r8 = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    ProgressiveRenderer(renderer=r8, checkpoint_path=ck).render(
        scene, 12, 12, batch_spp=8
    )
    # different seed -> fingerprint mismatch -> fresh start, still correct
    r_other = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=9)
    fb = ProgressiveRenderer(renderer=r_other, checkpoint_path=ck).render(
        scene, 12, 12, batch_spp=8
    )
    oneshot = r_other.render(scene, 12, 12)
    np.testing.assert_allclose(fb, oneshot, rtol=1e-5, atol=1e-7)


def test_progressive_stratified_equals_oneshot(scene, tmp_path):
    """STRATIFIED derives strata geometry from total spp; batching must not
    change it (each batch passes spp=total and bounds validity instead)."""
    from zig_weekend_raytracer_tpu.sampling.sampler import SamplerKind

    base = Renderer(
        samples_per_pixel=9, max_ray_bounce_depth=3, seed=4,
        sampler=SamplerKind.STRATIFIED,
    )
    oneshot = base.render(scene, 8, 8)
    ck = str(tmp_path / "ck_strat.npz")
    prog = ProgressiveRenderer(renderer=base, checkpoint_path=ck)
    fb = prog.render(scene, 8, 8, batch_spp=4)
    np.testing.assert_allclose(fb, oneshot, rtol=1e-5, atol=1e-7)


def test_cli_checkpoint_resume(tmp_path):
    """--checkpoint drives the progressive path from the CLI: the full
    render matches the plain CLI render after quantization, and a resumed
    render (checkpoint left by a smaller batch pass) completes to the same
    PPM bytes."""
    from PIL import Image

    from zig_weekend_raytracer_tpu.cli import main

    common = [
        "--image_width=12", "--image_height=12", "--samples_per_pixel=8",
        "--ray_bounce_max_depth=3", "--scene=cornell_box",
    ]
    plain = str(tmp_path / "plain.ppm")
    prog = str(tmp_path / "prog.ppm")
    ck = str(tmp_path / "ck.npz")
    assert main(common + [f"--image_out_path={plain}"]) == 0
    assert main(common + [
        f"--image_out_path={prog}", f"--checkpoint={ck}",
        "--checkpoint_batch_spp=4",
    ]) == 0
    a = np.asarray(Image.open(plain), np.int16)
    b = np.asarray(Image.open(prog), np.int16)
    assert np.abs(a - b).max() <= 1  # float reassociation vs one-shot
    # resume path: second run with the finished checkpoint present is a
    # no-op resume and must produce identical bytes
    prog2 = str(tmp_path / "prog2.ppm")
    assert main(common + [
        f"--image_out_path={prog2}", f"--checkpoint={ck}",
        "--checkpoint_batch_spp=4",
    ]) == 0
    assert open(prog, "rb").read() == open(prog2, "rb").read()


def test_cli_checkpoint_rejects_adaptive(tmp_path):
    from zig_weekend_raytracer_tpu.cli import main

    rc = main([
        "--image_width=8", "--image_height=8", "--adaptive=1",
        "--checkpoint=/tmp/never.npz", "--image_out_path=/tmp/never.ppm",
    ])
    assert rc == 1


def test_progressive_sharded_equals_oneshot(scene, tmp_path):
    """--checkpoint composes with --shard.  Sharded progressive
    batches (render_batch_sharded) complete to the single-device one-shot
    image (tolerance: psum/f32 reassociation), in both shard modes."""
    from zig_weekend_raytracer_tpu.parallel import make_mesh

    base = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    oneshot = base.render(scene, 12, 12)
    for shard in ("samples", "rows"):
        ck = str(tmp_path / f"ck_{shard}.npz")
        prog = ProgressiveRenderer(
            renderer=base, checkpoint_path=ck, shard=shard,
            mesh=make_mesh(4),
        )
        fb = prog.render(scene, 12, 12, batch_spp=3)
        np.testing.assert_allclose(fb, oneshot, rtol=1e-4, atol=1e-6)


def test_progressive_sharded_bitwise_resume(scene, tmp_path):
    """A crash-resumed sharded render equals the uninterrupted sharded
    render bit-for-bit (same mesh + mode = same summation order)."""
    from zig_weekend_raytracer_tpu.parallel import make_mesh

    base = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    mesh = make_mesh(4)
    ck_full = str(tmp_path / "full.npz")
    uninterrupted = ProgressiveRenderer(
        renderer=base, checkpoint_path=ck_full, shard="samples", mesh=mesh,
    ).render(scene, 12, 12, batch_spp=3)

    class Stop(Exception):
        pass

    def bail(done, _img):
        if done >= 3:
            raise Stop

    ck = str(tmp_path / "crash.npz")
    with pytest.raises(Stop):
        ProgressiveRenderer(
            renderer=base, checkpoint_path=ck, shard="samples", mesh=mesh,
        ).render(scene, 12, 12, batch_spp=3, on_batch=bail)
    assert int(np.load(ck)["samples_done"]) == 3
    fb = ProgressiveRenderer(
        renderer=base, checkpoint_path=ck, shard="samples", mesh=mesh,
    ).render(scene, 12, 12, batch_spp=3)
    np.testing.assert_array_equal(fb, uninterrupted)


def test_progressive_shard_fingerprint_pins_decomposition(scene, tmp_path):
    """Resuming under a different mesh size restarts (the estimator is
    decomposition-independent, the bits are not)."""
    from zig_weekend_raytracer_tpu.parallel import make_mesh

    base = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    ck = str(tmp_path / "ck.npz")
    ProgressiveRenderer(
        renderer=base, checkpoint_path=ck, shard="samples",
        mesh=make_mesh(2),
    ).render(scene, 8, 8, batch_spp=8)
    fb = ProgressiveRenderer(
        renderer=base, checkpoint_path=ck, shard="samples",
        mesh=make_mesh(4),
    ).render(scene, 8, 8, batch_spp=8)  # mismatch -> fresh, still correct
    oneshot = base.render(scene, 8, 8)
    np.testing.assert_allclose(fb, oneshot, rtol=1e-4, atol=1e-6)


def test_progressive_sharded_kernel_path(scene, tmp_path):
    """The production regenerating path inside sharded progressive
    batches."""
    from zig_weekend_raytracer_tpu.parallel import make_mesh

    base = Renderer(samples_per_pixel=8, max_ray_bounce_depth=3, seed=2)
    oneshot = base.render(scene, 12, 12)
    ck = str(tmp_path / "ck.npz")
    fb = ProgressiveRenderer(
        renderer=base, checkpoint_path=ck, shard="rows", mesh=make_mesh(4),
    ).render(scene, 12, 12, batch_spp=3)
    np.testing.assert_allclose(fb, oneshot, rtol=1e-4, atol=1e-6)


def test_cli_checkpoint_with_shard(tmp_path):
    from PIL import Image

    from zig_weekend_raytracer_tpu.cli import main

    common = [
        "--image_width=12", "--image_height=12", "--samples_per_pixel=8",
        "--ray_bounce_max_depth=3", "--scene=cornell_box",
    ]
    plain = str(tmp_path / "plain.ppm")
    prog = str(tmp_path / "prog.ppm")
    ck = str(tmp_path / "ck.npz")
    assert main(common + [f"--image_out_path={plain}"]) == 0
    assert main(common + [
        f"--image_out_path={prog}", f"--checkpoint={ck}",
        "--checkpoint_batch_spp=4", "--shard=samples",
    ]) == 0
    a = np.asarray(Image.open(plain), np.int16)
    b = np.asarray(Image.open(prog), np.int16)
    assert np.abs(a - b).max() <= 1


def test_sharded_batches_share_one_compiled_fn(scene):
    """sample0 is a DYNAMIC input of the sharded pipeline — every full
    batch of a progressive render must reuse one compiled shard_map
    function (baking sample0 into the closure would recompile per
    batch)."""
    from zig_weekend_raytracer_tpu.parallel import (
        make_mesh, render_batch_sharded,
    )
    from zig_weekend_raytracer_tpu.parallel import render as prender

    mesh = make_mesh(2)
    prender._sharded_fn_cache.pop(scene.compiled, None)
    a = render_batch_sharded(scene, 8, 8, 12, 0, 4, max_depth=2,
                             mesh=mesh, shard="samples", seed=5)
    n_after_first = len(prender._sharded_fn_cache[scene.compiled])
    b = render_batch_sharded(scene, 8, 8, 12, 4, 4, max_depth=2,
                             mesh=mesh, shard="samples", seed=5)
    c = render_batch_sharded(scene, 8, 8, 12, 8, 4, max_depth=2,
                             mesh=mesh, shard="samples", seed=5)
    assert len(prender._sharded_fn_cache[scene.compiled]) == n_after_first
    # and the three batch sums average to the one-shot render
    total = (np.asarray(a) + np.asarray(b) + np.asarray(c)) / 12
    oneshot = np.asarray(
        Renderer(
            samples_per_pixel=12, max_ray_bounce_depth=2, seed=5
        ).render(scene, 8, 8)
    )
    np.testing.assert_allclose(total, oneshot, rtol=1e-4, atol=1e-6)
