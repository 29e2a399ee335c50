"""bench.py and chip_smoke.py measure and check the GPU only: on a machine
without one they exit non-zero and never print a result."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [
    ["bench.py"], ["chip_smoke.py"], ["chip_smoke.py", "--four"],
])
def test_exits_nonzero_without_gpu(args):
    res = _run(args, ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "mpaths_per_s" not in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the repository, the script cannot run the
    renderer and must say so by its exit code."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], str(tmp_path))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_ppm_check(tmp_path):
    """The PPM validator accepts the CLI's P3 output and rejects a file
    with the wrong pixel count."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    from zig_weekend_raytracer_tpu.io.ppm import write_ppm
    import numpy as np

    good = tmp_path / "g.ppm"
    write_ppm(str(good), np.full((3, 4, 3), 0.25, np.float32))
    chip_smoke.check_ppm(str(good), 4, 3)
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke.check_ppm(str(good), 4, 4)
