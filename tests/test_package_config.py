"""Package-level configuration: where the persistent XLA compilation
cache goes."""

import os
import subprocess
import sys

import pytest

import zig_weekend_raytracer_tpu as zwrt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_defaults_to_repo():
    assert zwrt.compile_cache_dir({}) == os.path.join(ROOT, ".jax_cache")
    assert zwrt.REPO_ROOT == ROOT


@pytest.mark.parametrize("env", [
    {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"},
    {"ZWRT_NO_COMPILE_CACHE": "1"},
])
def test_cache_dir_left_to_jax(env):
    """With JAX's own variable set the package sets no directory (JAX
    reads the variable itself); the opt-out sets none either."""
    assert zwrt.compile_cache_dir(env) is None


@pytest.mark.parametrize("use_env", [True, False])
def test_cache_dir_in_a_fresh_process(tmp_path, use_env):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "ZWRT_NO_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    if use_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    res = subprocess.run(
        [sys.executable, "-c",
         "import zig_weekend_raytracer_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=dict(env, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    want = str(tmp_path) if use_env else os.path.join(ROOT, ".jax_cache")
    assert res.stdout.strip() == want
