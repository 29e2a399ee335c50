"""utils/device.py: naming the device, refusing a non-GPU backend, and the
timing statistics every measurement reports."""

import jax.numpy as jnp
import numpy as np
import pytest

from zig_weekend_raytracer_tpu.utils import device


def test_quartiles_of_known_sample():
    q = device.quartiles([5.0, 1.0, 3.0, 2.0, 4.0])
    assert q == {"median": 3.0, "q1": 2.0, "q3": 4.0}


def test_time_runs_blocks_on_each_result():
    calls = []

    def fn():
        calls.append(1)
        return jnp.arange(1000.0).sum()

    times = device.time_runs(fn, 5)
    assert len(times) == 5 and len(calls) == 5
    assert all(t > 0 for t in times)


def test_require_gpu_refuses_the_cpu():
    info = device.device_info()
    assert info["platform"] == "cpu" and info["count"] == 8
    with pytest.raises(device.NoGpuError, match="no GPU"):
        device.require_gpu()


def test_nvidia_smi_missing_is_reported(monkeypatch):
    """Without the tool the card line says so instead of raising."""
    monkeypatch.setenv("PATH", "/nonexistent")
    line = device.nvidia_smi_name_power()
    assert line.startswith("nvidia-smi")
    assert "unavailable" in line or "failed" in line


def test_peak_bytes_is_none_or_int():
    v = device.peak_bytes_in_use()
    assert v is None or (isinstance(v, int) and v >= 0)
