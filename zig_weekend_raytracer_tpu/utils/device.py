"""Naming the device a measurement ran on, and timing device work.

Every number this project reports names its device: JAX's platform,
``device_kind`` and device count, plus the card's name and power limit as
``nvidia-smi`` reports them (a card set below its maximum power runs slower
under load).  A measurement that finds no GPU fails; it never falls back.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np


def nvidia_smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one line per card, or a note when the tool is missing or fails.  Call
    it before JAX first touches the card."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    if res.returncode != 0:
        return f"nvidia-smi failed (rc={res.returncode})"
    return res.stdout.strip()


def device_info() -> dict:
    """{"platform", "kind", "count"} of the default JAX backend."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


class NoGpuError(RuntimeError):
    """The default JAX backend is not a GPU."""


def require_gpu(count: int = 1) -> dict:
    """``device_info()``, after checking the backend is a GPU with at least
    ``count`` devices; raises NoGpuError otherwise."""
    info = device_info()
    if info["platform"] != "gpu":
        raise NoGpuError(
            f"no GPU: JAX's default backend is {info['platform']!r} "
            f"({info['kind']})"
        )
    if info["count"] < count:
        raise NoGpuError(f"need {count} GPUs, JAX sees {info['count']}")
    return info


def time_runs(fn, runs: int) -> list:
    """Wall seconds of ``runs`` calls of ``fn``, each ending in
    ``block_until_ready`` on its result (JAX returns before the device
    finishes, so a timing without it measures the enqueue)."""
    import jax

    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def quartiles(values) -> dict:
    """Median and quartiles of a sample, unrounded."""
    q1, med, q3 = np.percentile(np.asarray(values, np.float64), [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3)}


def peak_bytes_in_use(device=None):
    """``memory_stats()["peak_bytes_in_use"]`` of a device (default: the
    first), or None where the backend keeps no statistics."""
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")
