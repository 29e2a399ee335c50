"""Test configuration: run everything on a virtual 8-device CPU mesh so
sharding tests work without accelerator hardware."""

import os
import sys

# Force CPU: the suite must run hermetically on a virtual 8-device CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"

# repo root on sys.path so `import __graft_entry__` works
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_threefry_partitionable", True)

assert len(jax.devices()) == 8, jax.devices()
