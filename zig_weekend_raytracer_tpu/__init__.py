"""zig_weekend_raytracer_tpu — a wavefront path-tracing framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``j-helland/zig-weekend-raytracer`` (a multithreaded CPU path tracer in Zig
implementing "Ray Tracing in One Weekend" books 1-3 plus PBRT-4e techniques).

Design (data-parallel, not a port):
  * Scenes compile to flat SoA device arrays (sphere/quad tables, material and
    texture tables, an image atlas, a light list, a linearized BVH).
  * The recursive per-ray integrator (reference: src/render.zig:188-289)
    becomes an iterative batched wavefront loop (``lax.while_loop`` over
    bounces, lanes respawning their next sample when a path ends) with
    masked live-ray state.
  * Tagged-union dispatch (reference: src/entity.zig:17, src/material.zig:25)
    becomes branchless masked select over type-code tables.
  * Data parallelism (reference: std.Thread.Pool over pixel blocks,
    src/render.zig:55-73) becomes sharding over a ``jax.sharding.Mesh`` with
    XLA collectives (see ``parallel/``).

Typical usage:

    import zig_weekend_raytracer_tpu as zwrt
    scene = zwrt.models.load_scene("cornell_box")
    img = zwrt.render.Renderer(samples_per_pixel=128).render(scene, 400, 400)
    zwrt.io.write_ppm("out.ppm", img)
"""

import os as _os

# ZWRT_CPU_DEVICES=N: virtual CPU device count (for --shard smoke runs
# without hardware; the XLA_FLAGS spelling is a no-op on jax 0.9).
if _os.environ.get("ZWRT_CPU_DEVICES"):
    import jax as _jax

    _jax.config.update(
        "jax_num_cpu_devices", int(_os.environ["ZWRT_CPU_DEVICES"])
    )

REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ=_os.environ):
    """Where this package points JAX's persistent compilation cache: None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself) or
    ``ZWRT_NO_COMPILE_CACHE`` opts out, else ``<repo>/.jax_cache``.  A
    fixed path, because the path is part of what the cache matches on."""
    if environ.get("JAX_COMPILATION_CACHE_DIR") or environ.get(
        "ZWRT_NO_COMPILE_CACHE"
    ):
        return None
    return _os.path.join(REPO_ROOT, ".jax_cache")


# Persistent XLA compilation cache: the render programs take seconds to
# minutes to compile, so keep them across processes.
if not _os.environ.get("ZWRT_NO_COMPILE_CACHE"):
    import jax as _jax

    if compile_cache_dir() is not None:
        _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

from . import dtypes
from . import math
from . import sampling
from . import geometry
from . import textures
from . import materials
from . import scene
from . import models
from . import render
from . import ops
from . import parallel
from . import io
from . import utils

__version__ = "0.1.0"
