"""Multi-chip scale-out over a ``jax.sharding.Mesh``.

The reference's only parallelism is data parallelism over pixel blocks on a
thread pool with a lock-free shared framebuffer (src/render.zig:55-73,
§2.4 of SURVEY.md).  The device-mesh equivalents:

  * **tile (row) sharding** — each device renders a disjoint row band;
    the framebuffer is concatenated across the mesh (no collective needed
    until the host gather), the direct analog of the reference's disjoint
    pixel partitions.
  * **sample sharding** — each device renders all pixels with a disjoint
    slice of the sample budget; one ``psum`` across the mesh sums the
    framebuffers (the "communication backend" the reference never needed
    beyond shared memory).
"""

from .mesh import make_mesh
from .render import (
    render_adaptive_sharded,
    render_batch_sharded,
    render_sharded,
)
