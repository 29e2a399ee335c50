"""Sampling: content-addressed RNG streams, distribution helpers, and the
pixel-sampler framework (independent / stratified / Sobol-Owen).

The reference uses a lazily seeded thread-local PRNG
(reference: src/math/rng.zig:6-27); the wavefront analog is a stateless
hash RNG (``hashrng``) keyed by (seed, global ray id, stream site) — every
ray draws iid values from one vectorized call, there is no shared RNG state,
and renders are bitwise-invariant to chunking and device count.
"""

from . import hashrng
from . import sobol
from .sampler import SamplerKind, pixel_offsets, sample_dimension
