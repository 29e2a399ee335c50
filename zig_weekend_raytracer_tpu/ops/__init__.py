"""Hot-path compute ops: closest-hit tracing (brute-force and stackless BVH)
and the shading-attribute fetch.
"""

from . import trace
from .shade import ShadeAttrs, shade_attrs
from .trace import Hit, closest_hit
