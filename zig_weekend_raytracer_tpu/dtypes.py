"""Precision policy.

The reference uses ``Real = f64`` throughout (reference: src/math/math.zig:40).
Accelerators run f64 far slower than f32 (or emulate it); the framework
is f32-native.  The
reference's float-robustness tricks are kept and retuned for f32:

  * AABB slab-test ULP slack: the reference multiplies tmax by a 4-ULP
    "MaxMult" factor (reference: src/math/aabb.zig:94-98, math.zig:101-107).
    We use the f32 constant from the same jcgt2013 robust-BVH listing.
  * Shadow-acne t_min: the reference uses 1e-4 in f64
    (reference: src/render.zig:203).  At Cornell-box scale (coordinates up to
    555, ray t up to ~900) an f32 ULP is ~6e-5, so 1e-4 is inside rounding
    noise; we default to 1e-3 (same value the reference uses for its PDF
    re-traces, src/entity.zig:506,631).
  * NaN scrub at image encode (reference: src/writer/writer.zig:83-94) kept.
"""

import jax.numpy as jnp
import numpy as np

# Compute dtype for all geometry/shading math.
real = jnp.float32
real_np = np.float32

# 4-ULP MaxMult robustness factor for the f32 AABB slab test
# (jcgt2013 robust-BVH listing 5; reference: src/math/math.zig:101-107).
AABB_MAX_MULT = real_np(1.00000024)

# t_min used when tracing bounce rays (shadow-acne epsilon).
T_MIN = real_np(1e-3)

# t_min used inside light-PDF evaluation re-traces
# (reference: src/entity.zig:506,631 uses 1e-3).
T_MIN_PDF = real_np(1e-3)

# Parallel-ray epsilon in the quad plane test (reference: src/entity.zig:481).
QUAD_PARALLEL_EPS = real_np(1e-8)

INF = real_np(np.inf)

# Largest float strictly below 1.0 in f32 (reference: src/math/sampler.zig:7).
ONE_MINUS_EPS = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))

# Rec.709 luminance weights, shared by every module that reduces RGB to
# luminance: the indirect clamp (render/integrator.py), the adaptive
# sampler's noise proxy and the denoiser's edge stop.
LUM_R = real_np(0.2126)
LUM_G = real_np(0.7152)
LUM_B = real_np(0.0722)
