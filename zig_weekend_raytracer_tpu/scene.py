"""Scene description and compilation to flat device arrays.

The reference builds a pointer graph of tagged-union entities on a memory
pool (reference: src/entity.zig:17-66, src/scene.zig:36-62).  A device
wavefront wants flat tables instead of pointers, so this module provides:

  * ``SceneBuilder`` — a host-side API mirroring the reference's scene
    construction surface (textures, materials, spheres, quads, boxes,
    translate / rotate-y instancing, collections, light lists, camera,
    background).
  * ``CompiledScene`` — the result: a pytree of SoA device arrays (sphere
    table, quad table, material table, texture table, image atlas, light
    list, optional linearized BVH).  Instancing transforms are *baked* into
    world-space primitives at compile time (in place of the reference's
    ray-transforming wrapper entities, src/entity.zig:68-206);
    sphere UVs keep the object-space orientation via a stored per-sphere
    inverse Y-rotation, so results match the reference exactly.

Material/texture/primitive "dispatch" becomes integer type codes consumed
branchlessly by the integrator.
"""

from __future__ import annotations

import math as _math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dtypes import real_np
from .math.v3 import V3


def _v3c(a: np.ndarray) -> V3:
    """Host (S, 3) array -> device SoA V3 of (S,) components."""
    a = np.asarray(a, real_np)
    return V3(jnp.asarray(a[..., 0]), jnp.asarray(a[..., 1]), jnp.asarray(a[..., 2]))

# Type codes (tagged-union tags become table codes).
MAT_LAMBERTIAN = 0  # reference: src/material.zig:99
MAT_ISOTROPIC = 1   # reference: src/material.zig:127
MAT_METAL = 2       # reference: src/material.zig:153
MAT_DIELECTRIC = 3  # reference: src/material.zig:181
MAT_DIFFUSE_LIGHT = 4  # reference: src/material.zig:79

TEX_SOLID = 0    # reference: src/texture.zig:80
TEX_CHECKER = 1  # reference: src/texture.zig:96
TEX_IMAGE = 2    # reference: src/texture.zig:33

PRIM_SPHERE = 0
PRIM_QUAD = 1

_F = real_np
_I = np.int32


# ---------------------------------------------------------------------------
# Camera (host-side; rasterization formulas from reference src/camera.zig)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Camera:
    """Look-at camera with optional defocus (depth of field).

    Construction matches reference src/camera.zig:61-90; ``viewport`` matches
    Viewport.init (src/camera.zig:117-157).
    """

    look_from: Tuple[float, float, float]
    look_at: Tuple[float, float, float]
    view_up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    vfov_degrees: float = 40.0
    focus_dist: float = 10.0
    defocus_angle_degrees: float = 0.0
    # Raster-grid shift in PIXEL units applied to pixel00 (default none).
    # Internal: render_supersampled uses it to keep the Sobol sampler's
    # PBRT-style raster convention aligned across resolutions — Sobol pixel
    # offsets live in [0,1) (parity: src/math/sampler.zig:222-233, same in
    # the reference), so pixel p covers [(p+.5)d, (p+1.5)d): a HALF-PIXEL
    # anchor that scales with resolution.  A k-res render tiles the base
    # pixels exactly only when shifted by (k-1)/2 sub-pixels.
    raster_shift: Tuple[float, float] = (0.0, 0.0)

    def basis(self):
        lf = np.asarray(self.look_from, np.float64)
        la = np.asarray(self.look_at, np.float64)
        vup = np.asarray(self.view_up, np.float64)
        w = lf - la
        w = w / np.linalg.norm(w)
        u = np.cross(vup, w)
        u = u / np.linalg.norm(u)
        v = np.cross(w, u)
        return u, v, w

    @property
    def has_depth_of_field(self) -> bool:
        return self.defocus_angle_degrees > 0.0

    def defocus_disk(self):
        u, v, _ = self.basis()
        radius = self.focus_dist * _math.tan(
            _math.radians(self.defocus_angle_degrees / 2.0)
        )
        return u * radius, v * radius

    def viewport(self, width: int, height: int):
        """Returns (pixel00_loc, pixel_delta_u, pixel_delta_v) as f32."""
        u, v, w = self.basis()
        aspect = width / height
        theta = _math.radians(self.vfov_degrees)
        h = _math.tan(theta / 2.0)
        vp_height = 2.0 * h * self.focus_dist
        vp_width = vp_height * aspect
        vp_u = vp_width * u
        vp_v = -vp_height * v
        lf = np.asarray(self.look_from, np.float64)
        upper_left = lf - self.focus_dist * w - vp_u / 2 - vp_v / 2
        du = vp_u / width
        dv = vp_v / height
        pixel00 = (
            upper_left + 0.5 * (du + dv)
            + self.raster_shift[0] * du + self.raster_shift[1] * dv
        )
        return pixel00.astype(_F), du.astype(_F), dv.astype(_F)


# ---------------------------------------------------------------------------
# Host-side entity nodes (flattened away at compile time)
# ---------------------------------------------------------------------------

@dataclass
class _Node:
    pass


@dataclass
class SphereNode(_Node):
    center: np.ndarray
    radius: float
    material: int
    move_to: Optional[np.ndarray] = None  # animated endpoint (motion blur)


@dataclass
class QuadNode(_Node):
    start: np.ndarray
    edge_u: np.ndarray
    edge_v: np.ndarray
    material: int


@dataclass
class ListNode(_Node):
    children: List[_Node] = field(default_factory=list)
    # When True the compiler builds a BVH subtree over this collection
    # (the analog of EntityCollection.createBvhTree, src/entity.zig:338).
    bvh: bool = False


@dataclass
class TranslateNode(_Node):
    offset: np.ndarray
    child: _Node


@dataclass
class RotateYNode(_Node):
    angle_degrees: float
    child: _Node


# ---------------------------------------------------------------------------
# Compiled scene pytree
# ---------------------------------------------------------------------------

_ARRAY_FIELDS = [
    # spheres
    "sph_center", "sph_radius", "sph_move", "sph_uv_cos", "sph_uv_sin",
    "sph_mat",
    # quads
    "quad_start", "quad_u", "quad_v", "quad_normal", "quad_w", "quad_offset",
    "quad_area", "quad_mat",
    # materials
    "mat_type", "mat_tex", "mat_albedo", "mat_fuzz", "mat_refract",
    # textures
    "tex_type", "tex_rgb", "tex_inv_scale", "tex_even", "tex_odd", "tex_img",
    # image atlas (channel planes + packed u32 plane)
    "atlas_r", "atlas_g", "atlas_b", "atlas_packed", "atlas_wh",
    # background
    "background",
    # denormalized per-prim shading records (see ops/shade.py)
    "shade_rows", "shade_cols_sph", "shade_cols_quad",
    # linearized BVH (over unified prim list); degenerate when not built
    "bvh_min", "bvh_max", "bvh_miss", "bvh_leaf_start", "bvh_leaf_count",
    "bvh_prim_kind", "bvh_prim_idx",
]

_STATIC_FIELDS = [
    "n_spheres", "n_quads", "n_materials", "n_textures",
    "has_moving", "has_bvh", "max_leaf_size", "has_image_textures",
    "lights", "image_dims", "needs_gauss", "has_nested_checker",
]


@dataclass(frozen=True, eq=False)
class CompiledScene:
    """SoA scene tables.  Array fields are pytree leaves; counts and feature
    flags are static (they select the compiled XLA program).

    ``eq=False``: identity semantics (and the inherited identity hash) —
    a generated field-wise __eq__/__hash__ over jax arrays would be
    unhashable, and the renderer's plan cache keys scenes weakly by
    object identity (render/renderer.py:_plan_cache)."""

    # spheres (padded to >=1; dummy entries can never be hit); V3 fields are
    # SoA component triples of (S,) arrays (see math/v3.py).
    sph_center: V3
    sph_radius: jnp.ndarray
    sph_move: V3
    sph_uv_cos: jnp.ndarray
    sph_uv_sin: jnp.ndarray
    sph_mat: jnp.ndarray
    # quads
    quad_start: V3
    quad_u: V3
    quad_v: V3
    quad_normal: V3
    quad_w: V3
    quad_offset: jnp.ndarray
    quad_area: jnp.ndarray
    quad_mat: jnp.ndarray
    # materials
    mat_type: jnp.ndarray
    mat_tex: jnp.ndarray
    mat_albedo: V3
    mat_fuzz: jnp.ndarray
    mat_refract: jnp.ndarray
    # textures
    tex_type: jnp.ndarray
    tex_rgb: V3
    tex_inv_scale: jnp.ndarray
    tex_even: jnp.ndarray
    tex_odd: jnp.ndarray
    tex_img: jnp.ndarray
    # image atlas, one (I, H, W) u8 plane per channel + packed u32 plane
    atlas_r: jnp.ndarray
    atlas_g: jnp.ndarray
    atlas_b: jnp.ndarray
    atlas_packed: jnp.ndarray
    atlas_wh: jnp.ndarray
    # background
    background: V3
    # (n_spheres + n_quads, 32) packed per-prim shading records, plus the
    # same data as per-kind 1D column tuples for small-scene select-chain
    # gathers (see ops/shade.py)
    shade_rows: jnp.ndarray
    shade_cols_sph: tuple
    shade_cols_quad: tuple
    # BVH
    bvh_min: V3
    bvh_max: V3
    bvh_miss: jnp.ndarray
    bvh_leaf_start: jnp.ndarray
    bvh_leaf_count: jnp.ndarray
    bvh_prim_kind: jnp.ndarray
    bvh_prim_idx: jnp.ndarray
    # static metadata
    n_spheres: int = 0
    n_quads: int = 0
    n_materials: int = 0
    n_textures: int = 0
    has_moving: bool = False
    has_bvh: bool = False
    max_leaf_size: int = 4
    has_image_textures: bool = False
    # True iff any material actually consumes the per-bounce gaussian triple
    # (isotropic scatter or fuzzy metal) — when False the bounce step
    # skips the Box-Muller transcendentals entirely.
    needs_gauss: bool = True
    # checker-in-checker nesting: records can't flatten it; the integrator
    # falls back to the general texture walk for such scenes
    has_nested_checker: bool = False
    # static (width, height) per atlas image: lets texture lookups compute
    # flat gather indices with compile-time strides (one 1D gather)
    image_dims: Tuple[Tuple[int, int], ...] = ((1, 1),)
    # Importance-sampled light list as STATIC ((kind, idx), ...) — the list
    # is tiny and static dispatch lets each slot evaluate only its own
    # primitive kind (reference: Scene.lights, src/scene.zig:43).
    lights: Tuple[Tuple[int, int], ...] = ()
    @property
    def n_lights(self) -> int:
        return len(self.lights)

    @property
    def has_lights(self) -> bool:
        return len(self.lights) > 0


def _scene_flatten(s: CompiledScene):
    children = tuple(getattr(s, f) for f in _ARRAY_FIELDS)
    aux = tuple(getattr(s, f) for f in _STATIC_FIELDS)
    return children, aux


def _scene_unflatten(aux, children):
    kwargs = dict(zip(_ARRAY_FIELDS, children))
    kwargs.update(dict(zip(_STATIC_FIELDS, aux)))
    return CompiledScene(**kwargs)


jax.tree_util.register_pytree_node(
    CompiledScene, _scene_flatten, _scene_unflatten
)


@dataclass(frozen=True)
class Scene:
    """A compiled scene plus its host-side render parameters."""

    compiled: CompiledScene
    camera: Camera
    background: Tuple[float, float, float]
    name: str = "scene"


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------

def _rot_y(angle_degrees: float) -> np.ndarray:
    """Object->world Y-rotation (reference: src/entity.zig:199-205)."""
    th = _math.radians(angle_degrees)
    c, s = _math.cos(th), _math.sin(th)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float64)


class SceneBuilder:
    """Mirror of the reference's scene-construction API (src/scene.zig),
    producing flat tables instead of a pointer graph."""

    def __init__(self) -> None:
        self._textures: List[dict] = []
        self._materials: List[dict] = []
        self._images: List[np.ndarray] = []
        self._roots: List[_Node] = []
        self._lights: List[_Node] = []
        self._camera: Optional[Camera] = None
        self._background = (0.0, 0.0, 0.0)
        self._root_bvh = False
        self._bvh_min_prims = 32

    # -- textures ----------------------------------------------------------
    def solid_color(self, rgb) -> int:
        self._textures.append({"kind": TEX_SOLID, "rgb": tuple(rgb)})
        return len(self._textures) - 1

    def checkerboard(self, inv_scale: float, tex_even: int, tex_odd: int) -> int:
        self._textures.append(
            {"kind": TEX_CHECKER, "inv_scale": inv_scale,
             "even": tex_even, "odd": tex_odd}
        )
        return len(self._textures) - 1

    def image_texture(self, image: np.ndarray) -> int:
        """``image`` is (H, W, 3) uint8."""
        img = np.ascontiguousarray(image[..., :3], dtype=np.uint8)
        self._images.append(img)
        self._textures.append({"kind": TEX_IMAGE, "img": len(self._images) - 1})
        return len(self._textures) - 1

    # -- materials ----------------------------------------------------------
    def lambertian(self, texture: int) -> int:
        self._materials.append({"type": MAT_LAMBERTIAN, "tex": texture})
        return len(self._materials) - 1

    def isotropic(self, texture: int) -> int:
        self._materials.append({"type": MAT_ISOTROPIC, "tex": texture})
        return len(self._materials) - 1

    def metal(self, albedo, fuzz: float) -> int:
        self._materials.append(
            {"type": MAT_METAL, "albedo": tuple(albedo), "fuzz": float(fuzz)}
        )
        return len(self._materials) - 1

    def dielectric(self, refraction_index: float) -> int:
        self._materials.append(
            {"type": MAT_DIELECTRIC, "refract": float(refraction_index)}
        )
        return len(self._materials) - 1

    def diffuse_light(self, texture: int) -> int:
        self._materials.append({"type": MAT_DIFFUSE_LIGHT, "tex": texture})
        return len(self._materials) - 1

    # -- entities ------------------------------------------------------------
    def sphere(self, center, radius: float, material: int) -> SphereNode:
        return SphereNode(
            np.asarray(center, np.float64), float(radius), material
        )

    def moving_sphere(self, center0, center1, radius: float, material: int) -> SphereNode:
        return SphereNode(
            np.asarray(center0, np.float64), float(radius), material,
            move_to=np.asarray(center1, np.float64),
        )

    def quad(self, start, edge_u, edge_v, material: int) -> QuadNode:
        return QuadNode(
            np.asarray(start, np.float64),
            np.asarray(edge_u, np.float64),
            np.asarray(edge_v, np.float64),
            material,
        )

    def box(self, point_a, point_b, material: int) -> ListNode:
        """Six quads spanning two opposite corners
        (reference: src/entity.zig:390-426)."""
        a = np.asarray(point_a, np.float64)
        b = np.asarray(point_b, np.float64)
        mn, mx = np.minimum(a, b), np.maximum(a, b)
        d = mx - mn
        dx = np.array([d[0], 0, 0])
        dy = np.array([0, d[1], 0])
        dz = np.array([0, 0, d[2]])
        faces = [
            (np.array([mn[0], mn[1], mx[2]]), dx, dy),    # front
            (np.array([mx[0], mn[1], mx[2]]), -dz, dy),   # right
            (np.array([mx[0], mn[1], mn[2]]), -dx, dy),   # back
            (np.array([mn[0], mn[1], mn[2]]), dz, dy),    # left
            (np.array([mn[0], mx[1], mx[2]]), dx, -dz),   # top
            (np.array([mn[0], mn[1], mn[2]]), dx, dz),    # bottom
        ]
        return ListNode([QuadNode(p, u, v, material) for p, u, v in faces])

    def collection(self, children: Sequence[_Node], bvh: bool = False) -> ListNode:
        return ListNode(list(children), bvh=bvh)

    def translate(self, offset, child: _Node) -> TranslateNode:
        return TranslateNode(np.asarray(offset, np.float64), child)

    def rotate_y(self, angle_degrees: float, child: _Node) -> RotateYNode:
        return RotateYNode(float(angle_degrees), child)

    # -- scene assembly -------------------------------------------------------
    def add(self, node: _Node) -> _Node:
        self._roots.append(node)
        return node

    def set_lights(self, lights: Sequence[_Node]) -> None:
        """Entities to importance-sample (reference: Scene.lights,
        src/scene.zig:43).  Collections are expanded to their leaves, which
        matches the reference's uniform-average collection PDF
        (src/entity.zig:371-386)."""
        self._lights = list(lights)

    def set_camera(self, camera: Camera) -> None:
        self._camera = camera

    def set_background(self, rgb) -> None:
        self._background = tuple(rgb)

    def use_bvh(self, enable: bool = True, min_prims: int = 32) -> None:
        """Build a BVH over the flattened primitive list at compile time
        (the analog of createBvhTree on the root collection).  Below
        ``min_prims`` primitives no tree is built and every ray scans the
        whole table (the threshold is unmeasured on the GPU)."""
        self._root_bvh = enable
        self._bvh_min_prims = min_prims

    # -- compile --------------------------------------------------------------
    def compile(self, name: str = "scene") -> Scene:
        spheres: List[dict] = []
        quads: List[dict] = []
        # map id(node) -> (kind, index) for light resolution
        prim_of_node: dict = {}

        def walk(node: _Node, R: np.ndarray, t: np.ndarray, yrot: float):
            if isinstance(node, SphereNode):
                c = R @ node.center + t
                move = (
                    R @ (node.move_to - node.center)
                    if node.move_to is not None
                    else np.zeros(3)
                )
                idx = len(spheres)
                spheres.append(
                    {"center": c, "radius": node.radius, "move": move,
                     "mat": node.material, "yrot": yrot}
                )
                prim_of_node[id(node)] = (PRIM_SPHERE, idx)
            elif isinstance(node, QuadNode):
                start = R @ node.start + t
                eu = R @ node.edge_u
                ev = R @ node.edge_v
                idx = len(quads)
                quads.append(
                    {"start": start, "u": eu, "v": ev, "mat": node.material}
                )
                prim_of_node[id(node)] = (PRIM_QUAD, idx)
            elif isinstance(node, ListNode):
                for ch in node.children:
                    walk(ch, R, t, yrot)
            elif isinstance(node, TranslateNode):
                # Compose under the accumulated rotation: the reference's
                # Translate offsets the ray in the frame of its *enclosing*
                # transforms (src/entity.zig:93-99), so a translate nested
                # inside a rotate must bake world = R @ (p + offset).
                walk(node.child, R, t + R @ node.offset, yrot)
            elif isinstance(node, RotateYNode):
                Ry = _rot_y(node.angle_degrees)
                # world = t + R @ (Ry @ p): compose rotations/offsets.
                walk(node.child, R @ Ry, t, yrot + node.angle_degrees)
            else:
                raise TypeError(f"unknown node type {type(node)}")

        eye = np.eye(3)
        zero = np.zeros(3)
        for root in self._roots:
            walk(root, eye, zero, 0.0)

        # -- lights ---------------------------------------------------------
        light_entries: List[Tuple[int, int]] = []

        def collect_light(node: _Node):
            if isinstance(node, ListNode):
                for ch in node.children:
                    collect_light(ch)
            else:
                if id(node) not in prim_of_node:
                    raise ValueError(
                        "light entity was never added to the scene"
                    )
                light_entries.append(prim_of_node[id(node)])

        for ln in self._lights:
            collect_light(ln)

        compiled = _compile_tables(
            spheres, quads, self._materials, self._textures, self._images,
            light_entries, self._background,
            build_bvh=self._root_bvh
            and (len(spheres) + len(quads)) >= self._bvh_min_prims,
        )
        camera = self._camera or Camera(
            look_from=(0, 0, 9), look_at=(0, 0, 0)
        )
        return Scene(
            compiled=compiled, camera=camera,
            background=self._background, name=name,
        )


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _morton_code(points: np.ndarray) -> np.ndarray:
    """30-bit 3D Morton codes for an (N, 3) point cloud (normalized to its
    own bounding box)."""
    lo = points.min(0)
    span = np.maximum(points.max(0) - lo, 1e-12)
    q = np.clip(((points - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )


def _morton_sort(prims: list, center_fn):
    """Returns (sorted_prims, old->new index map)."""
    if len(prims) < 2:
        return prims, {i: i for i in range(len(prims))}
    pts = np.stack([center_fn(p) for p in prims])
    order = np.argsort(_morton_code(pts), kind="stable")
    perm = {int(old): new for new, old in enumerate(order)}
    return [prims[i] for i in order], perm


def _compile_tables(
    spheres, quads, materials, textures, images, light_entries, background,
    build_bvh: bool,
) -> CompiledScene:
    # Sort each primitive table along a Morton space-filling curve so that
    # neighbouring table entries are neighbours in space.
    spheres, sph_perm = _morton_sort(
        spheres, lambda s: np.asarray(s["center"], np.float64)
    )
    quads, quad_perm = _morton_sort(
        quads,
        lambda q: np.asarray(q["start"], np.float64)
        + 0.5 * (np.asarray(q["u"], np.float64) + np.asarray(q["v"], np.float64)),
    )
    light_entries = [
        (k, sph_perm[i] if k == PRIM_SPHERE else quad_perm[i])
        for k, i in light_entries
    ]

    n_s, n_q = len(spheres), len(quads)
    # Pad tables to a multiple of 8 (>=1) so XLA gets friendly minor dims;
    # dummy prims are constructed to be unhittable.
    s_pad = max(8, _round_up(max(n_s, 1), 8))
    q_pad = max(8, _round_up(max(n_q, 1), 8))

    sph_center = np.full((s_pad, 3), 1e30, _F)
    sph_radius = np.zeros((s_pad,), _F)
    sph_move = np.zeros((s_pad, 3), _F)
    sph_uv_cos = np.ones((s_pad,), _F)
    sph_uv_sin = np.zeros((s_pad,), _F)
    sph_mat = np.zeros((s_pad,), _I)
    for i, s in enumerate(spheres):
        sph_center[i] = s["center"]
        sph_radius[i] = s["radius"]
        sph_move[i] = s["move"]
        th = _math.radians(s["yrot"])
        sph_uv_cos[i] = _math.cos(th)
        sph_uv_sin[i] = _math.sin(th)
        sph_mat[i] = s["mat"]

    quad_start = np.zeros((q_pad, 3), _F)
    quad_u = np.zeros((q_pad, 3), _F)
    quad_v = np.zeros((q_pad, 3), _F)
    quad_normal = np.zeros((q_pad, 3), _F)  # zero normal => parallel => miss
    quad_w = np.zeros((q_pad, 3), _F)
    quad_offset = np.zeros((q_pad,), _F)
    quad_area = np.zeros((q_pad,), _F)
    quad_mat = np.zeros((q_pad,), _I)
    for i, q in enumerate(quads):
        n_raw = np.cross(q["u"], q["v"])
        nn = float(n_raw @ n_raw)
        n_unit = n_raw / _math.sqrt(nn)
        quad_start[i] = q["start"]
        quad_u[i] = q["u"]
        quad_v[i] = q["v"]
        quad_normal[i] = n_unit
        quad_w[i] = n_raw / nn  # basis.w (reference: src/entity.zig:453)
        quad_offset[i] = float(n_unit @ q["start"])
        quad_area[i] = _math.sqrt(nn)  # |u x v| (src/entity.zig:469)
        quad_mat[i] = q["mat"]

    n_m = max(len(materials), 1)
    mat_type = np.zeros((n_m,), _I)
    mat_tex = np.zeros((n_m,), _I)
    mat_albedo = np.zeros((n_m, 3), _F)
    mat_fuzz = np.zeros((n_m,), _F)
    mat_refract = np.ones((n_m,), _F)
    for i, m in enumerate(materials):
        mat_type[i] = m["type"]
        mat_tex[i] = m.get("tex", 0)
        mat_albedo[i] = m.get("albedo", (0, 0, 0))
        mat_fuzz[i] = m.get("fuzz", 0.0)
        mat_refract[i] = m.get("refract", 1.0)

    n_t = max(len(textures), 1)
    tex_type = np.zeros((n_t,), _I)
    tex_rgb = np.zeros((n_t, 3), _F)
    tex_inv_scale = np.zeros((n_t,), _F)
    tex_even = np.zeros((n_t,), _I)
    tex_odd = np.zeros((n_t,), _I)
    tex_img = np.zeros((n_t,), _I)
    for i, t in enumerate(textures):
        tex_type[i] = t["kind"]
        if t["kind"] == TEX_SOLID:
            tex_rgb[i] = t["rgb"]
        elif t["kind"] == TEX_CHECKER:
            tex_inv_scale[i] = t["inv_scale"]
            tex_even[i] = t["even"]
            tex_odd[i] = t["odd"]
        else:
            tex_img[i] = t["img"]

    if images:
        h_max = max(im.shape[0] for im in images)
        w_max = max(im.shape[1] for im in images)
        atlas = np.zeros((len(images), h_max, w_max, 3), np.uint8)
        atlas_wh = np.zeros((len(images), 2), _I)
        for i, im in enumerate(images):
            atlas[i, : im.shape[0], : im.shape[1]] = im
            atlas_wh[i] = (im.shape[1], im.shape[0])  # (width, height)
    else:
        # magenta debug fallback (reference: src/image.zig:5)
        atlas = np.full((1, 1, 1, 3), (255, 0, 255), np.uint8)
        atlas_wh = np.array([[1, 1]], _I)
    atlas_r = np.ascontiguousarray(atlas[..., 0])
    atlas_g = np.ascontiguousarray(atlas[..., 1])
    atlas_b = np.ascontiguousarray(atlas[..., 2])
    # packed r|g<<8|b<<16 plane: one gather fetches the whole texel
    atlas_packed = (
        atlas_r.astype(np.uint32)
        | (atlas_g.astype(np.uint32) << 8)
        | (atlas_b.astype(np.uint32) << 16)
    )

    lights = tuple((int(k), int(idx)) for k, idx in light_entries)

    # -- denormalized per-prim shading records (ops/shade.py) ------------
    # Flattening covers solid / checker-of-(solid|image) / image; a checker
    # whose child is ANOTHER checker cannot fit one record, so such scenes
    # set has_nested_checker and the XLA integrator evaluates textures with
    # the general walk (textures.texture_value) via the record's texid
    # column instead (reference recursion: src/texture.zig:111-118).
    def _checker_children(t) -> list:
        return (
            [textures[t["even"]], textures[t["odd"]]]
            if t["kind"] == TEX_CHECKER
            else []
        )

    has_nested_checker = any(
        child["kind"] == TEX_CHECKER
        for t in textures
        for child in _checker_children(t)
    )

    def _shade_block(mat_id: int) -> list:
        m = materials[mat_id] if materials else {"type": MAT_LAMBERTIAN}
        mt = m["type"]
        tex_kind, img, img2, texid = TEX_SOLID, -1, -1, 0
        rgb, rgb2 = (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
        inv_scale, fz, refract = 0.0, 0.0, 1.0
        if mt == MAT_METAL:
            rgb = m.get("albedo", (0, 0, 0))
            fz = m.get("fuzz", 0.0)
        elif mt == MAT_DIELECTRIC:
            refract = m.get("refract", 1.5)
        else:  # lambertian / isotropic / diffuse-light: texture-driven
            texid = m.get("tex", 0)
            t = textures[texid] if textures else {"kind": TEX_SOLID, "rgb": (0, 0, 0)}
            if t["kind"] == TEX_SOLID:
                rgb = t["rgb"]
            elif t["kind"] == TEX_CHECKER:
                tex_kind = TEX_CHECKER
                inv_scale = t["inv_scale"]

                def _child_rgb_img(tid):
                    child = textures[tid]
                    if child["kind"] == TEX_SOLID:
                        return child["rgb"], -1
                    if child["kind"] == TEX_IMAGE:
                        # neutral albedo; the atlas pass multiplies the
                        # parity-selected image in (same u,v as the hit —
                        # reference: src/texture.zig:117)
                        return (1.0, 1.0, 1.0), child["img"]
                    # nested checker: values come from the general walk
                    # (has_nested_checker routes the scene off the fast
                    # path), the record slots are never read
                    return (1.0, 1.0, 1.0), -1

                rgb, img = _child_rgb_img(t["even"])
                rgb2, img2 = _child_rgb_img(t["odd"])
            else:
                tex_kind = TEX_IMAGE
                img = t["img"]
        return [float(mt), float(tex_kind), float(img), *map(float, rgb),
                *map(float, rgb2), float(inv_scale), float(fz),
                float(refract), float(img2), float(texid)]

    from .ops.shade import SHADE_BLOCK as _SB

    sph_shade = np.array(
        [_shade_block(s["mat"]) for s in spheres], _F
    ).reshape(n_s, _SB) if n_s else np.zeros((0, _SB), _F)
    quad_shade = np.array(
        [_shade_block(q["mat"]) for q in quads], _F
    ).reshape(n_q, _SB) if n_q else np.zeros((0, _SB), _F)

    from .ops.shade import build_shade_rows

    shade_rows = build_shade_rows(
        {
            "cx": sph_center[:n_s, 0], "cy": sph_center[:n_s, 1],
            "cz": sph_center[:n_s, 2],
            "mx": sph_move[:n_s, 0], "my": sph_move[:n_s, 1],
            "mz": sph_move[:n_s, 2],
            "r": sph_radius[:n_s],
            "uv_cos": sph_uv_cos[:n_s], "uv_sin": sph_uv_sin[:n_s],
        },
        {
            "sx": quad_start[:n_q, 0], "sy": quad_start[:n_q, 1],
            "sz": quad_start[:n_q, 2],
            "nx": quad_normal[:n_q, 0], "ny": quad_normal[:n_q, 1],
            "nz": quad_normal[:n_q, 2],
            "wx": quad_w[:n_q, 0], "wy": quad_w[:n_q, 1],
            "wz": quad_w[:n_q, 2],
            "ux": quad_u[:n_q, 0], "uy": quad_u[:n_q, 1],
            "uz": quad_u[:n_q, 2],
            "vx": quad_v[:n_q, 0], "vy": quad_v[:n_q, 1],
            "vz": quad_v[:n_q, 2],
        },
        sph_shade,
        quad_shade,
    )
    if shade_rows.shape[0] == 0:
        shade_rows = np.zeros((1, shade_rows.shape[1]), _F)

    def _cols(rows_np):
        if rows_np.shape[0] == 0:
            rows_np = np.zeros((1, shade_rows.shape[1]), _F)
        return tuple(jnp.asarray(rows_np[:, i]) for i in range(rows_np.shape[1]))

    shade_cols_sph = _cols(shade_rows[:n_s])
    shade_cols_quad = _cols(shade_rows[n_s : n_s + n_q])

    # BVH (built lazily in geometry.bvh; degenerate placeholder otherwise)
    from .geometry import bvh as _bvh

    if build_bvh and (n_s + n_q) >= 2:
        bvh_arrays = _bvh.build_bvh(
            sph_center[:n_s], sph_radius[:n_s], sph_move[:n_s],
            quad_start[:n_q], quad_u[:n_q], quad_v[:n_q],
        )
        has_bvh = True
    else:
        bvh_arrays = _bvh.degenerate_bvh()
        has_bvh = False

    bg = np.asarray(background, _F)
    _scene_has_image_textures = any(
        t["kind"] == TEX_IMAGE
        or any(c["kind"] == TEX_IMAGE for c in _checker_children(t))
        for t in textures
    )
    return CompiledScene(
        sph_center=_v3c(sph_center),
        sph_radius=jnp.asarray(sph_radius),
        sph_move=_v3c(sph_move),
        sph_uv_cos=jnp.asarray(sph_uv_cos),
        sph_uv_sin=jnp.asarray(sph_uv_sin),
        sph_mat=jnp.asarray(sph_mat),
        quad_start=_v3c(quad_start),
        quad_u=_v3c(quad_u),
        quad_v=_v3c(quad_v),
        quad_normal=_v3c(quad_normal),
        quad_w=_v3c(quad_w),
        quad_offset=jnp.asarray(quad_offset),
        quad_area=jnp.asarray(quad_area),
        quad_mat=jnp.asarray(quad_mat),
        mat_type=jnp.asarray(mat_type),
        mat_tex=jnp.asarray(mat_tex),
        mat_albedo=_v3c(mat_albedo),
        mat_fuzz=jnp.asarray(mat_fuzz),
        mat_refract=jnp.asarray(mat_refract),
        tex_type=jnp.asarray(tex_type),
        tex_rgb=_v3c(tex_rgb),
        tex_inv_scale=jnp.asarray(tex_inv_scale),
        tex_even=jnp.asarray(tex_even),
        tex_odd=jnp.asarray(tex_odd),
        tex_img=jnp.asarray(tex_img),
        atlas_r=jnp.asarray(atlas_r),
        atlas_g=jnp.asarray(atlas_g),
        atlas_b=jnp.asarray(atlas_b),
        atlas_packed=jnp.asarray(atlas_packed),
        atlas_wh=jnp.asarray(atlas_wh),
        background=V3(jnp.asarray(bg[0]), jnp.asarray(bg[1]), jnp.asarray(bg[2])),
        shade_rows=jnp.asarray(shade_rows),
        shade_cols_sph=shade_cols_sph,
        shade_cols_quad=shade_cols_quad,
        bvh_min=_v3c(bvh_arrays["bvh_min"]),
        bvh_max=_v3c(bvh_arrays["bvh_max"]),
        bvh_miss=jnp.asarray(bvh_arrays["bvh_miss"]),
        bvh_leaf_start=jnp.asarray(bvh_arrays["bvh_leaf_start"]),
        bvh_leaf_count=jnp.asarray(bvh_arrays["bvh_leaf_count"]),
        bvh_prim_kind=jnp.asarray(bvh_arrays["bvh_prim_kind"]),
        bvh_prim_idx=jnp.asarray(bvh_arrays["bvh_prim_idx"]),
        n_spheres=n_s,
        n_quads=n_q,
        n_materials=len(materials),
        n_textures=len(textures),
        has_moving=any(np.any(s["move"] != 0) for s in spheres),
        has_bvh=has_bvh,
        max_leaf_size=int(bvh_arrays.get("max_leaf_size", 4)),
        has_image_textures=_scene_has_image_textures,
        has_nested_checker=has_nested_checker,
        lights=lights,
        needs_gauss=any(
            m["type"] == MAT_ISOTROPIC
            or (m["type"] == MAT_METAL and float(m.get("fuzz", 0.0)) > 0.0)
            for m in materials
        ),
        image_dims=tuple(
            (int(w), int(h)) for w, h in np.asarray(atlas_wh)
        ),
    )
