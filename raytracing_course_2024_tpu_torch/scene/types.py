"""Scene data model: host-side description + SoA scene arrays.

Same layout as the JAX package's ``scene/types.py`` (field for field, so the
two builds can be compared array by array):

* ``SceneDesc``   -- host-side (numpy) list-of-primitives produced by parsers;
* ``SceneArrays`` -- numpy struct-of-arrays: one unified finite-primitive
  table (triangle / box / ellipsoid), a separate (tiny) infinite-plane
  table and a light-index table. ``ops/bounce.py`` turns it into the
  device tensors the bounce kernels read;
* ``RenderSettings`` -- render parameters (resolution, spp, depth, camera).

Shape encoding in the unified table (``ptype``):
  TRI=0        p0,p1,p2 = world-space verts; sn0..2 = shading normals
  BOX=1        p0 = half-extents ``s`` (reference src/geometry.rs:28-30)
  ELLIPSOID=2  p0 = radii (text-format scenes; dropped by reference HEAD but
               required by its scene inputs -- SURVEY.md section 2.2)

Material model (``mkind``):
  DIFFUSE=0     Lambertian; text-format default (COLOR only)
  MIRROR=1      text-format METALLIC flag: perfect specular reflection
  DIELECTRIC=2  text-format DIELECTRIC+IOR: Fresnel-split reflect/refract
  PBR=3         glTF metallic-roughness GGX (reference src/rendering.rs:133-184)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

# shape type ids
TRI, BOX, ELLIPSOID = 0, 1, 2
# material kinds
DIFFUSE, MIRROR, DIELECTRIC, PBR = 0, 1, 2, 3

EPS = 1e-4  # f32 retune of the reference's f64 EPS=1e-5 (src/geometry.rs:49)


@dataclasses.dataclass
class PrimitiveDesc:
    """One primitive as parsed from a scene file (host side, float64 numpy)."""

    ptype: int = TRI  # TRI / BOX / ELLIPSOID / PLANE(-1, stored separately)
    p0: np.ndarray = None  # tri a | box half-extents | ellipsoid radii | plane normal
    p1: np.ndarray = None
    p2: np.ndarray = None
    sn0: np.ndarray = None  # shading normals (triangles)
    sn1: np.ndarray = None
    sn2: np.ndarray = None
    position: np.ndarray = None
    rotation: np.ndarray = None  # quaternion (x, y, z, w)
    color: np.ndarray = None
    metallic: float = 0.0
    roughness: float = 1.0
    emission: np.ndarray = None
    ior: float = 1.5
    mkind: int = DIFFUSE

    def __post_init__(self):
        z3 = np.zeros(3)
        if self.p0 is None:
            self.p0 = z3.copy()
        if self.p1 is None:
            self.p1 = z3.copy()
        if self.p2 is None:
            self.p2 = z3.copy()
        if self.sn0 is None:
            self.sn0 = z3.copy()
        if self.sn1 is None:
            self.sn1 = z3.copy()
        if self.sn2 is None:
            self.sn2 = z3.copy()
        if self.position is None:
            self.position = z3.copy()
        if self.rotation is None:
            self.rotation = np.array([0.0, 0.0, 0.0, 1.0])
        if self.color is None:
            self.color = z3.copy()
        if self.emission is None:
            self.emission = z3.copy()

    @property
    def is_emissive(self) -> bool:
        # reference src/gltf_to_scene.rs:240: ||emission|| > EPS
        return float(np.linalg.norm(self.emission)) > 1e-5


PLANE = -1  # ptype marker used only in PrimitiveDesc


@dataclasses.dataclass
class CameraDesc:
    position: np.ndarray
    right: np.ndarray
    up: np.ndarray
    forward: np.ndarray
    fov_x: float
    fov_y: float


@dataclasses.dataclass
class RenderSettings:
    """Static (compile-time) render parameters."""

    width: int
    height: int
    samples: int
    ray_depth: int
    bg_color: tuple  # (r, g, b) floats
    camera: CameraDesc


@dataclasses.dataclass
class SceneDesc:
    """Parser output: primitives + settings, host side."""

    settings: RenderSettings
    primitives: list  # finite PrimitiveDesc (TRI/BOX/ELLIPSOID)
    planes: list  # infinite PrimitiveDesc (PLANE)


class PrimCol:
    """Row layout of SceneArrays.packed, the (C, N) transposed attribute pack
    used for all hot-loop gathers (see ops/gather.py for why)."""

    PTYPE = 0
    P0 = 1  # 1-3
    P1 = 4  # 4-6
    P2 = 7  # 7-9
    SN0 = 10  # 10-12
    SN1 = 13
    SN2 = 16
    POS = 19  # 19-21
    ROT = 22  # 22-25 (x, y, z, w)
    COLOR = 26  # 26-28
    METALLIC = 29
    ROUGHNESS = 30
    EMISSION = 31  # 31-33
    IOR = 34
    MKIND = 35
    COUNT = 36


class LightCol:
    """Row layout of SceneArrays.light_packed (C, L): the emissive-primitive
    table pre-gathered at build time (no double indirection at render)."""

    PTYPE = 0
    P0 = 1
    P1 = 4
    P2 = 7
    POS = 10
    ROT = 13  # 13-16
    INV_AREA = 17
    COUNT = 18


class PlaneCol:
    """Row layout of SceneArrays.plane_packed (C, P)."""

    NORMAL = 0  # 0-2 (local frame)
    POS = 3
    ROT = 6  # 6-9
    COLOR = 10
    METALLIC = 13
    ROUGHNESS = 14
    EMISSION = 15  # 15-17
    IOR = 18
    MKIND = 19
    COUNT = 20


class SceneArrays(NamedTuple):
    """Host-side scene arrays. All arrays are numpy (f32 / i32 / bool)."""

    # unified finite-primitive table, length N
    ptype: "np.ndarray"  # (N,) i32
    p0: "np.ndarray"  # (N, 3) f32
    p1: "np.ndarray"
    p2: "np.ndarray"
    sn0: "np.ndarray"
    sn1: "np.ndarray"
    sn2: "np.ndarray"
    position: "np.ndarray"  # (N, 3)
    rotation: "np.ndarray"  # (N, 4) quaternion xyzw
    color: "np.ndarray"  # (N, 3)
    metallic: "np.ndarray"  # (N,)
    roughness: "np.ndarray"  # (N,)
    emission: "np.ndarray"  # (N, 3)
    ior: "np.ndarray"  # (N,)
    mkind: "np.ndarray"  # (N,) i32

    # infinite planes, length P (>= 1; padded with never-hit sentinel)
    pl_normal: "np.ndarray"  # (P, 3) local-frame normal
    pl_position: "np.ndarray"  # (P, 3)
    pl_rotation: "np.ndarray"  # (P, 4)
    pl_color: "np.ndarray"  # (P, 3)
    pl_metallic: "np.ndarray"  # (P,)
    pl_roughness: "np.ndarray"  # (P,)
    pl_emission: "np.ndarray"  # (P, 3)
    pl_ior: "np.ndarray"  # (P,)
    pl_mkind: "np.ndarray"  # (P,) i32
    pl_mask: "np.ndarray"  # (P,) bool: False for padding

    # emissive finite primitives (the light list), length L (>= 1, padded)
    light_idx: "np.ndarray"  # (L,) i32 index into the finite table
    light_mask: "np.ndarray"  # (L,) bool
    light_inv_area: "np.ndarray"  # (L,) f32: 1/surface-area (local pdf;
    #   reference src/distributions.rs:70-81 get_local_pdf)

    # transposed attribute packs for hot-loop gathers (ops/gather.py)
    packed: "np.ndarray" = None  # (PrimCol.COUNT, N) f32
    light_packed: "np.ndarray" = None  # (LightCol.COUNT, L) f32
    plane_packed: "np.ndarray" = None  # (PlaneCol.COUNT, P) f32
    # (9, N) [a, e1, e2] pack of the dense triangle kernel (small all-tri
    # scenes only); kept so the arrays match the JAX build field for field
    tri_pack: "np.ndarray" = None

    # the host SAH tree of the BVH backend (ops/bvh.py:attach_bvh), which
    # also puts the finite table in the tree's primitive order
    bvh: Optional["BvhArrays"] = None


class BvhArrays(NamedTuple):
    """Flat binary-BVH arrays of the host SAH tree (ops/bvh.py), numpy; the
    JAX package's ``BvhArrays``. The nodes are in build order (root 0, each
    child after its parent)."""

    node_min: "np.ndarray"  # (M, 3) f32 AABB min
    node_max: "np.ndarray"  # (M, 3) f32 AABB max
    node_left: "np.ndarray"  # (M,) i32: internal -> left child; leaf -> prim start
    node_right: "np.ndarray"  # (M,) i32: internal -> right child; leaf -> prim count
    node_is_leaf: "np.ndarray"  # (M,) bool
    prim_order: "np.ndarray"  # (N,) i32: row of the original table at tree position i


class SceneStatics(NamedTuple):
    """Trace-time (python) facts about the scene that pick code paths.

    ``light_types`` / ``light_rotated`` let the light-pdf loop unroll with a
    *static* branch per light -- each light compiles only its own shape
    kernel and no lane-padded (B, L) intermediates exist."""

    num_prims: int
    num_planes: int  # real planes, excluding padding
    num_lights: int  # real lights, excluding padding
    any_rotation: bool  # any finite prim with non-identity quaternion
    any_nontri: bool  # any box/ellipsoid in the finite table
    light_types: tuple = ()  # per real light: TRI / BOX / ELLIPSOID
    light_rotated: tuple = ()  # per real light: non-identity rotation?
    any_delta: bool = False  # any MIRROR/DIELECTRIC material (incl. planes)
    # fused-bounce spec (ops/bounce.py): one (kind, rotated, mkind) triple
    # per entry of the unified geo table (finite prims then real planes;
    # kind 3 = plane), populated only for small scenes
    # (num_prims + num_planes <= 128). () = ineligible.
    mega_spec: tuple = ()
