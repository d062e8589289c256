"""A smooth-shaded displaced icosphere, optionally a smooth-shaded vase, and
the primitives and planes its configuration lists, built from formulas (no
random source).

The sphere: the icosahedron subdivided ``subdiv`` times (20 x 4^subdiv
faces; each edge's midpoint pushed back onto the unit sphere, new vertices
numbered in the order of their first edge), displaced radially by
``1 + 0.22 (sin(3.1 x + 1.3) cos(2.3 y) + 0.6 sin(4.7 z + 0.5) cos(3.9 x))``,
with smooth vertex normals (the normalised sum of the adjacent faces'
cross products). Subdivision 6 gives 81,920 triangles.

The vase (``vase``): a surface of revolution about the y axis, open at the
top and closed at the bottom by a pole, ``segments`` around and ``rings``
up: ``segments x (2 rings - 1)`` triangles (a fan at the pole, two a quad
above it). Ring k of ``rings`` lies at height ``height x k / rings`` with
radius ``radius x (0.35 + 0.65 sin(pi k / rings))``; smooth vertex normals
as the sphere's. Each listed primitive takes a rotation as an axis and an
angle in radians; the camera's vertical field of view follows the frame's
aspect from its horizontal one.
"""

from __future__ import annotations

import numpy as np

from . import BOX, ELLIPSOID, MIRROR, PBR, PLANE_FIELDS, PRIM_FIELDS, TRI, DIFFUSE, SceneSpec
from . import columns, concat

KINDS = {"triangle": TRI, "box": BOX, "ellipsoid": ELLIPSOID}
MATERIALS = {"diffuse": DIFFUSE, "mirror": MIRROR, "pbr": PBR}


def icosphere(subdiv: int) -> tuple:
    """(vertices (V, 3), faces (F, 3)) of the subdivided unit icosahedron."""
    t = (1 + 5 ** 0.5) / 2
    v = np.array([(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
                  (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)],
                 np.float64)
    v = v / np.sqrt(np.einsum("ij,ij->i", v, v))[:, None]
    f = np.array([(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
                  (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
                  (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
                  (8, 6, 7), (9, 8, 1)], np.int64)
    for _ in range(subdiv):
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        e = np.stack([np.stack([a, b], 1), np.stack([b, c], 1), np.stack([c, a], 1)], 1)
        e = e.reshape(-1, 2)
        lo, hi = e.min(1), e.max(1)
        _, first, inv = np.unique(lo * len(v) + hi, return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        m = v[e[first[order], 0]] + v[e[first[order], 1]]
        mid = (len(v) + rank[inv.reshape(-1)]).reshape(-1, 3)
        v = np.concatenate([v, m / np.sqrt(np.einsum("ij,ij->i", m, m))[:, None]])
        ab, bc, ca = mid[:, 0], mid[:, 1], mid[:, 2]
        f = np.stack([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                      np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)], 1).reshape(-1, 3)
    return v, f


def smooth_normals(vs: np.ndarray, fa: np.ndarray) -> np.ndarray:
    """The normalised sum of each vertex's adjacent faces' cross products."""
    fn = np.cross(vs[fa[:, 1]] - vs[fa[:, 0]], vs[fa[:, 2]] - vs[fa[:, 0]])
    vn = np.zeros_like(vs)
    for c in range(3):
        np.add.at(vn, fa[:, c], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-30)


def displaced_sphere(subdiv: int) -> tuple:
    """(vertices, faces, smooth vertex normals) of the displaced sphere."""
    vs, fa = icosphere(subdiv)
    x, y, z = vs[:, 0], vs[:, 1], vs[:, 2]
    vs = vs * (1.0 + 0.22 * (np.sin(3.1 * x + 1.3) * np.cos(2.3 * y)
                             + 0.6 * np.sin(4.7 * z + 0.5) * np.cos(3.9 * x)))[:, None]
    return vs, fa, smooth_normals(vs, fa)


def vase(segments: int, rings: int, radius: float, height: float, position) -> tuple:
    """(vertices, faces, smooth vertex normals) of the vase, its pole at
    ``position``."""
    k = np.arange(1, rings + 1, dtype=np.float64) / rings
    rho = radius * (0.35 + 0.65 * np.sin(np.pi * k))
    phi = 2.0 * np.pi * np.arange(segments, dtype=np.float64) / segments
    ring = np.stack([rho[:, None] * np.cos(phi), np.broadcast_to(height * k[:, None],
                     (rings, segments)), rho[:, None] * np.sin(phi)], -1).reshape(-1, 3)
    vs = np.concatenate([np.zeros((1, 3)), ring]) + np.asarray(position, np.float64)
    j = np.arange(segments)
    jn = (j + 1) % segments
    fan = np.stack([np.zeros(segments, np.int64), 1 + j, 1 + jn], 1)
    r0 = 1 + np.arange(rings - 1)[:, None] * segments
    a, b = r0 + j, r0 + jn
    c, d = b + segments, a + segments
    quads = np.stack([np.stack([a, c, b], -1), np.stack([a, d, c], -1)], -2).reshape(-1, 3)
    fa = np.concatenate([fan, quads])
    return vs, fa, smooth_normals(vs, fa)


def quat(axis, angle: float) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    return np.append(a * np.sin(angle / 2), np.cos(angle / 2))


def _row(p: dict) -> dict:
    r = {k: v for k, v in p.items() if k in PRIM_FIELDS or k in PLANE_FIELDS}
    r["kind"] = KINDS.get(p.get("shape", "triangle"), TRI)
    r["mkind"] = MATERIALS[p.get("material", "diffuse")]
    if "rotation_axis" in p:
        r["rotation"] = quat(p["rotation_axis"], p["rotation_angle"])
    return r


def mesh_rows(vs: np.ndarray, fa: np.ndarray, vn: np.ndarray, mat: dict) -> dict:
    """The columns of a smooth-shaded mesh's triangles, all of material
    ``mat``."""
    n = len(fa)
    rows = columns([], PRIM_FIELDS)
    rows.update(kind=np.full(n, TRI), p0=vs[fa[:, 0]], p1=vs[fa[:, 1]], p2=vs[fa[:, 2]],
                sn0=vn[fa[:, 0]], sn1=vn[fa[:, 1]], sn2=vn[fa[:, 2]],
                position=np.zeros((n, 3)), rotation=np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)),
                color=np.tile(np.asarray(mat["color"], np.float64), (n, 1)),
                metallic=np.full(n, float(mat["metallic"])),
                roughness=np.full(n, float(mat["roughness"])), emission=np.zeros((n, 3)),
                ior=np.full(n, 1.5), mkind=np.full(n, MATERIALS[mat["material"]]))
    return rows


def build(params: dict, root: str, width: int, height: int) -> SceneSpec:
    prims = mesh_rows(*displaced_sphere(int(params["subdiv"])), params["sphere_material"])
    if "vase" in params:
        v = params["vase"]
        prims = concat(prims, mesh_rows(*vase(int(v["segments"]), int(v["rings"]),
                                              float(v["radius"]), float(v["height"]),
                                              v["position"]), v["material"]))
    prims = concat(prims, columns([_row(p) for p in params["primitives"]], PRIM_FIELDS))
    planes = columns([_row(p) for p in params["planes"]], PLANE_FIELDS)
    cam = {k: np.asarray(v, np.float64) for k, v in params["camera"].items() if k != "fov_x"}
    fov_x = float(params["camera"]["fov_x"])
    cam.update(fov_x=fov_x, fov_y=2.0 * np.arctan(np.tan(fov_x / 2) * height / width))
    return SceneSpec(prims=prims, planes=planes, camera=cam, width=width, height=height,
                     ray_depth=int(params["ray_depth"]), bg=tuple(params["bg"]))
