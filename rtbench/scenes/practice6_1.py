"""The course's practice6_1 scene (light sampling with mesh lights) from
formulas: a ground quad, a torus light, a cube light and a diffuse subject.

The course's ``practice6_1.bin`` holds four meshes (``scenes/gen_practice6_1.py``
recovers their layout byte for byte): a ground quad of 2 triangles, a torus of
1,152 (48 x 12 segments, major radius 1, tube radius 0.0625), a cube of 12
(half extent 1) and Suzanne of 15,744. Its JSON (node transforms, materials,
camera) is lost; the stand-ins of ``gen_practice6_1.py`` are taken here. The
file itself is not in the repository, so the meshes are made:

* the ground: Blender's plane, +-1 in x and z at y = 0, its normal +y;
* the torus: 48 rings of 12 vertices about the local y axis (Blender's torus
  in glTF's y-up frame), two triangles a quad;
* the cube: 6 faces of two triangles, flat normals;
* the subject, Suzanne's stand-in: a closed latitude-longitude sphere of 96
  segments and 83 bands (a fan at each pole, two triangles a quad between:
  2 x 96 + 81 x 192 = 15,744 triangles), its radius
  ``(0.95, 0.85, 0.8) x (1 + 0.12 sin(3 x + 0.7) cos(2 y) + 0.08 sin(4 z + 0.3))``
  on the unit sphere's point (x, y, z).

Every mesh is wound outward and smooth-shaded with the normalised sum of its
adjacent faces' cross products (the cube: its faces' normals), then placed by
its node's translation, rotation (a quaternion x, y, z, w) and scale: the
normals rotated only, as the course's glTF reader does. Materials are the
reader's: metallic-roughness PBR, emission the emissive factor times the
strength. The camera is the node's: its basis rotated by the node's
quaternion, ``fov_y = yfov`` and ``fov_x = aspect x yfov``.
"""

from __future__ import annotations

import numpy as np

from . import PBR, PLANE_FIELDS, PRIM_FIELDS, TRI, SceneSpec, columns, concat
from .displaced_sphere import smooth_normals


def _rot(q, v: np.ndarray) -> np.ndarray:
    """Rows (or one vector) ``v`` rotated by the quaternion ``q``."""
    q = np.asarray(q, np.float64)
    qv, w = q[:3], q[3]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def ground() -> tuple:
    vs = np.array([[-1.0, 0.0, 1.0], [1.0, 0.0, 1.0], [1.0, 0.0, -1.0], [-1.0, 0.0, -1.0]])
    fa = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return vs, fa, np.tile([0.0, 1.0, 0.0], (4, 1))


def torus(major: int, minor: int, radius: float, tube: float) -> tuple:
    """(vertices, faces, normals): ``major`` rings of ``minor`` vertices."""
    phi = 2.0 * np.pi * np.arange(major)[:, None] / major
    th = 2.0 * np.pi * np.arange(minor)[None, :] / minor
    x = (radius + tube * np.cos(th)) * np.cos(phi)
    z = (radius + tube * np.cos(th)) * np.sin(phi)
    y = tube * np.sin(th) + 0.0 * phi
    vs = np.stack([x, y, z], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(major), np.arange(minor), indexing="ij")
    a, b = i * minor + j, ((i + 1) % major) * minor + j
    c, d = ((i + 1) % major) * minor + (j + 1) % minor, i * minor + (j + 1) % minor
    fa = np.stack([np.stack([a, d, c], -1), np.stack([a, c, b], -1)], -2).reshape(-1, 3)
    return vs, fa, smooth_normals(vs, fa)


def cube() -> tuple:
    """(vertices, faces, normals): 24 vertices, a face's four with its normal."""
    vs, fa, vn = [], [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            e = np.zeros(3)
            e[axis] = 1.0
            n, u, v = sign * e, np.roll(e, 1), sign * np.roll(e, 2)  # u x v = n
            base = len(vs)
            vs += [n + su * u + sv * v for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
            vn += [n] * 4
            fa += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return np.asarray(vs), np.asarray(fa, np.int64), np.asarray(vn)


def subject(segments: int, bands: int) -> tuple:
    """(vertices, faces, normals) of the closed sphere standing in for Suzanne."""
    th = np.pi * np.arange(1, bands)[:, None] / bands
    ph = 2.0 * np.pi * np.arange(segments)[None, :] / segments
    ring = np.stack([np.sin(th) * np.cos(ph), np.cos(th) + 0.0 * ph,
                     np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    unit = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    x, y, z = unit.T
    scale = 1.0 + 0.12 * np.sin(3.0 * x + 0.7) * np.cos(2.0 * y) + 0.08 * np.sin(4.0 * z + 0.3)
    vs = unit * scale[:, None] * np.array([0.95, 0.85, 0.8])
    j = np.arange(segments)
    jn = (j + 1) % segments
    last = len(vs) - 1
    top = np.stack([np.zeros(segments, np.int64), 1 + jn, 1 + j], 1)
    r0 = 1 + np.arange(bands - 2)[:, None] * segments
    a, b = r0 + j, r0 + jn
    c, d = b + segments, a + segments
    quads = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)], -2).reshape(-1, 3)
    rb = 1 + (bands - 2) * segments
    bottom = np.stack([np.full(segments, last), rb + j, rb + jn], 1)
    fa = np.concatenate([top, quads, bottom])
    return vs, fa, smooth_normals(vs, fa)


def _rows(mesh: tuple, node: dict, mat: dict) -> dict:
    vs, fa, vn = mesh
    q = node.get("rotation", [0.0, 0.0, 0.0, 1.0])
    s = np.asarray(node.get("scale", [1.0, 1.0, 1.0]), np.float64)
    world = _rot(q, vs * s) + np.asarray(node.get("translation", [0.0] * 3), np.float64)
    nrm = _rot(q, vn)
    n = len(fa)
    return dict(
        kind=np.full(n, TRI), p0=world[fa[:, 0]], p1=world[fa[:, 1]], p2=world[fa[:, 2]],
        sn0=nrm[fa[:, 0]], sn1=nrm[fa[:, 1]], sn2=nrm[fa[:, 2]], position=np.zeros((n, 3)),
        rotation=np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)),
        color=np.tile(np.asarray(mat["color"], np.float64), (n, 1)),
        metallic=np.full(n, float(mat["metallic"])),
        roughness=np.full(n, max(float(mat["roughness"]), 0.03)),
        emission=np.tile(np.asarray(mat.get("emission", [0.0] * 3), np.float64)
                         * float(mat.get("strength", 1.0)), (n, 1)),
        ior=np.full(n, 1.5), mkind=np.full(n, PBR))


def build(params: dict, root: str, width: int, height: int) -> SceneSpec:
    t = params["torus"]
    meshes = {"ground": ground(), "cube": cube(),
              "torus": torus(int(t["major"]), int(t["minor"]), float(t["radius"]),
                         float(t["tube"])),
              "subject": subject(int(params["subject"]["segments"]),
                                 int(params["subject"]["bands"]))}
    prims = columns([], PRIM_FIELDS)
    for node in params["nodes"]:
        prims = concat(prims, _rows(meshes[node["mesh"]], node, node["material"]))
    cam = params["camera"]
    q = cam["rotation"]
    camera = dict(position=np.asarray(cam["translation"], np.float64),
                  right=_rot(q, np.array([1.0, 0.0, 0.0])), up=_rot(q, np.array([0.0, 1.0, 0.0])),
                  forward=_rot(q, np.array([0.0, 0.0, -1.0])),
                  fov_x=float(cam["aspect"]) * float(cam["yfov"]), fov_y=float(cam["yfov"]))
    return SceneSpec(prims=prims, planes=columns([], PLANE_FIELDS), camera=camera, width=width,
                     height=height, ray_depth=int(params["ray_depth"]), bg=tuple(params["bg"]))
