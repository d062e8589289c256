"""glTF 2.0 loader (JSON + external/embedded binary buffers), no third-party
glTF library.

Replicates the reference converter's semantics (src/gltf_to_scene.rs):

* camera: ``fov_y = yfov``; ``fov_x = aspect * yfov`` -- the reference's
  *linear* approximation (gltf_to_scene.rs:134-135), copied as-is for image
  parity (SURVEY.md section 7 hard-part 6). Basis from the world matrix:
  position = M*origin, right = M*e_x, up = M*e_y, forward = -M*e_z
  (the scrambled intermediates at gltf_to_scene.rs:136-143 net to this).
* mesh: FIRST primitive only (gltf_to_scene.rs:148); indices required
  (u8/u16/u32, gltf_to_scene.rs:154-162); positions transformed by the full
  accumulated matrix with perspective divide (gltf_to_scene.rs:172-183);
  normals rotated by the accumulated node quaternion only
  (gltf_to_scene.rs:185-195); flat-normal fallback (gltf_to_scene.rs:197-200).
* material: base_color_factor rgb; metallic_factor; roughness clamped >= 0.03
  (gltf_to_scene.rs:217-222); emission = emissive_factor *
  KHR_materials_emissive_strength (gltf_to_scene.rs:223-231); ior fixed 1.5.
* scene settings: bg = black, ray_depth = 6 (gltf_to_scene.rs:62-78);
  width/height/samples come from the caller (CLI argv).

Deliberate deviation: the reference walks *all* nodes flat AND recurses
children, double-visiting non-root nodes in hierarchical files
(gltf_to_scene.rs:42-52 + 245-255; flagged in SURVEY.md section 2.2). We
visit each node exactly once via the scene graph (roots -> children), which
is identical on the course's flat scenes and correct on nested ones.
"""

from __future__ import annotations

import base64
import json
import math
import os

import numpy as np

from .types import (
    PBR,
    TRI,
    CameraDesc,
    PrimitiveDesc,
    RenderSettings,
    SceneDesc,
)

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_buffers(doc: dict, base_dir: str) -> list:
    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            raise ValueError("GLB-embedded buffers are not used by .gltf files")
        if uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            # external buffers resolve against the .gltf's own directory
            with open(os.path.join(base_dir, uri), "rb") as f:
                data = f.read()
        buffers.append(np.frombuffer(data, dtype=np.uint8))
    return buffers


def _read_accessor(doc: dict, buffers: list, accessor_idx: int) -> np.ndarray:
    acc = doc["accessors"][accessor_idx]
    view = doc["bufferViews"][acc["bufferView"]]
    buf = buffers[view["buffer"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
    ncomp = _TYPE_SIZES[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or dtype.itemsize * ncomp
    if stride == dtype.itemsize * ncomp:
        flat = np.frombuffer(
            buf.tobytes(), dtype=dtype, count=count * ncomp, offset=offset
        )
        out = flat.reshape(count, ncomp)
    else:
        out = np.empty((count, ncomp), dtype=dtype)
        raw = buf.tobytes()
        for i in range(count):
            start = offset + i * stride
            out[i] = np.frombuffer(raw, dtype=dtype, count=ncomp, offset=start)
    return out if ncomp > 1 else out[:, 0]


def _node_local_transform(node: dict) -> tuple:
    """Returns (matrix 4x4 f64, rotation quaternion xyzw f64)."""
    if "matrix" in node:
        m = np.array(node["matrix"], dtype=np.float64).reshape(4, 4).T  # column-major
        # extract rotation from the 3x3 part (course scenes have no shear)
        r3 = m[:3, :3].copy()
        scale = np.linalg.norm(r3, axis=0)
        scale[scale == 0] = 1.0
        q = _mat3_to_quat(r3 / scale)
        return m, q
    t = np.array(node.get("translation", [0, 0, 0]), dtype=np.float64)
    q = np.array(node.get("rotation", [0, 0, 0, 1]), dtype=np.float64)
    s = np.array(node.get("scale", [1, 1, 1]), dtype=np.float64)
    m = np.eye(4)
    m[:3, :3] = _quat_to_mat3(q) @ np.diag(s)
    m[:3, 3] = t
    return m, q


def _quat_to_mat3(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _mat3_to_quat(m: np.ndarray) -> np.ndarray:
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qv = q[:3]
    t = 2.0 * np.cross(qv, v)
    return v + q[3] * t + np.cross(qv, t)


class _Walker:
    def __init__(self, doc: dict, buffers: list):
        self.doc = doc
        self.buffers = buffers
        self.camera: CameraDesc | None = None
        self.prims: list = []

    def visit(self, node_idx: int, parent_m: np.ndarray, parent_q: np.ndarray):
        node = self.doc["nodes"][node_idx]
        local_m, local_q = _node_local_transform(node)
        m = parent_m @ local_m
        q = _quat_mul(parent_q, local_q)
        if "camera" in node:
            self._read_camera(self.doc["cameras"][node["camera"]], m)
        if "mesh" in node:
            self._read_mesh(self.doc["meshes"][node["mesh"]], m, q)
        for child in node.get("children", []):
            self.visit(child, m, q)

    def _read_camera(self, cam: dict, m: np.ndarray):
        if cam.get("type") != "perspective":
            raise ValueError("only perspective cameras are supported")
        persp = cam["perspective"]
        yfov = float(persp["yfov"])
        aspect = float(persp.get("aspectRatio", 1.0))
        origin = m @ np.array([0.0, 0.0, 0.0, 1.0])
        self.camera = CameraDesc(
            position=origin[:3] / origin[3],
            right=(m @ np.array([1.0, 0.0, 0.0, 0.0]))[:3],
            up=(m @ np.array([0.0, 1.0, 0.0, 0.0]))[:3],
            forward=(m @ np.array([0.0, 0.0, -1.0, 0.0]))[:3],
            fov_x=aspect * yfov,  # linear approx, matches gltf_to_scene.rs:135
            fov_y=yfov,
        )

    def _read_mesh(self, mesh: dict, m: np.ndarray, q: np.ndarray):
        prim = mesh["primitives"][0]  # first primitive only (ref:148)
        if "indices" not in prim:
            raise ValueError("mesh primitive without indices is unsupported")
        indices = _read_accessor(self.doc, self.buffers, prim["indices"]).astype(
            np.int64
        )
        positions = _read_accessor(
            self.doc, self.buffers, prim["attributes"]["POSITION"]
        ).astype(np.float64)
        normals = None
        if "NORMAL" in prim["attributes"]:
            normals = _read_accessor(
                self.doc, self.buffers, prim["attributes"]["NORMAL"]
            ).astype(np.float64)

        # world-space positions with perspective divide (ref:172-183)
        homo = np.concatenate([positions, np.ones((len(positions), 1))], axis=1)
        world = homo @ m.T
        world = world[:, :3] / world[:, 3:4]
        world_normals = None
        if normals is not None:
            world_normals = np.stack([_quat_rotate(q, n) for n in normals])

        material = self._read_material(prim.get("material"))
        tris = indices.reshape(-1, 3)
        for tri in tris:
            a, b, c = world[tri[0]], world[tri[1]], world[tri[2]]
            flat_n = np.cross(b - a, c - a)
            nrm = np.linalg.norm(flat_n)
            flat_n = flat_n / nrm if nrm > 0 else np.array([0.0, 0.0, 1.0])
            if world_normals is not None:
                sn = (
                    world_normals[tri[0]],
                    world_normals[tri[1]],
                    world_normals[tri[2]],
                )
            else:
                sn = (flat_n, flat_n, flat_n)
            self.prims.append(
                PrimitiveDesc(
                    ptype=TRI,
                    p0=a,
                    p1=b,
                    p2=c,
                    sn0=sn[0],
                    sn1=sn[1],
                    sn2=sn[2],
                    mkind=PBR,
                    **material,
                )
            )

    def _read_material(self, mat_idx) -> dict:
        if mat_idx is None:
            return dict(
                color=np.ones(3), metallic=1.0, roughness=1.0, emission=np.zeros(3)
            )
        mat = self.doc["materials"][mat_idx]
        pbr = mat.get("pbrMetallicRoughness", {})
        base = np.array(pbr.get("baseColorFactor", [1, 1, 1, 1]))[:3]
        metallic = float(pbr.get("metallicFactor", 1.0))
        roughness = max(float(pbr.get("roughnessFactor", 1.0)), 0.03)  # ref:221
        emissive = np.array(mat.get("emissiveFactor", [0, 0, 0]), dtype=np.float64)
        strength = (
            mat.get("extensions", {})
            .get("KHR_materials_emissive_strength", {})
            .get("emissiveStrength", 1.0)
        )
        return dict(
            color=base,
            metallic=metallic,
            roughness=roughness,
            emission=emissive * strength,
            ior=1.5,
        )


def load_gltf_scene(path: str, width: int, height: int, samples: int) -> SceneDesc:
    with open(path, "r") as f:
        doc = json.load(f)
    buffers = _load_buffers(doc, os.path.dirname(os.path.abspath(path)))

    walker = _Walker(doc, buffers)
    scene_idx = doc.get("scene", 0)
    if "scenes" in doc and doc["scenes"]:
        roots = doc["scenes"][scene_idx].get("nodes", [])
    else:  # no scene graph: every node is a root
        referenced = {c for n in doc.get("nodes", []) for c in n.get("children", [])}
        roots = [i for i in range(len(doc.get("nodes", []))) if i not in referenced]
    ident_q = np.array([0.0, 0.0, 0.0, 1.0])
    for root in roots:
        walker.visit(root, np.eye(4), ident_q)

    if walker.camera is None:
        raise ValueError(f"no camera node found in {path}")

    settings = RenderSettings(
        width=width,
        height=height,
        samples=samples,
        ray_depth=6,  # hardcoded, matches gltf_to_scene.rs:73
        bg_color=(0.0, 0.0, 0.0),  # gltf_to_scene.rs:65
        camera=walker.camera,
    )
    return SceneDesc(settings=settings, primitives=walker.prims, planes=[])
