"""A glTF 2.0 scene file (JSON, embedded or external buffers) read into a
``SceneSpec`` with the course's semantics (its ``gltf_to_scene``):

* every node once, from the scene's roots through its children, with the
  accumulated matrix (translation, rotation, scale or ``matrix``);
* a mesh's first primitive only, indexed; positions by the full matrix with
  the perspective divide; normals rotated by the accumulated rotation alone;
  no normals: the face's flat normal;
* materials: metallic-roughness factors, roughness at least 0.03, emission
  = emissive factor x ``KHR_materials_emissive_strength``; all PBR;
* the camera: ``fov_y = yfov``, ``fov_x = aspect * yfov`` (the course's
  linear approximation), its basis from the world matrix.

The configuration gives the ray depth and the background (the course's
converter fixes them: 6 and black). The program is handed the file itself.
"""

from __future__ import annotations

import base64
import json
import os

import numpy as np

from . import PBR, PLANE_FIELDS, PRIM_FIELDS, TRI, SceneSpec, columns

_DTYPES = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
           5125: np.uint32, 5126: np.float32}
_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _quat_mat(q) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _mat_quat(m: np.ndarray) -> np.ndarray:
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k]) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q


def _qmul(a, b) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([aw * bx + ax * bw + ay * bz - az * by, aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw, aw * bw - ax * bx - ay * by - az * bz])


def _qrot(q, v: np.ndarray) -> np.ndarray:
    qv = q[:3]
    t = 2.0 * np.cross(qv, v)
    return v + q[3] * t + np.cross(qv, t)


def _local(node: dict) -> tuple:
    if "matrix" in node:
        m = np.array(node["matrix"], np.float64).reshape(4, 4).T
        r = m[:3, :3].copy()
        s = np.linalg.norm(r, axis=0)
        s[s == 0] = 1.0
        return m, _mat_quat(r / s)
    q = np.array(node.get("rotation", [0, 0, 0, 1]), np.float64)
    m = np.eye(4)
    m[:3, :3] = _quat_mat(q) @ np.diag(np.array(node.get("scale", [1, 1, 1]), np.float64))
    m[:3, 3] = np.array(node.get("translation", [0, 0, 0]), np.float64)
    return m, q


class _Reader:
    def __init__(self, path: str):
        with open(path) as f:
            self.doc = json.load(f)
        base = os.path.dirname(os.path.abspath(path))
        self.bufs = []
        for b in self.doc.get("buffers", []):
            uri = b["uri"]
            if uri.startswith("data:"):
                self.bufs.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                with open(os.path.join(base, uri), "rb") as f:
                    self.bufs.append(f.read())
        self.rows, self.camera = [], None

    def accessor(self, i: int) -> np.ndarray:
        acc = self.doc["accessors"][i]
        view = self.doc["bufferViews"][acc["bufferView"]]
        dt = np.dtype(_DTYPES[acc["componentType"]])
        n, count = _SIZES[acc["type"]], acc["count"]
        off = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or dt.itemsize * n
        raw = self.bufs[view["buffer"]]
        out = np.stack([np.frombuffer(raw, dt, n, off + r * stride) for r in range(count)])
        return out if n > 1 else out[:, 0]

    def visit(self, i: int, pm: np.ndarray, pq: np.ndarray) -> None:
        node = self.doc["nodes"][i]
        lm, lq = _local(node)
        m, q = pm @ lm, _qmul(pq, lq)
        if "camera" in node:
            p = self.doc["cameras"][node["camera"]]["perspective"]
            yfov, aspect = float(p["yfov"]), float(p.get("aspectRatio", 1.0))
            o = m @ np.array([0.0, 0.0, 0.0, 1.0])
            self.camera = dict(position=o[:3] / o[3], right=(m @ [1.0, 0, 0, 0])[:3],
                               up=(m @ [0, 1.0, 0, 0])[:3], forward=(m @ [0, 0, -1.0, 0])[:3],
                               fov_x=aspect * yfov, fov_y=yfov)
        if "mesh" in node:
            self.mesh(self.doc["meshes"][node["mesh"]]["primitives"][0], m, q)
        for c in node.get("children", []):
            self.visit(c, m, q)

    def mesh(self, prim: dict, m: np.ndarray, q: np.ndarray) -> None:
        idx = self.accessor(prim["indices"]).astype(np.int64).reshape(-1, 3)
        pos = self.accessor(prim["attributes"]["POSITION"]).astype(np.float64)
        world = np.concatenate([pos, np.ones((len(pos), 1))], axis=1) @ m.T
        world = world[:, :3] / world[:, 3:4]
        nrm = None
        if "NORMAL" in prim["attributes"]:
            nrm = [_qrot(q, n) for n in self.accessor(prim["attributes"]["NORMAL"])
                   .astype(np.float64)]
        mat = self.material(prim.get("material"))
        for a, b, c in idx:
            if nrm is None:
                fn = np.cross(world[b] - world[a], world[c] - world[a])
                ln = np.linalg.norm(fn)
                fn = fn / ln if ln > 0 else np.array([0.0, 0.0, 1.0])
                sn = (fn, fn, fn)
            else:
                sn = (nrm[a], nrm[b], nrm[c])
            self.rows.append(dict(kind=TRI, p0=world[a], p1=world[b], p2=world[c], sn0=sn[0],
                                  sn1=sn[1], sn2=sn[2], mkind=PBR, **mat))

    def material(self, i) -> dict:
        if i is None:
            return dict(color=(1.0, 1.0, 1.0), metallic=1.0, roughness=1.0, ior=1.5)
        mat = self.doc["materials"][i]
        pbr = mat.get("pbrMetallicRoughness", {})
        strength = (mat.get("extensions", {}).get("KHR_materials_emissive_strength", {})
                    .get("emissiveStrength", 1.0))
        return dict(color=np.array(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float64)[:3],
                    metallic=float(pbr.get("metallicFactor", 1.0)),
                    roughness=max(float(pbr.get("roughnessFactor", 1.0)), 0.03),
                    emission=np.array(mat.get("emissiveFactor", [0, 0, 0]), np.float64)
                    * strength, ior=1.5)


def build(params: dict, root: str, width: int, height: int) -> SceneSpec:
    path = os.path.join(root, params["file"])
    r = _Reader(path)
    doc = r.doc
    if doc.get("scenes"):
        roots = doc["scenes"][doc.get("scene", 0)].get("nodes", [])
    else:
        kids = {c for n in doc.get("nodes", []) for c in n.get("children", [])}
        roots = [i for i in range(len(doc.get("nodes", []))) if i not in kids]
    for i in roots:
        r.visit(i, np.eye(4), np.array([0.0, 0.0, 0.0, 1.0]))
    if r.camera is None:
        raise ValueError(f"{path} has no camera node")
    return SceneSpec(prims=columns(r.rows, PRIM_FIELDS), planes=columns([], PLANE_FIELDS),
                     camera=r.camera, width=width, height=height,
                     ray_depth=int(params["ray_depth"]), bg=tuple(params["bg"]), file=path)
