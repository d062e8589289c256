"""Generate scenes/cornell_box.gltf -- an in-repo Cornell box.

A STAND-IN for the course's headline scene practice7_1 (not a copy of it):
the course scene files are not part of this repository, so tests and the
GPU smoke render this file instead. It mirrors practice7_1's description
(SURVEY.md section 2.2): 36 triangles in one glTF 2.0 file with
metallic-roughness materials --

* 5 walls = 10 triangles: white diffuse floor, ceiling and back wall, a red
  metallic left wall and a blue metallic right wall;
* an emissive ceiling quad = 2 triangles (KHR_materials_emissive_strength);
* two grey boxes = 24 triangles, placed by node translation / rotation /
  scale (the loader's node-transform path).

Every mesh carries per-vertex normals; the buffer is embedded as a
base64 ``data:`` URI, so the file needs no ``.bin``.

    python scenes/gen_cornell_box.py   # rewrites scenes/cornell_box.gltf
"""

import base64
import json
import math
import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cornell_box.gltf")


def quad(a, b, c, d):
    """Two triangles (a, b, c), (a, c, d) with the flat normal of (a, b, c)."""
    a, b, c, d = (np.asarray(p, np.float32) for p in (a, b, c, d))
    n = np.cross(b - a, c - a)
    n = n / np.linalg.norm(n)
    return [a, b, c, d], [n] * 4, [0, 1, 2, 0, 2, 3]


def merge(quads):
    pos, nrm, idx = [], [], []
    for p, n, i in quads:
        base = len(pos)
        pos += p
        nrm += n
        idx += [base + k for k in i]
    return np.array(pos, np.float32), np.array(nrm, np.float32), np.array(idx, np.uint16)


def unit_cube():
    """Cube [-1, 1]^3, 6 outward faces."""
    q = []
    for axis in range(3):
        for s in (1.0, -1.0):
            u, v = (axis + 1) % 3, (axis + 2) % 3
            corners = []
            for cu, cv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = [0.0, 0.0, 0.0]
                p[axis], p[u], p[v] = s, cu * s, cv
                corners.append(p)
            q.append(quad(*corners))
    return merge(q)


# room: x, z in [-1, 1], y in [0, 2]; every wall faces into the room
MESHES = {
    "white_walls": merge([
        quad((-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1)),  # floor, +y
        quad((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)),  # ceiling, -y
        quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)),  # back, +z
    ]),
    "red_wall": merge([quad((-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1))]),
    "blue_wall": merge([quad((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1))]),
    "light": merge([quad((-0.3, 1.98, -0.3), (0.3, 1.98, -0.3), (0.3, 1.98, 0.3),
                         (-0.3, 1.98, 0.3))]),
    "box": unit_cube(),
}

MATERIALS = [
    ("white", dict(baseColorFactor=[0.8, 0.8, 0.8, 1.0], metallicFactor=0.0,
                   roughnessFactor=1.0), None),
    ("red_metal", dict(baseColorFactor=[0.8, 0.15, 0.1, 1.0], metallicFactor=0.9,
                       roughnessFactor=0.3), None),
    ("blue_metal", dict(baseColorFactor=[0.1, 0.2, 0.8, 1.0], metallicFactor=0.9,
                        roughnessFactor=0.3), None),
    ("grey", dict(baseColorFactor=[0.6, 0.6, 0.6, 1.0], metallicFactor=0.0,
                  roughnessFactor=0.6), None),
    ("light", dict(baseColorFactor=[0.0, 0.0, 0.0, 1.0], metallicFactor=0.0,
                   roughnessFactor=1.0), ([1.0, 0.9, 0.75], 12.0)),
]
MESH_MATERIAL = {"white_walls": 0, "red_wall": 1, "blue_wall": 2, "light": 4, "box": 3}


def yrot(deg):
    h = math.radians(deg) / 2
    return [0.0, math.sin(h), 0.0, math.cos(h)]


def build() -> dict:
    blob = bytearray()
    views, accessors, meshes = [], [], []

    def add_view(arr, target):
        while len(blob) % 4:
            blob.append(0)
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": arr.nbytes, "target": target})
        blob.extend(arr.tobytes())
        return len(views) - 1

    for name, (pos, nrm, idx) in MESHES.items():
        vp = add_view(pos, 34962)
        vn = add_view(nrm, 34962)
        vi = add_view(idx, 34963)
        accessors += [
            {"bufferView": vp, "componentType": 5126, "count": len(pos),
             "type": "VEC3", "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": vn, "componentType": 5126, "count": len(nrm), "type": "VEC3"},
            {"bufferView": vi, "componentType": 5123, "count": len(idx), "type": "SCALAR"},
        ]
        a = len(accessors) - 3
        meshes.append({"name": name, "primitives": [{
            "attributes": {"POSITION": a, "NORMAL": a + 1}, "indices": a + 2,
            "material": MESH_MATERIAL[name]}]})

    materials = []
    for name, pbr, emissive in MATERIALS:
        m = {"name": name, "pbrMetallicRoughness": pbr}
        if emissive:
            m["emissiveFactor"] = emissive[0]
            m["extensions"] = {"KHR_materials_emissive_strength": {
                "emissiveStrength": emissive[1]}}
        materials.append(m)

    names = list(MESHES)
    nodes = [
        {"name": "camera", "camera": 0, "translation": [0.0, 1.0, 3.4]},
        {"name": "white_walls", "mesh": names.index("white_walls")},
        {"name": "red_wall", "mesh": names.index("red_wall")},
        {"name": "blue_wall", "mesh": names.index("blue_wall")},
        {"name": "light", "mesh": names.index("light")},
        {"name": "tall_box", "mesh": names.index("box"), "translation": [-0.38, 0.6, -0.3],
         "rotation": yrot(20.0), "scale": [0.28, 0.6, 0.28]},
        {"name": "short_box", "mesh": names.index("box"), "translation": [0.4, 0.3, 0.35],
         "rotation": yrot(-17.0), "scale": [0.3, 0.3, 0.3]},
    ]
    return {
        "asset": {"version": "2.0", "generator": "scenes/gen_cornell_box.py"},
        "extensionsUsed": ["KHR_materials_emissive_strength"],
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": 0.72, "aspectRatio": 16.0 / 9.0, "znear": 0.05, "zfar": 100.0}}],
        "meshes": meshes,
        "materials": materials,
        "buffers": [{"byteLength": len(blob), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(bytes(blob)).decode()}],
        "bufferViews": views,
        "accessors": accessors,
    }


if __name__ == "__main__":
    with open(OUT, "w") as f:
        json.dump(build(), f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}")
