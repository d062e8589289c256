"""Scene inputs of the benchmark's configurations.

A configuration's file names a scene builder (``scene.kind``): the module
``rtbench/scenes/<kind>.py``, whose ``build(params, root, width, height)``
returns a ``SceneSpec``. The same spec is handed to the program (through
``rtbench/program.py``) and to the plain reference, or, where the spec
names a scene file, the program loads that file itself and the reference
reads the spec its builder parsed from it.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np

# shape kinds and material kinds, as the course's scene formats have them
TRI, BOX, ELLIPSOID = 0, 1, 2
DIFFUSE, MIRROR, DIELECTRIC, PBR = 0, 1, 2, 3

PRIM_FIELDS = {"kind": 1, "p0": 3, "p1": 3, "p2": 3, "sn0": 3, "sn1": 3, "sn2": 3,
               "position": 3, "rotation": 4, "color": 3, "metallic": 1, "roughness": 1,
               "emission": 3, "ior": 1, "mkind": 1}
PLANE_FIELDS = {"normal": 3, "position": 3, "rotation": 4, "color": 3, "metallic": 1,
                "roughness": 1, "emission": 3, "ior": 1, "mkind": 1}
DEFAULTS = {"rotation": (0.0, 0.0, 0.0, 1.0), "roughness": 1.0, "ior": 1.5}


@dataclasses.dataclass
class SceneSpec:
    """Columns of float64 (kind, mkind: int64) numpy arrays, one row per
    finite primitive (``prims``) or infinite plane (``planes``); the camera
    (position, right, up, forward, fov_x, fov_y); the settings; ``file``,
    a scene file the program loads itself, or None."""

    prims: dict
    planes: dict
    camera: dict
    width: int
    height: int
    ray_depth: int
    bg: tuple
    file: str | None = None

    @property
    def num_prims(self) -> int:
        return len(self.prims["kind"])


def columns(rows: list, fields: dict) -> dict:
    """Row dicts -> the columns of ``fields``, missing values defaulted."""
    out = {}
    for name, width in fields.items():
        default = DEFAULTS.get(name, 0.0 if width == 1 else (0.0,) * width)
        vals = [r.get(name, default) for r in rows]
        dt = np.int64 if name in ("kind", "mkind") else np.float64
        arr = np.asarray(vals, dt)
        out[name] = arr.reshape((len(rows),) if width == 1 else (len(rows), width))
    return out


def concat(a: dict, b: dict) -> dict:
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def build(scene: dict, root: str, width: int, height: int) -> SceneSpec:
    """The ``SceneSpec`` of a configuration's ``scene`` entry."""
    mod = importlib.import_module(f"rtbench.scenes.{scene['kind']}")
    return mod.build(scene, root, width, height)
