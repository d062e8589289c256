"""Scene ingestion: text-format and glTF parsers -> SoA scene arrays.

Numpy-only host code, a copy of the JAX package's ``scene`` layer (that
package cannot be imported here: importing it loads jax).
"""

from __future__ import annotations

from .build import build_scene_arrays
from .gltf import load_gltf_scene
from .text_format import load_text_scene, parse_text_scene
from .types import (
    BOX,
    DIELECTRIC,
    DIFFUSE,
    ELLIPSOID,
    EPS,
    MIRROR,
    PBR,
    PLANE,
    TRI,
    CameraDesc,
    PrimitiveDesc,
    RenderSettings,
    SceneArrays,
    SceneDesc,
    SceneStatics,
)


def load_scene(path: str, width: int = 0, height: int = 0, samples: int = 0):
    """Dispatch on extension. For .txt, width/height/samples come from the
    file (argv values, if nonzero, override -- the reference CLI contract,
    where glTF gets them from argv)."""
    if path.endswith(".bin"):
        raise ValueError(
            f"{path} is a raw glTF buffer, not a scene: its .gltf JSON "
            "wrapper is required"
        )
    if path.endswith(".gltf") or path.endswith(".glb"):
        if not (width and height and samples):
            raise ValueError("glTF scenes require width/height/samples")
        return load_gltf_scene(path, width, height, samples)
    desc = load_text_scene(path)
    if width:
        desc.settings.width = width
    if height:
        desc.settings.height = height
    if samples:
        desc.settings.samples = samples
    return desc


__all__ = [
    "BOX",
    "DIELECTRIC",
    "DIFFUSE",
    "ELLIPSOID",
    "EPS",
    "MIRROR",
    "PBR",
    "PLANE",
    "TRI",
    "CameraDesc",
    "PrimitiveDesc",
    "RenderSettings",
    "SceneArrays",
    "SceneDesc",
    "SceneStatics",
    "build_scene_arrays",
    "load_gltf_scene",
    "load_scene",
    "load_text_scene",
    "parse_text_scene",
]
