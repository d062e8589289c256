"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Every scene is built by both packages from the same description, so a test
can hand identical inputs to the JAX reference and to the port. Nothing
here reads the course scene directory: the scenes are the inline MIXED
text scene, the graft entry's fallback Cornell box, a procedural mesh and
the in-repo ``scenes/cornell_box.gltf``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import raytracing_course_2024_tpu.scene as jscene
import raytracing_course_2024_tpu_torch.scene as tscene
from raytracing_course_2024_tpu_torch.ops.bounce import bounce_scene, gate_reason
from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
from __graft_entry__ import _FALLBACK_SCENE
from meshes import icosphere, mesh_scene_desc
from test_megakernel import MIXED_SCENE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell_box.gltf")
SCENES = ("mixed", "fallback", "mesh", "cornell")

# every light shape, rotated and not: box, ellipsoid, triangle lights
LIGHTS_SCENE = """
DIMENSIONS 24 16
RAY_DEPTH 4
SAMPLES 4
BG_COLOR 0.05 0.05 0.1
CAMERA_POSITION 0 0 8
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.1

NEW_PRIMITIVE
PLANE 0 1 0
POSITION 0 -2 0
COLOR 0.6 0.6 0.6

NEW_PRIMITIVE
BOX 0.6 0.2 0.4
POSITION -1.5 2 0
ROTATION 0.2 0.3 0.1 0.927
EMISSION 3 3 3

NEW_PRIMITIVE
BOX 0.3 0.3 0.3
POSITION 2 -1 -1
EMISSION 1 2 1

NEW_PRIMITIVE
ELLIPSOID 0.5 0.3 0.4
POSITION 1.5 1.5 0.5
ROTATION 0 0.3826834 0 0.9238795
EMISSION 2 1 1

NEW_PRIMITIVE
ELLIPSOID 0.3 0.3 0.3
POSITION -2 -1 1
EMISSION 1 1 2

NEW_PRIMITIVE
TRIANGLE -1 1 -2  1 1 -2  0 2.5 -2
EMISSION 2 2 2

NEW_PRIMITIVE
ELLIPSOID 0.8 0.8 0.8
POSITION 0 -1 0
COLOR 0.7 0.5 0.3
"""


def descs(name, w=None, h=None, spp=None):
    """(JAX SceneDesc, port SceneDesc) of one fixture scene."""
    if name in ("mixed", "fallback", "lights"):
        text = {"mixed": MIXED_SCENE, "fallback": _FALLBACK_SCENE,
                "lights": LIGHTS_SCENE}[name]
        jd, td = jscene.parse_text_scene(text), tscene.parse_text_scene(text)
        for d in (jd, td):
            if w:
                d.settings.width, d.settings.height = w, h
            if spp:
                d.settings.samples = spp
        return jd, td
    if name == "mesh":
        verts, faces = icosphere(1)
        d = mesh_scene_desc(verts, faces, width=w or 24, height=h or 16,
                            samples=spp or 4)
        return d, d  # both builders read the same attribute-only description
    if name == "cornell":
        w, h, spp = w or 32, h or 18, spp or 4
        return (jscene.load_scene(CORNELL, w, h, spp),
                tscene.load_scene(CORNELL, w, h, spp))
    raise KeyError(name)


def builds(name, w=None, h=None, spp=None):
    """((jdesc, jarrays numpy, jstatics), (tdesc, tarrays, tstatics))."""
    jd, td = descs(name, w, h, spp)
    ja, js = jscene.build_scene_arrays(jd)
    ta, ts = tscene.build_scene_arrays(td)
    return (jd, ja, js), (td, ta, ts)


def scene_from_jax(arrays, statics, device):
    """The port's device scenes and statics from the JAX package's host
    build (its ``SceneArrays`` of numpy arrays and its ``SceneStatics``, as
    ``raytracing_course_2024_tpu.scene.build_scene_arrays`` returns them),
    read field by field, so a test can run both packages on the identical
    scene: ``(BounceScene or None outside the fused gate, ModularScene,
    SceneStatics)``."""
    if arrays.bvh is not None:
        raise ValueError("the JAX package's treelet arrays have no port counterpart: build the "
                         "port's tree from the unreordered arrays (ops/bvh.py:attach_bvh)")
    port_arrays = tscene.SceneArrays(**{k: None if v is None else np.asarray(v)
                                        for k, v in arrays._asdict().items()})
    port_statics = tscene.SceneStatics(**statics._asdict())
    fused = (None if gate_reason(port_statics)
             else bounce_scene(port_arrays, port_statics, device))
    return fused, modular_scene(port_arrays, port_statics, device), port_statics


def to_jnp(arrays):
    return jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None,
                        arrays)


def t(x):
    """numpy / jax array -> CPU torch tensor (float32 stays float32)."""
    return torch.from_numpy(np.array(x))


def n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def random_unit(rng, b):
    v = rng.normal(size=(3, b))
    return (v / np.linalg.norm(v, axis=0)).astype(np.float32)
