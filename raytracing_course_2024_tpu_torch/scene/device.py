"""Scene state carried across from the JAX package.

``scene_from_jax`` takes the JAX package's host build (its ``SceneArrays``
of numpy arrays and its ``SceneStatics``, as
``raytracing_course_2024_tpu.scene.build_scene_arrays`` returns them) and
returns the port's device scenes and statics, so tests can run both
packages on the identical scene: the fused path's ``BounceScene`` (None
when the scene is outside the fused gate) and the modular dense path's
``ModularScene``. Nothing here imports jax: the JAX objects
are read field by field.
"""

from __future__ import annotations

import numpy as np

from ..ops.bounce import BounceScene, bounce_scene, gate_reason
from ..ops.scene_intersect import ModularScene, modular_scene
from .types import SceneArrays, SceneStatics


def scene_from_jax(arrays, statics, device
                   ) -> tuple[BounceScene | None, ModularScene, SceneStatics]:
    if arrays.bvh is not None:
        raise ValueError("the JAX package's treelet arrays have no port counterpart: build the "
                         "port's tree from the unreordered arrays (ops/bvh.py:attach_bvh)")
    port_arrays = SceneArrays(**{k: None if v is None else np.asarray(v)
                                 for k, v in arrays._asdict().items()})
    port_statics = SceneStatics(**statics._asdict())
    fused = (None if gate_reason(port_statics)
             else bounce_scene(port_arrays, port_statics, device))
    return fused, modular_scene(port_arrays, port_statics, device), port_statics
