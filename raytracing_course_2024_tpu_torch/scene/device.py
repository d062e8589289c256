"""Scene state carried across from the JAX package.

``scene_from_jax`` takes the JAX package's host build (its ``SceneArrays``
of numpy arrays and its ``SceneStatics``, as
``raytracing_course_2024_tpu.scene.build_scene_arrays`` returns them) and
returns the port's bounce tensors and statics, so tests can run both
packages on the identical scene. Nothing here imports jax: the JAX objects
are read field by field.
"""

from __future__ import annotations

import numpy as np

from ..ops.bounce import BounceScene, bounce_scene
from .types import SceneArrays, SceneStatics


def scene_from_jax(arrays, statics, device) -> tuple[BounceScene, SceneStatics]:
    if arrays.bvh is not None:
        raise NotImplementedError("BVH arrays are not ported yet (ROADMAP M6)")
    port_arrays = SceneArrays(**{k: None if v is None else np.asarray(v)
                                 for k, v in arrays._asdict().items()})
    port_statics = SceneStatics(**statics._asdict())
    return bounce_scene(port_arrays, port_statics, device), port_statics
