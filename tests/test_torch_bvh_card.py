"""PyTorch port, K6 on the card against its plain version.

On a card (marked ``cuda``; skipped here): K6 (``ops/traverse.py:bvh_nearest``,
the walk of the 4-wide tree, whose empty slots' boxes lie at +inf) against the
sweep (``bvh_nearest_plain``) on the 5,120-triangle mesh's BVH, with the live
mask and without, on random and axis-parallel rays from outside the mesh and
from within its boxes: t and row equal on every lane, masked lanes the miss
(inf, 0).
``python -m pytest tests/test_torch_bvh_card.py -m cuda`` runs them there.
"""

import numpy as np
import pytest
import torch

from meshes import displaced_organic_mesh, mesh_scene_desc
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops.bvh import WIDE_TOP, attach_bvh
from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
from raytracing_course_2024_tpu_torch.ops.traverse import bvh_nearest, bvh_nearest_plain
from raytracing_course_2024_tpu_torch.ops.vec import Vec3
from raytracing_course_2024_tpu_torch.scene import build_scene_arrays


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 runs only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["all", "live"])
def test_k6_equals_the_sweep_on_the_card(card, masked):
    v, f, vn = displaced_organic_mesh(subdiv=4)
    arrays, statics = build_scene_arrays(mesh_scene_desc(v, f, vn))
    scene = modular_scene(attach_bvh(arrays, statics)[0], statics, card)
    g = np.random.default_rng(31)
    n = 50_000
    o = g.uniform(-1.2, 1.2, (n, 3))
    o[: n // 2] *= 3.0  # from outside the mesh, and from within its boxes
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[: n // 10] = np.eye(3)[g.integers(0, 3, n // 10)]  # axis-parallel: infinite inv

    def vec(a):
        return Vec3(*torch.from_numpy(a.T.astype(np.float32).copy()).to(card))

    ro, rd = vec(o), vec(d)
    live = torch.from_numpy(g.uniform(size=n) < 0.6).to(card) if masked else None
    t, row = bvh_nearest(ro, rd, scene, live=live)
    tp, rp = bvh_nearest_plain(ro, rd, scene, live=live)
    torch.cuda.synchronize()
    assert torch.equal(t, tp) and torch.equal(row, rp)
    walked = live if masked else torch.ones_like(t, dtype=torch.bool)
    assert torch.isfinite(t[walked]).float().mean().item() > 0.2
    if masked:
        assert torch.isinf(t[~live]).all() and (row[~live] == 0).all()
    # the walk model counts visits to K6's staged top by the kernel's own count
    assert kernels.launch_geometry()["bvh_top_nodes"] == WIDE_TOP
