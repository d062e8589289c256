"""PyTorch port, modular nearest hit against the JAX package on the CPU.

K4's plain version (``ops/dense_nearest.py``) is held against the JAX
triangle kernel ``pallas_dense_nearest`` itself, run in interpret mode;
the port's ``nearest_hit`` + ``surface_detail`` against the JAX
package's on scenes that take K4 (Cornell), the single-pass sweep (MIXED:
planes, boxes, ellipsoids, rotations; icosphere(2): 320 triangles) and the
two-chunk sweep (a 1281-primitive mesh).

Tolerance: valid masks equal; idx equal on >= 99.9 % of valid lanes (a
grazing hit on a shared edge may go to either triangle when two float32
formulations round differently); t and every surface field within
atol = rtol = 1e-5 on >= 99.9 % of the lanes whose winner agrees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.ops.pallas_intersect import pallas_dense_nearest
from raytracing_course_2024_tpu.ops.scene_intersect import (
    nearest_hit_dense as j_nearest,
    surface_detail as j_detail,
)
from raytracing_course_2024_tpu.ops.vec import Vec3 as JV
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops import scene_intersect as SI
from raytracing_course_2024_tpu_torch.ops.dense_nearest import dense_nearest, dense_nearest_plain
from raytracing_course_2024_tpu_torch.ops.traverse import nearest_hit
from raytracing_course_2024_tpu_torch.ops.vec import Vec3 as TV
from torch_parity import builds, random_unit, to_jnp

import raytracing_course_2024_tpu.scene as jscene
import raytracing_course_2024_tpu_torch.scene as tscene
from meshes import displaced_organic_mesh, icosphere, mesh_scene_desc

N_RAYS = 3000  # not a multiple of the TPU kernel's 8192-lane block
TOL = dict(atol=1e-5, rtol=1e-5)
LANE_FRAC = 0.999


def _random_rays(box, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(*box, (3, N_RAYS)).astype(np.float32)
    return o, random_unit(r, N_RAYS)


def _camera_rays(cam, seed):
    """Rays from around the camera over 1.5x its field of view."""
    r = np.random.default_rng(seed)
    sx, sy = r.uniform(-1.5, 1.5, (2, N_RAYS))
    tx, ty = np.tan(cam.fov_x / 2), np.tan(cam.fov_y / 2)
    d = (np.asarray(cam.forward)[:, None] + sx * tx * np.asarray(cam.right)[:, None]
         + sy * ty * np.asarray(cam.up)[:, None])
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    o = np.asarray(cam.position)[:, None] + r.uniform(-0.05, 0.05, (3, N_RAYS))
    return o.astype(np.float32), d


def _scene(name):
    """((jarrays, jstatics), (tarrays, tstatics), rays(seed) -> (o, d)).

    Cornell's rays start at the camera: its box bottoms are coplanar with
    the floor, and from inside a box the two faces tie, so the winner would
    be decided by the last bit of t."""
    if name in ("mixed", "cornell"):
        (jd, ja, js), (_, ta, ts) = builds(name)
        if name == "cornell":
            return (ja, js), (ta, ts), lambda s: _camera_rays(jd.settings.camera, s)
        return (ja, js), (ta, ts), lambda s: _random_rays((-3.0, 3.0), s)
    if name == "ico1":
        desc = mesh_scene_desc(*icosphere(1))
    elif name == "ico2":
        desc = mesh_scene_desc(*icosphere(2))
    else:  # "mesh": 1280 smooth-shaded triangles + a light, above DENSE_CHUNK
        desc = mesh_scene_desc(*displaced_organic_mesh(subdiv=3))
    return (jscene.build_scene_arrays(desc), tscene.build_scene_arrays(desc),
            lambda s: _random_rays((-1.6, 1.6), s))


def _jv(a):
    return JV(*(jnp.asarray(c) for c in a))


def _tv(a):
    return TV(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _frac_close(got, want, mask):
    ok = np.isclose(np.asarray(got)[mask], np.asarray(want)[mask], **TOL)
    return ok.mean() if ok.size else 1.0


@pytest.mark.parametrize("name", ["cornell", "ico1"])
def test_k4_plain_matches_jax_kernel(name):
    (ja, _), (ta, _), rays = _scene(name)
    assert ta.tri_pack is not None and np.array_equal(ta.tri_pack, ja.tri_pack)
    o, d = rays(0)
    jt, ji = pallas_dense_nearest(_jv(o), _jv(d), jnp.asarray(ja.tri_pack))
    jt, ji = np.asarray(jt), np.asarray(ji)
    tt, ti = dense_nearest_plain(_tv(o), _tv(d), torch.from_numpy(ta.tri_pack))
    tt, ti = tt.numpy(), ti.numpy()
    assert ti.dtype == np.int32 and tt.dtype == np.float32
    valid = np.isfinite(jt)
    assert np.array_equal(np.isfinite(tt), valid)
    assert 0.2 < valid.mean() < 1.0  # hits and misses
    assert (ti[~valid] == 0).all()  # idx 0 on a miss, like the kernel
    assert (ti == ji)[valid].mean() >= LANE_FRAC
    np.testing.assert_allclose(tt[valid], jt[valid], **TOL)


def test_k4_wrapper_runs_plain_on_cpu_and_counts_nothing():
    (_, _), (ta, _), rays = _scene("cornell")
    o, d = rays(1)
    kernels.reset_launches()
    tri = torch.from_numpy(ta.tri_pack)
    got = dense_nearest(_tv(o), _tv(d), tri, 0.0)
    want = dense_nearest_plain(_tv(o), _tv(d), tri, 0.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.LAUNCHES["nearest"] == 0
    with pytest.raises(ValueError):
        dense_nearest(TV(*(torch.from_numpy(c).to("meta") for c in o)),
                      _tv(d), tri.to("meta"))


@pytest.mark.parametrize("name,sweep_elems", [
    ("cornell", None), ("mixed", None), ("ico2", None), ("mesh", None),
    ("mesh", 1024 * 700),  # lane cut too: five lane blocks of 700 rays
])
def test_nearest_hit_and_surface_detail_match_jax(name, sweep_elems, monkeypatch):
    (ja, js), (ta, ts), rays = _scene(name)
    if sweep_elems:
        monkeypatch.setattr(SI, "SWEEP_ELEMS", sweep_elems)
    o, d = rays(2)
    jhit = j_nearest(_jv(o), _jv(d), to_jnp(ja), js)
    jsurf = j_detail(_jv(o), _jv(d), jhit, to_jnp(ja), js)
    scene = SI.modular_scene(ta, ts, "cpu")
    assert (scene.tri_pack is not None) == (name == "cornell")
    thit = nearest_hit(_tv(o), _tv(d), scene)
    tsurf = SI.surface_detail(_tv(o), _tv(d), thit, scene)

    valid = np.asarray(jhit.valid)
    assert np.array_equal(thit.valid.numpy(), valid)
    assert 0.2 < valid.mean() < 1.0
    same = (valid & (thit.idx.numpy() == np.asarray(jhit.idx))
            & (thit.is_plane.numpy() == np.asarray(jhit.is_plane)))
    assert same.sum() >= LANE_FRAC * valid.sum()
    assert _frac_close(thit.t.numpy(), jhit.t, valid) >= LANE_FRAC
    if ts.num_planes:
        assert np.asarray(jhit.is_plane)[valid].any()
    for field in jsurf._fields:
        want, got = getattr(jsurf, field), getattr(tsurf, field)
        pairs = zip(got, want) if isinstance(want, JV) else [(got, want)]
        for g, w in pairs:
            g = g.numpy().astype(np.float32)
            assert _frac_close(g, np.asarray(w, np.float32), same) >= LANE_FRAC, field
