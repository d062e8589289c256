"""PyTorch port, what the bounce kernels read and count beside the (35, M)
table: the entry-major loop records (``build_loop_records``) hold every
entry of every fixture scene bit for bit, and the fused path's path-vertex
count, which the kernels take themselves level by level, equals the sum of
the per-level alive counts and the JAX stages' count."""

import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu_torch.integrator.path import (
    TraceConfig, render_pixels, trace_sample)
from raytracing_course_2024_tpu_torch.ops import bounce as B
from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays, pack_camera_row
from raytracing_course_2024_tpu_torch.scene.types import BOX, ELLIPSOID, TRI
from test_torch_render import _jax_counter_loop
from torch_parity import SCENES, builds

PLANE = 3
SEED32 = 0x9E3779B9


def _records(name):
    _, (_, ta, ts) = builds(name)
    geo = B.build_geo_rows(ta, ts)
    return geo, ts.mega_spec, B.build_loop_records(geo, ts.mega_spec)


@pytest.mark.parametrize("name", SCENES + ("lights",))
def test_loop_records_round_trip(name):
    """Every entry's record decodes to exactly the table columns the loop
    read before: a triangle's a, e1, e2; the other kinds' size or normal,
    position and quaternion; and the spec word, bit for bit."""
    geo, spec, rec = _records(name)
    m = geo.shape[1]
    assert rec.shape == (m, B.REC_FLOATS) and rec.dtype == np.float32
    assert rec.flags["C_CONTIGUOUS"]
    r = rec.reshape(m, 3, 4)
    codes = r[:, 0, 3].copy().view(np.int32)
    for i, (kind, rotated, mkind) in enumerate(spec):
        assert codes[i] == kind | (int(rotated) << 2) | (mkind << 3), i
        assert np.array_equal(r[i, 0, :3], geo[B._A:B._A + 3, i]), i
        if kind == TRI:
            assert np.array_equal(r[i, 1, :3], geo[B._E1:B._E1 + 3, i]), i
            assert np.array_equal(r[i, 2, :3], geo[B._E2:B._E2 + 3, i]), i
            assert r[i, 1, 3] == 0.0 and r[i, 2, 3] == 0.0
        else:
            assert np.array_equal(r[i, 1, :3], geo[B._POS:B._POS + 3, i]), i
            assert np.array_equal(r[i, 2], geo[B._ROT:B._ROT + 4, i]), i
            assert r[i, 1, 3] == 0.0


def test_loop_records_cover_every_entry_kind():
    """MIXED holds a triangle, a box, an ellipsoid and a plane, rotated and
    not; Cornell is all triangles, LIGHTS adds a rotated ellipsoid."""
    seen = set()
    for name in ("mixed", "lights", "cornell"):
        seen |= {(k, bool(r)) for k, r, _ in _records(name)[1]}
    assert {(TRI, False), (BOX, False), (BOX, True), (ELLIPSOID, False), (ELLIPSOID, True),
            (PLANE, False), (PLANE, True)} <= seen


def test_loop_records_follow_the_table_not_the_scene():
    """The records are a pure function of the table and the spec: a changed
    column changes that entry's record and no other."""
    geo, spec, rec = _records("mixed")
    geo2 = geo.copy()
    geo2[B._A, 2] += 1.0
    rec2 = B.build_loop_records(geo2, spec)
    changed = np.flatnonzero((rec2 != rec).any(axis=1))
    assert changed.tolist() == [2]
    with pytest.raises(ValueError):
        B.build_loop_records(geo, spec[:-1])


def test_bounce_scene_carries_the_records():
    _, (_, ta, ts) = builds("mixed")
    scene = B.bounce_scene(ta, ts, "cpu")
    want = B.build_loop_records(scene.geo_np, ts.mega_spec)
    assert scene.rec.dtype == torch.float32 and tuple(scene.rec.shape) == want.shape
    assert np.array_equal(scene.rec.numpy().view(np.int32), want.view(np.int32))
    B.check_scene(scene, torch.device("cpu"))
    with pytest.raises(ValueError):
        B.check_scene(scene._replace(rec=scene.rec[:, :8].contiguous()), torch.device("cpu"))


def _lanes(td, w, h):
    idx = torch.arange(w * h, dtype=torch.int32)
    cam = torch.from_numpy(pack_camera_row(camera_arrays(td.settings.camera))[0])
    return idx, (idx % w).float(), (idx // w).float(), cam


@pytest.mark.parametrize("name,depth", [("mixed", 1), ("mixed", 2), ("mixed", 4), ("cornell", 6)])
def test_trace_sample_count_is_the_sum_of_per_level_alive_counts(name, depth):
    """The count the wrappers take level by level (``count=``, on the card
    inside the kernels) equals the alive rows summed after every level but
    the last, plus every lane at bounce 0; the plain route gives the same."""
    w, h = 16, 12
    _, (td, ta, ts) = builds(name, w, h, 1)
    scene = B.bounce_scene(ta, ts, "cpu")
    cfg = TraceConfig(ray_depth=depth, bg_color=tuple(td.settings.bg_color))
    idx, px, py, cam = _lanes(td, w, h)
    bg, k = cfg.bg_color, cfg.max_tries
    want = w * h
    if depth >= 2:
        st = B.primary_plain(scene, cam, px, py, idx, 0, SEED32, bg, k, w, h)
        for i in range(1, depth - 1):
            want += int((st[12] > 0.5).sum())
            st = B.bounce_plain(scene, st, idx, 0, SEED32, i, bg, k)
        want += int((st[12] > 0.5).sum())
    state = torch.empty((B.N_STATE, w * h))
    st_k, rays_k = trace_sample(scene, state, SEED32, idx, 0, px, py, cam, cfg, w, h)
    st_p, rays_p = trace_sample(scene, state, SEED32, idx, 0, px, py, cam, cfg, w, h, plain=True)
    assert rays_k.dtype == torch.int64 and rays_k.dim() == 0
    assert int(rays_k) == want and float(rays_p) == float(want)
    assert want > w * h or depth == 1
    assert torch.equal(st_k, st_p)


def test_bounce_count_adds_the_lanes_alive_on_entry():
    """``bounce(count=)`` adds to the counter (it does not set it), in both
    modes of K1, and leaves the state it returns unchanged."""
    w, h = 16, 12
    _, (td, ta, ts) = builds("mixed", w, h, 1)
    scene = B.bounce_scene(ta, ts, "cpu")
    idx, px, py, cam = _lanes(td, w, h)
    bg = tuple(td.settings.bg_color)
    st = B.primary_bounce(scene, cam, px, py, idx, 0, SEED32, bg, 4, w, h)
    alive = int((st[12] > 0.5).sum())
    assert 0 < alive < w * h
    count = torch.full((), 7, dtype=torch.int64)
    out = B.bounce(scene, st, idx, 0, SEED32, 1, bg, 4, count=count)
    assert int(count) == 7 + alive
    assert torch.equal(out, B.bounce(scene, st, idx, 0, SEED32, 1, bg, 4))
    B.bounce(scene, st, idx, 0, SEED32, 3, bg, 4, final_only=True, count=count)
    assert int(count) == 7 + 2 * alive


def test_path_vertex_count_equals_the_jax_stages_on_the_inline_scene():
    """MIXED, 16x12 x 2 spp, depth 4: the frame's path vertices counted by
    the wrappers equal those of the JAX package's stages fed the same
    counter draws (each level's alive lanes, summed)."""
    w, h, spp, depth = 16, 12, 2, 4
    (jd, ja, js), (td, ta, ts) = builds("mixed", w, h, spp)
    _, want = _jax_counter_loop(jd, ja, js, w, h, spp, SEED32, depth)
    idx, px, py, cam = _lanes(td, w, h)
    cfg = TraceConfig(ray_depth=depth, bg_color=tuple(td.settings.bg_color))
    scene = B.bounce_scene(ta, ts, "cpu")
    _, got = render_pixels(scene, SEED32, idx, px, py, cam, cfg, w, h, spp, w * h)
    _, got_plain = render_pixels(scene, SEED32, idx, px, py, cam, cfg, w, h, spp, w * h,
                                 plain=True)
    assert got.dtype == torch.float64
    assert float(got) == float(got_plain) == want


@pytest.mark.parametrize("what,bad", [
    ("dtype", lambda t: t.double()), ("shape", lambda t: t[:, :5].contiguous()),
    ("strides", lambda t: t.t().contiguous().t())])
def test_check_refuses_a_tensor_a_kernel_cannot_take(what, bad):
    """``kernels.check`` guards every pointer handed to a kernel: the dtype,
    the shape and the contiguity must be the ones the kernel indexes by."""
    from raytracing_course_2024_tpu_torch.ops import kernels

    t = torch.zeros((B.N_STATE, 8))
    dev = torch.device("cpu")
    kernels.check("state", t, torch.float32, (B.N_STATE, 8), dev)
    with pytest.raises(ValueError, match="state"):
        kernels.check("state", bad(t), torch.float32, (B.N_STATE, 8), dev)


def test_one_build_ships_without_contraction_or_fast_math():
    """The library is built from the sources and ``NVCC_FLAGS`` alone, no
    ``-D`` switch among them: rounding stays op by op and IEEE."""
    from raytracing_course_2024_tpu_torch.ops import kernels

    assert "--fmad=false" in kernels.NVCC_FLAGS
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
    assert not any(f.startswith("-D") for f in kernels.NVCC_FLAGS)


def test_tile_tickets_are_kept_per_device_and_stream():
    """K1 and K5 hand out their tiles with two int32 that stay 0 between
    launches: one pair per (device, stream), reused by every launch."""
    from raytracing_course_2024_tpu_torch.ops import kernels

    dev = torch.device("cpu")
    pair = kernels._tickets(dev, 0)
    assert kernels._tickets(dev, 0) is pair
    assert kernels._tickets(dev, 7) is not pair
    assert pair.dtype == torch.int32 and pair.tolist() == [0, 0]


def test_a_failed_launch_leaves_the_tile_tickets_at_zero():
    """A launcher's error raises, and the tickets that launch took are set
    back, so the next launch on the stream starts from tile 0."""
    from raytracing_course_2024_tpu_torch.ops import kernels

    pair = torch.tensor([5, 2], dtype=torch.int32)
    kernels._raise_on(0, "rt_launch_bounce", pair)
    assert pair.tolist() == [5, 2]
    with pytest.raises(RuntimeError, match="rt_launch_bounce"):
        kernels._raise_on(700, "rt_launch_bounce", pair)
    assert pair.tolist() == [0, 0]
