"""PyTorch port, K4's loop records and live mask on the CPU.

``build_tri_records`` must carry the (9, N) triangle pack bit for bit into
16-byte-aligned entry-major records with zero padding; a live mask must
change nothing on the live lanes and give the masked ones the miss
``(inf, 0)``; and the integrators, which pass their alive mask, must render
what the JAX package renders (the JAX package intersects every lane and
reads the hit only where the path is alive).

Tolerances: records, masked results and port-against-port frames are exact;
frames against the JAX engines as in test_torch_wavefront.py and
test_torch_modular.py (>= 99 % of pixels within 1e-4, path vertices within
1 %).
"""

import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.runtime.render import Renderer as JRenderer
from raytracing_course_2024_tpu_torch.ops import dense_nearest as DN
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops import scene_intersect as SI
from raytracing_course_2024_tpu_torch.ops import traverse
from raytracing_course_2024_tpu_torch.ops.traverse import nearest_hit
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from test_torch_dense_nearest import _scene, _tv
from torch_parity import descs

N_RAYS = 3000


def _pack(name):
    """The (9, N) pack of a fixture scene, or a random one of N triangles."""
    if name.startswith("random"):
        n = int(name[len("random"):])
        return np.random.default_rng(n).normal(size=(9, n)).astype(np.float32)
    return _scene(name)[1][0].tri_pack


@pytest.mark.parametrize("name", ["cornell", "ico1", "random1", "random7", "random128"])
def test_tri_records_round_trip(name):
    tri = _pack(name)
    rec = DN.build_tri_records(tri)
    n = tri.shape[1]
    assert rec.dtype == np.float32 and rec.shape == (n, DN.REC_FLOATS)
    assert rec.flags["C_CONTIGUOUS"] and rec.strides == (48, 4)  # three float4 per entry
    r = rec.reshape(n, 3, 4)
    for k in range(3):  # a, e1, e2: the pack's values, bit for bit
        assert np.array_equal(r[:, k, :3].T.view(np.uint32), tri[3 * k:3 * k + 3].view(np.uint32))
    assert not r[:, :, 3].any()  # padding
    back = np.ascontiguousarray(r[:, :, :3].reshape(n, 9).T)
    assert np.array_equal(back.view(np.uint32), tri.view(np.uint32))


def test_tri_records_refuse_another_layout():
    with pytest.raises(ValueError):
        DN.build_tri_records(np.zeros((12, 9), np.float32))


@pytest.mark.parametrize("name", ["cornell", "mixed", "ico2"])
def test_modular_scene_holds_the_records(name):
    (_, _), (ta, ts), _ = _scene(name)
    scene = SI.modular_scene(ta, ts, "cpu")
    if name != "cornell":  # planes or > 128 triangles: the sweep, no K4 tables
        assert scene.tri_pack is None and scene.tri_rec is None
        return
    assert torch.equal(scene.tri_rec, torch.from_numpy(DN.build_tri_records(ta.tri_pack)))
    assert scene.tri_rec.shape == (ta.tri_pack.shape[1], 12) and scene.tri_rec.is_contiguous()


def _masks():
    i = np.arange(N_RAYS)
    return {"every-third-dead": i % 3 != 0, "all-dead": np.zeros(N_RAYS, bool),
            "all-live": np.ones(N_RAYS, bool),
            "dead-warps-and-tiles": ((i // 32) % 3 != 0) & ((i // 512) % 2 == 0),
            "random": np.random.default_rng(3).random(N_RAYS) < 0.4}


@pytest.mark.parametrize("pattern", list(_masks()))
def test_plain_live_mask(pattern):
    (_, _), (ta, _), rays = _scene("cornell")
    o, d = rays(4)
    tri = torch.from_numpy(ta.tri_pack)
    live = torch.from_numpy(_masks()[pattern])
    t0, i0 = DN.dense_nearest_plain(_tv(o), _tv(d), tri)
    t1, i1 = DN.dense_nearest_plain(_tv(o), _tv(d), tri, live=live)
    assert t1.dtype == torch.float32 and i1.dtype == torch.int32
    assert torch.equal(t1[live], t0[live]) and torch.equal(i1[live], i0[live])
    assert torch.isinf(t1[~live]).all() and (t1[~live] > 0).all() and (i1[~live] == 0).all()
    if pattern == "all-live":
        assert torch.equal(t1, t0) and torch.equal(i1, i0)


def test_wrapper_takes_mask_and_records_on_cpu_and_counts_nothing():
    (_, _), (ta, ts), rays = _scene("cornell")
    o, d = rays(5)
    scene = SI.modular_scene(ta, ts, "cpu")
    live = torch.from_numpy(_masks()["every-third-dead"])
    kernels.reset_launches()
    got = DN.dense_nearest(_tv(o), _tv(d), scene.tri_pack, 0.0, live, records=scene.tri_rec)
    want = DN.dense_nearest_plain(_tv(o), _tv(d), scene.tri_pack, 0.0, live)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.LAUNCHES["nearest"] == 0
    hit = nearest_hit(_tv(o), _tv(d), scene, live=live)
    full = nearest_hit(_tv(o), _tv(d), scene)
    assert not hit.valid[~live].any() and torch.equal(hit.valid[live], full.valid[live])
    assert torch.equal(hit.t[live], full.t[live]) and torch.equal(hit.idx[live], full.idx[live])


def _without_mask(monkeypatch):
    """Makes the integrators' nearest hit ignore the live mask, and counts the
    calls that came with one."""
    seen = {"masked": 0, "calls": 0}
    plain = DN.dense_nearest_plain

    def unmasked(ro, rd, tri_pack, tmin=0.0, live=None):
        seen["calls"] += 1
        seen["masked"] += live is not None
        return plain(ro, rd, tri_pack, tmin)

    monkeypatch.setattr(traverse, "dense_nearest_plain", unmasked)
    monkeypatch.setattr(DN, "dense_nearest_plain", unmasked)
    return seen


@pytest.mark.parametrize("engine", ["batch", "sticky", "wavefront"])
def test_frames_do_not_depend_on_the_mask(engine, monkeypatch):
    """Cornell with roulette (the modular path; the lane engines' XLA core)
    renders the same frame, bit for bit, whether K4's plain version masks the
    dead lanes or intersects them: nothing reads a dead lane's hit."""
    _, td = descs("cornell", 24, 18, 2)
    kw = dict(device="cpu", engine=engine, russian_roulette=True)
    if engine == "wavefront":
        kw["batch_size"] = 256
    r = Renderer(td, **kw)
    assert not r.fused and r.scene.tri_pack is not None
    outs, verts = r.render_frame_device(seed=7)
    seen = _without_mask(monkeypatch)
    outs2, verts2 = Renderer(td, **kw).render_frame_device(seed=7)
    assert seen["calls"] > 0 and seen["masked"] == seen["calls"]  # every call passed a mask
    assert verts == verts2
    assert all(torch.equal(a, b) for a, b in zip(outs, outs2))


@pytest.mark.parametrize("engine", ["sticky", "wavefront"])
def test_masked_cornell_frames_match_jax(engine):
    """The lane engines' XLA core with the mask passed, against the JAX
    Renderer with the same engine, Cornell with roulette at 24x18 x 2 spp
    (JAX on the XLA sweep: the same nearest hit as its interpret-mode
    triangle kernel, far less CPU time). The batch engine's modular frame is
    held against the JAX-driven counter loop in test_torch_modular.py."""
    w, h = 24, 18
    jd, td = descs("cornell", w, h, 2)
    kw = dict(engine=engine, russian_roulette=True)
    if engine == "wavefront":
        kw["batch_size"] = 256
    jr = JRenderer(jd, **kw)
    jr.arrays = jr.arrays._replace(tri_pack=None)
    jouts, jverts = jr.render_frame_device(seed=5)
    r = Renderer(td, device="cpu", **kw)
    assert not r.fused and r.scene.tri_rec is not None
    outs, verts = r.render_frame_device(seed=5)
    got, want = outs[0].numpy(), np.asarray(jouts[0])
    assert got.shape == want.shape and np.isfinite(got).all() and got.max() > 0
    ok = (np.abs(got - want) <= 1e-4).all(axis=0)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(verts - float(jverts)) <= 0.01 * float(jverts)


def test_every_kernel_source_shares_the_lane_queue():
    """The persistent grid and the lane queue live in one header that every
    kernel includes, and the build hashes it with the rest of ``csrc/``."""
    names = {p.name for p in kernels.CSRC.iterdir() if p.is_file()}
    assert "lane_queue.cuh" in names
    text = {n: (kernels.CSRC / n).read_text() for n in names}
    for n in ("bounce_body.cuh", "dense_nearest.cu", "sampler.cu"):
        assert '#include "lane_queue.cuh"' in text[n], n
    for n in ("bounce.cu", "persistent.cu"):
        assert '#include "bounce_body.cuh"' in text[n], n
    assert [n for n, src in text.items() if "struct LaneQueue " in src] == ["lane_queue.cuh"]
    for n, src in text.items():  # every quoted include is a file of csrc/
        for line in src.splitlines():
            if line.startswith('#include "'):
                assert line.split('"')[1] in names, (n, line)
