"""PyTorch port, the fused route's captured bodies and the counter
wavefront's refill body (``runtime/graphs.py``), on the CPU.

* K1 (batch mode, ``final_only`` and lane mode) and K2, wrapper and plain
  version, given the seed and the work-id offset as two consecutive
  elements of one (2,) int64 tensor (the pair the routes own, which reaches
  the kernels as it is) equal the int call bit for bit, for a seed and an
  offset past 2^32 too (their low 32 bits).
* Through a graph cache whose capture is a recording stub (it runs the body
  once with its launches recorded, counts them as the warm-up's, and
  replays the body with its launches recorded and dropped, so that a replay
  counts only what the capture recorded, as on the card), every frame
  equals the eager frame bit for bit: image, path vertices, rounds and
  launches (the fused wrappers count on the CPU here), for two seeds and a
  second ``samp_base``, with one capture per entry. Cases: the fused batch
  route (K2; ``ray_depth`` 1), the counter wavefront with
  its refill inside its guarded rounds on the fused and the modular route, the sticky engine
  on fewer lanes than pixels and on its K5 route. The first frame of each
  matches the JAX package at test_torch_graphs.py's tolerance (>= 99 % of
  the pixels within 1e-4, path vertices within 1 %): the batch route
  against the JAX stages fed the same counter draws, the lane engines
  against the JAX Renderer with the same engine and lanes.
* The cache: a second seed, ``samp_base`` or shard (``pix_base``) adds no
  entry; the cfg (its ``ray_depth``), the lane count and the pass's
  pixels and samples do.
"""

import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.runtime.render import Renderer as JRenderer
from raytracing_course_2024_tpu_torch.integrator import path as P
from raytracing_course_2024_tpu_torch.integrator import wavefront as W
from raytracing_course_2024_tpu_torch.ops import bounce as B
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops import refill as RF
from raytracing_course_2024_tpu_torch.ops.rng import work_key
from raytracing_course_2024_tpu_torch.ops.bounce import bounce_scene
from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays, pack_camera_row
from raytracing_course_2024_tpu_torch.runtime.graphs import GraphCache
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from test_torch_render import _jax_counter_loop
from torch_parity import builds, descs

SEED = 3
M32 = 0xFFFFFFFF


def _seed32(seed):
    return (seed * 2654435761) & M32


# --- K1 and K2 with the seed and the offset on the device ----------------------


def _fused_inputs(w=16, h=12):
    (_, _, _), (td, ta, ts) = builds("mixed", w, h, 2)
    scene = bounce_scene(ta, ts, "cpu")
    idx = torch.arange(w * h, dtype=torch.int32)
    cam = torch.from_numpy(pack_camera_row(camera_arrays(td.settings.camera))[0])
    bg = tuple(td.settings.bg_color)
    st = B.primary_plain(scene, cam, (idx % w).float(), (idx // w).float(), idx, 0, 7, bg, 4,
                         w, h)
    return scene, st, idx, cam, bg, w, h


@pytest.mark.parametrize("seed,off", [(_seed32(SEED), 192 * 5), (2**32 + 9, 2**33 + 1)])
@pytest.mark.parametrize("mode", ["primary", "bounce", "final", "lane"])
@pytest.mark.parametrize("fn", ["wrapper", "plain"])
def test_k1_k2_with_a_device_pair_equal_ints(seed, off, mode, fn):
    scene, st, idx, cam, bg, w, h = _fused_inputs()
    depth = (idx % 4).to(torch.int32)
    pair = torch.tensor([seed, off], dtype=torch.int64)

    def call(s, o):
        if mode == "primary":
            f = B.primary_bounce if fn == "wrapper" else B.primary_plain
            return f(scene, cam, (idx % w).float(), (idx // w).float(), idx, o, s, bg, 4, w, h)
        f = B.bounce if fn == "wrapper" else B.bounce_plain
        return f(scene, st, idx, o, s, 1, bg, 4, final_only=mode == "final",
                 depth=depth if mode == "lane" else None)

    want = call(seed, off)
    assert torch.equal(want, call(pair[0], pair[1]))
    assert torch.equal(want, call(seed & M32, off & M32))  # the low 32 bits
    if mode != "final":  # the final level draws nothing
        assert not torch.equal(want, call(seed + 1, off))


# --- the recording stub and the frames ---------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """The fused wrappers (K2, K1, K5) count their calls on the CPU as their
    launches on the card, and ``LAUNCHES`` starts from 0."""
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES, 0))
    for mod, name, kind in ((B, "primary_bounce", lambda kw: "primary"),
                            (B, "bounce", lambda kw: "final" if kw.get("final_only") else "bounce"),
                            (W, "persistent_round", lambda kw: "persistent")):
        orig = getattr(mod, name)

        def counting(*a, _orig=orig, _kind=kind, **kw):
            kernels._count(_kind(kw))
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, counting)


class RecordingStub:
    """A capture that runs the body once with its launches recorded and
    counted (the warm-up's), and replays the body with its launches
    recorded and dropped: a replay then counts what the capture recorded,
    as a replayed graph does."""

    def __init__(self):
        self.bodies = []

    def __call__(self, body, device):
        with kernels.recording() as rec:
            body()
        kernels.add_launches(rec)
        self.bodies.append(body)

        def replay():
            with kernels.recording():
                body()

        return replay, dict(rec), {"capture_ms": 0.0, "pool_mb": 0.0}


def _frame(r, seed, samp_base=0, graphs=None, pix_base=0):
    """One frame of ``r``'s pixel count (its samples ``samp_base ..`` from
    pixel ``pix_base`` on, through the integrators, as a chunk or a shard
    renders them; pixels past the last row render the last row's) with the
    launches counted from 0: image, path vertices, rounds, launches."""
    s = r.settings
    w, h, spp = s.width, s.height, s.samples
    n_pix = w * h
    kernels.reset_launches()
    rounds = 0
    if r.engine == "batch":
        outs, verts = P.render_batches(r.scene, _seed32(seed), r.cam_row, r.cfg, w, h, spp,
                                       n_pix, pix_base=pix_base, n_pix=n_pix,
                                       samp_base=samp_base, graphs=graphs)
        img, verts = torch.cat(outs, dim=1), float(verts)
    else:
        render = W.render_wavefront_sticky if r.engine == "sticky" else W.render_wavefront
        img, verts, rounds = render(_seed32(seed), pix_base, samp_base, r.cam, r.scene, r.cfg,
                                    w, h, n_pix, spp, min(r.batch_size, n_pix * spp),
                                    graphs=graphs)
    return img, verts, rounds, dict(kernels.LAUNCHES)


def _same(a, b):
    return torch.equal(a[0], b[0]) and a[1:] == b[1:]


W_, H_, SPP = 16, 12, 2
# case -> (Renderer keywords, ray_depth, cache entries of a frame)
CASES = {
    "batch-fused": ({}, None, 1),
    "batch-fused-depth-1": ({}, 1, 1),
    "wavefront-fused": (dict(engine="wavefront", batch_size=64), None, 1),
    "wavefront-modular": (dict(engine="wavefront", batch_size=64, russian_roulette=True), None,
                          1),
    "sticky-fused-lanes-below-pixels": (dict(engine="sticky", batch_size=100), None, 1),
    "sticky-fused-k5": (dict(engine="sticky"), None, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_frames_match_jax_and_eager(case, counted):
    kw, depth, entries = CASES[case]
    jd, td = descs("mixed", W_, H_, SPP)
    if depth is not None:
        jd.settings.ray_depth = td.settings.ray_depth = depth
    r = Renderer(td, device="cpu", **kw)
    assert r.fused == (case != "wavefront-modular") and r.graphs is None
    stub = RecordingStub()
    cache = GraphCache(r.scene, "cpu", capture_fn=stub)
    first = None
    for seed, samp_base in ((SEED, 0), (SEED + 1, 0), (SEED + 1, 3)):
        eager = _frame(r, seed, samp_base)
        got = _frame(r, seed, samp_base, graphs=cache)
        assert _same(got, eager), (seed, samp_base)
        assert any(got[3].values()) == r.fused
        first = first or got
    assert len(cache.entries) == len(stub.bodies) == entries
    assert sum(e.replays for e in cache.entries.values()) > 0

    img, verts = first[0].numpy(), first[1]
    if r.engine == "batch":
        (jd, ja, js), _ = builds("mixed", W_, H_, SPP)
        jd.settings.ray_depth = td.settings.ray_depth
        want, want_verts = _jax_counter_loop(jd, ja, js, W_, H_, SPP, _seed32(SEED),
                                             td.settings.ray_depth)
    else:
        jr = JRenderer(jd, **kw)
        # the XLA dense sweep in place of the interpret-mode triangle kernel
        jr.arrays = jr.arrays._replace(tri_pack=None)
        jouts, want_verts = jr.render_frame_device(seed=SEED)
        want, want_verts = np.asarray(jouts[0]), float(want_verts)
    ok = (np.abs(img - want) <= 1e-4).all(axis=0)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(verts - want_verts) <= 0.01 * want_verts, (verts, want_verts)


def test_cache_keys_fused_routes(counted):
    """A second seed, ``samp_base`` and ``pix_base`` (a shard) reuse the
    entries of a frame; another ``ray_depth`` adds one to the batch route,
    the pass's samples a counter-wavefront loop and a sticky loop."""
    _, td = descs("mixed", W_, H_, SPP)
    for kw, n_first, n_new in (({}, 1, 2), (dict(engine="wavefront", batch_size=64), 1, 2),
                               (dict(engine="sticky", batch_size=100), 1, 2)):
        r = Renderer(td, device="cpu", **kw)
        stub = RecordingStub()
        cache = GraphCache(r.scene, "cpu", capture_fn=stub)
        for seed, samp_base, pix_base in ((SEED, 0, 0), (SEED + 7, 5, 0), (SEED, 0, 16),
                                          (SEED + 1, 2, 16)):
            assert _same(_frame(r, seed, samp_base, cache, pix_base),
                         _frame(r, seed, samp_base, None, pix_base))
            assert len(cache.entries) == n_first, (kw, seed, samp_base, pix_base)
        cfg = r.cfg
        if r.engine == "batch":
            r.cfg = cfg._replace(ray_depth=cfg.ray_depth - 1)
        else:
            r.settings.samples = 3
        assert _same(_frame(r, SEED, 0, cache), _frame(r, SEED, 0))
        r.cfg, r.settings.samples = cfg, SPP
        assert len(cache.entries) == len(stub.bodies) == n_new, kw
        if r.engine == "wavefront":  # one loop for each pass's samples
            assert sum(k[0] == "wavefront" for k in cache.entries) == 2


def test_refill_body_equals_the_eager_refill():
    """One ``RefillBody`` call on a mid-frame state against the refill
    written out on the host, as the counter wavefront ran it before it was
    a body: the same flush, ranks, work items, work ids, camera rays and
    depths, and the counter moved by min(dead, work left)."""
    _, td = descs("mixed", W_, H_, SPP)
    r = Renderer(td, device="cpu", engine="wavefront", batch_size=64)
    loop, _ = W.wavefront_loop(r.cfg, r.scene, r.cam, W_, H_, 100, SPP, 64)
    core, refill = loop.core, loop.refill
    run_core, run_refill = core, refill
    refill.reset(_seed32(SEED), 37, 4)
    run_refill()
    for _ in range(3):
        run_core()
    state, work, depth = core.state.clone(), refill.work.clone(), core.depth.clone()
    done, counter = refill.done.clone(), int(refill.counter)
    run_refill()

    total = 100 * SPP
    dead = state[12] < 0.5
    assert 0 < int(dead.sum()) < 64
    drop = total + torch.arange(64)
    done.index_copy_(1, torch.where(dead & (work >= 0), work, drop), state[9:12])
    state[9:12] = torch.where(dead, 0.0, state[9:12])
    new_id = counter + torch.cumsum(dead, 0) - 1
    take = dead & (new_id < total)
    work = torch.where(take, new_id, torch.where(dead, -1, work))
    w = work.clamp(min=0)
    wid = (4 + w // 100) * (W_ * H_) + 37 + w % 100
    pixg = 37 + w % 100
    rays = RF.camera_rows(r.cam, pixg % W_, torch.clamp(pixg // W_, max=H_ - 1), W_, H_,
                           work_key(_seed32(SEED), wid))
    RF.restart_rows(state, take, rays)
    assert torch.equal(refill.done, done) and torch.equal(refill.work, work)
    assert torch.equal(core.state, state)
    assert torch.equal(core.depth, torch.where(take, 0, depth))
    assert torch.equal(core.wid, wid.to(torch.int32))
    assert int(refill.counter) == counter + min(int(dead.sum()), total - counter)


def test_renderer_frames_use_the_cache_on_both_routes(counted):
    """A ``Renderer`` given a cache renders its fused frames through it
    (the batch route, the counter wavefront, the sticky engine below one
    lane per pixel, and its K5 route), one entry each."""
    _, td = descs("mixed", W_, H_, SPP)
    for kw, entries in (({}, 1), (dict(engine="wavefront", batch_size=64), 1),
                        (dict(engine="sticky", batch_size=100), 1), (dict(engine="sticky"), 1)):
        r = Renderer(td, device="cpu", **kw)
        eager = r.render_frame_device(seed=SEED)
        r.graphs = GraphCache(r.scene, "cpu", capture_fn=RecordingStub())
        got = r.render_frame_device(seed=SEED)
        assert torch.equal(torch.cat(got[0], 1), torch.cat(eager[0], 1)) and got[1] == eager[1]
        assert len(r.graphs.entries) == entries, kw
