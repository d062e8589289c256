"""PyTorch port, the bodies that a CUDA graph captures (``runtime/graphs.py``),
on the CPU.

* The counter RNG and the sampler with the seed and the work-id offset as
  0-dim int64 tensors equal their int versions bit for bit, seeds and
  offsets past 2^32 included (they wrap to their low 32 bits).
* One modular sample (``integrator/path.py:_modular_sample``) and the lane
  engines' XLA core (``integrator/wavefront.py:_make_bounce_core``) with
  device scalars equal the int versions bit for bit, on a dense modular
  scene with roulette and on a BVH mesh.
* Through a graph cache whose capture is a stub (the body itself replayed),
  the batch engine's frames match the JAX package's stages fed the same
  counter draws at test_torch_render.py's and test_torch_bvh_render.py's
  tolerances (>= 99 % of pixels within 1e-4, path vertices within 1 %), the
  lane engines the JAX Renderer, and every frame equals the eager frame bit
  for bit.
* A host-read guard: under it, ``Tensor.item``, ``__bool__``, ``__int__``,
  ``__float__``, ``__index__``, ``tolist``, ``numpy``, ``cpu``,
  ``nonzero`` and indexing by a boolean mask raise. The sample body, the
  wavefront core and refill and the sticky round run under it, on the
  modular and on the fused route (``ray_depth`` 1 too), with the kernel entry points swapped for their plain twins, which
  run outside it: none reads the host, so a capture would not freeze a
  value or fail on a sync.
* The cache: one entry per key, reused across seeds, samples, ``samp_base``
  and ``pix_base``; a new one for a new batch, replica count or cfg; a
  replay adds the launches recorded at capture.
* On a card (marked ``cuda``; skipped here): graphed frames equal eager ones,
  on the BVH backend and on the fused route.
"""

import contextlib
import threading

import jax
import numpy as np
import pytest
import torch

from meshes import displaced_organic_mesh, mesh_scene_desc
from raytracing_course_2024_tpu.integrator import path as jpath
from raytracing_course_2024_tpu.runtime.render import Renderer as JRenderer
from raytracing_course_2024_tpu_torch.integrator import path as P
from raytracing_course_2024_tpu_torch.integrator import wavefront as W
from raytracing_course_2024_tpu_torch.ops import bounce as B
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops import refill as RF
from raytracing_course_2024_tpu_torch.ops import rng as trng
from raytracing_course_2024_tpu_torch.ops import sampler as S
from raytracing_course_2024_tpu_torch.ops import traverse as T
from raytracing_course_2024_tpu_torch.ops.bounce import bounce_scene
from raytracing_course_2024_tpu_torch.ops.bvh import attach_bvh
from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays, pack_camera_row
from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
from raytracing_course_2024_tpu_torch.ops.vec import Vec3
from raytracing_course_2024_tpu_torch.runtime.graphs import GraphCache, Graphed
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from raytracing_course_2024_tpu_torch.scene import build_scene_arrays
import test_torch_render as TR
from test_torch_render import _jax_counter_loop
from torch_parity import builds, descs

SEED = 11
SEED32 = (SEED * 2654435761) & 0xFFFFFFFF
M32 = 0xFFFFFFFF


def _i64(x):
    return torch.tensor(x, dtype=torch.int64)


# --- the counter RNG and the sampler with device scalars -------------------


@pytest.mark.parametrize("seed,off", [
    (0, 0), (SEED32, 921_600 * 15), (M32, 7), (2**32 + 5, 2**32 + 3), (2**40 + 1, -5),
])
def test_rng_with_tensor_scalars_equals_ints(seed, off):
    wid = torch.from_numpy(np.random.default_rng(1).integers(-2**31, 2**31, 4096,
                                                             dtype=np.int64).astype(np.int32))
    ids = trng.offset_ids(wid, off)
    assert torch.equal(ids, trng.offset_ids(wid, _i64(off)))
    key = trng.work_key(seed, ids)
    assert torch.equal(key, trng.work_key(_i64(seed), ids))
    assert torch.equal(key, trng.work_key(seed & M32, ids))  # the low 32 bits
    for ctr in (0, 1, 29, trng.WF_BOUNCE0 + trng.WF_STRIDE * 3):
        assert torch.equal(trng.uniform_ctr(key, ctr),
                           trng.uniform_ctr(trng.work_key(_i64(seed), ids), ctr))
    assert torch.equal(trng.device_scalar(off, "cpu"), _i64(off))


def _sampler_inputs(name, b=2048):
    (_, _, _), (td, ta, ts) = builds(name, 16, 12, 2)
    scene = modular_scene(ta, ts, "cpu")
    g = np.random.default_rng(3)

    def unit():
        v = g.normal(size=(3, b))
        return Vec3(*torch.from_numpy((v / np.linalg.norm(v, axis=0)).astype(np.float32)))

    n = unit()
    point = Vec3(*torch.from_numpy(g.uniform(-2, 2, (3, b)).astype(np.float32)))
    v = unit()
    rough = torch.from_numpy(g.uniform(0.05, 1.0, b).astype(np.float32))
    need = torch.from_numpy(g.uniform(size=b) < 0.8)
    wid = torch.arange(b, dtype=torch.int32)
    return scene, wid, point, n, v, rough, need


@pytest.mark.parametrize("name", ["lights", "cornell"])
@pytest.mark.parametrize("fn", ["plain", "kernel", "faithful"])
@pytest.mark.parametrize("seed,off", [(SEED32, 921_600 * 3), (2**32 + 9, 2**33 + 1)])
def test_sampler_with_tensor_scalars_equals_ints(name, fn, seed, off):
    scene, wid, point, n, v, rough, need = _sampler_inputs(name)
    f = {"plain": S.sampler_plain, "kernel": S.sample_mixture_kernel,
         "faithful": lambda *a: S.sampler_plain(*a, faithful=True)}[fn]
    ctr = trng.batch_ctr(2 * trng.draws_per_bounce(4), 4)
    want = f(scene, seed, wid, off, ctr, point, n, n, v, rough, need)
    got = f(scene, _i64(seed), wid, _i64(off), ctr, point, n, n, v, rough, need)
    for a, b in zip([*want[0], *want[1:]], [*got[0], *got[1:]]):
        assert torch.equal(a, b)
    assert want[2].any()


# --- scenes of the bodies ----------------------------------------------------


def _dense_rr(w=16, h=12, spp=2, depth=4):
    """The MIXED scene on the modular route with roulette (depth 4: bounce
    2 rolls)."""
    (jd, ja, js), (td, ta, ts) = builds("mixed", w, h, spp)
    for d in (jd, td):
        d.settings.ray_depth = depth
    cfg = P.TraceConfig(ray_depth=depth, bg_color=tuple(td.settings.bg_color), rr=True)
    return (jd, ja, js), td, modular_scene(ta, ts, "cpu"), cfg


def _bvh_mesh(w=8, h=6, spp=2, subdiv=3):
    """A displaced mesh of tests/meshes.py on the BVH backend: 1,280
    triangles (subdiv 4: 5,120)."""
    v, f, vn = displaced_organic_mesh(subdiv=subdiv)
    d = mesh_scene_desc(v, f, vn, width=w, height=h, samples=spp)
    ta, ts = build_scene_arrays(d)
    ta, _ = attach_bvh(ta, ts)
    cfg = P.TraceConfig(ray_depth=d.settings.ray_depth, bg_color=tuple(d.settings.bg_color),
                        backend="bvh")
    return d, modular_scene(ta, ts, "cpu"), cfg


SCENES = {"dense-rr": lambda: _dense_rr()[1:], "bvh-mesh": _bvh_mesh}


def _lanes(d):
    w, h = d.settings.width, d.settings.height
    idx = torch.arange(w * h, dtype=torch.int32)
    cam = torch.from_numpy(pack_camera_row(camera_arrays(d.settings.camera))[0])
    return idx, (idx % w).float(), (idx // w).float(), cam


@pytest.mark.parametrize("scene_name", list(SCENES))
def test_modular_sample_with_device_scalars_equals_ints(scene_name):
    d, scene, cfg = SCENES[scene_name]()
    idx, px, py, cam_row = _lanes(d)
    cam = P.camera_from_row(cam_row)
    w, h = d.settings.width, d.settings.height
    for off in (3 * w * h, 2**32 + 17):
        want = P._modular_sample(scene, SEED32, idx, off, px, py, cam, cfg, w, h, False)
        got = P._modular_sample(scene, _i64(SEED32), idx, _i64(off), px, py, cam, cfg, w, h,
                                False)
        assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
        assert float(want[1]) > w * h


def _lane_state(d, scene, b):
    """A lane engines' state: camera rays of work items 0 .. b-1, every
    fifth lane dead, per-lane depths 0 .. 2."""
    w, h = d.settings.width, d.settings.height
    work = torch.arange(b, dtype=torch.int64)
    pix = work % (w * h)
    rows = RF.camera_rows(camera_arrays(d.settings.camera), pix % w, pix // w, w, h,
                           trng.work_key(SEED32, work))
    st = W._initial_state(13, b, "cpu")
    RF.restart_rows(st, work % 5 != 0, rows)
    return st, work.to(torch.int32), (work % 3).to(torch.int32)


@pytest.mark.parametrize("scene_name", list(SCENES))
def test_xla_core_with_a_device_seed_equals_int(scene_name):
    d, scene, cfg = SCENES[scene_name]()
    st, wid, depth = _lane_state(d, scene, 2 * d.settings.width * d.settings.height)
    want_core, fused = W._make_bounce_core(cfg, scene, SEED32)
    got_core, _ = W._make_bounce_core(cfg, scene, _i64(SEED32))
    assert not fused
    want, got = want_core(st.clone(), wid, depth), got_core(st.clone(), wid, depth)
    assert torch.equal(want, got) and not torch.equal(want, st)


# --- the stub capture and the cache ------------------------------------------


class Stub:
    """A capture that runs the body (the warm-up) and replays it eagerly;
    ``launches`` is what it reports a replay launches."""

    def __init__(self, launches=None):
        self.bodies, self.launches = [], dict(launches or {})

    def __call__(self, body, device):
        body()
        self.bodies.append(body)
        return body, dict(self.launches), {"capture_ms": 0.0, "pool_mb": 0.0}


def _cache(scene, launches=None):
    stub = Stub(launches)
    return GraphCache(scene, "cpu", capture_fn=stub), stub


def _render_batches(scene, d, cfg, graphs=None, seed=SEED32, samples=2, batch=None, **kw):
    w, h = d.settings.width, d.settings.height
    _, _, _, cam = _lanes(d)
    outs, verts = P.render_batches(scene, seed, cam, cfg, w, h, samples, batch or w * h,
                                   graphs=graphs, **kw)
    return torch.cat(outs, dim=1), verts


def _agree(got, want, verts, want_verts):
    ok = (np.abs(got - want) <= 1e-4).all(axis=0)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(float(verts) - want_verts) <= 0.01 * want_verts, (verts, want_verts)


@pytest.mark.parametrize("scene_name", list(SCENES))
def test_graphed_batch_frames_match_jax_and_eager(scene_name, monkeypatch):
    """The batch engine through the cache (stub capture) against the JAX
    package's stages fed the port's counter draws (its BVH on the mesh,
    with its level function jitted as test_torch_bvh_render.py does), and
    bit for bit against the eager frame."""
    if scene_name == "dense-rr":
        (jd, ja, js), d, scene, cfg = _dense_rr()
        backend = "dense"
    else:
        d, scene, cfg = _bvh_mesh(12, 8, subdiv=4)
        jd = d
        from raytracing_course_2024_tpu.scene import build_scene_arrays as jbuild
        ja, js = jbuild(jd)
        backend = "bvh"
        monkeypatch.setattr(TR, "_collect_hit",
                            jax.jit(jpath._collect_hit, static_argnums=(2, 3)))
    cache, stub = _cache(scene)
    got, verts = _render_batches(scene, d, cfg, cache)
    eager, eager_verts = _render_batches(scene, d, cfg)
    assert torch.equal(got, eager) and torch.equal(verts, eager_verts)
    assert len(cache.entries) == 1 and len(stub.bodies) == 1
    s = d.settings
    want, want_verts = _jax_counter_loop(jd, ja, js, s.width, s.height, 2, SEED32,
                                         s.ray_depth, rr=cfg.rr, backend=backend)
    _agree(got.numpy(), want, verts, want_verts)


@pytest.mark.parametrize("engine", ["wavefront", "sticky"])
def test_graphed_lane_engines_match_jax_and_eager(engine):
    """The lane engines on the MIXED scene's BVH backend through the cache
    (stub capture) against the JAX Renderer with the same engine and lanes,
    and bit for bit against the eager frame."""
    w, h, spp, lanes = 32, 24, 2, 256
    jd, td = descs("mixed", w, h, spp)
    r = Renderer(td, device="cpu", backend="bvh", engine=engine, batch_size=lanes)
    eager, eager_verts = r.render_frame_device(seed=SEED)
    eager_rounds = r.rounds
    r.graphs, stub = _cache(r.scene)
    got, verts = r.render_frame_device(seed=SEED)
    assert torch.equal(got[0], eager[0]) and verts == eager_verts and r.rounds == eager_rounds
    # one entry per engine: its guarded rounds, the counter refill inside them
    assert len(stub.bodies) == 1 and len(r.graphs.entries) == 1
    jr = JRenderer(jd, backend="bvh", engine=engine, batch_size=lanes)
    jouts, jverts = jr.render_frame_device(seed=SEED)
    _agree(got[0].numpy(), np.asarray(jouts[0]), verts, float(jverts))


def test_cache_keys_batch_engine():
    """One entry per key: a second seed, samples, ``samp_base`` and
    ``pix_base`` reuse it; a new batch, replica count or cfg adds one. Every
    graphed frame equals its eager twin."""
    d, scene, cfg = _dense_rr(w=16, h=12)[1:]
    cache, stub = _cache(scene)

    def frame(**kw):
        got = _render_batches(scene, d, cfg, cache, **kw)
        want = _render_batches(scene, d, cfg, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return len(cache.entries), len(stub.bodies)

    assert frame() == (1, 1)
    entry = next(iter(cache.entries.values()))
    assert entry.replays == 1  # 2 samples: the capture's warm-up, then a replay
    assert frame(seed=SEED32 + 1) == (1, 1)
    assert frame(samples=3, samp_base=5) == (1, 1)
    assert frame(pix_base=16, n_pix=192) == (1, 1)
    assert entry.replays == 1 + 2 + 3 + 2
    assert frame(batch=64) == (2, 2)  # 3 batches of 64 lanes, one entry
    assert frame(batch=1024, samples=4) == (3, 3)  # 192 pixels x 4 replicas
    assert frame(batch=1024, samples=8) == (3, 3)  # 4 replicas again, 2 spp each
    assert frame(batch=1024, samples=2) == (4, 4)  # 2 replicas
    for new_cfg, n in ((cfg._replace(max_tries=3), 5), (cfg._replace(rr=False), 6)):
        got = _render_batches(scene, d, new_cfg, cache)
        assert torch.equal(got[0], _render_batches(scene, d, new_cfg)[0])
        assert len(cache.entries) == n and len(stub.bodies) == n


def test_cache_keys_lane_engines():
    """The counter wavefront's loop and the sticky loop are keyed by lanes,
    cfg, the frame and the shard's pixels and samples: a second seed and a
    second ``samp_base`` or ``pix_base`` reuse them."""
    d, scene, cfg = _dense_rr(w=8, h=6)[1:]
    cam = camera_arrays(d.settings.camera)
    w, h = d.settings.width, d.settings.height
    cache, stub = _cache(scene)
    for render in (W.render_wavefront, W.render_wavefront_sticky):
        for seed, pix_base, samp_base in ((SEED32, 0, 0), (7, 0, 0), (7, 24, 3)):
            args = (seed, pix_base, samp_base, cam, scene, cfg, w, h, 24, 2, 32)
            got, want = render(*args, graphs=cache), render(*args)
            assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    assert len(cache.entries) == 2 and len(stub.bodies) == 2  # the two loops
    W.render_wavefront(SEED32, 0, 0, cam, scene, cfg, w, h, 24, 2, 16, graphs=cache)
    W.render_wavefront_sticky(SEED32, 0, 0, cam, scene, cfg, w, h, 24, 4, 32, graphs=cache)
    assert len(cache.entries) == 4


def test_cache_serves_its_own_scene_only():
    d, scene, cfg = _dense_rr(w=8, h=6)[1:]
    other = modular_scene(*build_scene_arrays(d), "cpu")
    cache, _ = _cache(scene)
    with pytest.raises(ValueError, match="device scene it was made for"):
        _render_batches(other, d, cfg, cache)


def test_replays_add_the_launches_recorded_at_capture(monkeypatch):
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES, 0))
    calls = []
    g = Graphed(lambda: calls.append(1), torch.device("cpu"),
                Stub({"bvh": 4, "sampler": 3}))
    for _ in range(3):
        g()
    assert len(calls) == 3 and g.replays == 2
    assert kernels.LAUNCHES == {k: {"bvh": 8, "sampler": 6}.get(k, 0) for k in kernels.LAUNCHES}


def test_recording_counts_this_threads_launches_only(monkeypatch):
    """Under ``recording()`` this thread's launches go to the recorder;
    another thread's still reach ``LAUNCHES``."""
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES, 0))
    with kernels.recording() as rec:
        kernels._count("bvh")
        kernels._count("bvh")
        th = threading.Thread(target=kernels._count, args=("sampler",))
        th.start()
        th.join()
    kernels._count("nearest")
    assert rec == {"bvh": 2}
    assert kernels.LAUNCHES == {k: int(k in ("sampler", "nearest")) for k in kernels.LAUNCHES}


# --- the host-read guard -------------------------------------------------------

_GUARDED = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist", "numpy", "cpu",
            "nonzero")
_GUARD = threading.local()


class HostRead(RuntimeError):
    pass


def _is_mask(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in items)


@contextlib.contextmanager
def _unguarded():
    was = getattr(_GUARD, "on", False)
    _GUARD.on = False
    try:
        yield
    finally:
        _GUARD.on = was


@pytest.fixture
def guard(monkeypatch):
    """``with guard():`` makes every host read of a tensor raise."""
    for name in _GUARDED:
        orig = getattr(torch.Tensor, name)

        def patched(self, *a, _orig=orig, _name=name, **k):
            if getattr(_GUARD, "on", False):
                raise HostRead(f"Tensor.{_name} inside a captured body")
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, patched)
    for name in ("__getitem__", "__setitem__"):
        orig = getattr(torch.Tensor, name)

        def indexed(self, index, *a, _orig=orig, _name=name):
            if getattr(_GUARD, "on", False) and _is_mask(index):
                raise HostRead(f"boolean-mask Tensor.{_name} inside a captured body")
            return _orig(self, index, *a)

        monkeypatch.setattr(torch.Tensor, name, indexed)

    def nonzero(*a, _orig=torch.nonzero, **k):
        if getattr(_GUARD, "on", False):
            raise HostRead("torch.nonzero inside a captured body")
        return _orig(*a, **k)

    monkeypatch.setattr(torch, "nonzero", nonzero)
    # the kernels' entry points: their plain twins read the host (K4's plain
    # version reads its triangle table), which the kernels do not
    for mod, name in ((T, "dense_nearest"), (T, "bvh_nearest"),
                      (P, "sample_mixture_kernel"), (B, "bounce"), (B, "primary_bounce"),
                      (W, "persistent_round")):
        orig = getattr(mod, name)

        def twin(*a, _orig=orig, **k):
            with _unguarded():
                return _orig(*a, **k)

        monkeypatch.setattr(mod, name, twin)

    @contextlib.contextmanager
    def on():
        _GUARD.on = True
        try:
            yield
        finally:
            _GUARD.on = False

    return on


def test_guard_catches_host_reads(guard):
    x = torch.arange(4)
    with guard():
        for read in (lambda: x.sum().item(), lambda: bool(x.any()), lambda: int(x[0]),
                     lambda: float(x[1]), lambda: x.tolist(), lambda: x.numpy(),
                     lambda: x.cpu(), lambda: x[x > 1], lambda: torch.nonzero(x),
                     lambda: range(10)[x[2]]):
            with pytest.raises(HostRead):
                read()
        x[1:3] += 1  # index arithmetic on the device is fine
    assert x.tolist() == [0, 2, 3, 3]


def _guarded_body(d, scene, cfg, body_name):
    """A body of ``scene`` ready for a call that does work: its inputs
    written and, for the refill and the sticky round, a first call made."""
    w, h = d.settings.width, d.settings.height
    cam = camera_arrays(d.settings.camera)
    if body_name == "sample":
        idx, px, py, cam_row = _lanes(d)
        body, _ = P.sample_body(scene, cam_row, cfg, w, h, w * h)
        body.load(SEED32, idx, px, py)
        body.at(w * h)
        out = body.acc
    elif body_name == "wavefront-core":
        body = W.CoreBody(cfg, scene, w * h)
        st, wid, depth = _lane_state(d, scene, w * h)
        body.state.copy_(st)
        body.wid.copy_(wid)
        body.depth.copy_(depth)
        body.seed.fill_(SEED32)
        out = body.state
    elif body_name == "wavefront-refill":
        loop, _ = W.wavefront_loop(cfg, scene, cam, w, h, w * h - 5, 2, w * h // 2)
        core, body = loop.core, loop.refill
        body.reset(SEED32, 5, 3)
        body()  # the first refill: every lane takes work
        for _ in range(3):
            core()
        out = core.state
    elif body_name in ("wavefront-round", "sticky-loop-round", "k5-loop-round"):
        # one guarded round as a capture records it: the guards' bodies run
        # (``_capture_guards``), the round test last (N5's twin)
        if body_name == "wavefront-round":
            body, _ = W.wavefront_loop(cfg, scene, cam, w, h, w * h - 5, 2, w * h // 2)
        elif body_name == "sticky-loop-round":
            body = W.StickyLoop(cfg, scene, cam, w, h, w * h, 2, w * h // 2)
        else:
            body = W.FusedStickyLoop(cfg, scene, cam, w, h, w * h, 2)
        body.reset(SEED32, 0, 3)
        body.round()
        return body.round, body.ls.loop
    else:
        body = W.StickyBody(cfg, scene, cam, w, h, w * h, 2, w * h // 2)
        body.reset(SEED32, 0, 3)
        body()  # the first round: lanes start their paths
        out = body.state
    return body, out


BODIES = ["sample", "wavefront-core", "wavefront-refill", "sticky-round", "wavefront-round",
          "sticky-loop-round"]


@pytest.fixture
def _capture_guards(monkeypatch):
    """``runtime/graphs.py:guard`` as a capture takes it: the guarded body
    runs as an IF node's body is recorded, with no read of its predicate."""
    monkeypatch.setattr(W, "guard", lambda pred, fn, tag, sections: fn())


@pytest.mark.parametrize("scene_name", list(SCENES))
@pytest.mark.parametrize("body_name", BODIES)
def test_bodies_read_nothing_from_the_host(guard, _capture_guards, scene_name, body_name):
    """Each body, and one guarded round of each lane loop (the counter
    wavefront's refill, bounce and round test, N5's twin; the sticky
    round and its test), runs under the host-read guard."""
    d, scene, cfg = SCENES[scene_name]()
    body, out = _guarded_body(d, scene, cfg, body_name)
    before = out.clone()
    with guard():
        body()
    assert not torch.equal(out, before)


@pytest.mark.parametrize("variant", ["default", "depth-1"])
@pytest.mark.parametrize("body_name", BODIES + ["k5-loop-round"])
def test_fused_bodies_read_nothing_from_the_host(guard, _capture_guards, body_name, variant):
    """The same on the fused route (a ``BounceScene``: K2, K1, K1-final and
    K1 in lane mode, swapped for their plain twins outside the guard): at
    ``ray_depth`` 1 too (N4, then K1-final); and one guarded round of the
    K5 loop (K5's plain twin outside the guard, then N5's twin in its
    ``K5`` mode)."""
    (_, _, _), (d, ta, ts) = builds("mixed", 16, 12, 2)
    if variant == "depth-1":
        d.settings.ray_depth = 1
    cfg = P.TraceConfig(ray_depth=d.settings.ray_depth, bg_color=tuple(d.settings.bg_color))
    assert P.mega_gate(cfg, ts)
    body, out = _guarded_body(d, bounce_scene(ta, ts, "cpu"), cfg, body_name)
    before = out.clone()
    with guard():
        body()
    assert not torch.equal(out, before)


# --- on the card -----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graph capture runs only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("engine,backend", [
    ("batch", "bvh"), ("wavefront", "bvh"), ("sticky", "bvh"),
    ("batch", "dense"), ("wavefront", "dense"), ("sticky", "dense"),
])
def test_graphed_frames_equal_eager_on_the_card(card, engine, backend):
    """The MIXED scene's BVH backend, and its dense backend on the fused
    route (K2, K1, K1-final; K1 in lane mode: the counter wavefront on
    4,096 lanes, the sticky engine on 1,024, fewer than the 3,072 pixels):
    image, path vertices, rounds and launches of the graphed frame equal the
    eager frame's, for two seeds."""
    _, td = descs("mixed", 64, 48, 4)
    lanes = 1024 if (engine, backend) == ("sticky", "dense") else 4096
    kw = dict(device=card, backend=backend, engine=engine, batch_size=lanes)
    eager, graphed = Renderer(td, eager=True, **kw), Renderer(td, **kw)
    assert graphed.fused == (backend == "dense")
    for seed in (1, 2):
        res = []
        for r in (eager, graphed):
            kernels.reset_launches()
            outs, verts = r.render_frame_device(seed=seed)
            res.append((torch.cat(outs, 1).cpu(), verts, r.rounds, dict(kernels.LAUNCHES)))
        assert torch.equal(res[0][0], res[1][0]) and res[0][1:] == res[1][1:]
    assert len(graphed.graphs.entries) == 1  # a lane loop's entry holds its refill


def test_renderer_takes_no_cache_on_the_cpu():
    _, td = descs("mixed", 8, 6, 1)
    assert Renderer(td, device="cpu").graphs is None


def test_k3_takes_consecutive_scalars_as_they_are():
    """The modular route's (seed, offset) pair reaches K3 as a view of its
    own buffer (no launch); other scalars are stacked into a new pair."""
    pair = torch.tensor([SEED32, 2**32 + 3], dtype=torch.int64)
    view = trng.seed_off(pair[0], pair[1], "cpu")
    assert view.data_ptr() == pair.data_ptr() and torch.equal(view, pair)
    for seed, off in ((SEED32, 2**32 + 3), (pair[0], 2**32 + 3), (pair[1], pair[0])):
        got = trng.seed_off(seed, off, "cpu")
        assert got.data_ptr() != pair.data_ptr()
        assert got.tolist() == [int(seed), int(off)]
