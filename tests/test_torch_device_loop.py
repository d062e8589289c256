"""PyTorch port, the lane loops' control on the device
(``integrator/wavefront.py``: ``WavefrontLoop``, ``StickyLoop``,
``FusedStickyLoop``; the round test N5, ``ops/loop.py``), on the CPU.

* N5's plain version (and its wrapper, which runs it on the CPU) against a
  count written in the test, on lanes all alive, all dead, 3 % alive and an
  odd lane count, in the counter wavefront's and the sticky engine's mode,
  three tests in a row; the refill predicate at ``thresh - 1``, ``thresh``
  and ``thresh + 1`` dead lanes; the round test that ends a K5 round
  (``k5_round_plain``). Counts are integers: equal exactly.
* Each loop at 1, 3 and 8 rounds a call against a host loop written here
  over the same bodies (``CoreBody`` and ``RefillBody``, ``StickyBody``,
  K5's plain version): the loop the port ran before its control moved to
  the device, reading the lanes alive on the host every round and
  mirroring the work counter. Image bit for bit; path vertices, rounds and
  refills exactly; the loop's host reads max(ceil(rounds / R), 1).
  Graphed through a stub capture, the same.
* A frame past its cap of rounds raises on each loop; none stops short.
* The counter wavefront and the sticky engine against the JAX package's
  ``render_wavefront`` / ``render_wavefront_sticky`` on the MIXED tile
  (pixels 37..136 at samples 4..5, 64 lanes) and the Cornell box, at
  test_torch_wavefront.py's tolerances (>= 99 % of pixels within 1e-4, path
  vertices within 1 %), and the counter wavefront's rounds against the JAX
  ``while_loop``'s own count (``RT_WF_DEBUG=1`` makes the JAX
  ``_wf_finish`` return it): equal where the two frames' path vertices are
  equal, as on these cases; where they differ (a flipped accept decision
  ends a path a round earlier or later) within one round.
* On a card (marked ``cuda``; skipped here): N5 against its twin, the
  test alone and each tail (``round_tail``), eagerly and replayed from a
  graph with the launch in an IF node; graphed lane
  frames against eager ones (image, path vertices, rounds, refills,
  launches), their host reads per frame, and no implicit sync of the card
  in a graphed frame (``torch.cuda.set_sync_debug_mode``).
"""

import math
import warnings

import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.integrator import wavefront as jwf
from raytracing_course_2024_tpu.integrator.path import TraceConfig as JTraceConfig
from raytracing_course_2024_tpu.ops.camera import camera_arrays as j_camera
from raytracing_course_2024_tpu_torch.integrator import path as P
from raytracing_course_2024_tpu_torch.integrator import wavefront as W
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops import loop as LP
from raytracing_course_2024_tpu_torch.ops.bounce import bounce_scene
from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays
from raytracing_course_2024_tpu_torch.ops.persistent import S_ACC, S_K, persistent_plain
from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
from raytracing_course_2024_tpu_torch.ops.shade import PARK_DIR, PARK_ORIGIN
from raytracing_course_2024_tpu_torch.runtime.graphs import GraphCache
from torch_parity import builds, to_jnp

SEED = 7
SEED32 = (SEED * 2654435761) & 0xFFFFFFFF


# --- N5's plain version against a count written here ---------------------------------


def _lanes(n, live, seed=0):
    g = np.random.default_rng(seed)
    alive = torch.from_numpy((g.random(n) < live).astype(np.float32))
    k = torch.from_numpy(g.integers(0, 4, n))
    kmax = torch.from_numpy(g.integers(0, 4, n))
    return alive, k, kmax


def _want(mode, alive, k, kmax, counter, total, thresh):
    """(n, more, refill, lanes entering the next bounce), counted in Python."""
    a = alive.numpy() > 0.5
    if mode == LP.STICKY:
        n = int((a | (k.numpy() < kmax.numpy())).sum())
        return n, n > 0, False, n
    n, b = int(a.sum()), len(a)
    more = counter < total or n > 0
    refill = more and b - n >= thresh
    return n, more, refill, n + (min(b - n, total - counter) if refill else 0)


@pytest.mark.parametrize("fn", [LP.round_test_plain, LP.round_test], ids=["plain", "wrapper"])
@pytest.mark.parametrize("mode", [LP.COUNTER, LP.STICKY], ids=["counter", "sticky"])
@pytest.mark.parametrize("n,live", [(4096, 1.0), (4096, 0.0), (4096, 0.03), (997, 0.5)],
                         ids=["all-live", "all-dead", "3pct", "odd"])
def test_round_test_counts_the_lanes(fn, mode, n, live):
    ls = LP.LoopState("cpu")
    start = torch.tensor([9, 1, 1, 100, 4, 2])
    ls.loop.copy_(start)
    want = start.tolist()
    for step in range(3):
        alive, k, kmax = _lanes(n, live, seed=step)
        counter, total, thresh = 3 * n + step, 4 * n, n // 8
        if live == 0.0 and step == 2:
            counter = total  # no work left and no lane alive: the loop stops
        fn(ls, mode, alive=alive, k=k, kmax=kmax, counter=torch.tensor(counter), total=total,
           thresh=thresh)
        cnt, more, refill, enter = _want(mode, alive, k, kmax, counter, total, thresh)
        want[:3] = [cnt, int(more), int(refill)]
        want[LP.NVERTS] += enter if more else 0
        want[LP.ROUNDS] += int(more)
        want[LP.REFILLS] += int(refill)
        assert ls.loop.tolist() == want, step
        assert ls.preds.tolist() == [more, refill]
    assert not ls.scratch.any()


@pytest.mark.parametrize("dead_off", [-1, 0, 1])
def test_refill_predicate_at_the_threshold(dead_off):
    """The refill runs from ``thresh`` dead lanes on, as the JAX
    ``lax.cond(n_dead >= thresh)``; what it hands out is min(dead, left)."""
    b, thresh = 512, 64
    dead = thresh + dead_off
    alive = torch.ones(b)
    alive[:dead] = 0.0
    for left in (1000, 5):
        ls = LP.LoopState("cpu")
        LP.round_test_plain(ls, LP.COUNTER, alive=alive, counter=torch.tensor(2000 - left),
                            total=2000, thresh=thresh)
        refill = dead >= thresh
        assert ls.refill_pred.item() == refill and ls.more.item()
        assert ls.loop[LP.NVERTS].item() == b - dead + (min(dead, left) if refill else 0)
        assert ls.loop[LP.REFILLS].item() == int(refill)


def test_round_test_k5_counts():
    """The round test that ends a K5 round (``k5_round_plain``, K5's last
    block on a card): its lanes with work left are the loop's ``n`` and
    decide ``more``, its live lanes go to the path vertices."""
    ls = LP.LoopState("cpu")
    ls.loop[LP.ROUNDS] = 1
    for live, left, rounds in ((40, 12, 2), (30, 0, 2)):
        LP.k5_round_plain(ls, torch.tensor(live), torch.tensor(left))
        assert ls.loop[LP.N_ALIVE].item() == left
        assert ls.more.item() == (left > 0) and ls.loop[LP.ROUNDS].item() == rounds
    assert ls.loop[LP.NVERTS].item() == 70 and not ls.refill_pred.item()
    assert not ls.scratch.any()


def test_round_test_refuses_other_devices():
    ls = LP.LoopState("meta")
    with pytest.raises(ValueError, match="round test"):
        LP.round_test(ls, LP.COUNTER, alive=torch.zeros(8, device="meta"),
                      counter=torch.zeros((), dtype=torch.int64, device="meta"), total=8)


# --- the loops against the host loop ------------------------------------------------


def _scene(route):
    """The MIXED scene at 16x12 x 2 spp on the fused route (K1 in lane mode
    and K5, their plain versions here) or the modular one (roulette)."""
    (_, _, _), (td, ta, ts) = builds("mixed", 16, 12, 2)
    s = td.settings
    cfg = P.TraceConfig(ray_depth=s.ray_depth, bg_color=tuple(s.bg_color), rr=route == "modular")
    scene = bounce_scene(ta, ts, "cpu") if route == "fused" else modular_scene(ta, ts, "cpu")
    return scene, cfg, camera_arrays(s.camera), s.width, s.height


def _park_and_step(state, depth, last):
    """The end of a round as the port ran it on the host before N5 took it
    over: the fused core's final-depth cap and park (a no-op after the XLA
    core, whose N1a applies the cap and whose N1b parks), then the depth
    step."""
    cont = (state[12] > 0.5) & (depth < last)
    state[12] = cont.to(torch.float32)
    state[0:3] = torch.where(cont, state[0:3], PARK_ORIGIN)
    state[3:6] = torch.where(cont, state[3:6], PARK_DIR)
    depth += 1


def _host_wavefront(scene, cfg, cam, w, h, n_pix, spp, lanes, pix_base, samp_base):
    """The counter wavefront as the host ran it: the lanes alive read every
    round, the work counter and the path vertices mirrored; a round's
    bounce, cap, park and depth step written out."""
    core = W.CoreBody(cfg, scene, lanes)
    refill = W.RefillBody(core, cam, w, h, n_pix, spp)
    refill.reset(SEED32, pix_base, samp_base)
    thresh, total = W.refill_thresh(lanes), n_pix * spp
    counter = nverts = rounds = refills = 0
    n_dead = lanes
    while counter < total or n_dead < lanes:
        n_take = 0
        if n_dead >= thresh:
            refill()
            refills += 1
            n_take = min(n_dead, total - counter)
            counter += n_take
        nverts += lanes - n_dead + n_take
        core.state.copy_(core.core(core.state, core.wid, core.depth))
        _park_and_step(core.state, core.depth, cfg.ray_depth - 1)
        rounds += 1
        n_dead = lanes - int((core.state[12] > 0.5).sum())
    img = W._wf_finish(core.state, refill.work, refill.done, refill.drop, n_pix, spp)
    return img, float(nverts), rounds, refills


def _host_sticky(scene, cfg, cam, w, h, n_pix, spp, lanes, pix_base, samp_base):
    """The sticky engine as the host ran it: ``more`` read every round; a
    round's restart, bounce, cap, park and depth step written out."""
    body = W.StickyBody(cfg, scene, cam, w, h, n_pix, spp, lanes)
    body.reset(SEED32, pix_base, samp_base)
    nverts = rounds = 0
    while bool(((body.state[12] > 0.5) | (body.k < body.kmax)).any()):
        body.restart()
        nverts += int((body.state[12] > 0.5).sum())
        body.state.copy_(body.core(body.state, body.wid, body.depth))
        _park_and_step(body.state, body.depth, cfg.ray_depth - 1)
        rounds += 1
    body.restart()
    return body.acc[:, :n_pix] * (1.0 / spp), float(nverts), rounds, 0


def _host_k5(scene, cfg, cam, w, h, n_pix, spp, lanes, pix_base, samp_base):
    """The K5 loop as the host ran it: one plain round after another while
    a lane has work left."""
    ins, state, args = W._sticky_inputs(SEED32, pix_base, samp_base, cam, scene, cfg, w, h,
                                        n_pix, spp)
    nverts = rounds = 0
    more = n_pix * spp > 0
    while more:
        state, live, left = persistent_plain(*ins, state, *args)
        nverts += int(live)
        rounds += 1
        more = int(left) > 0
    started = state[S_K] > 0.5
    acc = torch.where(started, state[S_ACC:S_ACC + 3] + state[9:12], state[S_ACC:S_ACC + 3])
    return acc * (1.0 / spp), float(nverts), rounds, 0


# engine -> (route, lanes, the host loop, the port's render)
LOOPS = {
    "wavefront": ("fused", 64, _host_wavefront, W.render_wavefront),
    "wavefront-modular": ("modular", 64, _host_wavefront, W.render_wavefront),
    "sticky": ("fused", 50, _host_sticky, W.render_wavefront_sticky),
    "sticky-modular": ("modular", 50, _host_sticky, W.render_wavefront_sticky),
    "k5": ("fused", 192, _host_k5, W.render_wavefront_sticky),
}


class Stub:
    """A capture that runs the body (the warm-up) and replays it as it is."""

    def __call__(self, body, device):
        body()
        return body, {}, {"capture_ms": 0.0, "pool_mb": 0.0}


@pytest.mark.parametrize("per", [1, 3, 8])
@pytest.mark.parametrize("engine", list(LOOPS))
def test_loop_equals_the_host_loop(engine, per, monkeypatch):
    monkeypatch.setattr(W, "ROUNDS_PER_REPLAY", per)
    route, lanes, host, render = LOOPS[engine]
    scene, cfg, cam, w, h = _scene(route)
    n_pix, spp, pix_base, samp_base = 150, 2, 37, 4
    want = host(scene, cfg, cam, w, h, n_pix, spp, lanes, pix_base, samp_base)
    for graphs in (None, GraphCache(scene, "cpu", capture_fn=Stub())):
        W.REFILLS[0] = W.HOST_READS[0] = 0
        img, verts, rounds = render(SEED32, pix_base, samp_base, cam, scene, cfg, w, h, n_pix,
                                    spp, lanes, graphs=graphs)
        assert torch.equal(img, want[0])
        assert (verts, rounds, W.REFILLS[0]) == want[1:]
        assert W.HOST_READS[0] == max(math.ceil(rounds / per), 1)
    assert rounds > 1 and (engine != "k5" or n_pix <= lanes)


def test_loops_count_the_launches_of_the_rounds_run(monkeypatch):
    """The launches of a guarded body are added times the runs the device
    counters report: N5 once per round and once before the first, K1 once
    per round, N2a once per refill; a round the test stopped adds none."""
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES, 0))
    scene, cfg, cam, w, h = _scene("fused")
    calls = {"refill": 0, "core": 0}
    for cls, key in ((W.RefillBody, "refill"), (W.CoreBody, "core")):
        def counted(self, _f=cls.__call__, _k=key):
            calls[_k] += 1
            kernels._count({"refill": "refill", "core": "bounce"}[_k])
            return _f(self)
        monkeypatch.setattr(cls, "__call__", counted)
    monkeypatch.setattr(LP, "round_test_plain",
                        lambda *a, _f=LP.round_test_plain, **k: (kernels._count("loop"),
                                                                 _f(*a, **k)))
    W.REFILLS[0] = 0
    _, _, rounds = W.render_wavefront(SEED32, 0, 0, cam, scene, cfg, w, h, 150, 2, 64)
    assert calls == {"refill": W.REFILLS[0], "core": rounds}
    assert kernels.LAUNCHES == dict(dict.fromkeys(kernels.LAUNCHES, 0), bounce=rounds,
                                    refill=W.REFILLS[0], loop=rounds + 1)


@pytest.mark.parametrize("engine", ["wavefront", "sticky", "k5"])
def test_a_frame_past_its_cap_raises(engine, monkeypatch):
    """Each loop stops at its cap of rounds with an error, never short in
    silence: here the cap cut to 2 rounds."""
    route, lanes, _, render = LOOPS[engine]
    scene, cfg, cam, w, h = _scene(route)
    cls = {"wavefront": W.WavefrontLoop, "sticky": W.StickyLoop, "k5": W.FusedStickyLoop}[engine]
    init = cls.__init__

    def capped(self, *a, **kw):
        init(self, *a, **kw)
        self.cap = 2

    monkeypatch.setattr(cls, "__init__", capped)
    monkeypatch.setattr(W, "ROUNDS_PER_REPLAY", 1)
    with pytest.raises(RuntimeError, match="work left after 2 rounds"):
        render(SEED32, 0, 0, cam, scene, cfg, w, h, 150, 2, lanes)


def test_caps_hold_the_frames():
    """The caps are no tighter than the frames: samples x ray_depth rounds
    on the K5 route, jmax x samples x ray_depth off it, the counter
    wavefront's from its work, threshold and depth."""
    scene, cfg, cam, w, h = _scene("fused")
    for lanes in (8, 64):
        loop, _ = W.wavefront_loop(cfg, scene, cam, w, h, 150, 2, lanes)
        _, _, rounds = W.render_wavefront(SEED32, 0, 0, cam, scene, cfg, w, h, 150, 2, lanes)
        assert rounds <= loop.cap
    sticky = W.StickyLoop(cfg, scene, cam, w, h, 150, 2, 50)
    assert sticky.cap == 3 * 2 * cfg.ray_depth
    assert W.FusedStickyLoop(cfg, scene, cam, w, h, 150, 2).cap == 2 * cfg.ray_depth


# --- against the JAX package ---------------------------------------------------------


def _agree(got, want, got_verts, want_verts):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all() and got.max() > 0
    ok = (np.abs(got - want) <= 1e-4).all(axis=0)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(got_verts - want_verts) <= 0.01 * want_verts, (got_verts, want_verts)


# case -> (scene, width, height, pixel base, pixels, sample base, samples, lanes)
JAX_CASES = {
    "mixed-tile": ("mixed", 16, 12, 37, 100, 4, 2, 64),
    "cornell": ("cornell", 24, 18, 0, 24 * 18, 0, 2, 300),
}


def _jax_args(name):
    scene, w, h, pix_base, n_pix, samp_base, spp, lanes = JAX_CASES[name]
    (jd, ja, js), (td, ta, ts) = builds(scene, w, h, 2)
    bg = tuple(jd.settings.bg_color)
    depth = jd.settings.ray_depth
    jcfg = JTraceConfig(ray_depth=depth, bg_color=bg, max_tries=4)
    cfg = P.TraceConfig(ray_depth=depth, bg_color=bg, max_tries=4)
    # the XLA dense sweep in place of the interpret-mode triangle kernel
    jarr = to_jnp(ja._replace(tri_pack=None))
    jargs = (np.uint32(SEED32), np.int32(pix_base), np.int32(samp_base),
             j_camera(jd.settings.camera), jarr, js, jcfg, w, h, n_pix, spp, lanes)
    targs = (SEED32, pix_base, samp_base, camera_arrays(td.settings.camera),
             bounce_scene(ta, ts, "cpu"), cfg, w, h, n_pix, spp, lanes)
    return jargs, targs


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_counter_wavefront_matches_jax_and_its_rounds(name, monkeypatch):
    monkeypatch.setenv("RT_WF_DEBUG", "1")
    jargs, targs = _jax_args(name)
    jimg, jverts, jrounds = jwf.render_wavefront(*jargs)
    img, verts, rounds = W.render_wavefront(*targs)
    _agree(img.numpy(), jimg, verts, float(jverts))
    if verts == float(jverts):
        assert rounds == int(jrounds)
    else:
        assert abs(rounds - int(jrounds)) <= 1


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sticky_engine_matches_jax(name):
    jargs, targs = _jax_args(name)
    jimg, jverts = jwf.render_wavefront_sticky(*jargs)
    img, verts, _ = W.render_wavefront_sticky(*targs)
    _agree(img.numpy(), jimg, verts, float(jverts))


# --- on the card -----------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: N5 and IF nodes run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [LP.COUNTER, LP.STICKY], ids=["counter", "sticky"])
@pytest.mark.parametrize("n", [997, 262_144, 1_048_576])
def test_n5_equals_its_twin_on_the_card(card, mode, n):
    """N5 against its plain version, exactly: three tests in a row, then
    replayed from a graph whose IF node's predicate goes true, false, true
    with the lanes changed before each replay."""
    from raytracing_course_2024_tpu_torch.runtime.graphs import capture, guard

    def inputs(seed, live):
        alive, k, kmax = _lanes(n, live, seed)
        return {"alive": alive.to(card), "k": k.to(card), "kmax": kmax.to(card),
                "counter": torch.tensor(3 * n, device=card), "total": 4 * n,
                "thresh": n // 8}

    def states():
        pair = (LP.LoopState(card), LP.LoopState(card))
        for ls in pair:
            ls.loop.copy_(torch.arange(6, device=card) + 3)
        return pair

    def same(a, b):
        return (torch.equal(a.loop, b.loop) and torch.equal(a.preds, b.preds)
                and not a.scratch.any().item())

    ins = inputs(0, 0.03)
    kern, twin = states()
    for _ in range(3):
        LP.round_test(kern, mode, **ins)
        LP.round_test_plain(twin, mode, **ins)
    assert same(kern, twin)
    kern, twin = states()
    pred = torch.ones((), dtype=torch.bool, device=card)
    replay, _, _ = capture(lambda: guard(pred, lambda: LP.round_test(kern, mode, **ins),
                                         "test", {}), card)
    LP.round_test_plain(twin, mode, **ins)
    for step, on in enumerate((True, False, True), start=1):
        fresh = inputs(step, 0.1 * step)
        for key in ("alive", "k", "kmax"):
            ins[key].copy_(fresh[key])
        pred.fill_(on)
        replay()
        if on:
            LP.round_test_plain(twin, mode, **ins)
        torch.cuda.synchronize()
        assert same(kern, twin), step


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [LP.TAIL_NONE, LP.TAIL_DEPTH, LP.TAIL_FUSED],
                         ids=["none", "depth", "fused"])
@pytest.mark.parametrize("mode", [LP.COUNTER, LP.STICKY], ids=["counter", "sticky"])
@pytest.mark.parametrize("n", [997, 262_144, 1_048_576])
def test_n5_tails_equal_their_twin_on_the_card(card, mode, tail, n):
    """N5's tails against ``round_tail_plain``, bit for bit (state rows,
    depths, counters, predicates): three rounds in a row on a state with
    lanes alive, dying and parked on entry, then replayed from a graph whose
    IF node's predicate goes true, false, true with the state changed
    before each replay."""
    from raytracing_course_2024_tpu_torch.runtime.graphs import capture, guard

    def lanes(seed):
        g = np.random.default_rng(seed)
        st = (g.random((13, n)) * 4.0 - 2.0).astype(np.float32)
        st[12] = (g.random(n) < 0.5).astype(np.float32)
        parked = (st[12] < 0.5) & (g.random(n) < 0.5)
        st[0:3, parked] = np.float32(PARK_ORIGIN)
        st[3:6, parked] = np.float32(PARK_DIR)
        return (torch.from_numpy(st).to(card),
                torch.from_numpy(g.integers(0, 7, n).astype(np.int32)).to(card))

    k = torch.from_numpy(np.random.default_rng(1).integers(0, 8, n)).to(card)
    kw = dict(k=k, n_pix=2 * n + 5, samples=2, counter=torch.tensor(3 * n, device=card),
              total=4 * n, thresh=n // 8)
    kern = [*lanes(0), LP.LoopState(card)]
    twin = [kern[0].clone(), kern[1].clone(), LP.LoopState(card)]

    def run(x, fn):
        return lambda: fn(x[2], mode, x[0], x[1], tail, 5, **kw)

    def same():
        return (torch.equal(kern[0].view(torch.int32), twin[0].view(torch.int32))
                and torch.equal(kern[1], twin[1]) and torch.equal(kern[2].loop, twin[2].loop)
                and torch.equal(kern[2].preds, twin[2].preds)
                and not kern[2].scratch.any().item())

    for _ in range(3):
        run(kern, LP.round_tail)()
        run(twin, LP.round_tail_plain)()
    assert same()
    pred = torch.ones((), dtype=torch.bool, device=card)
    replay, _, _ = capture(lambda: guard(pred, run(kern, LP.round_tail), "test", {}), card)
    run(twin, LP.round_tail_plain)()
    for step, on in enumerate((True, False, True), start=1):
        st, depth = lanes(step)
        for x in (kern, twin):
            x[0].copy_(st)
            x[1].copy_(depth)
        pred.fill_(on)
        replay()
        if on:
            run(twin, LP.round_tail_plain)()
        torch.cuda.synchronize()
        assert same(), step


@pytest.mark.cuda
@pytest.mark.parametrize("engine,lanes", [("wavefront", 4096), ("sticky", 1024),
                                          ("sticky", None)])
@pytest.mark.parametrize("backend", ["dense", "bvh"])
def test_graphed_lane_frames_equal_eager_on_the_card(card, engine, lanes, backend):
    """The MIXED scene at 64x48 x 4 spp, graphed (IF nodes) against eager:
    image, path vertices, rounds, refills and launches equal for two
    seeds; the graphed frame reads the loop's counters
    max(ceil(rounds / ROUNDS_PER_REPLAY), 1) times, and the one after the
    capture makes no sync that ATen makes on its own."""
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from torch_parity import descs

    _, td = descs("mixed", 64, 48, 4)
    kw = dict(device=card, backend=backend, engine=engine, batch_size=lanes)
    rs = {"eager": Renderer(td, eager=True, **kw), "graphed": Renderer(td, **kw)}
    for seed in (1, 2):
        res = {}
        for mode, r in rs.items():
            kernels.reset_launches()
            W.REFILLS[0] = W.HOST_READS[0] = 0
            with warnings.catch_warnings(record=True) as syncs:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    outs, verts = r.render_frame_device(seed=seed)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            implicit = sum("synchroniz" in str(w.message) for w in syncs)
            res[mode] = (torch.cat(outs, 1).cpu(), verts, r.rounds, W.REFILLS[0],
                         dict(kernels.LAUNCHES), W.HOST_READS[0], implicit)
        e, g = res["eager"], res["graphed"]
        assert torch.equal(e[0], g[0]) and e[1:5] == g[1:5]
        assert g[5] == max(math.ceil(g[2] / W.ROUNDS_PER_REPLAY), 1)
        # the first graphed frame captures (a capture syncs); after it the event
        # waits of the loop's reads are the frame's only syncs
        assert seed == 1 or g[6] == 0
    assert len(rs["graphed"].graphs.entries) == 1
