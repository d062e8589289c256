"""Lane engines: the counter-refill wavefront and the pixel-sticky engine.

The JAX package's ``integrator/wavefront.py``. One batch of lanes lives for
the whole frame and each lane walks path after path, so the lanes stay busy
when paths end at different depths:

* ``render_wavefront`` (counter refill): when at least ``REFILL_FRAC``
  (1/8) of the lanes are dead, their radiance is flushed and they
  take the next work items, ranked by a cumulative sum; work item ``w`` is
  (pixel ``w % n_pix``, sample ``w // n_pix``). A work item finishes once,
  so the flush writes its radiance to a column of its own and the image is
  summed over the samples at the end, in a fixed order;
* ``render_wavefront_sticky`` (pixel-sticky): lane ``l`` owns pixels
  ``l, l + lanes, ...`` and restarts its own next sample the round after a
  path ends, accumulating in place; with at least as many lanes as pixels
  and a scene that passes the fused gate, a whole round is one kernel, K5
  (``FusedStickyLoop``, ``ops/persistent.py``).

Every draw is keyed by the work item, global (pixel, sample), in the lane
engines' layout (``ops/rng.py``: ``lane_ctr``), so both engines give the
same image for any lane count, and the same as the JAX package's engines on
the CPU, image for image.

A bounce (``_make_bounce_core``) is either the fused core, K1 in lane mode
(``ops/bounce.py``), when the scene is a ``BounceScene`` (the round's tail,
N5, then caps the depth and parks the rays of the lanes left dead); or the
XLA core on a ``ModularScene`` (roulette, faithful acceptance, large
scenes, the BVH backend): the
scene's nearest hit over the finite table (``ops/traverse.py:nearest_table``:
K4 or the sweep, or the BVH walk K6), the shade pass N1a (the planes,
``surface_detail``, emission, and the final-depth rule), the mixture
sampler on the layout's draws and the finish pass N1b (``_finish_bounce``
with the layout's draws, then ``park``). The sampler is picked by the batch
route's rule (``integrator/path.py:sample_bounce``): K3 in lane mode, or
its XLA formulation for faithful acceptance. On the
card N1a, K3 and N1b are kernels; the JAX package's lane core samples in
XLA, which fuses it.

Per-lane depth replaces the batch engine's bounce index: a lane whose
final depth is reached dies after collecting emission (the reference
returns black at depth 0, src/rendering.rs:93-95). Each engine returns
((3, n_pix) mean radiance, path vertices, rounds): a round is one bounce
of every lane (one K1 or one K5 launch on the fused routes).

The loop control is on the device, as the JAX package's ``lax.while_loop``
and ``lax.cond`` have it (``_render_wf``, one ``jax.jit``): a frame's loop
(``WavefrontLoop``, ``StickyLoop``, ``FusedStickyLoop``) holds its round
bodies over static buffers (``CoreBody`` and ``RefillBody``, ``StickyBody``,
or K5), which read the seed and the frame offsets on the device, and its
counters (``ops/loop.py:LoopState``). Each round ends with N5
(``ops/loop.py:round_tail``; K5 ends its own round with the same test): the
fused core's depth cap and park, every lane's depth step, then the round
test, which writes whether another round runs (``more``), whether the
counter wavefront's next round refills (``refill_pred``), the lanes alive,
the path vertices (the lanes that enter each bounce), the rounds and the
refills; before a loop's first round N5 runs the test alone. A call of a
loop runs ``ROUNDS_PER_REPLAY`` rounds, each guarded by ``more`` and the
refill in it by ``refill_pred`` (``runtime/graphs.py:guard``). Given a graph cache the
call is a captured CUDA graph whose guards are IF nodes, so a round whose
test said stop costs a conditional check; the host replays it and reads the
counters of the replay before the last (a pinned copy and an event per
replay, ``_run_loop``), so the card always has the next replay queued: a
frame of ``rounds`` rounds makes at most ceil(rounds / ROUNDS_PER_REPLAY) +
2 host reads. Without a cache (``eager=True``, ``plain``, the CPU) a guard
is a host read of its predicate, the counterpart of ``jax.disable_jit()``.
Every engine refuses a frame whose work ids would pass 2^32
(``ops/rng.py:check_work_ids``) before any work, and raises where a frame
still has work after a cap of rounds derived from its work and depth.
"""

from __future__ import annotations

import threading

import torch

from ..ops import bounce as B
from ..ops import loop as L
from ..ops import refill as RF
from ..ops.camera import CameraArrays, pack_camera_row
from ..ops.loop import LoopState, k5_round_plain, round_tail, round_tail_plain
from ..ops.persistent import N_PSTATE, S_ACC, S_K, persistent_plain, persistent_round
from ..ops.rng import check_work_ids, lane_ctr
from ..ops.shade import PARK_DIR, PARK_ORIGIN, finish, finish_plain, shade, shade_plain
from ..ops.traverse import nearest_table
from ..ops.vec import Vec3
from ..runtime.graphs import guard, settle
from ..runtime.profiling import count, span
from .path import TraceConfig, graphed_body, sample_bounce


def _scene_device(scene) -> torch.device:
    return (scene.geo if isinstance(scene, B.BounceScene) else scene.packed).device


def _initial_state(rows: int, b: int, dev) -> torch.Tensor:
    """Dead lanes with parked rays, zero throughput and radiance."""
    st = torch.zeros((rows, b), dtype=torch.float32, device=dev)
    st[0:3] = PARK_ORIGIN
    st[3:6] = PARK_DIR
    return st


def _lane_frame(cam: CameraArrays, width: int, height: int, n_pix: int, samples: int,
                dev) -> RF.LaneFrame:
    """The frame the refill or the restart reads, the camera row on ``dev``."""
    row = torch.from_numpy(pack_camera_row(cam)[0]).to(dev)
    return RF.LaneFrame(cam, row, width, height, n_pix, samples)


def _lane_seed(seed):
    """``(seed, work-id offset)`` as a lane core hands them to K1 and to the
    key: the elements of a (2,) int64 pair (seed, 0), which reach K1 as the
    pair itself, with no launch; an int or a 0-dim tensor with offset 0."""
    if isinstance(seed, torch.Tensor) and seed.dim() == 1:
        return seed[0], seed[1]
    return seed, 0


def _make_bounce_core(cfg: TraceConfig, scene, seed, plain: bool = False):
    """One full bounce shared by both engines. Returns
    ``(core(state, wid, depth) -> state', fused)``: ``state`` is the (13, B)
    path state, ``wid`` the lanes' int32 work ids, ``depth`` their int32
    depths. The XLA core's ``alive'`` already applies the per-lane
    final-depth rule and its dead lanes' rays are parked; the fused core
    (``fused`` True) leaves both to the round's tail (``ops/loop.py:
    round_tail``, ``TAIL_FUSED``, as the JAX core's own ``cont`` and
    ``park``). The fused core updates ``state`` in place on CUDA.
    ``plain`` runs the plain versions of the kernels on any device.
    ``seed`` is an int, a 0-dim int64 tensor or the (2,) int64 pair (seed,
    0) of a body (``_lane_seed``), on the scene's device; a tensor is read
    on the device, by K1 too."""
    k, bg = cfg.max_tries, cfg.bg_color
    last = cfg.ray_depth - 1
    lane_ctr(0, k)  # refuses a max_tries whose draws overflow the counter block
    seed, wid_off = _lane_seed(seed)

    if isinstance(scene, B.BounceScene):
        def fused_core(state, wid, depth):
            if plain:
                return B.bounce_plain(scene, state, wid, wid_off, seed, 0, bg, k, depth=depth)
            return B.bounce(scene, state, wid, wid_off, seed, 0, bg, k, out=state, depth=depth)

        return fused_core, True

    shade_fn, finish_fn = (shade_plain, finish_plain) if plain else (shade, finish)

    def xla_core(state, wid, depth):
        ro, rd = Vec3(state[0], state[1], state[2]), Vec3(state[3], state[4], state[5])
        t, idx = nearest_table(ro, rd, scene, plain=plain, live=state[12] > 0.5)
        # N1a: alive becomes "hit and depth < last", the final-depth rule
        st, surf, need = shade_fn(state, t, idx, scene, bg, depth=depth, last=last)
        # K3 in lane mode, or its XLA formulation when faithful, as on the batch route
        l_s, pdf, ok = sample_bounce(scene, cfg, seed, wid, wid_off, surf, need, plain,
                                     depth=depth)
        # N1b in the lane layout parks the rays of the lanes it leaves dead
        return finish_fn(st, surf, l_s, pdf, ok, wid, seed, wid_off, cfg, depth=depth)[0]

    return xla_core, False


class CoreBody:
    """One round's bounce of the counter wavefront over static buffers:
    ``seed_off`` ((2,) int64: the seed and 0; ``seed`` is its first
    element), ``state`` (13, B), ``wid`` and ``depth`` (int32) in. A call
    runs one bounce (the fused core, K1 in lane mode, on a ``BounceScene``;
    the XLA core on a ``ModularScene``) and leaves the state in ``state``;
    the round's tail (``tail``: ``TAIL_FUSED`` after the fused core,
    ``TAIL_DEPTH`` after the XLA core) steps the depths."""

    def __init__(self, cfg: TraceConfig, scene, lanes: int, plain: bool = False):
        dev = _scene_device(scene)
        self.seed_off = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.seed = self.seed_off[0]
        self.state = _initial_state(B.N_STATE, lanes, dev)
        self.wid = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        self.depth = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        self.plain = plain
        self.core, fused = _make_bounce_core(cfg, scene, self.seed_off, plain)
        self.tail = L.TAIL_FUSED if fused else L.TAIL_DEPTH

    def __call__(self) -> None:
        _bounce_into(self.state, self.core(self.state, self.wid, self.depth))


def _bounce_into(state: torch.Tensor, out: torch.Tensor) -> None:
    """A core's output into ``state`` (no copy where the core wrote it in
    place)."""
    if out is not state:
        state.copy_(out)


class RefillBody:
    """The counter wavefront's refill over static buffers: its
    ``CoreBody``'s (``seed_off``, ``state``, ``wid``, ``depth``) and its own,
    ``bases`` ((2,) int64: pix_base, samp_base), ``work`` (the work item of
    each lane, int64, -1 for none), ``counter`` (0-dim int64: the work items
    handed out) and ``done`` (3 x (work items + lanes) f32: column ``w``
    holds work item ``w``'s radiance; every column is written by one lane,
    so the writes are plain stores, in no order that could change a sum). A
    call is ``ops/refill.py:refill`` (N2a on a card): it flushes the dead
    lanes' radiance, hands them the next work items in lane order, moves
    ``counter`` on, writes every lane's work id into ``wid`` and starts the
    taken lanes on their camera rays. It reads nothing from the host."""

    def __init__(self, core: CoreBody, cam: CameraArrays, width: int, height: int, n_pix: int,
                 samples: int):
        dev = core.state.device
        b = core.state.shape[1]
        self.core = core
        self.frame = _lane_frame(cam, width, height, n_pix, samples, dev)
        self.total = n_pix * samples
        self.bases = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.work = torch.full((b,), -1, dtype=torch.int64, device=dev)
        self.counter = torch.zeros((), dtype=torch.int64, device=dev)
        self.done = torch.zeros((3, self.total + b), dtype=torch.float32, device=dev)
        self.drop = self.total + torch.arange(b, dtype=torch.int64, device=dev)
        self.scan = RF.refill_scan(b, dev) if dev.type == "cuda" and not core.plain else None

    def reset(self, seed32: int, pix_base: int, samp_base: int) -> None:
        """A pass's seed and offsets in, every lane dead with no work."""
        c = self.core
        c.seed.fill_(seed32)
        self.bases[0].fill_(pix_base)
        self.bases[1].fill_(samp_base)
        c.state.copy_(_initial_state(B.N_STATE, c.state.shape[1], c.state.device))
        for t in (c.wid, c.depth, self.counter, self.done):
            t.zero_()
        self.work.fill_(-1)

    def __call__(self) -> None:
        c = self.core
        args = (c.state, self.work, self.counter, self.done, c.depth, c.wid, c.seed_off,
                self.bases, self.frame)
        if c.plain:
            RF.refill_plain(*args)
        else:
            RF.refill(*args, self.scan)


# rounds a lane loop runs per call: one replay of its graph, whose rounds are
# guarded by the device's round test; the host reads the loop's counters
# once per replay (PERF.md: the sweep of 4, 8 and 16 on the card). Read when
# a loop is made; the cache keys hold it.
ROUNDS_PER_REPLAY = 8

# share of the lanes dead at which the counter wavefront refills them
# (``refill_thresh``)
REFILL_FRAC = 0.125

# refills the counter wavefront has run (every pass and shard, eager or
# replayed), from the device counters at the end of each pass; a caller may
# set it to 0 and read it beside N2a's launches (ops/kernels.py:LAUNCHES["refill"])
REFILLS = [0]
# host reads of the lane loops' counters (one pinned copy each, ``_run_loop``)
HOST_READS = [0]
_COUNT_LOCK = threading.Lock()  # shards render from threads


class _GuardedLoop:
    """What the three lane loops share: the loop control ``ls``
    (``ops/loop.py:LoopState``), the launches of one run of each guarded
    body (``sections``), and a call of ``rounds_per_replay`` rounds, each
    guarded by ``ls.more``; a subclass defines ``round`` (one round's work,
    its round test last), ``reset`` and ``cap`` (the most rounds a frame
    may take). ``lanes``: the lanes each round's launches cover."""

    def __init__(self, dev, lanes: int):
        self.lanes = lanes
        self.ls = LoopState(dev)
        self.reader = _Lagged(self.ls.loop)
        self.sections: dict = {}
        self.rounds_per_replay = ROUNDS_PER_REPLAY

    def __call__(self) -> None:
        for _ in range(self.rounds_per_replay):
            guard(self.ls.more, self.round, "round", self.sections)


class WavefrontLoop(_GuardedLoop):
    """One counter-refill pass: a ``CoreBody`` and its ``RefillBody``. A
    round is the refill, guarded by ``refill_pred`` (the JAX ``lax.cond``),
    the bounce, and the round's tail and test (N5 in ``COUNTER`` mode: lanes
    alive, the work counter against ``total``, the refill threshold
    ``thresh``)."""

    def __init__(self, cfg: TraceConfig, scene, cam: CameraArrays, width: int, height: int,
                 n_pix: int, samples: int, lanes: int, thresh: int, plain: bool = False):
        self.core = CoreBody(cfg, scene, lanes, plain)
        self.refill = RefillBody(self.core, cam, width, height, n_pix, samples)
        super().__init__(self.core.state.device, lanes)
        self.thresh = thresh
        self.last = cfg.ray_depth - 1
        # a lane's path takes at most ray_depth rounds, all lanes are dead
        # ray_depth rounds after a refill, and every refill but the last
        # with work left hands out at least ``thresh`` items
        depth = max(cfg.ray_depth, 1)
        self.cap = depth * (-(-self.refill.total // thresh) + 2)

    def reset(self, seed32: int, pix_base: int, samp_base: int) -> None:
        self.refill.reset(seed32, pix_base, samp_base)
        self.ls.reset()
        self.test(L.TAIL_NONE)  # the loop test before the first round

    def test(self, tail: int | None = None) -> None:
        """N5: the round's tail (``tail``, by default the core's) and test."""
        c = self.core
        fn = round_tail_plain if c.plain else round_tail
        fn(self.ls, L.COUNTER, c.state, c.depth, c.tail if tail is None else tail, self.last,
           counter=self.refill.counter, total=self.refill.total, thresh=self.thresh)

    def round(self) -> None:
        guard(self.ls.refill_pred, self.refill, "refill", self.sections)
        self.core()
        self.test()


# work items of one counter-refill pass: the flush keeps 12 bytes per item
# (400 MB at this cap); a frame with more work renders in passes of whole
# samples, summed in order
WF_MAX_WORK = 1 << 25


def refill_thresh(lanes: int) -> int:
    """Dead lanes at which the counter wavefront refills: rounds price the
    full lane batch, so refilling at ``REFILL_FRAC`` (1/8) dead keeps
    occupancy near 94 % at the cost of a rank, a flush and the camera math
    per refill (the JAX package's default)."""
    return max(int(lanes * REFILL_FRAC), 1)


def wavefront_loop(cfg: TraceConfig, scene, cam: CameraArrays, width: int, height: int,
                   n_pix: int, samples: int, lanes: int, plain: bool = False, graphs=None):
    """``(loop, run)`` of one counter-refill pass (``graphed_body``): the
    cache entry is keyed by the lanes, cfg, the frame, the camera,
    ``n_pix`` and the pass's samples (they size ``done``), the refill
    threshold and ``ROUNDS_PER_REPLAY``; seeds, ``pix_base`` and
    ``samp_base`` are device values and key nothing."""
    thresh = refill_thresh(lanes)
    key = ("wavefront", lanes, cfg, width, height, pack_camera_row(cam).tobytes(), n_pix,
           samples, thresh, ROUNDS_PER_REPLAY)
    return graphed_body(graphs, scene, key, lambda: WavefrontLoop(
        cfg, scene, cam, width, height, n_pix, samples, lanes, thresh, plain))


class _Lagged:
    """Reads of a loop's counters one call late: after each call a copy of
    ``loop`` into a pinned host slot and an event (two slots in turn); a
    read waits for the call before the last one. Made once per loop, its
    buffers serve every frame (``restart``)."""

    def __init__(self, loop: torch.Tensor):
        cuda = loop.device.type == "cuda"
        self.loop = loop
        self.host = torch.zeros((2,) + tuple(loop.shape), dtype=loop.dtype, pin_memory=cuda)
        self.events = [torch.cuda.Event(), torch.cuda.Event()] if cuda else None
        self.posted = self.read_at = 0

    def restart(self) -> None:
        self.posted = self.read_at = 0

    def post(self) -> None:
        i = self.posted % 2
        self.host[i].copy_(self.loop, non_blocking=True)
        if self.events:
            self.events[i].record()
        self.posted += 1

    def read(self) -> list:
        """The counters of the call before the last (span ``rt.loop.wait``:
        the event's wait and the copy's read)."""
        with span("rt.loop.wait"):
            i = self.read_at % 2
            if self.events:
                self.events[i].synchronize()
            self.read_at += 1
            with _COUNT_LOCK:
                HOST_READS[0] += 1
            return self.host[i].tolist()


def _run_loop(loop: _GuardedLoop, run, what: str, seed32: int, pix_base: int,
              samp_base: int) -> list:
    """Resets ``loop`` to the frame (span ``rt.loop.reset``, the first
    round test included), then calls ``run`` (``loop``'s rounds, a replay
    on a card) until the round test says stop, with the next call always
    queued before the host waits for the counters of the one before it.
    Raises where the counters show more than ``loop.cap`` rounds. Returns
    the final counters (``ops/loop.py``: ``NVERTS``, ``ROUNDS``,
    ``REFILLS``) and adds the launches of the rounds and refills run
    (``settle``) and the lane slots of the rounds (``rt.lane_slots``: lanes
    x rounds)."""
    with span("rt.loop.reset"):
        loop.reset(seed32, pix_base, samp_base)
    reader = loop.reader
    reader.restart()
    run()
    reader.post()
    while True:
        run()
        reader.post()
        vals = reader.read()
        if vals[L.ROUNDS] > loop.cap:
            raise RuntimeError(f"{what} has work left after {loop.cap} rounds")
        if not vals[L.MORE]:
            break
    settle(loop.sections, {"round": vals[L.ROUNDS], "refill": vals[L.REFILLS]})
    count("rt.lane_slots", loop.lanes * vals[L.ROUNDS])
    return vals


def render_wavefront(seed32: int, pix_base: int, samp_base: int, cam: CameraArrays, scene,
                     cfg: TraceConfig, width: int, height: int, n_pix: int, samples: int,
                     lanes: int, plain: bool = False, graphs=None):
    """Render pixels [pix_base, pix_base + n_pix) (row-major coordinates of
    the full width x height frame) at ``samples`` spp from global sample
    ``samp_base``, on ``lanes`` lanes with counter refill.

    Returns ((3, n_pix) f32 mean radiance, path vertices, rounds). Every
    work item's radiance is written to its own column with a plain indexed
    write and the columns are summed over the samples at the end, so two
    frames from one seed are equal bit for bit on any device. A frame of
    more than ``WF_MAX_WORK`` work items runs as passes of whole samples.

    A round is a refill (``RefillBody``, when at least
    ``REFILL_FRAC`` of the lanes are dead), a bounce (``CoreBody``)
    and the round test, in a ``WavefrontLoop``; ``graphs`` (a graph cache of
    ``scene``) replays ``ROUNDS_PER_REPLAY`` guarded rounds as one captured
    graph, on either route. Rounds, refills and path vertices come from the
    device counters. ``plain`` runs eagerly."""
    check_work_ids(width * height, samp_base, samples)
    per_pass = max(WF_MAX_WORK // max(n_pix, 1), 1)
    if samples > per_pass:
        img, nverts, rounds = 0.0, 0.0, 0
        for s0 in range(0, samples, per_pass):
            n_s = min(per_pass, samples - s0)
            part, v, r = render_wavefront(seed32, pix_base, samp_base + s0, cam, scene, cfg,
                                          width, height, n_pix, n_s, lanes, plain, graphs)
            img = img + part * (n_s / samples)
            nverts, rounds = nverts + v, rounds + r
        return img, nverts, rounds
    loop, run = wavefront_loop(cfg, scene, cam, width, height, n_pix, samples, lanes, plain,
                               None if plain else graphs)
    vals = _run_loop(loop, run, "counter wavefront pass", seed32, pix_base, samp_base)
    with _COUNT_LOCK:
        REFILLS[0] += vals[L.REFILLS]
    refill = loop.refill
    with span("rt.loop.finish"):
        img = _wf_finish(loop.core.state, refill.work, refill.done, refill.drop, n_pix, samples)
    return img, float(vals[L.NVERTS]), vals[L.ROUNDS]


def _wf_finish(state, work, done, drop, n_pix: int, samples: int) -> torch.Tensor:
    """Final flush: the loop exits with work exhausted and no lane alive,
    but the last completions still hold their radiance in-lane. Then the
    mean over the samples, summed in sample order."""
    done.index_copy_(1, torch.where(work >= 0, work, drop), state[9:12])
    return done[:, :n_pix * samples].reshape(3, samples, n_pix).sum(dim=1) * (1.0 / samples)


class StickyBody:
    """One round of the pixel-sticky engine on a ``ModularScene``, or
    through the fused core (K1 in lane mode) off the K5 route, over static
    buffers: ``seed_off`` ((2,) int64: the seed and 0; ``seed`` is its first
    element) and ``bases`` (pix_base, samp_base) in; the lanes' state, path
    counters ``k``, depths and work ids and the radiance slots ``acc``
    carried from round to round. A call is one round: the restart
    (``ops/refill.py:restart``, N2b on a card: flush the finished paths,
    restart the dead lanes, every lane's work id) and one bounce; the
    round's tail (``tail``, as ``CoreBody``'s) steps the depths."""

    def __init__(self, cfg: TraceConfig, scene, cam: CameraArrays, width: int, height: int,
                 n_pix: int, samples: int, lanes: int, plain: bool = False):
        dev = _scene_device(scene)
        b = self.b = lanes
        self.plain = plain
        self.frame = _lane_frame(cam, width, height, n_pix, samples, dev)
        self.jmax = max(-(-n_pix // b), 1)  # owned pixels per lane (ceil)
        self.seed_off = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.seed = self.seed_off[0]
        self.bases = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.kmax = RF.sticky_kmax(b, n_pix, samples, dev)
        self.state = _initial_state(B.N_STATE, b, dev)
        self.k = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.depth = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.wid = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.acc = torch.zeros((3, self.jmax * b), dtype=torch.float32, device=dev)  # j * b + l
        self.core, fused = _make_bounce_core(cfg, scene, self.seed_off, plain)
        self.tail = L.TAIL_FUSED if fused else L.TAIL_DEPTH

    def reset(self, seed32: int, pix_base: int, samp_base: int) -> None:
        """A frame's seed and offsets in, every lane dead with no path."""
        self.seed.fill_(seed32)
        self.bases[0].fill_(pix_base)
        self.bases[1].fill_(samp_base)
        self.state.copy_(_initial_state(B.N_STATE, self.b, self.state.device))
        for t in (self.k, self.depth, self.wid, self.acc):
            t.zero_()

    def restart(self) -> None:
        """Flush dead lanes' finished paths, start their next sample, write
        every lane's work id."""
        (RF.restart_plain if self.plain else RF.restart)(
            self.state, self.k, self.kmax, self.depth, self.wid, self.acc, self.seed_off,
            self.bases, self.frame)

    def __call__(self) -> None:
        self.restart()
        _bounce_into(self.state, self.core(self.state, self.wid, self.depth))


class StickyLoop(_GuardedLoop):
    """The pixel-sticky engine off the K5 route: a round is a ``StickyBody``
    call and the round's tail and test (N5 in ``STICKY`` mode: lanes alive
    or with paths left)."""

    def __init__(self, cfg: TraceConfig, scene, cam: CameraArrays, width: int, height: int,
                 n_pix: int, samples: int, lanes: int, plain: bool = False):
        self.body = StickyBody(cfg, scene, cam, width, height, n_pix, samples, lanes, plain)
        super().__init__(self.body.state.device, lanes)
        # a lane walks jmax * samples paths of at most ray_depth rounds each
        self.cap = self.body.jmax * samples * max(cfg.ray_depth, 1)
        self.last = cfg.ray_depth - 1
        self.n_pix, self.samples = n_pix, samples

    def reset(self, seed32: int, pix_base: int, samp_base: int) -> None:
        self.body.reset(seed32, pix_base, samp_base)
        self.ls.reset()
        self.test(L.TAIL_NONE)

    def test(self, tail: int | None = None) -> None:
        """N5: the round's tail (``tail``, by default the core's) and test."""
        b = self.body
        fn = round_tail_plain if b.plain else round_tail
        fn(self.ls, L.STICKY, b.state, b.depth, b.tail if tail is None else tail, self.last,
           k=b.k, n_pix=self.n_pix, samples=self.samples)

    def round(self) -> None:
        self.body()
        self.test()


def render_wavefront_sticky(seed32: int, pix_base: int, samp_base: int, cam: CameraArrays,
                            scene, cfg: TraceConfig, width: int, height: int, n_pix: int,
                            samples: int, lanes: int, plain: bool = False, graphs=None):
    """Pixel-sticky engine: lane ``l`` owns pixels ``{l, l + lanes, ...}``
    and walks each owned pixel's ``samples`` paths in turn, accumulating
    radiance in place, with no rank, no scatter and no cross-lane
    coordination. Returns ((3, n_pix) mean radiance, path vertices, rounds),
    as ``render_wavefront`` does, from the same work-item streams.

    When the fused gate passes and ``n_pix <= lanes``, each round is one K5
    launch on ``n_pix`` lanes (``FusedStickyLoop``); otherwise a
    ``StickyBody`` call (N2b and one bounce: K1 in lane mode, or the XLA
    core; ``StickyLoop``). ``graphs`` (a graph cache of ``scene``) replays
    ``ROUNDS_PER_REPLAY`` guarded rounds as one captured graph on either;
    ``plain`` runs eagerly."""
    check_work_ids(width * height, samp_base, samples)
    b = lanes
    _, fused = _make_bounce_core(cfg, scene, seed32, plain)
    if plain:
        graphs = None
    frame = (width, height, pack_camera_row(cam).tobytes(), n_pix, samples, ROUNDS_PER_REPLAY)
    if fused and n_pix <= b:
        loop, run = graphed_body(graphs, scene, ("sticky-k5", cfg, *frame), lambda: (
            FusedStickyLoop(cfg, scene, cam, width, height, n_pix, samples, plain)))
        vals = _run_loop(loop, run, "sticky frame", seed32, pix_base, samp_base)
        with span("rt.loop.finish"):
            img = loop.finish()
        return img, float(vals[L.NVERTS]), vals[L.ROUNDS]
    loop, run = graphed_body(graphs, scene, ("sticky", b, cfg, *frame), lambda: StickyLoop(
        cfg, scene, cam, width, height, n_pix, samples, b, plain))
    vals = _run_loop(loop, run, "sticky frame", seed32, pix_base, samp_base)
    body = loop.body
    with span("rt.loop.finish"):
        body.restart()  # final flush, once, after the last round: the last paths are still in-lane
        img = body.acc[:, :n_pix] * (1.0 / samples)
    return img, float(vals[L.NVERTS]), vals[L.ROUNDS]


def _sticky_inputs(seed32: int, pix_base: int, samp_base: int, cam: CameraArrays, scene,
                   cfg: TraceConfig, width: int, height: int, n_pix: int, samples: int):
    """What each K5 round reads: ``(ins, state, args)`` with ``ins`` =
    (scene, camera row, px, py, kmax) of lane ``l`` = pixel ``pix_base +
    l``, ``state`` the initial (18, n_pix) state and ``args`` the launch
    arguments after the state."""
    dev = scene.geo.device
    pixg = pix_base + torch.arange(n_pix, dtype=torch.int64, device=dev)
    px = (pixg % width).to(torch.float32)
    py = torch.clamp(pixg // width, max=height - 1).to(torch.float32)
    kmax = torch.full((n_pix,), float(samples), dtype=torch.float32, device=dev)
    cam_row = torch.from_numpy(pack_camera_row(cam)[0]).to(dev)
    args = (seed32, width * height, pix_base, samp_base, cfg.bg_color, cfg.max_tries,
            cfg.ray_depth, width, height)
    return (scene, cam_row, px, py, kmax), _initial_state(N_PSTATE, n_pix, dev), args


class FusedStickyLoop(_GuardedLoop):
    """The pixel-sticky engine on the K5 route, one K5 launch per round on
    ``n_pix`` lanes (lane ``l`` owns pixel ``pix_base + l``): the (18,
    n_pix) state and K5's inputs with the seed and the offsets as a device
    triple ``sb`` (seed, pix_base, samp_base), so that one graph serves
    every frame. K5 ends each round with the round test on its own counts
    (``ops/loop.py:k5_round_plain``), so a round is one launch. A lane's
    paths take at most ``ray_depth`` rounds each, so the frame ends within
    ``samples * ray_depth`` rounds (``cap``)."""

    def __init__(self, cfg: TraceConfig, scene, cam: CameraArrays, width: int, height: int,
                 n_pix: int, samples: int, plain: bool = False):
        self.ins, self.state, args = _sticky_inputs(0, 0, 0, cam, scene, cfg, width, height,
                                                    n_pix, samples)
        dev = self.state.device
        super().__init__(dev, n_pix)
        self.plain = plain
        self.sb = torch.zeros((3,), dtype=torch.int64, device=dev)
        self.args = (self.sb[0], args[1], self.sb[1], self.sb[2], *args[4:])
        self.k5_args = (self.sb, args[1], *args[4:])
        self.width, self.height, self.n_pix, self.samples = width, height, n_pix, samples
        self.cap = samples * max(cfg.ray_depth, 1)

    def reset(self, seed32: int, pix_base: int, samp_base: int) -> None:
        for i, v in enumerate((seed32, pix_base, samp_base)):
            self.sb[i].fill_(v)
        _, px, py, _ = self.ins[1:]
        pixg = pix_base + torch.arange(self.n_pix, dtype=torch.int64, device=px.device)
        px.copy_(pixg % self.width)
        py.copy_(torch.clamp(pixg // self.width, max=self.height - 1))
        self.state.copy_(_initial_state(N_PSTATE, self.n_pix, self.state.device))
        self.ls.reset()
        more = int(self.n_pix * self.samples > 0)  # the loop test before the first round
        for i in (L.MORE, L.ROUNDS):
            self.ls.loop[i].fill_(more)
        self.ls.more.fill_(bool(more))

    def round(self) -> None:
        if self.plain:
            state, live, more = persistent_plain(*self.ins, self.state, *self.args)
            self.state.copy_(state)
            k5_round_plain(self.ls, live, more)
        else:
            persistent_round(*self.ins, self.state, self.ls, *self.k5_args, out=self.state)

    def finish(self) -> torch.Tensor:
        """Final flush: paths that ended in the last round still hold their
        radiance; then the mean."""
        st = self.state
        started = st[S_K] > 0.5
        acc = torch.where(started, st[S_ACC:S_ACC + 3] + st[9:12], st[S_ACC:S_ACC + 3])
        return acc * (1.0 / self.samples)
