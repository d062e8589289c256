"""Lane engines: the counter-refill wavefront and the pixel-sticky engine.

The JAX package's ``integrator/wavefront.py``. One batch of lanes lives for
the whole frame and each lane walks path after path, so the lanes stay busy
when paths end at different depths:

* ``render_wavefront`` (counter refill): when at least ``RT_WF_REFILL_FRAC``
  (default 0.125) of the lanes are dead, their radiance is flushed and they
  take the next work items, ranked by a cumulative sum; work item ``w`` is
  (pixel ``w % n_pix``, sample ``w // n_pix``). A work item finishes once,
  so the flush writes its radiance to a column of its own and the image is
  summed over the samples at the end, in a fixed order;
* ``render_wavefront_sticky`` (pixel-sticky): lane ``l`` owns pixels
  ``l, l + lanes, ...`` and restarts its own next sample the round after a
  path ends, accumulating in place; with at least as many lanes as pixels
  and a scene that passes the fused gate, a whole round is one kernel, K5
  (``_sticky_fused``, ``ops/persistent.py``).

Every draw is keyed by the work item, global (pixel, sample), in the lane
engines' layout (``ops/rng.py``: ``lane_ctr``), so both engines give the
same image for any lane count, and the same as the JAX package's engines on
the CPU, image for image.

A bounce (``_make_bounce_core``) is either the fused core, K1 in lane mode
(``ops/bounce.py``) then the depth cap and ``park``, when the scene is a
``BounceScene``; or the XLA core on a ``ModularScene`` (roulette, faithful
acceptance, ``RT_MEGAKERNEL=0``, large scenes, the BVH backend): the
scene's nearest hit over the finite table (``ops/traverse.py:nearest_table``:
K4 or the sweep, or the BVH walk K6), the shade pass N1a (the planes,
``surface_detail``, emission, and the final-depth rule), the mixture
sampler on the layout's draws and the finish pass N1b (``_finish_bounce``
with the layout's draws, then ``park``). The sampler is picked by the batch
route's rule (``integrator/path.py:sample_bounce``): K3 in lane mode, or
its XLA formulation for faithful acceptance and large light tables. On the
card N1a, K3 and N1b are kernels; the JAX package's lane core samples in
XLA, which fuses it.

Per-lane depth replaces the batch engine's bounce index: a lane whose
final depth is reached dies after collecting emission (the reference
returns black at depth 0, src/rendering.rs:93-95). Each engine returns
((3, n_pix) mean radiance, path vertices, rounds): a round is one bounce
of every lane (one K1 or one K5 launch on the fused routes).

The counter wavefront's bounce and refill and the sticky round are bodies
over static buffers (``CoreBody``, ``RefillBody``, ``StickyBody``) that read
the seed and the frame offsets on the device, on either route (K1 reads
its seed pair there too, K3 and N1b the same pair); the refill and the
sticky restart are one kernel each on the card, N2a and N2b
(``ops/refill.py``). Given a graph cache (``runtime/graphs.py``) the
counter wavefront replays its refill and its bounce as captured CUDA graphs
and the sticky engine its whole round (restart, core, the live test), the
counterpart of the JAX package's ``_render_wf`` (each engine one
``lax.while_loop`` under ``jax.jit``); the one host read per round stays.
The sticky engine's K5 loop stays eager: one launch per round, its counts
read one round late. Every engine refuses a frame whose work ids would pass
2^32 (``ops/rng.py:check_work_ids``) before any work.
"""

from __future__ import annotations

import os
import threading

import torch

from ..ops import bounce as B
from ..ops import refill as RF
from ..ops.camera import CameraArrays, pack_camera_row
from ..ops.persistent import N_PSTATE, S_ACC, S_K, persistent_plain, persistent_round
from ..ops.rng import check_work_ids, lane_ctr
from ..ops.shade import PARK_DIR, PARK_ORIGIN, finish, finish_plain, park, shade, shade_plain
from ..ops.traverse import nearest_table
from ..ops.vec import Vec3
from .path import TraceConfig, check_sampler, graphed_body, sample_bounce


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
    depths; ``alive'`` already applies the per-lane final-depth rule and dead
    lanes' rays are parked. The fused core updates ``state`` in place on
    CUDA. ``plain`` runs the plain versions of the kernels on any device.
    ``seed`` is an int, a 0-dim int64 tensor or the (2,) int64 pair (seed,
    0) of a body (``_lane_seed``), on the scene's device; a tensor is read
    on the device, by K1 too."""
    k, bg = cfg.max_tries, cfg.bg_color
    last = cfg.ray_depth - 1
    lane_ctr(0, k)  # refuses a max_tries whose draws overflow the counter block
    check_sampler(cfg, _scene_device(scene))
    seed, wid_off = _lane_seed(seed)

    if isinstance(scene, B.BounceScene):
        def fused_core(state, wid, depth):
            if plain:
                st = B.bounce_plain(scene, state, wid, wid_off, seed, 0, bg, k, depth=depth)
            else:
                st = B.bounce(scene, state, wid, wid_off, seed, 0, bg, k, out=state, depth=depth)
            return park(st, (st[12] > 0.5) & (depth < last))

        return fused_core, True

    shade_fn, finish_fn = (shade_plain, finish_plain) if plain else (shade, finish)

    def xla_core(state, wid, depth):
        ro, rd = Vec3(state[0], state[1], state[2]), Vec3(state[3], state[4], state[5])
        t, idx = nearest_table(ro, rd, scene, plain=plain, live=state[12] > 0.5)
        # N1a: alive becomes "hit and depth < last", the final-depth rule
        st, surf, need = shade_fn(state, t, idx, scene, bg, depth=depth, last=last)
        # K3 in lane mode, or its XLA formulation (``takes_k3``), as on the batch route
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
    the XLA core on a ``ModularScene``) and leaves the state in ``state``,
    adds one to every lane's depth and counts the lanes alive after it into
    ``n_alive``, the host's one read per round."""

    def __init__(self, cfg: TraceConfig, scene, lanes: int, plain: bool = False):
        dev = _scene_device(scene)
        self.seed_off = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.seed = self.seed_off[0]
        self.state = _initial_state(B.N_STATE, lanes, dev)
        self.wid = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        self.depth = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        self.n_alive = torch.zeros((), dtype=torch.int64, device=dev)
        self.plain = plain
        self.core, _ = _make_bounce_core(cfg, scene, self.seed_off, plain)

    def __call__(self) -> None:
        self.state.copy_(self.core(self.state, self.wid, self.depth))
        self.depth += 1
        self.n_alive.copy_((self.state[12] > 0.5).sum())


class RefillBody:
    """The counter wavefront's refill over static buffers: its
    ``CoreBody``'s (``seed_off``, ``state``, ``wid``, ``depth``) and its own,
    ``bases`` ((2,) int64: pix_base, samp_base), ``work`` (the work item of
    each lane, int64, -1 for none), ``counter`` (0-dim int64: the work items
    handed out) and ``done`` (3 x (work items + lanes) f32: column ``w``
    holds work item ``w``'s radiance; every column is written by one lane,
    so the writes are plain stores, in no order that could change a sum). A
    call is ``ops/refill.py:refill`` (N2a on a card): it flushes the dead
    lanes' radiance, hands them the next work items in lane order, writes
    every lane's work id into ``wid`` and starts the taken lanes on their
    camera rays. It reads nothing from the host: the host mirrors
    ``counter`` with the same integer arithmetic."""

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
        for t in (c.wid, c.depth, c.n_alive, self.counter, self.done):
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


# refills the counter wavefront has run (every pass and shard, eager or
# replayed): the host's own count, which a caller may set to 0 and read
# beside N2a's launches (ops/kernels.py:LAUNCHES["refill"])
REFILLS = [0]
_REFILLS_LOCK = threading.Lock()  # shards render from threads


# work items of one counter-refill pass: the flush keeps 12 bytes per item
# (400 MB at this cap); a frame with more work renders in passes of whole
# samples, summed in order
WF_MAX_WORK = 1 << 25


def wavefront_bodies(cfg: TraceConfig, scene, cam: CameraArrays, width: int, height: int,
                     n_pix: int, samples: int, lanes: int, plain: bool = False, graphs=None):
    """``(core, run_core, refill, run_refill)`` of one counter-refill pass
    (``graphed_body``): the core's cache entry is keyed by the lanes and
    cfg, the refill's also by the frame, the camera, ``n_pix`` and the
    pass's samples (they size ``done``); seeds, ``pix_base`` and
    ``samp_base`` are device values and key nothing."""
    core, run_core = graphed_body(graphs, scene, ("wavefront", lanes, cfg),
                                  lambda: CoreBody(cfg, scene, lanes, plain))
    key = ("refill", lanes, cfg, width, height, pack_camera_row(cam).tobytes(), n_pix, samples)
    refill, run_refill = graphed_body(graphs, scene, key, lambda: RefillBody(
        core, cam, width, height, n_pix, samples))
    if refill.core is not core:
        raise RuntimeError("a refill body serves the core body it was made with")
    return core, run_core, refill, run_refill


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
    ``RT_WF_REFILL_FRAC`` of the lanes are dead) and a bounce
    (``CoreBody``), each a call over static buffers; ``graphs`` (a graph
    cache of ``scene``) replays both as captured graphs, on either route.
    The host reads one number per round, the lanes alive after the bounce,
    and decides from it whether to refill and when to stop; it mirrors the
    work counter and the path vertices with the same integer arithmetic, so
    rounds and path vertices are exact. ``plain`` runs eagerly."""
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
    total_work = n_pix * samples
    b = lanes
    core, run_core, refill, run_refill = wavefront_bodies(
        cfg, scene, cam, width, height, n_pix, samples, b, plain, None if plain else graphs)
    refill.reset(seed32, pix_base, samp_base)

    # refill threshold: rounds price the full lane batch, so refilling at
    # 1/8 dead keeps occupancy near 94 % at the cost of a cumsum, a
    # flush and the camera math per refill (the JAX package's default)
    frac = float(os.environ.get("RT_WF_REFILL_FRAC", "0.125"))
    thresh = max(int(b * frac), 1)

    counter = nverts = rounds = 0
    n_dead = b  # every lane starts dead
    while counter < total_work or n_dead < b:
        n_take = 0
        if n_dead >= thresh:  # flush dead lanes' radiance, hand out fresh work
            run_refill()
            with _REFILLS_LOCK:
                REFILLS[0] += 1
            n_take = min(n_dead, total_work - counter)
            counter += n_take
        nverts += b - n_dead + n_take
        run_core()
        rounds += 1
        n_dead = b - int(core.n_alive)  # the one host read per round
    return _wf_finish(core.state, refill.work, refill.done, refill.drop, n_pix, samples), \
        float(nverts), rounds


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
    counters ``k``, depths and work ids, the radiance slots ``acc``, the
    path vertices ``nverts`` and ``more`` (a lane is alive or has paths
    left) carried from round to round. A call is one round: the restart
    (``ops/refill.py:restart``, N2b on a card: flush the finished paths,
    restart the dead lanes, every lane's work id), one bounce, then
    ``more``."""

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
        self.nverts = torch.zeros((), dtype=torch.int64, device=dev)
        self.more = torch.zeros((), dtype=torch.bool, device=dev)
        self.core, _ = _make_bounce_core(cfg, scene, self.seed_off, plain)

    def reset(self, seed32: int, pix_base: int, samp_base: int) -> None:
        """A frame's seed and offsets in, every lane dead with no path."""
        self.seed.fill_(seed32)
        self.bases[0].fill_(pix_base)
        self.bases[1].fill_(samp_base)
        self.state.copy_(_initial_state(B.N_STATE, self.b, self.state.device))
        for t in (self.k, self.depth, self.wid, self.acc, self.nverts):
            t.zero_()
        self.more.copy_(self._more())

    def _more(self) -> torch.Tensor:
        return ((self.state[12] > 0.5) | (self.k < self.kmax)).any()

    def restart(self) -> None:
        """Flush dead lanes' finished paths, start their next sample, write
        every lane's work id."""
        (RF.restart_plain if self.plain else RF.restart)(
            self.state, self.k, self.kmax, self.depth, self.wid, self.acc, self.seed_off,
            self.bases, self.frame)

    def __call__(self) -> None:
        self.restart()
        self.nverts += (self.state[12] > 0.5).sum()
        self.state.copy_(self.core(self.state, self.wid, self.depth))
        self.depth += 1
        self.more.copy_(self._more())


def render_wavefront_sticky(seed32: int, pix_base: int, samp_base: int, cam: CameraArrays,
                            scene, cfg: TraceConfig, width: int, height: int, n_pix: int,
                            samples: int, lanes: int, plain: bool = False, graphs=None):
    """Pixel-sticky engine: lane ``l`` owns pixels ``{l, l + lanes, ...}``
    and walks each owned pixel's ``samples`` paths in turn, accumulating
    radiance in place, with no rank, no scatter and no cross-lane
    coordination. Returns ((3, n_pix) mean radiance, path vertices, rounds),
    as ``render_wavefront`` does, from the same work-item streams.

    When the fused gate passes and ``n_pix <= lanes``, each round is one K5
    launch on ``n_pix`` lanes (``_sticky_fused``), which stays eager: a
    graph of one launch would save nothing, and the loop reads its counts
    one round late so that the card always has the next round queued.
    Otherwise each round is a ``StickyBody`` call: a torch restart and one
    bounce (K1 in lane mode, or the XLA core); ``graphs`` (a graph cache of
    ``scene``) replays the round as a captured graph on either route;
    ``plain`` runs eagerly."""
    check_work_ids(width * height, samp_base, samples)
    b = lanes
    _, fused = _make_bounce_core(cfg, scene, seed32, plain)
    if fused and n_pix <= b:
        return _sticky_fused(seed32, pix_base, samp_base, cam, scene, cfg, width, height,
                             n_pix, samples, plain)
    if plain:
        graphs = None
    key = ("sticky", b, cfg, width, height, pack_camera_row(cam).tobytes(), n_pix, samples)
    body, run = graphed_body(graphs, scene, key, lambda: StickyBody(
        cfg, scene, cam, width, height, n_pix, samples, b, plain))
    body.reset(seed32, pix_base, samp_base)
    rounds = 0
    while bool(body.more):  # the one host read per round
        run()
        rounds += 1
    body.restart()  # final flush: the last paths are still in-lane
    return body.acc[:, :n_pix] * (1.0 / samples), float(body.nverts), rounds


def _sticky_inputs(seed32: int, pix_base: int, samp_base: int, cam: CameraArrays, scene,
                   cfg: TraceConfig, width: int, height: int, n_pix: int, samples: int):
    """What each K5 round of ``_sticky_fused`` reads: ``(ins, state, args)``
    with ``ins`` = (scene, camera row, px, py, kmax) of lane ``l`` = pixel
    ``pix_base + l``, ``state`` the initial (18, n_pix) state and ``args``
    the launch arguments after the state."""
    dev = scene.geo.device
    pixg = pix_base + torch.arange(n_pix, dtype=torch.int64, device=dev)
    px = (pixg % width).to(torch.float32)
    py = torch.clamp(pixg // width, max=height - 1).to(torch.float32)
    kmax = torch.full((n_pix,), float(samples), dtype=torch.float32, device=dev)
    cam_row = torch.from_numpy(pack_camera_row(cam)[0]).to(dev)
    args = (seed32, width * height, pix_base, samp_base, cfg.bg_color, cfg.max_tries,
            cfg.ray_depth, width, height)
    return (scene, cam_row, px, py, kmax), _initial_state(N_PSTATE, n_pix, dev), args


def _sticky_fused(seed32: int, pix_base: int, samp_base: int, cam: CameraArrays, scene,
                  cfg: TraceConfig, width: int, height: int, n_pix: int, samples: int,
                  plain: bool = False):
    """Pixel-sticky engine, one K5 launch per round on ``n_pix`` lanes: lane
    ``l`` owns pixel ``pix_base + l``.

    The loop runs while a lane is alive or has paths left. The host reads
    that count one round late (a pinned copy and an event per round), so
    the card always has the next round queued; the round after the one that
    emptied the frame is a no-op that is launched and counted. A lane's
    paths take at most ``ray_depth`` rounds each, so the frame ends within
    ``samples * ray_depth`` rounds; a frame with work left after that many
    rounds raises."""
    ins, state, args = _sticky_inputs(seed32, pix_base, samp_base, cam, scene, cfg, width,
                                      height, n_pix, samples)
    dev = state.device
    max_rounds = samples * max(cfg.ray_depth, 1)
    counts = torch.zeros((max_rounds, 2), dtype=torch.int32, device=dev)
    host = torch.zeros((max_rounds, 2), dtype=torch.int32, pin_memory=dev.type == "cuda")
    done = []  # one event per round on CUDA: its counts have reached ``host``
    rounds = 0
    while rounds < max_rounds:
        if plain:
            state, live, more = persistent_plain(*ins, state, *args)
            counts[rounds] += torch.stack([live, more]).to(torch.int32)
        else:
            persistent_round(*ins, state, counts[rounds], *args, out=state)
        host[rounds].copy_(counts[rounds], non_blocking=True)
        if dev.type == "cuda":
            done.append(torch.cuda.Event())
            done[-1].record()
        rounds += 1
        if rounds >= 2:
            if done:
                done[rounds - 2].synchronize()
            if int(host[rounds - 2, 1]) == 0:
                break
    if done:
        done[-1].synchronize()
    if rounds == max_rounds and int(host[rounds - 1, 1]) != 0:
        raise RuntimeError(f"sticky frame has work left after samples x ray_depth = {rounds} "
                           "rounds")
    nverts = float(host[:rounds, 0].sum())

    # final flush: paths that ended in the last round still hold their radiance
    started = state[S_K] > 0.5
    acc = torch.where(started, state[S_ACC:S_ACC + 3] + state[9:12], state[S_ACC:S_ACC + 3])
    return acc * (1.0 / samples), nverts, rounds
