"""Path-tracing integrator: the fused-bounce path and the modular dense path.

The reference's recursive estimator (src/rendering.rs:86-127) telescopes
into a loop carrying (ray, throughput T, radiance L, alive) per lane:

    L += T * emission_at_hit, or T * background on a miss (then the lane dies)
    T *= brdf(l, n, v) * (l.n) / pdf     (mixture-sampled lobe)

run for ``ray_depth - 1`` full bounces and a final level that only collects
emission (the reference returns black at depth 0, so its last sampled
direction never contributes). Two routes compute it, picked by
``mega_gate`` as the JAX package's ``_mega_gate`` picks them:

* **fused** (small scenes, no roulette, no faithful acceptance): each
  sample is a chain of fused-bounce kernels (ops/bounce.py): bounce 0 with
  the camera ray generated in the same kernel (K2), bounces
  1 .. ray_depth-2 (K1), the final level (K1 ``final_only``). At
  ``ray_depth`` 1 the fresh state on the camera rays comes from the camera
  stage N4 (``ops/camera.py:camera_state``) and only the final level runs.
  This is the JAX package's ``_trace_paths_mega_primary`` /
  ``render_pixels`` route.
* **modular** (everything else, the BVH backend included): the (13, B)
  state of fresh paths on their camera rays from the camera stage N4
  (``ops/camera.py:camera_state``: the work key, the jitter draws, the
  ray and the fresh rows in one kernel), then per level, on that state as
  on the fused route's: the scene's nearest hit over the finite table
  (``ops/traverse.py:nearest_table``: K4 or the chunked sweep on the dense
  backend, the BVH walk K6 on the BVH backend), the shade pass N1a (the
  planes, ``surface_detail``, emission / background; ``ops/shade.py``),
  the mixture sampler (K3, ops/sampler.py, or its XLA formulation for
  faithful acceptance) and the finish pass N1b (the BRDF weight,
  the delta rules, optional Russian roulette: ``_finish_bounce``); the last
  level runs N1a alone. This is the JAX package's ``trace_paths`` batch
  scan, whose element-wise work XLA fuses.

Both routes draw from the counter RNG with the same layout (ops/rng.py),
so from one seed they trace the same paths. Path vertices (one scene
intersection per live lane and level) are counted exactly, as an int64 on
the device: the unit behind the Mrays/s metric (bench.py). The kernel that
opens a level adds the lanes alive on its entry (K1 on the fused route, N1a
on the modular route), so neither route launches a reduction per level.

Both routes run one sample of a batch as ``SampleBody``: a call over
static buffers that reads the seed and the sample's work-id offset from the
device (K1, K2, K3 and N1b read them there too) and adds the sample to device
sums. Given a graph cache (``runtime/graphs.py``; a ``Renderer`` on a card
holds one), the first call of a (scene, route, lanes, cfg, frame) captures
it in a CUDA graph and every later sample, batch, seed and frame replays
it: the counterpart of the JAX package's ``_render_batch`` (one ``jax.jit``
of the sample and level scans, on either route). Without a cache the same
call runs eagerly.

Work ids are 32-bit: ``render_batches`` refuses a frame whose
``frame_pix * (samp_base + samples)`` passes 2^32
(``ops/rng.py:check_work_ids``) before any work.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import torch

from ..ops import bounce as B
from ..ops.camera import (CameraArrays, camera_from_row, camera_state, camera_state_plain,
                          pack_camera_row)
from ..ops.rng import WF_STRIDE, batch_ctr, check_work_ids, draws_per_bounce, lane_ctr
from ..ops.sampler import sample_mixture_kernel, sampler_plain
from ..ops.scene_intersect import ModularScene
from ..ops.shade import finish, finish_plain, sampler_inputs, shade, shade_plain
from ..ops.traverse import nearest_table
from ..ops.vec import Vec3
from ..runtime.profiling import count, span
from ..scene.types import SceneStatics

log = logging.getLogger("rt_torch")

# lanes per batch on every engine and both backends. The JAX package's
# engine-aware counts (16,384 wavefront lanes, 262,144 BVH batch lanes;
# raytracing_course_2024_tpu/runtime/render.py:30-38, :80-87) are sweeps
# made on a TPU and are not ported; the H100's sweep waits for the port's
# benchmark (ROADMAP.md B0).
DEFAULT_BATCH = 1_048_576


class TraceConfig(NamedTuple):
    """Integrator parameters (the JAX package's TraceConfig)."""

    ray_depth: int
    bg_color: tuple  # (r, g, b)
    max_tries: int = 4  # mixture rejection candidates
    backend: str = "dense"  # "dense" | "bvh"
    faithful: bool = False  # reference-exact acceptance (modular path only)
    rr: bool = False  # Russian roulette (modular path only)


def mega_gate(cfg: TraceConfig, statics: SceneStatics) -> bool:
    """Whether the fused-bounce path renders this configuration (the JAX
    package's ``_mega_gate``): the dense backend, neither faithful
    acceptance nor roulette, and a scene inside the fused gate
    (``ops/bounce.py:gate_reason``). Nothing else steers the route."""
    return (cfg.backend == "dense" and not cfg.faithful and not cfg.rr
            and B.gate_reason(statics) is None)


# ---------------------------------------------------------------------------
# fused path
# ---------------------------------------------------------------------------


def trace_sample(scene: B.BounceScene, state: torch.Tensor, seed, wid: torch.Tensor, wid_off,
                 px: torch.Tensor, py: torch.Tensor, cam_row: torch.Tensor, cfg: TraceConfig,
                 width: int, height: int, plain: bool = False, cam: CameraArrays | None = None):
    """One camera sample per lane through all depth levels of the fused path.

    ``state`` is a (13, B) buffer the kernels overwrite in place (the plain
    versions return fresh tensors). Returns (state after the final level,
    path vertices as a 0-dim int64 tensor on the device): every lane at
    bounce 0, then the lanes alive on entry to each later level. Through the
    kernels each level's launch adds its own count; the plain versions sum
    the alive row per level. ``seed`` and ``wid_off`` are ints or 0-dim
    int64 tensors on the lanes' device, read there. ``cam`` is ``cam_row``
    unpacked on the host (a captured body passes its own: unpacking reads
    the row back)."""
    bg, k = cfg.bg_color, cfg.max_tries
    if cam is None:
        cam = camera_from_row(cam_row)
    if not plain:
        return _trace_sample_kernels(scene, state, seed, wid, wid_off, px, py, cam_row, cam,
                                     cfg, width, height)
    rays = torch.full((), px.shape[0], dtype=torch.int64, device=px.device)
    if cfg.ray_depth < 2:  # the final level only: camera rays, then K1 final_only
        st = camera_state_plain(seed, wid, wid_off, px, py, cam, width, height)
    else:
        st = B.primary_plain(scene, cam_row, px, py, wid, wid_off, seed, bg, k, width, height)
        for i in range(1, cfg.ray_depth - 1):
            rays += (st[12] > 0.5).sum()
            st = B.bounce_plain(scene, st, wid, wid_off, seed, i, bg, k)
        rays += (st[12] > 0.5).sum()
    st = B.bounce_plain(scene, st, wid, wid_off, seed, max(cfg.ray_depth - 1, 0), bg, k,
                        final_only=True)
    return st, rays


def _trace_sample_kernels(scene, state, seed, wid, wid_off, px, py, cam_row, cam,
                          cfg: TraceConfig, width: int, height: int):
    """``trace_sample`` through the wrappers of ``ops/bounce.py``: K2, then
    K1 per level, then K1 ``final_only``, in place in ``state``. K2 runs every
    lane; each later launch adds the lanes alive on its entry to ``rays``
    (on the CPU the wrappers sum the alive row). At ``ray_depth`` 1 the
    camera stage N4 writes the fresh state into ``state`` and only K1
    ``final_only`` runs."""
    bg, k = cfg.bg_color, cfg.max_tries
    if cfg.ray_depth >= 2:
        st = B.primary_bounce(scene, cam_row, px, py, wid, wid_off, seed, bg, k, width, height,
                              out=state)
        rays = torch.full((), px.shape[0], dtype=torch.int64, device=px.device)
    else:  # camera rays, then the final level alone
        st = camera_state(seed, wid, wid_off, px, py, cam, cam_row, width, height, out=state)
        rays = torch.zeros((), dtype=torch.int64, device=px.device)
    for i in range(1, cfg.ray_depth - 1):
        st = B.bounce(scene, st, wid, wid_off, seed, i, bg, k, out=st, count=rays)
    st = B.bounce(scene, st, wid, wid_off, seed, max(cfg.ray_depth - 1, 0), bg, k,
                  final_only=True, out=st, count=rays)
    return st, rays


# ---------------------------------------------------------------------------
# modular dense path (the JAX package's trace_paths batch scan)
# ---------------------------------------------------------------------------


def _collect_hit(state: torch.Tensor, scene: ModularScene, cfg: TraceConfig,
                 plain: bool = False, live: torch.Tensor | None = None, final: bool = False,
                 count: torch.Tensor | None = None):
    """Nearest hit over the finite table, then the shade pass (N1a,
    ``ops/shade.py``: the planes, the surface, emission / background).
    ``live`` (default: the state's alive row) masks the walk: K4 and K6 walk
    nothing for a dead lane. ``count`` (a 0-dim int64 tensor) gets the lanes
    alive on entry added by N1a. Returns ``(state', surf, need)``; ``final``
    (the last level) only collects emission: ``surf`` and ``need`` None."""
    ro, rd = Vec3(state[0], state[1], state[2]), Vec3(state[3], state[4], state[5])
    t, idx = nearest_table(ro, rd, scene, plain=plain,
                           live=state[12] > 0.5 if live is None else live)
    return (shade_plain if plain else shade)(state, t, idx, scene, cfg.bg_color, final=final,
                                             count=count)


def _bounce(state: torch.Tensor, scene: ModularScene, cfg: TraceConfig, seed,
            wid: torch.Tensor, wid_off, bounce_i: int, plain: bool = False,
            live: torch.Tensor | None = None, count: torch.Tensor | None = None):
    """One full modular bounce of the (13, B) ``state`` at depth level
    ``bounce_i``: the nearest hit, N1a (adding the lanes alive on entry to
    ``count``), the sampler, N1b (on a CUDA tensor in place in ``state``).
    ``seed`` and ``wid_off`` are ints or 0-dim int64 tensors on the lanes'
    device; the bounce reads nothing from the host. Returns ``(state',
    live')``."""
    state, surf, need = _collect_hit(state, scene, cfg, plain, live, count=count)
    l_s, pdf, ok = sample_bounce(scene, cfg, seed, wid, wid_off, surf, need, plain, bounce_i)
    return (finish_plain if plain else finish)(state, surf, l_s, pdf, ok, wid, seed, wid_off,
                                               cfg, bounce_i)


def sample_bounce(scene: ModularScene, cfg: TraceConfig, seed, wid: torch.Tensor, wid_off,
                  surf, need: torch.Tensor, plain: bool = False, bounce_i: int = 0,
                  depth: torch.Tensor | None = None):
    """The modular bounce's mixture sampler on N1a's surface ``surf``, for
    the batch route (the draws of level ``bounce_i``) and the lane engines'
    rounds (``depth``: each lane's own depth in their layout): K3 for the
    fast acceptance, whatever the light count (above 32 lights K3 walks the
    lights' own tree; ``ops/sampler.py``; its plain version on the CPU and
    with ``plain``); for faithful acceptance the XLA formulation, as in the
    JAX package. The JAX package also takes that formulation above 32
    lights: the port differs on purpose, since its (B, L) sweep is no route
    for a card. Returns (l, pdf, ok)."""
    k = cfg.max_tries
    ins = (*sampler_inputs(surf), need, k)
    if depth is None:
        ctr = batch_ctr(bounce_i * draws_per_bounce(k), k)
    else:
        ctr = lane_ctr(0, k)  # the kernel moves it WF_STRIDE per level of depth
    if not plain and not cfg.faithful:
        return sample_mixture_kernel(scene, seed, wid, wid_off, ctr, *ins, depth)
    if depth is not None:
        ctr = ctr.at_depth(depth, WF_STRIDE)
    return sampler_plain(scene, seed, wid, wid_off, ctr, *ins, faithful=cfg.faithful)


def trace_paths(scene: ModularScene, state: torch.Tensor, seed, wid: torch.Tensor, wid_off,
                cfg: TraceConfig, plain: bool = False, count: torch.Tensor | None = None):
    """Radiance of one path per lane on the modular path from ``state``, the
    (13, B) state of fresh paths (``ops/camera.py:camera_state``), which the
    kernels update in place. N1a adds the lanes alive on its entry to
    ``count`` (a 0-dim int64 tensor on the lanes' device; a fresh zero when
    None), at every level, the last included; the route launches no
    reduction per level. Level 0 masks the nearest hit by the state's alive
    row, every later level by N1b's ``live``. Returns ((3, B) radiance,
    ``count``)."""
    if count is None:
        count = torch.zeros((), dtype=torch.int64, device=state.device)
    st, live = state, None
    for i in range(cfg.ray_depth - 1):
        st, live = _bounce(st, scene, cfg, seed, wid, wid_off, i, plain, live, count)
    st, _, _ = _collect_hit(st, scene, cfg, plain, live, final=True, count=count)
    return st[9:12], count


def _modular_sample(scene: ModularScene, seed, wid: torch.Tensor,
                    wid_off, px: torch.Tensor, py: torch.Tensor, cam,
                    cfg: TraceConfig, width: int, height: int, plain: bool,
                    cam_row: torch.Tensor | None = None, state: torch.Tensor | None = None,
                    count: torch.Tensor | None = None):
    """One camera sample per lane on the modular route: ((3, B) radiance,
    path vertices as a 0-dim int64 tensor: ``count`` with this sample's
    added, as ``trace_paths`` returns it). ``seed`` and ``wid_off`` are ints
    or 0-dim int64 tensors on the lanes' device. The fresh state comes from
    the camera stage: its plain version with ``plain``, else N4
    (``camera_state``: the kernel on a card, into ``state`` when given,
    reading the camera as ``cam_row``, which a card needs; the plain version
    on the CPU)."""
    if plain:
        st = camera_state_plain(seed, wid, wid_off, px, py, cam, width, height)
    else:
        st = camera_state(seed, wid, wid_off, px, py, cam, cam_row, width, height, out=state)
    return trace_paths(scene, st, seed, wid, wid_off, cfg, plain, count)


class SampleBody:
    """One sample of one batch, on either route, over static buffers:
    ``seed_off`` ((2,) int64: the seed and the sample's work-id offset),
    ``wid``, ``px``, ``py`` (one entry per lane) in, the sums ``acc`` ((3,
    B) f32 radiance) and ``nrays`` (0-dim int64 path vertices) out. Each
    call works in the body's own (13, B) ``state``. On the fused route (a
    ``BounceScene``) a call runs ``trace_sample``: K2, K1 per level and K1
    ``final_only`` (at ``ray_depth`` 1 the camera stage N4 and K1
    ``final_only``), and adds
    its count to ``nrays``; on the modular route ``_modular_sample``: N4,
    then the levels, whose N1a launches add into ``nrays`` themselves. A
    call adds one sample to the sums and reads nothing from the host, so a
    CUDA graph
    captured from one call replays it for any values in the inputs
    (``runtime/graphs.py``). On the CPU the wrappers
    return fresh tensors from the plain versions, which the body copies or
    adds into its buffers, so the same code runs there."""

    def __init__(self, scene, cam_row: torch.Tensor, cfg: TraceConfig, width: int,
                 height: int, lanes: int, device, plain: bool = False):
        self.scene, self.cfg = scene, cfg
        self.width, self.height, self.plain = width, height, plain
        self.cam_row = cam_row.clone()
        self.cam = camera_from_row(cam_row)
        self.fused = not isinstance(scene, ModularScene)
        self.seed_off = torch.zeros((2,), dtype=torch.int64, device=device)
        self.wid = torch.zeros((lanes,), dtype=torch.int32, device=device)
        self.px = torch.zeros((lanes,), dtype=torch.float32, device=device)
        self.py = torch.zeros((lanes,), dtype=torch.float32, device=device)
        self.state = torch.zeros((B.N_STATE, lanes), dtype=torch.float32, device=device)
        self.acc = torch.zeros((3, lanes), dtype=torch.float32, device=device)
        self.nrays = torch.zeros((), dtype=torch.int64, device=device)

    def load(self, seed: int, wid: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> None:
        """A batch's lanes and seed in, the sums zeroed."""
        self.seed_off[0].fill_(int(seed) & 0xFFFFFFFF)
        self.wid.copy_(wid)
        self.px.copy_(px)
        self.py.copy_(py)
        self.acc.zero_()
        self.nrays.zero_()

    def at(self, wid_off: int) -> None:
        """The next call renders the sample whose work ids start at ``wid_off``."""
        self.seed_off[1].fill_(int(wid_off))

    def __call__(self) -> None:
        seed, wid_off = self.seed_off[0], self.seed_off[1]
        if self.fused:
            st, rays = trace_sample(self.scene, self.state, seed, self.wid, wid_off, self.px,
                                    self.py, self.cam_row, self.cfg, self.width, self.height,
                                    self.plain, self.cam)
            rad = st[9:12]
            self.nrays += rays
        else:
            rad, _ = _modular_sample(self.scene, seed, self.wid, wid_off, self.px, self.py,
                                     self.cam, self.cfg, self.width, self.height, self.plain,
                                     self.cam_row, self.state, self.nrays)
        self.acc += rad


def graphed_body(graphs, scene, key, make):
    """``(body, run)``: without a graph cache a fresh ``make()`` run as it
    is; with one, the cache's entry of ``key`` (made from ``make()`` on
    first use) and the call that replays its graph."""
    if graphs is None:
        body = make()
        return body, body
    run = graphs.get(scene, key, make)
    return run.body, run


def sample_body(scene, cam_row: torch.Tensor, cfg: TraceConfig, width: int, height: int,
                lanes: int, plain: bool = False, graphs=None):
    """``(body, run)`` of ``lanes`` lanes of either route (``graphed_body``;
    one cache entry per route, lanes, cfg, frame size and camera)."""
    fused = not isinstance(scene, ModularScene)
    key = ("batch", fused, lanes, cfg, width, height,
           pack_camera_row(camera_from_row(cam_row)).tobytes())
    return graphed_body(graphs, scene, key, lambda: SampleBody(
        scene, cam_row, cfg, width, height, lanes, cam_row.device, plain))


def render_pixels(scene, seed: int, wid: torch.Tensor, px: torch.Tensor,
                  py: torch.Tensor, cam_row: torch.Tensor, cfg: TraceConfig,
                  width: int, height: int, samples: int, n_pix: int,
                  plain: bool = False, graphs=None):
    """Average radiance over ``samples`` jittered paths per lane.

    The scene's type is the route: ``mega_gate`` picks it once, when the
    Renderer builds a ``BounceScene`` (fused path) or a ``ModularScene``
    (modular path). Lane ``i`` renders pixel (px[i], py[i]); its sample ``s``
    is work item ``wid[i] + s * n_pix`` of the counter RNG. Returns ((3, B)
    f32 channel-major radiance, path vertices as a 0-dim float64 tensor),
    both fresh tensors. Each sample is one call of a ``SampleBody``;
    ``graphs`` (a graph cache of ``scene``) replays it as a captured graph
    on either route; ``plain`` runs eagerly."""
    body, run = sample_body(scene, cam_row, cfg, width, height, px.shape[0], plain,
                            None if plain else graphs)
    body.load(seed, wid, px, py)
    out, rays = run_samples(body, run, samples, n_pix)
    return out, rays.to(torch.float64)


def run_samples(body: SampleBody, run, samples: int, n_pix: int):
    """``samples`` calls of a loaded ``body`` (``run``: the body or its
    graph's replay), sample ``s`` at work-id offset ``s * n_pix``. Returns
    ((3, B) mean radiance, path vertices as a 0-dim int64 tensor), fresh
    tensors, and counts the lane slots the levels' launches cover
    (``rt.lane_slots``: lanes x levels x samples)."""
    for s in range(samples):
        body.at(s * n_pix)
        run()
    count("rt.lane_slots", body.wid.shape[0] * max(body.cfg.ray_depth, 1) * samples)
    return body.acc * (1.0 / samples), body.nrays.clone()


def plan_batches(batch_size: int, n_pix: int, samples: int) -> tuple:
    """(batch, replicas) for ``n_pix`` pixels: fill ~``batch_size`` lanes;
    a frame smaller than that gives each pixel ``replicas`` lanes, where
    ``replicas`` divides ``samples`` (the JAX package's ``_plan``)."""
    b = min(batch_size, n_pix)
    replicas = 1
    if n_pix < batch_size:
        budget = max(batch_size // n_pix, 1)
        for c in range(min(budget, samples), 0, -1):
            if samples % c == 0:
                replicas = c
                break
    return b, replicas


def render_batches(scene, seed: int, cam_row: torch.Tensor, cfg: TraceConfig, width: int,
                   height: int, samples: int, batch_size: int, pix_base: int = 0,
                   n_pix: int | None = None, samp_base: int = 0, plain: bool = False,
                   progress: bool = False, graphs=None):
    """The batch engine on pixels [pix_base, pix_base + n_pix) of the
    width x height frame (row-major; default: the whole frame) at samples
    ``samp_base`` .. ``samp_base + samples - 1``.

    Pixels are cut into batches of ``plan_batches`` lanes; lane (replica r,
    pixel p) renders samples ``samp_base + r * samples / replicas`` onwards,
    as ``render_pixels`` renders them (spans ``rt.batch.prep``: a batch's
    lanes into its ``SampleBody``; ``rt.batch.fold``: the replica mean and
    the batch's int64 count added to the frame's float64 sum). A pixel past
    the last row renders the last row's pixel of its column (the camera
    always sees the true height; the caller crops it). Returns (per-batch
    (3, B) channel-major mean radiance, path vertices as a 0-dim float64
    tensor). ``progress`` logs each batch; ``graphs`` is passed on to
    ``render_pixels``."""
    total = width * height
    n_pix = total if n_pix is None else n_pix
    check_work_ids(total, samp_base, samples)
    b, replicas = plan_batches(batch_size, n_pix, samples)
    spp_r = samples // replicas
    dev = cam_row.device
    n_batches = -(-n_pix // b)
    outs = []
    nrays = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(n_batches):
        with span("rt.batch.prep"):
            lin = torch.arange(b, dtype=torch.int64, device=dev)
            pixg = pix_base + torch.clamp(lin + i * b, max=n_pix - 1)
            px, py = pixg % width, torch.clamp(pixg // width, max=height - 1)
            rep = torch.arange(replicas, dtype=torch.int64, device=dev)
            # lane (replica r, pixel p) renders samples samp_base + r*spp_r .. + spp_r - 1
            wid = ((samp_base + rep[:, None] * spp_r) * total
                   + (py * width + px)[None, :]).reshape(-1)
            body, run = sample_body(scene, cam_row, cfg, width, height, b * replicas, plain,
                                    None if plain else graphs)
            body.load(seed, wid.to(torch.int32), px.repeat(replicas).to(torch.float32),
                      py.repeat(replicas).to(torch.float32))
        out, rays = run_samples(body, run, spp_r, total)
        with span("rt.batch.fold"):
            if replicas > 1:
                out = out.reshape(3, replicas, b).mean(dim=1)
            outs.append(out)
            nrays += rays
        if progress:
            log.info("render progress: %d/%d batches", i + 1, n_batches)
    return outs, nrays
