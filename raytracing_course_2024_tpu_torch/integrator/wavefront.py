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
scene's nearest hit (``ops/traverse.py:nearest_hit``: K4 or the sweep, or
the BVH walk K6), ``surface_detail``, the XLA ``sample_mixture`` fed the layout's draws
and ``_finish_bounce``. As in the JAX package, the XLA core never takes the
sampler kernel K3.

Per-lane depth replaces the batch engine's bounce index: a lane whose
final depth is reached dies after collecting emission (the reference
returns black at depth 0, src/rendering.rs:93-95). Each engine returns
((3, n_pix) mean radiance, path vertices, rounds): a round is one bounce
of every lane (one K1 or one K5 launch on the fused routes).
"""

from __future__ import annotations

import os

import torch

from ..ops import bounce as B
from ..ops.camera import CameraArrays, generate_rays_u, pack_camera_row
from ..ops.persistent import N_PSTATE, S_ACC, S_K, persistent_plain, persistent_round
from ..ops.rng import CTR_JITTER, lane_ctr, mixture_rows, uniform_ctr, work_key
from ..ops.sampling import sample_mixture
from ..ops.scene_intersect import surface_detail
from ..ops.traverse import nearest_hit
from ..ops.vec import Vec3, where3
from ..scene.types import DIELECTRIC, MIRROR
from .path import RR_START, PathState, TraceConfig, _finish_bounce, check_sampler

# a dead lane's parked ray: far outside every scene, pointing away along the
# all-positive diagonal so slab and cull tests reject it with finite math
PARK_ORIGIN = 1.0e30
PARK_DIR = 0.5773502691896258  # 1/sqrt(3)


def _scene_device(scene) -> torch.device:
    return (scene.geo if isinstance(scene, B.BounceScene) else scene.packed).device


def _initial_state(rows: int, b: int, dev) -> torch.Tensor:
    """Dead lanes with parked rays, zero throughput and radiance."""
    st = torch.zeros((rows, b), dtype=torch.float32, device=dev)
    st[0:3] = PARK_ORIGIN
    st[3:6] = PARK_DIR
    return st


def _park(state: torch.Tensor, cont: torch.Tensor) -> torch.Tensor:
    """Set alive to ``cont`` and park the rays of the other lanes (in place)."""
    state[12] = cont.to(torch.float32)
    state[0:3] = torch.where(cont, state[0:3], PARK_ORIGIN)
    state[3:6] = torch.where(cont, state[3:6], PARK_DIR)
    return state


def _camera_rows(cam: CameraArrays, px, py, width, height, key):
    """(6, B) jittered camera rays (ro3, rd3) from draws 0 and 1 of ``key``."""
    o, d = generate_rays_u(cam, px, py, width, height, uniform_ctr(key, CTR_JITTER),
                           uniform_ctr(key, CTR_JITTER + 1))
    return torch.stack([*o, *d])


def _restart_rows(state: torch.Tensor, take: torch.Tensor, rays: torch.Tensor) -> None:
    """Lanes in ``take`` start a fresh path on ``rays`` (in place)."""
    state[0:6] = torch.where(take, rays, state[0:6])
    state[6:9] = torch.where(take, 1.0, state[6:9])
    state[12] = torch.where(take, 1.0, state[12])


def _make_bounce_core(cfg: TraceConfig, scene, seed: int, plain: bool = False):
    """One full bounce shared by both engines. Returns
    ``(core(state, wid, depth) -> state', fused)``: ``state`` is the (13, B)
    path state, ``wid`` the lanes' int32 work ids, ``depth`` their int32
    depths; ``alive'`` already applies the per-lane final-depth rule and dead
    lanes' rays are parked. The fused core updates ``state`` in place on
    CUDA. ``plain`` runs the plain versions of the kernels on any device."""
    k, bg = cfg.max_tries, cfg.bg_color
    last = cfg.ray_depth - 1
    lane_ctr(0, k)  # refuses a max_tries whose draws overflow the counter block
    check_sampler(cfg, _scene_device(scene))

    if isinstance(scene, B.BounceScene):
        def fused_core(state, wid, depth):
            if plain:
                st = B.bounce_plain(scene, state, wid, 0, seed, 0, bg, k, depth=depth)
            else:
                st = B.bounce(scene, state, wid, 0, seed, 0, bg, k, out=state, depth=depth)
            return _park(st, (st[12] > 0.5) & (depth < last))

        return fused_core, True

    def xla_core(state, wid, depth):
        key = work_key(seed, wid)
        s = state
        ro, rd = Vec3(s[0], s[1], s[2]), Vec3(s[3], s[4], s[5])
        thr, rad = Vec3(s[6], s[7], s[8]), Vec3(s[9], s[10], s[11])
        alive = s[12] > 0.5
        hit = nearest_hit(ro, rd, scene, plain=plain, live=alive)
        surf = surface_detail(ro, rd, hit, scene)
        zero = ro.x * 0.0
        bgv = Vec3(zero + bg[0], zero + bg[1], zero + bg[2])
        miss = alive & ~hit.valid
        on_hit = alive & hit.valid
        rad = rad + where3(miss, thr.mul(bgv),
                           where3(on_hit, thr.mul(surf.emission), Vec3(zero, zero, zero)))
        cont = on_hit & (depth < last)
        is_delta = (surf.mkind == MIRROR) | (surf.mkind == DIELECTRIC)
        ctr = lane_ctr(depth, k)
        l_s, pdf, ok = sample_mixture(
            mixture_rows(key, ctr, k), surf.point, surf.n_geom, surf.n_shade, -rd,
            surf.roughness, scene.lp_np, scene.statics, k, need=cont & ~is_delta,
            faithful=cfg.faithful)
        rr_kw = {}
        if cfg.rr:
            rr_kw = dict(u_rr=uniform_ctr(key, ctr.base + ctr.rr), rr_mask=depth >= RR_START)
        ps = _finish_bounce(PathState(ro, rd, thr, rad, cont), surf, l_s, pdf, ok,
                            uniform_ctr(key, ctr.base + ctr.diel), cfg, **rr_kw)
        st = torch.stack([*ps.ro, *ps.rd, *ps.throughput, *ps.radiance,
                          ps.alive.to(torch.float32)])
        return _park(st, ps.alive)

    return xla_core, False


# work items of one counter-refill pass: the flush keeps 12 bytes per item
# (400 MB at this cap); a frame with more work renders in passes of whole
# samples, summed in order
WF_MAX_WORK = 1 << 25


def render_wavefront(seed32: int, pix_base: int, samp_base: int, cam: CameraArrays, scene,
                     cfg: TraceConfig, width: int, height: int, n_pix: int, samples: int,
                     lanes: int, plain: bool = False):
    """Render pixels [pix_base, pix_base + n_pix) (row-major coordinates of
    the full width x height frame) at ``samples`` spp from global sample
    ``samp_base``, on ``lanes`` lanes with counter refill.

    Returns ((3, n_pix) f32 mean radiance, path vertices, rounds). Every
    work item's radiance is written to its own column with a plain indexed
    write and the columns are summed over the samples at the end, so two
    frames from one seed are equal bit for bit on any device. A frame of
    more than ``WF_MAX_WORK`` work items runs as passes of whole samples."""
    per_pass = max(WF_MAX_WORK // max(n_pix, 1), 1)
    if samples > per_pass:
        img, nverts, rounds = 0.0, 0.0, 0
        for s0 in range(0, samples, per_pass):
            n_s = min(per_pass, samples - s0)
            part, v, r = render_wavefront(seed32, pix_base, samp_base + s0, cam, scene, cfg,
                                          width, height, n_pix, n_s, lanes, plain)
            img = img + part * (n_s / samples)
            nverts, rounds = nverts + v, rounds + r
        return img, nverts, rounds
    dev = _scene_device(scene)
    total_work = n_pix * samples
    b = lanes
    frame_pix = width * height
    core, _ = _make_bounce_core(cfg, scene, seed32, plain)

    def wid_of(work):
        return (samp_base + work // n_pix) * frame_pix + pix_base + work % n_pix

    # refill threshold: rounds price the full lane batch, so refilling at
    # 1/8 dead keeps occupancy near 94 % at the cost of a cumsum, a
    # flush and the camera math per refill (the JAX package's default)
    frac = float(os.environ.get("RT_WF_REFILL_FRAC", "0.125"))
    thresh = max(int(b * frac), 1)

    state = _initial_state(B.N_STATE, b, dev)
    work = torch.full((b,), -1, dtype=torch.int64, device=dev)
    depth = torch.zeros((b,), dtype=torch.int32, device=dev)
    # column w holds work item w's radiance; columns total_work + l take
    # lane l's writes while it holds no finished item (the JAX package's
    # mode="drop"): every column is written by one lane, so the writes are
    # plain stores, in no order that could change a sum
    done = torch.zeros((3, total_work + b), dtype=torch.float32, device=dev)
    drop = total_work + torch.arange(b, dtype=torch.int64, device=dev)
    counter = nverts = rounds = 0
    while True:
        alive = state[12] > 0.5
        n_dead = b - int(alive.sum())  # the one host read per round
        if counter >= total_work and n_dead == b:
            break
        n_take = 0
        if n_dead >= thresh:  # flush dead lanes' radiance, hand out fresh work
            dead = ~alive
            done.index_copy_(1, torch.where(dead & (work >= 0), work, drop), state[9:12])
            state[9:12] = torch.where(dead, 0.0, state[9:12])
            new_id = counter + torch.cumsum(dead, 0) - 1
            take = dead & (new_id < total_work)
            work = torch.where(take, new_id, torch.where(dead, -1, work))
            n_take = min(n_dead, total_work - counter)
            counter += n_take
            w = work.clamp(min=0)
            pixg = pix_base + w % n_pix
            rays = _camera_rows(cam, pixg % width, torch.clamp(pixg // width, max=height - 1),
                                width, height, work_key(seed32, wid_of(w)))
            _restart_rows(state, take, rays)
            depth = torch.where(take, 0, depth)
        nverts += b - n_dead + n_take
        state = core(state, wid_of(work.clamp(min=0)).to(torch.int32), depth)
        depth = depth + 1
        rounds += 1
    return _wf_finish(state, work, done, drop, n_pix, samples), float(nverts), rounds


def _wf_finish(state, work, done, drop, n_pix: int, samples: int) -> torch.Tensor:
    """Final flush: the loop exits with work exhausted and no lane alive,
    but the last completions still hold their radiance in-lane. Then the
    mean over the samples, summed in sample order."""
    done.index_copy_(1, torch.where(work >= 0, work, drop), state[9:12])
    return done[:, :n_pix * samples].reshape(3, samples, n_pix).sum(dim=1) * (1.0 / samples)


def render_wavefront_sticky(seed32: int, pix_base: int, samp_base: int, cam: CameraArrays,
                            scene, cfg: TraceConfig, width: int, height: int, n_pix: int,
                            samples: int, lanes: int, plain: bool = False):
    """Pixel-sticky engine: lane ``l`` owns pixels ``{l, l + lanes, ...}``
    and walks each owned pixel's ``samples`` paths in turn, accumulating
    radiance in place, with no rank, no scatter and no cross-lane
    coordination. Returns ((3, n_pix) mean radiance, path vertices, rounds),
    as ``render_wavefront`` does, from the same work-item streams.

    When the fused gate passes and ``n_pix <= lanes``, each round is one K5
    launch on ``n_pix`` lanes (``_sticky_fused``); otherwise each round is a
    torch restart and one bounce (K1 in lane mode, or the XLA core)."""
    b = lanes
    core, fused = _make_bounce_core(cfg, scene, seed32, plain)
    if fused and n_pix <= b:
        return _sticky_fused(seed32, pix_base, samp_base, cam, scene, cfg, width, height,
                             n_pix, samples, plain)
    dev = _scene_device(scene)
    jmax = max(-(-n_pix // b), 1)  # owned pixels per lane (ceil)
    frame_pix = width * height
    lane = torch.arange(b, dtype=torch.int64, device=dev)
    kmax = sum((lane + j * b < n_pix).to(torch.int64) for j in range(jmax)) * samples

    def path_coords(k):
        """Current path (k - 1 for started paths) -> (owned slot, pixel, sample)."""
        cur = torch.clamp(k - 1, min=0)
        j = cur // samples
        return j, torch.clamp(lane + j * b, max=n_pix - 1), cur % samples

    def wid_of(pixl, samp):
        return (samp_base + samp) * frame_pix + pix_base + pixl

    state = _initial_state(B.N_STATE, b, dev)
    k = torch.zeros((b,), dtype=torch.int64, device=dev)
    depth = torch.zeros((b,), dtype=torch.int32, device=dev)
    acc = torch.zeros((3, jmax * b), dtype=torch.float32, device=dev)  # slot j * b + l

    def restart(state, k, depth):
        """Flush dead lanes' finished paths, start their next sample."""
        dead = state[12] < 0.5
        slot = path_coords(k)[0] * b + lane  # distinct per lane: the sum order is fixed
        acc.index_add_(1, slot, torch.where(dead & (k > 0), state[9:12], 0.0))
        state[9:12] = torch.where(dead, 0.0, state[9:12])
        take = dead & (k < kmax)
        k = torch.where(take, k + 1, k)
        _, pixl, samp = path_coords(k)
        pixg = pix_base + pixl
        rays = _camera_rows(cam, pixg % width, torch.clamp(pixg // width, max=height - 1),
                            width, height, work_key(seed32, wid_of(pixl, samp)))
        _restart_rows(state, take, rays)
        return state, k, torch.where(take, 0, depth)

    nverts = torch.zeros((), dtype=torch.int64, device=dev)
    rounds = 0
    while bool(((state[12] > 0.5) | (k < kmax)).any()):  # the one host read per round
        state, k, depth = restart(state, k, depth)
        nverts += (state[12] > 0.5).sum()
        _, pixl, samp = path_coords(k)
        state = core(state, wid_of(pixl, samp).to(torch.int32), depth)
        depth = depth + 1
        rounds += 1
    restart(state, k, depth)  # final flush: the last paths are still in-lane
    return acc[:, :n_pix] * (1.0 / samples), float(nverts), rounds


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
