"""The pixel-sticky engine's persistent round: the hand-written CUDA kernel K5
and its plain PyTorch version.

Port of the JAX package's ``ops/pallas_bounce.py:_persistent_kernel`` (via
``_run_persistent``, API ``persistent_round``). Lane ``l`` owns pixel
``pix_base + l`` and walks its ``kmax[l]`` paths one after another; one
round, per lane:

1. flush: a dead lane with ``k > 0`` adds its path radiance to ``acc``;
2. restart: a dead lane with ``k < kmax`` starts path ``k`` (``k += 1``,
   depth 0, throughput 1);
3. the work key of path (pixel, sample ``samp_base + k - 1``), after the
   restart;
4. camera jitter from draws 0 and 1 of that key, the pinhole ray;
5. the fused bounce (``ops/bounce.py:_bounce_math``, K1's body) at the
   lane's own depth, in the lane engines' draw layout (``ops/rng.py``);
6. the depth cap ``alive' = alive' & depth < ray_depth - 1``, depth + 1.

State: one (18, B) float32 tensor, rows ro3, rd3, thr3, rad3, alive, k,
depth, acc3 (the JAX order; rows 0-12 are K1's state). Each round also
counts the lanes alive after the restart (path vertices) and the lanes
still alive or with paths left (the loop runs while that is > 0), and ends
with the loop's round test on those counts (``ops/loop.py:k5_round_plain``,
into a ``LoopState``). The seed and the offsets are read on the device
(``ids``), so that a captured graph of the round serves every frame.

``persistent_round`` runs the plain version only for tensors on the CPU. On
a CUDA tensor it launches ``csrc/persistent.cu`` or raises, and counts the
launch in ``ops/kernels.py:LAUNCHES["persistent"]``.
"""

from __future__ import annotations

import torch

from .bounce import BounceScene, _bounce_math, check_scene
from .camera import camera_from_row, generate_rays_u
from .kernels import check, launch_persistent
from .loop import LoopState, check_state, k5_round_plain
from .rng import CTR_JITTER, WF_STRIDE, lane_ctr, uniform_ctr, work_key
from .vec import Vec3, where3

N_PSTATE = 18
S_ALIVE, S_K, S_DEPTH, S_ACC = 12, 13, 14, 15


def persistent_plain(scene: BounceScene, cam_row: torch.Tensor, px: torch.Tensor,
                     py: torch.Tensor, kmax: torch.Tensor, state: torch.Tensor,
                     seed: int, frame_pix: int, pix_base: int, samp_base: int,
                     bg: tuple, max_tries: int, ray_depth: int, width: int,
                     height: int):
    """Plain version of ``persistent_round``. Returns (new (18, B) state,
    lanes alive after the restart, lanes with work left), the counts as
    0-dim int64 tensors."""
    s = state
    ro, rd = Vec3(s[0], s[1], s[2]), Vec3(s[3], s[4], s[5])
    thr, rad = Vec3(s[6], s[7], s[8]), Vec3(s[9], s[10], s[11])
    alive, k, depth = s[S_ALIVE] > 0.5, s[S_K], s[S_DEPTH]
    acc = Vec3(s[S_ACC], s[S_ACC + 1], s[S_ACC + 2])

    dead = ~alive
    acc = where3(dead & (k > 0.5), acc + rad, acc)
    zero = k * 0.0
    rad = where3(dead, Vec3(zero, zero, zero), rad)
    take = dead & (k < kmax)
    k = torch.where(take, k + 1.0, k)
    depth = torch.where(take, zero, depth)
    one = zero + 1.0
    thr = where3(take, Vec3(one, one, one), thr)

    lane = torch.arange(k.shape[0], dtype=torch.int64, device=k.device)
    samp = torch.clamp(k - 1.0, min=0.0).to(torch.int64)
    key = work_key(seed, (samp_base + samp) * frame_pix + pix_base + lane)
    o, d = generate_rays_u(camera_from_row(cam_row), px, py, width, height,
                           uniform_ctr(key, CTR_JITTER), uniform_ctr(key, CTR_JITTER + 1))
    ro, rd = where3(take, o, ro), where3(take, d, rd)
    alive = alive | take

    point, l, thr, rad, new_alive = _bounce_math(
        scene, max_tries, bg, lambda c: uniform_ctr(key, c), lane_ctr(depth, max_tries),
        ro, rd, thr, rad, alive,
    )
    cont = new_alive & (depth < float(ray_depth - 1))
    out = torch.stack([*point, *l, *thr, *rad, cont.to(torch.float32), k, depth + 1.0, *acc])
    return out, alive.sum(), (cont | (k < kmax)).sum()


def ids(seed: int, pix_base: int, samp_base: int, dev) -> torch.Tensor:
    """(seed, pix_base, samp_base) as the (3,) int64 tensor on ``dev`` that
    ``persistent_round`` reads."""
    return torch.tensor([seed, pix_base, samp_base], dtype=torch.int64, device=dev)


def persistent_round(scene: BounceScene, cam_row: torch.Tensor, px: torch.Tensor,
                     py: torch.Tensor, kmax: torch.Tensor, state: torch.Tensor, ls: LoopState,
                     sb: torch.Tensor, frame_pix: int, bg: tuple, max_tries: int,
                     ray_depth: int, width: int, height: int,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """One round of the (18, B) state, its two counts (lanes alive after the
    restart, lanes with work left) written into ``ls`` as the round test
    (``ops/loop.py:k5_round_plain``). ``sb`` is the (3,) int64 tensor
    (seed, pix_base, samp_base, ``ids``) on the state's device. Returns
    the new state.

    On CUDA, ``out`` may be ``state`` itself: one thread reads a lane and
    then writes it (the JAX kernel aliased its 18 inputs to its
    outputs)."""
    if state.device.type == "cpu":
        res, live, more = persistent_plain(scene, cam_row, px, py, kmax, state, sb[0],
                                           frame_pix, sb[1], sb[2], bg, max_tries, ray_depth,
                                           width, height)
        k5_round_plain(ls, live, more)
        if out is None:
            return res
        out.copy_(res)
        return out
    if state.device.type != "cuda":
        raise ValueError(f"no persistent kernel for device {state.device}")
    b = state.shape[1]
    dev = state.device
    check("state", state, torch.float32, (N_PSTATE, b), dev)
    for name, t in (("px", px), ("py", py), ("kmax", kmax)):
        check(name, t, torch.float32, (b,), dev)
    check("cam_row", cam_row, torch.float32, (128,), dev)
    check("sb", sb, torch.int64, (3,), dev)
    check_state(ls, dev)
    check_scene(scene, dev)
    if out is None:
        out = torch.empty_like(state)
    check("out", out, torch.float32, (N_PSTATE, b), dev)
    launch_persistent(scene, state, out, px, py, kmax, cam_row, width, height, sb, frame_pix,
                      lane_ctr(0, max_tries), WF_STRIDE, ray_depth, bg, max_tries, ls.loop,
                      ls.preds, ls.scratch)
    return out
