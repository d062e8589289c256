"""The lane engines' refill and restart: the hand-written CUDA kernels N2a
and N2b (``csrc/refill.cu``) and their plain PyTorch versions.

Neither has a Pallas source. The JAX package runs each lane engine as one
``lax.while_loop`` under ``jax.jit`` and XLA fuses the element-wise work of
its body: the counter wavefront's ``refill`` and the sticky engine's
``restart`` (``raytracing_course_2024_tpu/integrator/wavefront.py:236-274``
and ``:455-500``). Here that work is one kernel each, called from the
round bodies of ``integrator/wavefront.py`` (``RefillBody``,
``StickyBody``):

* ``refill`` (N2a): the dead lanes' radiance flushed into the columns of
  their work items, their radiance zeroed, the next work items handed to
  them in lane order (the JAX ``cumsum``; the counter moves on by the items
  handed out), every lane's int32 work id written, and the taken lanes
  started on their pixel's jittered camera ray at depth 0; one launch, the
  rank across tiles by a decoupled look-back over ``refill_scan``'s status
  words;
* ``restart`` (N2b): each lane's finished path added into its owned slot of
  ``acc``, a dead lane's radiance zeroed and, with paths left (``k <
  kmax``, the kernel computing ``kmax`` from the lane index as
  ``sticky_kmax`` does), its next path started; every lane's work id
  written.

Both update their buffers in place and equal their plain versions bit for
bit. The plain versions are the bodies' torch code, moved here unchanged.
They read the seed and the pass's ``(pix_base, samp_base)`` from the
device as the kernels do, so one captured graph serves every pass.

A wrapper runs the plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises, and counts the launch in
``ops/kernels.py:LAUNCHES`` (``"refill"``, ``"restart"``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import CameraArrays, generate_rays_u
from .kernels import check, launch_refill, launch_restart
from .rng import CTR_JITTER, uniform_ctr, work_key

# lanes per tile of N2a's rank (csrc/refill.cu: kTileLanes); its launcher
# refuses a scan shorter than 1 + tiles
REFILL_TILE_LANES = 2048


class LaneFrame(NamedTuple):
    """What a refill or a restart reads of the frame: the camera (host
    values for the plain versions, its (128,) f32 row on the lanes' device
    for the kernels, ``ops/camera.py:pack_camera_row``), the frame's size
    and the pass's pixels and samples per pixel."""

    cam: CameraArrays
    cam_row: torch.Tensor
    width: int
    height: int
    n_pix: int
    samples: int

    def wid_of(self, bases: torch.Tensor, pixl, samp):
        """(pixel ``pixl`` of the pass, sample ``samp``) -> int64 work id."""
        return (bases[1] + samp) * (self.width * self.height) + bases[0] + pixl

    def pixel_rays(self, bases: torch.Tensor, pixl, key) -> torch.Tensor:
        """``camera_rows`` through pixel ``pixl`` of the pass."""
        pixg = bases[0] + pixl
        w, h = self.width, self.height
        return camera_rows(self.cam, pixg % w, torch.clamp(pixg // w, max=h - 1), w, h, key)


def camera_rows(cam: CameraArrays, px, py, width: int, height: int, key) -> torch.Tensor:
    """(6, B) jittered camera rays (ro3, rd3) from draws 0 and 1 of ``key``."""
    o, d = generate_rays_u(cam, px, py, width, height, uniform_ctr(key, CTR_JITTER),
                           uniform_ctr(key, CTR_JITTER + 1))
    return torch.stack([*o, *d])


def restart_rows(state: torch.Tensor, take: torch.Tensor, rays: torch.Tensor) -> None:
    """Lanes in ``take`` start a fresh path on ``rays`` (in place)."""
    state[0:6] = torch.where(take, rays, state[0:6])
    state[6:9] = torch.where(take, 1.0, state[6:9])
    state[12] = torch.where(take, 1.0, state[12])


def refill_plain(state, work, counter, done, depth, wid, seed_off, bases,
                 frame: LaneFrame) -> None:
    """Plain version of ``refill``. ``state`` the (13, B) path state,
    ``work`` each lane's int64 work item (-1 for none), ``counter`` the
    0-dim int64 count of items handed out, in [0, total], ``done`` (3,
    total + B): column ``w`` holds item ``w``'s radiance, column ``total +
    l`` takes lane ``l``'s write while it holds no finished item (the JAX
    package's ``mode="drop"``), ``depth`` and ``wid`` int32, ``seed_off``
    the (2,) int64 (seed, 0), ``bases`` the (2,) int64 (pix_base,
    samp_base)."""
    total = frame.n_pix * frame.samples
    dead = state[12] < 0.5
    drop = total + torch.arange(state.shape[1], dtype=torch.int64, device=state.device)
    done.index_copy_(1, torch.where(dead & (work >= 0), work, drop), state[9:12])
    state[9:12] = torch.where(dead, 0.0, state[9:12])
    new_id = counter + torch.cumsum(dead, 0) - 1
    take = dead & (new_id < total)
    work.copy_(torch.where(take, new_id, torch.where(dead, -1, work)))
    counter += torch.minimum(dead.sum(), total - counter)
    w = work.clamp(min=0)
    wid64 = frame.wid_of(bases, w % frame.n_pix, w // frame.n_pix)
    rays = frame.pixel_rays(bases, w % frame.n_pix, work_key(seed_off[0], wid64))
    restart_rows(state, take, rays)
    depth.copy_(torch.where(take, 0, depth))
    wid.copy_(wid64.to(torch.int32))


def refill(state, work, counter, done, depth, wid, seed_off, bases, frame: LaneFrame,
           scan: torch.Tensor | None = None) -> None:
    """N2a for tensors on CUDA, its plain version for tensors on the CPU;
    arguments as ``refill_plain``'s. ``scan`` is the kernel's scratch,
    ``refill_scan(lanes)``, made once by a caller that refills again and
    again (a graph replays its launches); the CPU needs none."""
    dev = state.device
    if dev.type == "cpu":
        refill_plain(state, work, counter, done, depth, wid, seed_off, bases, frame)
        return
    if dev.type != "cuda":
        raise ValueError(f"no refill kernel for device {dev}")
    b = state.shape[1]
    total = frame.n_pix * frame.samples
    _check_lanes(state, depth, wid, seed_off, bases, frame, dev)
    check("work", work, torch.int64, (b,), dev)
    check("counter", counter, torch.int64, (), dev)
    check("done", done, torch.float32, (3, done.shape[1]), dev)
    if done.shape[1] < total:
        raise ValueError(f"done has {done.shape[1]} columns, the pass has {total} work items")
    if scan is None:
        raise ValueError("N2a needs its scan (refill_scan)")
    check("scan", scan, torch.int64, (1 + -(-b // REFILL_TILE_LANES),), dev)
    launch_refill(state, work, counter, done, depth, wid, seed_off, frame.cam_row, bases,
                  frame.n_pix, frame.samples, frame.width, frame.height, scan)


def refill_scan(lanes: int, device) -> torch.Tensor:
    """N2a's scratch for ``lanes`` lanes, zero: a ticket that every tile of
    every launch counts up (tile = ticket % tiles, epoch = ticket / tiles)
    and one status word per tile (flag, epoch, dead lanes so far). A launch
    leaves it ready for the next: the words of an earlier epoch read as not
    ready, so it is made once and never reset."""
    n = 1 + -(-lanes // REFILL_TILE_LANES)
    return torch.zeros((n,), dtype=torch.int64, device=device)


def path_coords(k: torch.Tensor, lane: torch.Tensor, samples: int, n_pix: int):
    """The sticky engine's current path (k - 1 for a started one) -> (owned
    slot j, pixel of the pass, sample); lane ``l`` owns pixels ``l, l + B,
    ...``."""
    cur = torch.clamp(k - 1, min=0)
    j = cur // samples
    return j, torch.clamp(lane + j * lane.shape[0], max=n_pix - 1), cur % samples


def sticky_kmax(lanes: int, n_pix: int, samples: int, device) -> torch.Tensor:
    """(lanes,) int64: the paths lane ``l`` of the sticky engine owns,
    ``samples`` times its pixels ``l + j * lanes < n_pix``, i.e. ``samples *
    ((n_pix - 1 - l) // lanes + 1)`` for ``l < n_pix`` and 0 past them; N2b
    computes the same from the lane index."""
    lane = torch.arange(lanes, dtype=torch.int64, device=device)
    return torch.where(lane < n_pix, ((n_pix - 1 - lane) // lanes + 1) * samples, 0)


def restart_plain(state, k, kmax, depth, wid, acc, seed_off, bases, frame: LaneFrame) -> None:
    """Plain version of ``restart``. ``state`` the (13, B) path state, ``k``
    and ``kmax`` each lane's int64 paths started and owned (``kmax`` as
    ``sticky_kmax`` makes it), ``depth`` and ``wid`` int32, ``acc`` (3, jmax
    * B) the radiance slots (slot ``j * B + l``: lane ``l``'s ``j``-th
    pixel), ``seed_off`` and ``bases`` as ``refill_plain`` takes them."""
    lane = torch.arange(state.shape[1], dtype=torch.int64, device=state.device)
    dead = state[12] < 0.5
    slot = path_coords(k, lane, frame.samples, frame.n_pix)[0] * lane.shape[0] + lane
    acc.index_add_(1, slot, torch.where(dead & (k > 0), state[9:12], 0.0))
    state[9:12] = torch.where(dead, 0.0, state[9:12])
    take = dead & (k < kmax)
    k.copy_(torch.where(take, k + 1, k))
    _, pixl, samp = path_coords(k, lane, frame.samples, frame.n_pix)
    wid64 = frame.wid_of(bases, pixl, samp)
    rays = frame.pixel_rays(bases, pixl, work_key(seed_off[0], wid64))
    restart_rows(state, take, rays)
    depth.copy_(torch.where(take, 0, depth))
    wid.copy_(wid64.to(torch.int32))


def restart(state, k, kmax, depth, wid, acc, seed_off, bases, frame: LaneFrame) -> None:
    """N2b for tensors on CUDA, its plain version for tensors on the CPU;
    arguments as ``restart_plain``'s. The kernel does not read ``kmax``: it
    computes each lane's from its index, as ``sticky_kmax`` does."""
    dev = state.device
    if dev.type == "cpu":
        restart_plain(state, k, kmax, depth, wid, acc, seed_off, bases, frame)
        return
    if dev.type != "cuda":
        raise ValueError(f"no restart kernel for device {dev}")
    b = state.shape[1]
    _check_lanes(state, depth, wid, seed_off, bases, frame, dev)
    check("k", k, torch.int64, (b,), dev)
    jmax = max(-(-frame.n_pix // b), 1)
    check("acc", acc, torch.float32, (3, jmax * b), dev)
    launch_restart(state, k, depth, wid, acc, seed_off, frame.cam_row, bases,
                   frame.n_pix, frame.samples, frame.width, frame.height)


def _check_lanes(state, depth, wid, seed_off, bases, frame: LaneFrame, dev) -> None:
    b = state.shape[1]
    check("state", state, torch.float32, (13, b), dev)
    check("depth", depth, torch.int32, (b,), dev)
    check("wid", wid, torch.int32, (b,), dev)
    check("seed_off", seed_off, torch.int64, (2,), dev)
    check("bases", bases, torch.int64, (2,), dev)
    check("cam_row", frame.cam_row, torch.float32, (128,), dev)
