"""Camera ray generation (reference src/rendering.rs:71-84).

    px = (2 (x + u) / w - 1) *  tan(fov_x / 2)
    py = -(2 (y + v) / h - 1) * tan(fov_y / 2)
    dir = normalize(px * right + py * up + forward)

with u, v ~ U(0, 1) jitter -- the JAX package's ``ops/camera.py``. The
camera basis is kept as float32 numpy values: each enters the lane math as
a scalar constant.

The modular route's camera stage is the hand-written CUDA kernel N4
(``csrc/camera.cu``) and its plain version: ``camera_state`` /
``camera_state_plain`` give the (13, B) state of fresh paths on their
jittered rays, keyed by the counter RNG (``ops/rng.py``: draws
``CTR_JITTER`` and ``CTR_JITTER + 1`` of ``work_key(seed, wid +
wid_off)``). The JAX package computes the same inside its jitted sample
scan (``integrator/path.py:490`` calls ``generate_rays``; ``trace_paths``
builds the state at ``:304-312``), where XLA fuses it into one pass. The
wrapper runs the plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises, and counts the launch in
``ops/kernels.py:LAUNCHES`` (``"camera"``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..scene.types import CameraDesc
from .kernels import check, launch_camera
from .rng import CTR_JITTER, offset_ids, seed_off, uniform_ctr, work_key
from .vec import Vec3, true_div


class CameraArrays(NamedTuple):
    position: np.ndarray  # (3,) f32
    right: np.ndarray
    up: np.ndarray
    forward: np.ndarray
    tan_half_fov_x: np.float32
    tan_half_fov_y: np.float32


def camera_arrays(cam: CameraDesc) -> CameraArrays:
    def f3(v):
        return np.asarray(v, np.float64).astype(np.float32)

    return CameraArrays(
        position=f3(cam.position),
        right=f3(cam.right),
        up=f3(cam.up),
        forward=f3(cam.forward),
        tan_half_fov_x=np.float32(math.tan(cam.fov_x * 0.5)),
        tan_half_fov_y=np.float32(math.tan(cam.fov_y * 0.5)),
    )


def generate_rays_u(cam: CameraArrays, px: torch.Tensor, py: torch.Tensor,
                    width: int, height: int, u0: torch.Tensor,
                    u1: torch.Tensor):
    """Jittered pinhole rays from caller-supplied draws. Returns
    (origin Vec3 (B,), unit direction Vec3 (B,))."""
    real_x = px.to(torch.float32) + u0
    real_y = py.to(torch.float32) + u1
    sx = (true_div(2.0 * real_x, width) - 1.0) * cam.tan_half_fov_x
    sy = -(true_div(2.0 * real_y, height) - 1.0) * cam.tan_half_fov_y

    def axis(i):
        return sx * cam.right[i] + sy * cam.up[i] + cam.forward[i]

    d = Vec3(axis(0), axis(1), axis(2)).normalize()
    zero = d.x * 0.0
    o = Vec3(zero + cam.position[0], zero + cam.position[1],
             zero + cam.position[2])
    return o, d


# camera row layout of the primary-bounce kernel: (128,) f32
CAM_POS = 0  # 0-2 position
CAM_RIGHT = 3  # 3-5
CAM_UP = 6  # 6-8
CAM_FWD = 9  # 9-11
CAM_TANX = 12
CAM_TANY = 13


def pack_camera_row(cam: CameraArrays) -> np.ndarray:
    """CameraArrays -> (1, 128) f32 row, the JAX package's layout."""
    row = np.zeros((128,), np.float32)
    row[CAM_POS:CAM_POS + 3] = cam.position
    row[CAM_RIGHT:CAM_RIGHT + 3] = cam.right
    row[CAM_UP:CAM_UP + 3] = cam.up
    row[CAM_FWD:CAM_FWD + 3] = cam.forward
    row[CAM_TANX] = cam.tan_half_fov_x
    row[CAM_TANY] = cam.tan_half_fov_y
    return row[None, :]


def camera_from_row(row) -> CameraArrays:
    """Inverse of ``pack_camera_row`` (row: 128 floats, any array or tensor)."""
    r = np.asarray(row.cpu() if isinstance(row, torch.Tensor) else row,
                   np.float32).reshape(-1)
    return CameraArrays(
        position=r[CAM_POS:CAM_POS + 3], right=r[CAM_RIGHT:CAM_RIGHT + 3],
        up=r[CAM_UP:CAM_UP + 3], forward=r[CAM_FWD:CAM_FWD + 3],
        tan_half_fov_x=r[CAM_TANX], tan_half_fov_y=r[CAM_TANY],
    )


def camera_state_plain(seed, wid: torch.Tensor, wid_off, px: torch.Tensor, py: torch.Tensor,
                       cam: CameraArrays, width: int, height: int) -> torch.Tensor:
    """Plain version of ``camera_state``: the (13, B) f32 state of fresh
    paths, the ray origin (rows 0-2) and unit direction (3-5) through pixel
    (px, py) jittered by draws ``CTR_JITTER`` and ``CTR_JITTER + 1`` of
    ``work_key(seed, wid + wid_off)``, throughput 1 (6-8), radiance 0
    (9-11), alive 1 (12). ``seed`` and ``wid_off`` are ints or 0-dim int64
    tensors on the lanes' device, read there. The zero and the one derive
    from the origin's x, as the JAX package's ``trace_paths`` derives them
    (a zero's sign follows it)."""
    key = work_key(seed, offset_ids(wid, wid_off))
    ro, rd = generate_rays_u(cam, px, py, width, height, uniform_ctr(key, CTR_JITTER),
                             uniform_ctr(key, CTR_JITTER + 1))
    zero = ro.x * 0.0
    one = zero + 1.0
    return torch.stack([*ro, *rd, one, one, one, zero, zero, zero, one])


def camera_state(seed, wid: torch.Tensor, wid_off, px: torch.Tensor, py: torch.Tensor,
                 cam: CameraArrays, cam_row: torch.Tensor | None, width: int, height: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """N4 for tensors on CUDA, its plain version for tensors on the CPU;
    arguments as ``camera_state_plain``'s, the camera also as its (128,) f32
    row on the lanes' device (``pack_camera_row``), which the kernel reads.
    Writes the state into ``out`` (13, B) when given. On the card the seed
    and the work-id offset reach the kernel as a (2,) int64 device pair
    (``ops/rng.py:seed_off``), so a captured CUDA graph replays the launch
    for any sample."""
    dev = px.device
    if dev.type == "cpu":
        res = camera_state_plain(seed, wid, wid_off, px, py, cam, width, height)
        if out is None:
            return res
        return out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"no camera kernel for device {dev}")
    b = px.shape[0]
    check("px", px, torch.float32, (b,), dev)
    check("py", py, torch.float32, (b,), dev)
    check("wid", wid, torch.int32, (b,), dev)
    if cam_row is None:
        raise ValueError("N4 reads the camera as its (128,) row on the lanes' device (cam_row)")
    check("cam_row", cam_row, torch.float32, (128,), dev)
    if out is None:
        out = torch.empty((13, b), dtype=torch.float32, device=dev)
    check("out", out, torch.float32, (13, b), dev)
    pair = seed_off(seed, wid_off, dev)
    check("seed_off", pair, torch.int64, (2,), dev)
    launch_camera(px, py, wid, pair, cam_row, width, height, out)
    return out
