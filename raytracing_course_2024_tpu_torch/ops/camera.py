"""Camera ray generation (reference src/rendering.rs:71-84).

    px = (2 (x + u) / w - 1) *  tan(fov_x / 2)
    py = -(2 (y + v) / h - 1) * tan(fov_y / 2)
    dir = normalize(px * right + py * up + forward)

with u, v ~ U(0, 1) jitter -- the JAX package's ``ops/camera.py``. The
camera basis is kept as float32 numpy values: each enters the lane math as
a scalar constant.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..scene.types import CameraDesc
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
