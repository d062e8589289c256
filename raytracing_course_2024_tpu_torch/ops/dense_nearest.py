"""Dense triangle nearest-hit: the hand-written CUDA kernel K4 and its plain
PyTorch version.

Port of the JAX package's ``ops/pallas_intersect.py`` (``_kernel`` via
``pallas_dense_nearest``): for each ray the nearest Moller-Trumbore hit
with t > tmin over the N <= 128 triangles of a (9, N) ``[a, e1, e2]`` pack
(``scene/build.py:prepare_tri_pack``). Returns (t (B,) f32, +inf on a
miss; idx (B,) i32, 0 on a miss).

``dense_nearest_plain`` follows the TPU kernel's arithmetic, not the
sweep's ``ray_triangle``: it multiplies by ``1 / det`` (guarded at 1e-30),
tests ``u + v <= 1``, and keeps a hit only if ``t < best_t``, so the
lowest index wins a tie.

``live`` (optional, (B,) bool; ``None`` = every lane, as the JAX API) names
the lanes whose hit the caller will read: a lane whose flag is False gets
the miss ``(inf, 0)``, from the kernel without walking the triangles. The
integrators pass the paths' alive mask.

``dense_nearest`` runs the plain version only for tensors on the CPU; on a
CUDA tensor it launches ``csrc/dense_nearest.cu`` or raises, and counts
the launch in ``ops/kernels.py:LAUNCHES["nearest"]``. The kernel's loop
reads the triangles as entry-major records (``build_tri_records``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.build import MAX_PRIMS  # the kernel stages every record in shared memory
from .kernels import check, launch_dense_nearest
from .vec import Vec3

REC_FLOATS = 12  # one record: three float4


def build_tri_records(tri_pack: np.ndarray) -> np.ndarray:
    """(N, 12) f32 records of the kernel's loop from the (9, N) ``[a, e1,
    e2]`` pack: per triangle ``(a, 0) (e1, 0) (e2, 0)``, three float4 that
    the kernel reads with three 16-byte loads. The values are the pack's."""
    tri = np.asarray(tri_pack, np.float32)
    if tri.ndim != 2 or tri.shape[0] != 9:
        raise ValueError(f"tri_pack has shape {tri.shape}, expected (9, N)")
    rec = np.zeros((tri.shape[1], 3, 4), np.float32)
    rec[:, :, :3] = tri.T.reshape(-1, 3, 3)
    return np.ascontiguousarray(rec.reshape(-1, REC_FLOATS))


def dense_nearest_plain(ro: Vec3, rd: Vec3, tri_pack: torch.Tensor,
                        tmin: float = 0.0, live: torch.Tensor | None = None):
    """Plain version of ``dense_nearest``, one triangle at a time."""
    tri = tri_pack.detach().cpu().numpy()  # per-triangle scalar constants
    ox, oy, oz = ro
    dx, dy, dz = rd
    best_t = torch.full_like(ox, float("inf"))
    best_i = torch.zeros(ox.shape, dtype=torch.int32, device=ox.device)
    for i in range(tri.shape[1]):
        ax, ay, az = tri[0, i], tri[1, i], tri[2, i]
        e1x, e1y, e1z = tri[3, i], tri[4, i], tri[5, i]
        e2x, e2y, e2z = tri[6, i], tri[7, i], tri[8, i]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        det_ok = torch.abs(det) > 1e-30
        inv_det = 1.0 / torch.where(det_ok, det, 1e-30)
        tvx, tvy, tvz = ox - ax, oy - ay, oz - az
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & det_ok & (t > tmin)
              & (t < best_t))
        best_t = torch.where(ok, t, best_t)
        best_i = torch.where(ok, i, best_i)
    if live is not None:
        best_t = torch.where(live, best_t, float("inf"))
        best_i = torch.where(live, best_i, 0)
    return best_t, best_i


def dense_nearest(ro: Vec3, rd: Vec3, tri_pack: torch.Tensor,
                  tmin: float = 0.0, live: torch.Tensor | None = None,
                  records: torch.Tensor | None = None):
    """Nearest triangle hit per ray: (t, idx). ``records`` are
    ``build_tri_records(tri_pack)`` on the rays' device; a caller that holds
    them (``ModularScene.tri_rec``) saves the kernel route building them."""
    dev = ro.x.device
    if dev.type == "cpu":
        return dense_nearest_plain(ro, rd, tri_pack, tmin, live)
    if dev.type != "cuda":
        raise ValueError(f"no dense_nearest kernel for device {dev}")
    b = ro.x.shape[0]
    rays = (*ro, *rd)
    for name, c in zip(("ro.x", "ro.y", "ro.z", "rd.x", "rd.y", "rd.z"), rays):
        check(name, c, torch.float32, (b,), dev)
    n = tri_pack.shape[1]
    if not 1 <= n <= MAX_PRIMS:
        raise ValueError(f"tri_pack has {n} triangles, the kernel takes 1..{MAX_PRIMS}")
    check("tri_pack", tri_pack, torch.float32, (9, n), dev)
    if records is None:
        records = torch.from_numpy(build_tri_records(tri_pack.cpu().numpy())).to(dev)
    check("records", records, torch.float32, (n, REC_FLOATS), dev)
    if live is not None:
        check("live", live, torch.bool, (b,), dev)
    t = torch.empty((b,), dtype=torch.float32, device=dev)
    idx = torch.empty((b,), dtype=torch.int32, device=dev)
    launch_dense_nearest(rays, records, tmin, live, t, idx)
    return t, idx
