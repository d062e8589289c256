"""Ray-shape intersection math of the light pdf (``ops/sampling.py``) and
the modular dense path (``ops/scene_intersect.py``).

Port of the JAX package's ``ops/intersect.py``: box and ellipsoid
intervals and normals, the Moller-Trumbore triangle test, the plane test,
and the world<->local transforms. Every function broadcasts its ``Vec3``
components, so a per-light scalar (numpy float32) table entry combines with
(B,) ray tensors, and (B, 1) rays with (1, N) table rows give (B, N).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vec import Quat, Vec3, true_div, where3

INF = float("inf")
EPS = 1e-4  # f32 retune of the reference's EPS=1e-5
DIR_BIAS = 1e-9  # slab-test direction bias


class Interval(NamedTuple):
    """Entry/exit parameters of a ray vs a closed shape (2 roots max)."""

    t1: torch.Tensor
    t2: torch.Tensor
    valid: torch.Tensor


def ray_box_interval(ro: Vec3, rd: Vec3, s: Vec3) -> Interval:
    """Centered box with half-extents s."""
    inv = Vec3(
        1.0 / (rd.x + DIR_BIAS), 1.0 / (rd.y + DIR_BIAS), 1.0 / (rd.z + DIR_BIAS)
    )
    ax = (-s.x - ro.x) * inv.x
    bx = (s.x - ro.x) * inv.x
    ay = (-s.y - ro.y) * inv.y
    by = (s.y - ro.y) * inv.y
    az = (-s.z - ro.z) * inv.z
    bz = (s.z - ro.z) * inv.z
    t1 = torch.maximum(
        torch.minimum(ax, bx),
        torch.maximum(torch.minimum(ay, by), torch.minimum(az, bz)),
    )
    t2 = torch.minimum(
        torch.maximum(ax, bx),
        torch.minimum(torch.maximum(ay, by), torch.maximum(az, bz)),
    )
    return Interval(t1, t2, t1 <= t2)


def box_normal(p_local: Vec3, s: Vec3, eps: float = EPS) -> Vec3:
    """Face normal from a point on the box surface (EPS-compare chain)."""
    on_x = (s.x - torch.abs(p_local.x)) < eps
    on_y = (s.y - torch.abs(p_local.y)) < eps
    zero = torch.zeros_like(p_local.x)
    nx = Vec3(torch.sign(p_local.x), zero, zero)
    ny = Vec3(zero, torch.sign(p_local.y), zero)
    nz = Vec3(zero, zero, torch.sign(p_local.z))
    return where3(on_x, nx, where3(on_y, ny, nz))


def ray_ellipsoid_interval(ro: Vec3, rd: Vec3, r: Vec3) -> Interval:
    """Axis-aligned ellipsoid |p/r| = 1 in the local frame."""
    o = ro.div(r)
    d = rd.div(r)
    a = d.dot(d)
    b = o.dot(d)
    c = o.dot(o) - 1.0
    disc = b * b - a * c
    valid = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_a = 1.0 / torch.clamp(a, min=1e-30)
    return Interval((-b - sq) * inv_a, (-b + sq) * inv_a, valid)


def ellipsoid_normal(p_local: Vec3, r: Vec3) -> Vec3:
    """Outward normal at a surface point: normalize(p / r^2)."""
    return Vec3(true_div(p_local.x, r.x * r.x), true_div(p_local.y, r.y * r.y),
                true_div(p_local.z, r.z * r.z)).normalize()


def ray_triangle(ro: Vec3, rd: Vec3, a: Vec3, b: Vec3, c: Vec3):
    """Moller-Trumbore. Returns (t, u, v, valid_geom); range checks are the
    caller's."""
    e1 = b - a
    e2 = c - a
    pv = rd.cross(e2)
    det = e1.dot(pv)
    det_ok = torch.abs(det) > 1e-30
    inv_det = 1.0 / torch.where(det_ok, det, 1e-30)
    tv = ro - a
    u = tv.dot(pv) * inv_det
    qv = tv.cross(e1)
    v = rd.dot(qv) * inv_det
    t = e2.dot(qv) * inv_det
    valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & det_ok
    return t, u, v, valid


def ray_plane_t(ro: Vec3, rd: Vec3, n: Vec3):
    """Plane through the local origin with normal n. Returns (t, valid)."""
    denom = n.dot(rd)
    den_ok = torch.abs(denom) > 1e-30
    t = -n.dot(ro) / torch.where(den_ok, denom, 1e-30)
    return t, den_ok


def to_local(ro: Vec3, rd: Vec3, pos: Vec3, rot: Quat, rotated: bool):
    """World ray -> primitive-local frame; the quaternion math runs only for
    rotated primitives."""
    o = ro - pos
    if rotated:
        return rot.inverse_rotate(o), rot.inverse_rotate(rd)
    return o, rd


def normal_to_world(n_local: Vec3, rot: Quat, rotated: bool) -> Vec3:
    return rot.rotate(n_local) if rotated else n_local
