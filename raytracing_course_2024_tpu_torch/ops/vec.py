"""Struct-of-arrays 3-vector math on torch tensors.

A ``Vec3`` is a NamedTuple of three same-shaped float32 tensors (x, y, z),
the JAX package's ``ops/vec.py`` layout: for a batch of B rays each
component is a ``(B,)`` tensor. Only the helpers the fused-bounce slice
uses are ported.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

Scalar = Union[float, torch.Tensor]


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, s: Scalar) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def mul(self, o: "Vec3") -> "Vec3":
        """Component-wise (Hadamard) product."""
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    def div(self, o: "Vec3") -> "Vec3":
        return Vec3(true_div(self.x, o.x), true_div(self.y, o.y), true_div(self.z, o.z))

    def normalize(self, eps: float = 0.0) -> "Vec3":
        """``v * rsqrt(max(|v|^2, eps or 1e-30))``, as the JAX package."""
        inv = torch.rsqrt(torch.clamp(self.dot(self), min=eps if eps else 1e-30))
        return self * inv


def true_div(x: torch.Tensor, s: Scalar) -> torch.Tensor:
    """``x / s`` rounded once. On CUDA, PyTorch divides a tensor by a host
    scalar as a product with the scalar's reciprocal (up to 1 ulp off, which
    the ellipsoid discriminant's cancellation amplifies); the kernels divide,
    so the plain versions do too. The divisor becomes a 0-dim device tensor
    (a fill kernel: no host synchronisation)."""
    if isinstance(s, torch.Tensor) or x.device.type == "cpu":
        return x / s
    return x / torch.full((), float(s), dtype=x.dtype, device=x.device)


def where3(cond: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    """Per-lane select between two Vec3 (cond broadcasts over components)."""
    return Vec3(
        torch.where(cond, a.x, b.x),
        torch.where(cond, a.y, b.y),
        torch.where(cond, a.z, b.z),
    )


def lerp3(a: Vec3, b: Vec3, t: Scalar) -> Vec3:
    return a * (1.0 - t) + b * t


def reflect(v: Vec3, n: Vec3) -> Vec3:
    """Mirror direction: reflect *outgoing* v about n: ``-v + 2 (v.n) n``."""
    return n * (2.0 * v.dot(n)) - v


class Quat(NamedTuple):
    """Quaternion (x, y, z, w); components are tensors or python floats."""

    x: Scalar
    y: Scalar
    z: Scalar
    w: Scalar

    def conjugate(self) -> "Quat":
        return Quat(-self.x, -self.y, -self.z, self.w)

    def rotate(self, v: Vec3) -> Vec3:
        """v' = v + 2 q_v x (q_v x v + w v), the JAX package's formula."""
        qv = Vec3(self.x, self.y, self.z)
        t = qv.cross(v) * 2.0
        return v + t * self.w + qv.cross(t)

    def inverse_rotate(self, v: Vec3) -> Vec3:
        return self.conjugate().rotate(v)
