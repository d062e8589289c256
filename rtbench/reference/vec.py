"""Structure-of-arrays 3-vectors and quaternions on tensors of one shape.
Dot products are written out term by term, left to right, so that the
rounding is that of the scalar formula."""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o: "V3") -> "V3":
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "V3") -> "V3":
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "V3":
        return V3(-self.x, -self.y, -self.z)

    def __mul__(self, s) -> "V3":
        return V3(self.x * s, self.y * s, self.z * s)

    def dot(self, o: "V3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(self.y * o.z - self.z * o.y, self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def had(self, o: "V3") -> "V3":
        return V3(self.x * o.x, self.y * o.y, self.z * o.z)

    def normalize(self, eps: float = 1e-30) -> "V3":
        return self * torch.rsqrt(torch.clamp(self.dot(self), min=eps))

    def at(self, i) -> "V3":
        return V3(self.x[i], self.y[i], self.z[i])


def where3(c: torch.Tensor, a: V3, b: V3) -> V3:
    return V3(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y), torch.where(c, a.z, b.z))


def reflect(v: V3, n: V3) -> V3:
    """``v`` (pointing away from the surface) mirrored about ``n``."""
    return n * (2.0 * v.dot(n)) - v


def rotate(q: tuple, v: V3) -> V3:
    """``v`` rotated by the unit quaternion ``q`` = (x, y, z, w)."""
    qv = V3(q[0], q[1], q[2])
    t = qv.cross(v) * 2.0
    return v + t * q[3] + qv.cross(t)


def unrotate(q: tuple, v: V3) -> V3:
    return rotate((-q[0], -q[1], -q[2], q[3]), v)


def tdiv(x: torch.Tensor, s) -> torch.Tensor:
    """``x / s`` rounded once: a host scalar goes to the device as a 0-dim
    tensor, since PyTorch on CUDA would multiply by its reciprocal."""
    if isinstance(s, torch.Tensor) or x.device.type == "cpu":
        return x / s
    return x / torch.full((), float(s), dtype=x.dtype, device=x.device)
