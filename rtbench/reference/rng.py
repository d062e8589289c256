"""The renderer's counter RNG, written again: one key per work item (a
(pixel, sample) pair), two rounds of the "lowbias32" finalizer, and a
uniform in [0, 1) with a 24-bit mantissa per counter.

    key = fmix(fmix_in(wid * 0x9E3779B9 ^ seed32))
    u(c) = (fmix(key ^ (c * 0x85EBCA77 + 0x165667B1)) >> 8) / 2^24

The hash runs in int64 with every intermediate masked to 32 bits; products
are split into 16-bit halves so that no int64 product overflows.

Two counter layouts exist, one per engine family:

* batch engine: bounce ``i`` owns counters ``[i * D, (i + 1) * D)`` with
  ``D = 7 * max_tries + 4``; draws 0 and 1 are the camera jitter, row ``r``
  of mixture candidate ``t`` is at ``i * D + 2 + 7 t + r``, the dielectric
  split at ``i * D + 2 + 7 max_tries``, the roulette draw one after it;
* lane engines (wavefront, sticky): draws 0 and 1 are the jitter, depth
  ``d`` starts at ``b = 2 + 64 d``; row ``r`` of candidate ``t`` at
  ``b + t + r * max_tries``, the roulette draw at ``b + 62``, the
  dielectric split at ``b + 63``.

A frame rendered with seed ``s`` keys its work items with
``seed32 = (s * 2654435761) mod 2^32``.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
_C1 = 0x7FEB352D
_C2 = 0x846CA68B
_CTR_MUL = 0x85EBCA77
_CTR_ADD = 0x165667B1
MIX_ROWS = 7


def frame_seed32(seed: int) -> int:
    return (int(seed) * 2654435761) & M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def work_key(seed32: int, wid: torch.Tensor) -> torch.Tensor:
    """The u32 key (in int64) of each work id."""
    return _fmix(_mul32(wid.to(torch.int64) & M32, _GOLD) ^ (seed32 & M32))


def uniform(key: torch.Tensor, ctr, dtype=torch.float32) -> torch.Tensor:
    """One U[0, 1) draw per key at counter ``ctr`` (an int or an int tensor)."""
    if isinstance(ctr, torch.Tensor):
        cm = (_mul32(ctr.to(torch.int64) & M32, _CTR_MUL) + _CTR_ADD) & M32
    else:
        cm = ((int(ctr) & M32) * _CTR_MUL + _CTR_ADD) & M32
    bits = _fmix(key ^ cm)
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24))


class Layout:
    """Where the draws of bounce ``level`` sit: ``mix(level, t, r)``,
    ``diel(level)``, ``rr(level)``; ``lane`` picks the lane engines'
    layout, else the batch engine's."""

    def __init__(self, lane: bool, max_tries: int):
        self.lane, self.k = lane, max_tries
        if lane and MIX_ROWS * max_tries >= 62:
            raise ValueError(f"max_tries {max_tries} overflows the lane layout's block")

    def _base(self, level: int) -> int:
        return 2 + 64 * level if self.lane else level * (MIX_ROWS * self.k + 4) + 2

    def mix(self, level: int, t: int, r: int) -> int:
        b = self._base(level)
        return b + t + r * self.k if self.lane else b + MIX_ROWS * t + r

    def diel(self, level: int) -> int:
        return self._base(level) + (63 if self.lane else MIX_ROWS * self.k)

    def rr(self, level: int) -> int:
        return self._base(level) + (62 if self.lane else MIX_ROWS * self.k + 1)
