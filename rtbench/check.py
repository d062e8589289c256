"""What decides ``correct``: a sample of the window's frames, drawn from the
run's seed, judged pixel by pixel against the plain reference.

During the window a reservoir keeps ``check.frames`` frames, each drawn
with equal chance from all the frames the window renders, and of each the
radiance of ``check.pixels`` pixels: every pixel of the frame where that is
the frame's count, else one pixel drawn from the seed in each of as many
equal runs of the frame's pixels in row-major order. Once the window has
closed and the program is freed, the reference renders the same pixels of
the same frames from the same seeds and two numbers are compared with their
limits:

* ``pixel_mismatch_pct``: the share of judged pixels in which some channel
  differs from the reference by more than 1e-3 + 1e-3 |reference|;
* ``verts_rel_err_pct``: for each judged frame, the program's path-vertex
  count against the reference's count of the judged pixels scaled to the
  frame (its share of the pixels; the count itself where every pixel is
  judged); the largest, in percent.
"""

from __future__ import annotations

import random

import numpy as np
import torch

ATOL = RTOL = 1e-3


class Reservoir:
    """Keeps ``k`` of a stream of frames, each with equal chance, choosing
    from a generator seeded by the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.items: list = []

    def slot(self, i: int):
        """Where frame ``i`` (0, 1, ...) goes, or None to drop it."""
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None


def judged_pixels(seed: int, n_pix: int, count: int) -> np.ndarray:
    """``count`` distinct pixels of the frame, in order: all of them, or one
    drawn from ``seed`` in each of ``count`` equal runs of the row-major
    pixel indices (a stratified sample, spread over the whole frame)."""
    if count >= n_pix:
        return np.arange(n_pix, dtype=np.int64)
    edges = (np.arange(count + 1, dtype=np.int64) * n_pix) // count
    u = np.random.default_rng(seed).random(count)
    return edges[:-1] + (u * (edges[1:] - edges[:-1])).astype(np.int64)


def compare(prog: list, ref: list, n_pix: int, n_judged: int) -> dict:
    """``prog`` and ``ref``: per frame (radiance (3, P) float32, path
    vertices: the program's of the frame, the reference's of the judged
    pixels). Returns the compared numbers."""
    bad, total, verr = 0, 0, 0.0
    for (p_rad, p_verts), (r_rad, r_verts) in zip(prog, ref):
        ok = torch.isfinite(p_rad).all(0) & ((p_rad - r_rad).abs() <= ATOL + RTOL * r_rad.abs()
                                             ).all(0)
        bad += int((~ok).sum())
        total += ok.numel()
        est = float(r_verts) * n_pix / n_judged
        verr = max(verr, abs(float(p_verts) - est) / est * 100.0)
    return {"pixel_mismatch_pct": 100.0 * bad / max(total, 1), "verts_rel_err_pct": verr}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)


def lines(numbers: dict, limits: dict) -> dict:
    """The result line's last key: each number beside its limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
