"""ACES tonemap + gamma encode (reference src/rendering.rs:228-262).

Narkowicz ACES-approx coefficients 2.51 / 0.03 / 2.43 / 0.59 / 0.14, then
gamma 1/2.2, then round to u8 -- the JAX package's ``ops/tonemap.py``.
"""

from __future__ import annotations

import torch


def aces_tonemap(x: torch.Tensor) -> torch.Tensor:
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def color_to_u8(color: torch.Tensor) -> torch.Tensor:
    """Linear radiance (any shape) -> u8 pixels of the same shape."""
    tonemapped = aces_tonemap(color)
    gamma = torch.pow(torch.clamp(tonemapped, min=0.0), 1.0 / 2.2)
    return torch.round(gamma * 255.0).to(torch.uint8)
