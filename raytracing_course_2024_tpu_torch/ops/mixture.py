"""The MIS mixture-sampling stage of the fused bounce, plain PyTorch.

Port of ``mixture_body`` (the JAX package's ``ops/pallas_sampling.py``),
which the TPU kernels K1/K2 inline: ``max_tries`` iid candidates, each
from one uniformly picked component (cosine, GGX-VNDF, light surface);
the first candidate with l.n_shade > 0 and l.n_geom > 0 is kept; the
mixture pdf is evaluated for that candidate only. With no accepted
candidate l = (0, 0, 1) and ``ok`` is False (the lane dies).

``draw(c)`` returns the lane's uniform at counter ``c`` (an int, or an int
tensor of per-lane counters); candidate ``t`` reads row ``r`` at
``ctr.mix(t, r)`` of the bounce's layout ``ctr`` (``ops/rng.py``: the batch
path's or the lane engines'). The same stage is ``mixture()`` in
``csrc/common.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.types import SceneStatics
from .rng import Ctr
from .sampling import (
    _SAFE,
    pdf_cosine,
    pdf_lights_lp,
    pdf_vndf,
    sample_cosine_u,
    sample_light_dir_u,
    sample_vndf_u,
)
from .vec import Vec3, true_div, where3


def mixture_body(draw, ctr: Ctr, point: Vec3, n: Vec3, ns: Vec3, v: Vec3,
                 roughness: torch.Tensor, lp: np.ndarray,
                 statics: SceneStatics, k_tries: int):
    """Returns (l, pdf >= _SAFE, accepted)."""
    n_comp = 3 if statics.num_lights > 0 else 2
    zero = point.x * 0.0
    sel = Vec3(zero, zero, zero + 1.0)
    accepted = zero > 1.0  # all False

    for t in range(k_tries):
        which = torch.clamp(
            (draw(ctr.mix(t, 0)) * n_comp).to(torch.int32), max=n_comp - 1
        )
        u1, u2 = draw(ctr.mix(t, 1)), draw(ctr.mix(t, 2))
        cand = sample_cosine_u(u1, u2, n)
        cand = where3(which == 1, sample_vndf_u(u1, u2, n, v, roughness), cand)
        if statics.num_lights > 0:
            us = [u1, u2] + [draw(ctr.mix(t, r)) for r in range(3, 7)]
            cand = where3(
                which == 2, sample_light_dir_u(us, point, lp, statics), cand
            )
        ok = (cand.dot(ns) > 0.0) & (cand.dot(n) > 0.0)
        take = ok & ~accepted
        sel = where3(take, cand, sel)
        accepted = accepted | ok

    pdf = pdf_cosine(n, sel) + pdf_vndf(n, sel, v, roughness)
    if statics.num_lights > 0:
        pdf = pdf + pdf_lights_lp(point, sel, lp, statics)
    pdf = true_div(pdf, n_comp)
    accepted = accepted & (pdf > _SAFE)
    return sel, torch.clamp(pdf, min=_SAFE), accepted
