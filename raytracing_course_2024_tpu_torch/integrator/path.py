"""Path-tracing integrator of the fused-bounce main path.

The reference's recursive estimator (src/rendering.rs:86-127) telescopes
into a loop carrying (ray, throughput T, radiance L, alive) per lane:

    L += T * emission_at_hit, or T * background on a miss (then the lane dies)
    T *= brdf(l, n, v) * (l.n) / pdf     (mixture-sampled lobe)

One sample of a pixel batch is ``ray_depth`` levels of the fused bounce
(ops/bounce.py): bounce 0 with the camera ray generated in the same kernel
(K2), full bounces 1 .. ray_depth-2 (K1), and the final level, which only
collects emission (K1 with ``final_only``; the reference returns black at
depth 0, so its last sampled direction never contributes). This is the JAX
package's ``_trace_paths_mega_primary`` / ``render_pixels`` route.

Path vertices (one scene intersection per live lane and level) are counted
exactly: the unit behind the Mrays/s metric (bench.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bounce as B
from ..scene.types import SceneStatics


class TraceConfig(NamedTuple):
    """Integrator parameters (the JAX package's TraceConfig)."""

    ray_depth: int
    bg_color: tuple  # (r, g, b)
    max_tries: int = 4  # mixture rejection candidates
    backend: str = "dense"  # "dense" | "bvh"
    faithful: bool = False  # reference-exact acceptance (modular path only)
    rr: bool = False  # Russian roulette (modular path only)


def mega_gate_reason(cfg: TraceConfig, statics: SceneStatics) -> str | None:
    """Why the fused-bounce path cannot render this configuration (the JAX
    package's ``_mega_gate``), or None. The port has no other path yet."""
    if cfg.backend != "dense":
        return "the BVH backend is not ported yet (ROADMAP M6)"
    if cfg.faithful:
        return "faithful acceptance runs on the modular dense path (ROADMAP M5)"
    if cfg.rr:
        return "Russian roulette runs on the modular dense path (ROADMAP M5)"
    if cfg.ray_depth < 2:
        return "ray_depth < 2 runs on the modular dense path (ROADMAP M5)"
    return B.gate_reason(statics)


def trace_sample(scene: B.BounceScene, state: torch.Tensor, seed: int,
                 wid: torch.Tensor, wid_off: int, px: torch.Tensor,
                 py: torch.Tensor, cam_row: torch.Tensor, cfg: TraceConfig,
                 width: int, height: int, plain: bool = False):
    """One camera sample per lane through all depth levels.

    ``state`` is a (13, B) buffer the kernels overwrite in place (the plain
    versions return fresh tensors). Returns (state after the final level,
    path vertices as a 0-dim float64 tensor on the device)."""
    bg, k = cfg.bg_color, cfg.max_tries
    args = (scene, cam_row, px, py, wid, wid_off, seed, bg, k, width, height)
    st = B.primary_plain(*args) if plain else B.primary_bounce(*args, out=state)
    rays = torch.full((), float(px.shape[0]), dtype=torch.float64, device=px.device)
    for i in range(1, cfg.ray_depth - 1):
        rays += st[12].sum(dtype=torch.float64)
        if plain:
            st = B.bounce_plain(scene, st, wid, wid_off, seed, i, bg, k)
        else:
            st = B.bounce(scene, st, wid, wid_off, seed, i, bg, k, out=st)
    rays += st[12].sum(dtype=torch.float64)
    fin = (scene, st, wid, wid_off, seed, cfg.ray_depth - 1, bg, k)
    if plain:
        st = B.bounce_plain(*fin, final_only=True)
    else:
        st = B.bounce(*fin, final_only=True, out=st)
    return st, rays


def render_pixels(scene: B.BounceScene, seed: int, wid: torch.Tensor,
                  px: torch.Tensor, py: torch.Tensor, cam_row: torch.Tensor,
                  cfg: TraceConfig, width: int, height: int, samples: int,
                  n_pix: int, plain: bool = False):
    """Average radiance over ``samples`` jittered paths per lane.

    Lane ``i`` renders pixel (px[i], py[i]); its sample ``s`` is work item
    ``wid[i] + s * n_pix`` of the counter RNG. Returns ((3, B) f32
    channel-major radiance, path vertices as a 0-dim float64 tensor)."""
    b = px.shape[0]
    acc = torch.zeros((3, b), dtype=torch.float32, device=px.device)
    state = torch.empty((B.N_STATE, b), dtype=torch.float32, device=px.device)
    nrays = torch.zeros((), dtype=torch.float64, device=px.device)
    for s in range(samples):
        st, rays = trace_sample(scene, state, seed, wid, s * n_pix, px, py,
                                cam_row, cfg, width, height, plain)
        acc += st[9:12]
        nrays += rays
    return acc * (1.0 / samples), nrays
