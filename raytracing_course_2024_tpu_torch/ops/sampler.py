"""Standalone MIS mixture sampler: the hand-written CUDA kernel K3 and its
plain PyTorch version.

Port of the JAX package's ``ops/pallas_sampling.py`` (``_kernel`` via
``sample_mixture_pallas``, body ``mixture_body``): per lane ``max_tries``
iid candidates, each from one uniformly picked component (cosine,
GGX-VNDF, light surface); the first with l.n_shade > 0 and l.n_geom > 0 is
kept and the mixture pdf is evaluated for it only. Returns (l, pdf, ok).

The TPU kernel drew from the hardware PRNG; here candidate ``t`` reads row
``r`` at counter ``ctr.mix(t, r)`` of the lane's key
``work_key(seed, wid + wid_off)``, where ``ctr`` is an ``ops.rng.Ctr``:
the batch layout (``batch_ctr``) on the modular batch route, the lane
engines' layout (``lane_ctr``) in their rounds. In lane mode the kernel
takes the depth-0 layout and each lane's ``depth`` and moves the counters
``WF_STRIDE`` per level, as K1's lane mode does (``Ctr.at_depth``). So the
kernel, its plain version and the fused bounce (K1, same counters at the
same bounce) see the same draws.

``sampler_plain`` is the JAX package's XLA ``sample_mixture`` fed those
draws as its 7 candidate-major rows (``ops/sampling.py``). ``ok`` is
masked with ``need`` on both routes. Where ``ok`` is False, l and pdf are
undefined and no caller reads them: the kernel ranks the lanes whose
``need`` holds into full passes and runs the sampler for those alone, and
writes l = (0, 0, 1) for lanes with no accepted candidate, where the XLA
formulation returns l = 0.

``sample_mixture_kernel`` runs the plain version only for tensors on the
CPU; on a CUDA tensor it launches ``csrc/sampler.cu`` or raises, and
counts the launch in ``ops/kernels.py:LAUNCHES["sampler"]`` (above 32
lights ``LAUNCHES["sampler_many"]``). Up to
``UNROLL_MAX_LIGHTS`` lights the kernel stages the light pack in shared
memory; above, it reads the scene's light records and walks the lights'
own tree for the light pdf (``ModularScene.light_rec``, ``light_nodes``;
``csrc/light_tree.cuh``), where the plain version sums one (B, L) sweep.

``seed`` and ``wid_off`` are ints or 0-dim integer tensors on the lanes'
device, on both routes. The kernel reads them from a (2,) int64 device
tensor (``ops/rng.py:seed_off``), so a CUDA graph that captured the launch
replays it for any seed and sample offset; the plain version reads the
tensors with device ops.
"""

from __future__ import annotations

import torch

from .bvh import LIGHT_REC, WIDE_FLOATS, WIDE_STACK
from .kernels import check, launch_sampler, launch_sampler_many
from .rng import WF_STRIDE, Ctr, mixture_rows, offset_ids, seed_off, work_key
from .sampling import UNROLL_MAX_LIGHTS, sample_mixture
from .vec import Vec3


def sampler_plain(scene, seed, wid: torch.Tensor, wid_off,
                  ctr: Ctr, point: Vec3, n_geom: Vec3, n_shade: Vec3,
                  v: Vec3, roughness: torch.Tensor, need: torch.Tensor,
                  max_tries: int = 4, faithful: bool = False):
    """Plain version of ``sample_mixture_kernel``; ``faithful=True`` is the
    reference's acceptance, which has no kernel (the JAX package runs it in
    XLA only). ``ctr`` may hold one base per lane (the lane layout)."""
    key = work_key(seed, offset_ids(wid, wid_off))
    rows = mixture_rows(key, ctr, max_tries)
    return sample_mixture(rows, point, n_geom, n_shade, v, roughness, scene.lp_np,
                          scene.statics, max_tries, need=need, faithful=faithful,
                          lp_dev=scene.light_packed)


def sample_mixture_kernel(scene, seed, wid: torch.Tensor, wid_off,
                          ctr: Ctr, point: Vec3, n_geom: Vec3, n_shade: Vec3,
                          v: Vec3, roughness: torch.Tensor, need: torch.Tensor,
                          max_tries: int = 4, depth: torch.Tensor | None = None):
    """Mixture-sampled direction per lane: (l Vec3, pdf, ok). ``ctr`` has an
    int base; ``depth`` (int32 (B,)) selects lane mode: lane ``i`` draws at
    ``ctr.at_depth(depth, WF_STRIDE)``."""
    dev = point.x.device
    if dev.type == "cpu":
        if depth is not None:
            ctr = ctr.at_depth(depth, WF_STRIDE)
        return sampler_plain(scene, seed, wid, wid_off, ctr, point, n_geom, n_shade,
                             v, roughness, need, max_tries)
    if dev.type != "cuda":
        raise ValueError(f"no sampler kernel for device {dev}")
    b = point.x.shape[0]
    ins = (*point, *n_geom, *n_shade, *v, roughness)
    for i, c in enumerate(ins):
        check(f"input row {i}", c, torch.float32, (b,), dev)
    check("need", need, torch.bool, (b,), dev)
    check("wid", wid, torch.int32, (b,), dev)
    if depth is not None:
        check("depth", depth, torch.int32, (b,), dev)
    if isinstance(ctr.base, torch.Tensor):
        raise ValueError("the kernel takes a Ctr with an int base; per-lane depths go in `depth`")
    pair = seed_off(seed, wid_off, dev)
    check("seed_off", pair, torch.int64, (2,), dev)
    out = torch.empty((4, b), dtype=torch.float32, device=dev)
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    n_lights = scene.statics.num_lights
    if n_lights > UNROLL_MAX_LIGHTS:
        if scene.light_nodes is None:
            raise ValueError(f"{n_lights} lights and no light tree (ops/bvh.py:build_light_tree)")
        check("light_rec", scene.light_rec, torch.float32, (n_lights, LIGHT_REC), dev)
        check("light_leaf", scene.light_leaf, torch.float32, (n_lights, LIGHT_REC), dev)
        nodes = scene.light_nodes
        check("light_nodes", nodes, torch.float32, (nodes.shape[0], WIDE_FLOATS), dev)
        if not 0 <= scene.light_stack <= WIDE_STACK:
            raise ValueError(f"the light walk needs {scene.light_stack} stack entries, "
                             f"K3 holds {WIDE_STACK}")
        launch_sampler_many(ins, need, wid, pair, ctr, depth, WF_STRIDE, scene.light_rec,
                            scene.light_leaf, nodes, scene.light_stack, max_tries, out, ok)
        return Vec3(out[0], out[1], out[2]), out[3], ok
    lp, lspec = scene.light_packed, scene.lspec
    nl = lp.shape[1]
    if not 1 <= nl <= UNROLL_MAX_LIGHTS:
        raise ValueError(f"light table has {nl} entries, the kernel takes 1..{UNROLL_MAX_LIGHTS}")
    check("light_packed", lp, torch.float32, (lp.shape[0], nl), dev)
    check("lspec", lspec, torch.int32, (nl,), dev)
    launch_sampler(ins, need, wid, pair, ctr, depth, WF_STRIDE, lp, lspec,
                   n_lights, max_tries, out, ok)
    return Vec3(out[0], out[1], out[2]), out[3], ok

