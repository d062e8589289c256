"""Kernel K6 (csrc/bvh_traverse.cu ``bvh_nearest_kernel``), the nearest hit
over the BVH: the stage's share of its roofline (``roofline.py``).

Work: one ray per path vertex V, each costing what a walk of a binary SAH
tree costs, modelled on the benchmark's own tree (``reference/bvh.py``): 51
operations an internal node visited (two slab tests and the ordering) and
54 a primitive tested (the Moller-Trumbore test and the running minimum),
the mean over every ray that the reference traces, at every level, for
sample 0 of 4,096 pixels taken at an even stride from the judged pixels
(which are spread over the whole frame). The work is the stage's, not K6's
own 4-wide tree's, so a later walk or ray order is held to the same work.
Bytes: each ray's origin and direction read (24 B), its t and row written
(8 B), its live flag read (1 B)."""

import torch

from rtbench.reference import bvh, tracer
from rtbench.reference.rng import Layout
from rtbench.roofline import share

UNIT = "%"
LAYER = "Kernels (csrc/)"
TRACE_NAMES = ("bvh_nearest_kernel",)
OPS_NODE, OPS_PRIM = 51, 54
WALK_PIXELS = 4096


def ops_per_ray(ctx) -> float:
    s = ctx.ref_scene
    w = s.spec.width
    pix = ctx.pixels[::max(1, ctx.pixels.shape[0] // WALK_PIXELS)][:WALK_PIXELS]
    levels = []
    tracer.trace(s, ctx.seed32, pix, pix % w, pix // w,
                 Layout(ctx.engine != "batch", ctx.cell.config["max_tries"]),
                 ctx.cell.traffic["russian_roulette"], levels=levels)
    live = [torch.nonzero(alive).squeeze(1) for _, _, alive in levels]
    ro = tracer.V3(*(torch.cat([getattr(o, c)[i] for (o, _, _), i in zip(levels, live)])
                     for c in "xyz"))
    rd = tracer.V3(*(torch.cat([getattr(d, c)[i] for (_, d, _), i in zip(levels, live)])
                     for c in "xyz"))
    _, _, inner, tests = bvh.walk(ro, rd, s.tree, lambda o, d, r: tracer.prim_t(s, o, d, r),
                                  count=True)
    per = (OPS_NODE * inner + OPS_PRIM * tests).double().mean()
    ctx.note(f"bvh_nearest_roofline: walk model over {ro.x.shape[0]} rays of {pix.shape[0]} "
             f"pixels ({[int(i.shape[0]) for i in live]} a level): internal nodes "
             f"{float(inner.double().mean())}, primitive tests {float(tests.double().mean())} "
             f"a ray, {float(per)} operations a ray")
    return float(per)


def read(ctx):
    if ctx.ref_scene.tree is None:
        return None
    return share(ctx, "bvh_nearest", TRACE_NAMES, ctx.verts * 33, ctx.verts * ops_per_ray(ctx))
