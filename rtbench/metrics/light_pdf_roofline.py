"""Kernel K3 above 32 lights (csrc/sampler.cu ``sampler_many_kernel``): the
mixture sampler with the light pdf by an all-hits walk of the lights' own
tree, its share of its roofline (``roofline.py``).

Work: one sampled lane per kept direction, each costing K3's own operations
and the all-hits walk of a binary SAH tree over the light triangles, modelled
on the benchmark's own tree (``reference/bvh.py``, built over the reference
scene's lights): ``bvh.walk`` with a primitive test that never hits enters
every box the ray meets beyond 0, which is the all-hits walk, and counts 51
operations an internal node visited and 54 a light tested, as
``bvh_nearest_roofline`` does. The directions: those the reference keeps
(every level's ray after the first) for sample 0 of 4,096 pixels taken at an
even stride from the judged pixels; the window's sampled lanes are its path
vertices times the model's kept directions over its vertices (a lower bound:
a lane whose candidates are all refused is sampled and keeps none). K3's own
operations, counted from its math as the fewest a lane can do: one cosine
candidate (the sphere point, the sum and its normalisation, 24), its two
acceptance tests (10), the cosine pdf (6), the GGX visible-normal pdf (the
tangent frame, both local vectors, the half vector, G1 and D: 76) and the
mixture's sum and division (4): 120. Bytes: each lane's 13 input rows, work
id, need flag and depth read (61 B) and its direction, pdf and flag written
(17 B)."""

import torch

from rtbench.reference import bvh, tracer
from rtbench.reference.rng import Layout
from rtbench.roofline import share

UNIT = "%"
LAYER = "Kernels (csrc/)"
TRACE_NAMES = ("sampler_many_kernel",)
OPS_NODE, OPS_LIGHT, OPS_OWN = 51, 54, 120
BYTES_LANE = 78
WALK_PIXELS = 4096


def light_tree(s) -> bvh.DeviceTree:
    """The benchmark's binary SAH tree over the reference scene's lights."""
    tab = s.l_tab.float().cpu().numpy()
    n = tab.shape[0]
    zeros = torch.zeros((n, 3)).numpy()
    quat = torch.tensor([[0.0, 0.0, 0.0, 1.0]]).repeat(n, 1).numpy()
    lo, hi = bvh.prim_boxes(torch.zeros(n, dtype=torch.int64).numpy(), tab[:, 0:3],
                            tab[:, 3:6], tab[:, 6:9], zeros, quat)
    return bvh.DeviceTree(bvh.cached_build(lo, hi), s.l_tab.device, s.dtype)


def per_lane(ctx) -> tuple:
    """(operations a sampled lane, sampled lanes a path vertex) of the model."""
    s = ctx.ref_scene
    w = s.spec.width
    pix = ctx.pixels[::max(1, ctx.pixels.shape[0] // WALK_PIXELS)][:WALK_PIXELS]
    levels = []
    tracer.trace(s, ctx.seed32, pix, pix % w, pix // w,
                 Layout(ctx.engine != "batch", ctx.cell.config["max_tries"]),
                 ctx.cell.traffic["russian_roulette"], levels=levels)
    live = [torch.nonzero(alive).squeeze(1) for _, _, alive in levels]
    kept = list(zip(levels[1:], live[1:]))
    ro = tracer.V3(*(torch.cat([getattr(o, c)[i] for (o, _, _), i in kept]) for c in "xyz"))
    rd = tracer.V3(*(torch.cat([getattr(d, c)[i] for (_, d, _), i in kept]) for c in "xyz"))

    def never(o, d, rows):
        return torch.full_like(o.x, float("inf"))

    _, _, inner, tests = bvh.walk(ro, rd, light_tree(s), never, count=True)
    walk = (OPS_NODE * inner + OPS_LIGHT * tests).double().mean()
    dirs, verts = ro.x.shape[0], sum(int(i.shape[0]) for i in live)
    ctx.note(f"light_pdf_roofline: all-hits walk model over {dirs} kept directions of "
             f"{pix.shape[0]} pixels ({[int(i.shape[0]) for i in live]} vertices a level): "
             f"internal nodes {float(inner.double().mean())}, lights tested "
             f"{float(tests.double().mean())} a direction, {float(walk)} walk and {OPS_OWN} "
             f"own operations a lane; {dirs / verts} sampled lanes a path vertex")
    return float(walk) + OPS_OWN, dirs / verts


def read(ctx):
    if ctx.ref_scene.n_lights <= 32:
        return None
    ops, lanes_per_vertex = per_lane(ctx)
    lanes = ctx.verts * lanes_per_vertex
    return share(ctx, "light_pdf", TRACE_NAMES, lanes * BYTES_LANE, lanes * ops)
