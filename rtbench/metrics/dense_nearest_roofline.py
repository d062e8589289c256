"""Kernel K4 (csrc/dense_nearest.cu ``dense_nearest_kernel``), the dense
nearest hit: the stage's share of its roofline (``roofline.py``). Work: one
ray per path vertex V, each tested against every triangle, 53 operations a
test (one Moller-Trumbore test and the running minimum); bytes: each ray's
origin and direction read (24 B), its t and row written (8 B), its live
flag read (1 B)."""

from rtbench.roofline import share

UNIT = "%"
LAYER = "Kernels (csrc/)"
TRACE_NAMES = ("dense_nearest_kernel",)
OPS_TRI = 53


def read(ctx):
    tris = int((ctx.spec.prims["kind"] == 0).sum())
    return share(ctx, "dense_nearest", TRACE_NAMES, ctx.verts * 33, ctx.verts * tris * OPS_TRI)
