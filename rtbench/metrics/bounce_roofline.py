"""Kernels of the fused bounce (csrc/bounce.cu: K2 ``primary_kernel``, K1
and K1-final ``bounce_kernel``): the stage's share of its roofline
(``roofline.py``) over the traced frames.

Work, from the frames' lanes and path vertices V (each lane alive at a
level is one vertex), on ``n`` = W x H lanes a launch, ``S`` samples a frame
and depth ``D``, the launches in place: K2 reads px, py and the work id
and writes the 13-row state (64 B a lane); a middle level reads and writes
a live lane's 13 rows and work id (108 B) and a dead lane's flag and
throughput (28 B); the final level 80 B a live lane and 4 B a dead one.
Counted from below: every vertex past level 0 at the final level's 76 B
above a dead lane's. Each launch also reads the scene's table once (35
floats and a spec word an entry, 19 words a light). Operations: the
intersection loop, 53 a triangle entry and live lane, and the winner's
normal, 18 a live lane; the sampler and the BRDF are not counted."""

from rtbench.roofline import share

UNIT = "%"
LAYER = "Kernels (csrc/)"
TRACE_NAMES = ("primary_kernel", "bounce_kernel")
OPS_TRI, OPS_NORMAL = 53, 18


def read(ctx):
    s = ctx.spec
    f, n, spp, d = ctx.frames, s.width * s.height, ctx.cell.traffic["spp"], s.ray_depth
    m = s.num_prims + len(s.planes["mkind"])
    lights = ctx.ref_scene.n_lights
    paths = f * spp * n
    nbytes = (paths * (64 + (d - 2) * 28 + 4) + 76 * (ctx.verts - paths)
              + f * spp * d * (36 * m + 19 * lights) * 4)
    return share(ctx, "bounce", TRACE_NAMES, nbytes, ctx.verts * (OPS_TRI * m + OPS_NORMAL))
