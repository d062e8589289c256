"""The scene's nearest hit on either backend, the BVH walk K6 (a
hand-written CUDA kernel), its plain version, and a model of its walk.

The JAX package traverses its BVH in XLA (``ops/traverse.py`` ->
``ops/treelet.py:nearest_hit_treelet``): 128-slot treelets, because a TPU
lane cannot gather per lane. Here each CUDA thread walks the binary SAH tree
of ``ops/bvh.py`` itself (``csrc/bvh_traverse.cu``): for each ray the
nearest hit with t > tmin over the finite table, t (+inf on a miss) and the
row of the table (0 on a miss), which ``surface_detail`` reads as it reads
the sweep's, since ``attach_bvh`` put the table in the tree's order.

* ``bvh_nearest_plain``: the chunked sweep over the whole table
  (``ops/scene_intersect.py:sweep_nearest``). It computes the same nearest
  hit for any N, the lowest row on a tie; K6 matches it bit for bit.
* ``bvh_nearest``: K6 for tensors on CUDA (or raises), the plain version
  for tensors on the CPU; counts its launches in
  ``ops/kernels.py:LAUNCHES["bvh"]``.
* ``nearest_hit``: the one choice of nearest-hit routine (the JAX
  package's ``integrator/path.py:_nearest``): K6 on a scene with a BVH, K4
  (``ops/dense_nearest.py``) on one of at most 128 triangles, else the
  sweep; with ``plain`` the plain versions. The infinite planes fold in
  afterwards (``_fold_in_planes``, as ``ops/treelet.py:323-324`` does).
* ``walk_reference``: K6's walk, node for node, in PyTorch over a batch of
  rays in lockstep: the same hits, and how many nodes and primitives each
  ray visits (the work K6's bound is counted from).

``live`` (optional (B,) bool) names the lanes whose hit the caller will
read: a lane whose flag is False gets the miss ``(inf, 0)`` from K6 and K4
without walking; the dense sweep and the plane fold ignore the mask, so a
masked lane's hit is unspecified and must not be read.
"""

from __future__ import annotations

import torch

from .bounce import REC_FLOATS
from .bvh import BVH_STACK, NODE_FLOATS
from .dense_nearest import dense_nearest, dense_nearest_plain
from .kernels import check, launch_bvh_nearest
from .scene_intersect import (
    ModularScene,
    SceneHit,
    _fold_in_planes,
    _prim_ts,
    prim_ref_from_table,
    sweep_nearest,
)
from .vec import Vec3


def _mask(t: torch.Tensor, idx: torch.Tensor, live: torch.Tensor | None):
    if live is None:
        return t, idx
    return torch.where(live, t, float("inf")), torch.where(live, idx, 0)


def bvh_nearest_plain(ro: Vec3, rd: Vec3, scene: ModularScene, tmin: float = 0.0,
                      live: torch.Tensor | None = None):
    """Plain version of ``bvh_nearest``: the sweep over the table."""
    return _mask(*sweep_nearest(ro, rd, scene.packed, scene.statics, tmin), live)


def bvh_nearest(ro: Vec3, rd: Vec3, scene: ModularScene, tmin: float = 0.0,
                live: torch.Tensor | None = None):
    """Nearest (t, row) per ray over the scene's finite table."""
    dev = ro.x.device
    if dev.type == "cpu":
        return bvh_nearest_plain(ro, rd, scene, tmin, live)
    if dev.type != "cuda":
        raise ValueError(f"no bvh_nearest kernel for device {dev}")
    if scene.bvh_nodes is None:
        raise ValueError("the scene has no BVH (ops/bvh.py:attach_bvh)")
    b = ro.x.shape[0]
    rays = (*ro, *rd)
    for name, c in zip(("ro.x", "ro.y", "ro.z", "rd.x", "rd.y", "rd.z"), rays):
        check(name, c, torch.float32, (b,), dev)
    m, n = scene.bvh_nodes.shape[0], scene.bvh_rec.shape[0]
    check("bvh_nodes", scene.bvh_nodes, torch.float32, (m, NODE_FLOATS), dev)
    check("bvh_rec", scene.bvh_rec, torch.float32, (n, REC_FLOATS), dev)
    if not 0 <= scene.bvh_depth <= BVH_STACK:
        raise ValueError(f"BVH depth {scene.bvh_depth} exceeds the stack of {BVH_STACK}")
    if live is not None:
        check("live", live, torch.bool, (b,), dev)
    t = torch.empty((b,), dtype=torch.float32, device=dev)
    idx = torch.empty((b,), dtype=torch.int32, device=dev)
    launch_bvh_nearest(rays, scene.bvh_nodes, scene.bvh_depth, scene.bvh_rec, tmin, live, t, idx)
    return t, idx


def nearest_hit(ro: Vec3, rd: Vec3, scene: ModularScene, tmin: float = 0.0,
                plain: bool = False, live: torch.Tensor | None = None) -> SceneHit:
    """Nearest hit over the finite table and the planes: K6 where the scene
    carries a BVH, K4 where it is at most 128 triangles, else the sweep
    (``plain``: the kernels' plain versions, on any device)."""
    if scene.bvh_nodes is not None:
        t, idx = (bvh_nearest_plain if plain else bvh_nearest)(ro, rd, scene, tmin, live)
    elif scene.tri_pack is None:
        t, idx = sweep_nearest(ro, rd, scene.packed, scene.statics, tmin)
    elif plain:
        t, idx = dense_nearest_plain(ro, rd, scene.tri_pack, tmin, live)
    else:
        t, idx = dense_nearest(ro, rd, scene.tri_pack, tmin, live, records=scene.tri_rec)
    hit = SceneHit(t, idx, torch.zeros_like(t, dtype=torch.bool), torch.isfinite(t))
    if scene.statics.num_planes > 0:
        hit = _fold_in_planes(ro, rd, scene, hit, tmin)
    return hit


def _box_entry(nodes: torch.Tensor, ro: Vec3, inv: Vec3, tmin: float, limit: torch.Tensor):
    """``box_entry`` of csrc/bvh_traverse.cu: the rays' entry distance into
    their nodes' boxes (``nodes`` (R, 8)), inf where the slab interval misses
    [tmin, limit]; fmin/fmax leave a NaN slab out, as fminf/fmaxf do."""
    x0, x1 = (nodes[:, 0] - ro.x) * inv.x, (nodes[:, 4] - ro.x) * inv.x
    y0, y1 = (nodes[:, 1] - ro.y) * inv.y, (nodes[:, 5] - ro.y) * inv.y
    z0, z1 = (nodes[:, 2] - ro.z) * inv.z, (nodes[:, 6] - ro.z) * inv.z
    fmin, fmax = torch.fmin, torch.fmax
    near = fmax(fmax(fmin(x0, x1), fmin(y0, y1)), fmax(fmin(z0, z1), torch.full_like(x0, tmin)))
    far = fmin(fmin(fmax(x0, x1), fmax(y0, y1)), fmin(fmax(z0, z1), limit))
    return torch.where(near <= far, near, float("inf"))


def walk_reference(ro: Vec3, rd: Vec3, scene: ModularScene, tmin: float = 0.0):
    """K6's walk modelled in PyTorch, every ray a step at a time in lockstep:
    the same order (nearer child first), the same pruning, the same box and
    primitive arithmetic. Returns (t, row, internal nodes visited, leaves
    visited, primitives tested) per ray. Slow (one step of every ray per
    Python iteration): it counts the work of a sample of rays, and holds the
    walk against the sweep."""
    nodes = scene.bvh_nodes
    words = nodes[:, [3, 7]].contiguous().view(torch.int32)
    dev, r = ro.x.device, ro.x.shape[0]
    inv = Vec3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
    inf = float("inf")
    best_t = torch.full((r,), inf, device=dev)
    best_i = torch.zeros((r,), dtype=torch.int64, device=dev)
    inner_n = torch.zeros((r,), dtype=torch.int64, device=dev)
    leaf_n = torch.zeros((r,), dtype=torch.int64, device=dev)
    tests = torch.zeros((r,), dtype=torch.int64, device=dev)
    stack_node = torch.zeros((r, BVH_STACK), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((r, BVH_STACK), device=dev)
    sp = torch.zeros((r,), dtype=torch.int64, device=dev)
    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    go = _box_entry(nodes[node], ro, inv, tmin, best_t) != inf

    def sel(v: Vec3, rays):
        return Vec3(v.x[rays], v.y[rays], v.z[rays])

    while bool(go.any()):
        act = torch.nonzero(go).squeeze(1)
        a, b = words[node[act], 0].long(), words[node[act], 1].long()
        leaf = b < 0
        pop = act[leaf]
        leaf_n[pop] += 1
        inner_n[act[~leaf]] += 1
        start, count = a[leaf], b[leaf] & 0x7FFFFFFF
        for off in range(int(count.max()) if count.numel() else 0):
            m = off < count
            rays, rows = pop[m], start[m] + off
            t = _prim_ts(sel(ro, rays), sel(rd, rays), prim_ref_from_table(scene.packed, rows),
                         scene.statics, tmin)
            tests[rays] += 1
            bt, bi = best_t[rays], best_i[rays]
            better = (t < bt) | ((t == bt) & (rows < bi))
            best_t[rays] = torch.where(better, t, bt)
            best_i[rays] = torch.where(better, rows, bi)
        inner, left, right = act[~leaf], a[~leaf], b[~leaf]
        tl = _box_entry(nodes[left], sel(ro, inner), sel(inv, inner), tmin, best_t[inner])
        tr = _box_entry(nodes[right], sel(ro, inner), sel(inv, inner), tmin, best_t[inner])
        enter = (tl != inf) | (tr != inf)
        first = tl <= tr
        t_far = torch.where(first, tr, tl)
        push = enter & (t_far != inf)
        rp = inner[push]
        stack_node[rp, sp[rp]] = torch.where(first, right, left)[push]
        stack_t[rp, sp[rp]] = t_far[push]
        sp[rp] += 1
        node[inner[enter]] = torch.where(first, left, right)[enter]
        pop = torch.cat([pop, inner[~enter]])
        go[pop] = False
        while pop.numel():  # each ray pops until a node can still hold a hit
            pop = pop[sp[pop] > 0]
            sp[pop] -= 1
            ok = stack_t[pop, sp[pop]] <= best_t[pop]
            took = pop[ok]
            node[took] = stack_node[took, sp[took]]
            go[took] = True
            pop = pop[~ok]
    return best_t, best_i.to(torch.int32), inner_n, leaf_n, tests
