"""The scene's nearest hit on either backend, the BVH walk K6 (a
hand-written CUDA kernel), its plain version, and models of its walk.

The JAX package traverses its BVH in XLA (``ops/traverse.py`` ->
``ops/treelet.py:nearest_hit_treelet``): 128-slot treelets, because a TPU
lane cannot gather per lane. Here each CUDA thread walks a 4-wide tree
collapsed from the binary SAH tree of ``ops/bvh.py``
(``build_bvh4_nodes``; ``csrc/bvh_traverse.cu``): for each ray the
nearest hit with t > tmin over the finite table, t (+inf on a miss) and the
row of the table (0 on a miss), which ``surface_detail`` reads as it reads
the sweep's, since ``attach_bvh`` put the table in the tree's order.

* ``bvh_nearest_plain``: the chunked sweep over the whole table
  (``ops/scene_intersect.py:sweep_nearest``). It computes the same nearest
  hit for any N, the lowest row on a tie; K6 matches it bit for bit.
* ``bvh_nearest``: K6 for tensors on CUDA (or raises), the plain version
  for tensors on the CPU; counts its launches in
  ``ops/kernels.py:LAUNCHES["bvh"]``.
* ``nearest_table``: the one choice of nearest-hit routine (the JAX
  package's ``integrator/path.py:_nearest``): K6 on a scene with a BVH, K4
  (``ops/dense_nearest.py``) on one of at most 128 triangles, else the
  sweep; with ``plain`` the plain versions. The modular bounce hands its
  (t, row) to N1a (``ops/shade.py``), which folds the infinite planes in.
* ``fold_hit``: a (t, row) of the finite table with the infinite planes
  folded in (``_fold_in_planes``, as ``ops/treelet.py:323-324`` does), the
  one definition that ``nearest_hit`` and N1a's plain version share.
* ``nearest_hit``: ``nearest_table``, then ``fold_hit``.
* ``walk_reference``: K6's walk of the 4-wide tree, node for node, in
  PyTorch over a batch of rays in lockstep: the same hits, and how many
  wide nodes (and of them in K6's staged top), child boxes and primitives
  each ray visits.
* ``walk_binary``: the same for a walk of the binary tree (K6's first
  design): the work that K6's bound is counted from, so that its share of
  the bound stays comparable across designs.

``live`` (optional (B,) bool) names the lanes whose hit the caller will
read: a lane whose flag is False gets the miss ``(inf, 0)`` from K6 and K4
without walking; the dense sweep and the plane fold ignore the mask, so a
masked lane's hit is unspecified and must not be read.
"""

from __future__ import annotations

import torch

from .bounce import REC_FLOATS
from .bvh import BVH_STACK, WIDE, WIDE_FLOATS, WIDE_STACK, WIDE_TOP
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
    check("bvh_nodes", scene.bvh_nodes, torch.float32, (m, WIDE_FLOATS), dev)
    check("bvh_rec", scene.bvh_rec, torch.float32, (n, REC_FLOATS), dev)
    check_stack(scene.bvh_stack)
    if live is not None:
        check("live", live, torch.bool, (b,), dev)
    t = torch.empty((b,), dtype=torch.float32, device=dev)
    idx = torch.empty((b,), dtype=torch.int32, device=dev)
    launch_bvh_nearest(rays, scene.bvh_nodes, scene.bvh_stack, scene.bvh_rec, tmin, live, t, idx)
    return t, idx


def check_stack(stack: int) -> None:
    """Raises unless K6's stack holds the ``stack`` entries a walk of the
    tree can need (``ops/bvh.py:Bvh4.stack``)."""
    if not 0 <= stack <= WIDE_STACK:
        raise ValueError(f"the BVH walk needs {stack} stack entries, K6 holds {WIDE_STACK}")


def nearest_table(ro: Vec3, rd: Vec3, scene: ModularScene, tmin: float = 0.0,
                  plain: bool = False, live: torch.Tensor | None = None):
    """Nearest (t, row) over the finite table, +inf and 0 on a miss: K6
    where the scene carries a BVH, K4 where it is at most 128 triangles,
    else the sweep (``plain``: the kernels' plain versions, on any device).
    The planes are not folded in: the modular bounce's shade pass
    (``ops/shade.py``, N1a) folds them."""
    if scene.bvh_nodes is not None:
        return (bvh_nearest_plain if plain else bvh_nearest)(ro, rd, scene, tmin, live)
    if scene.tri_pack is None:
        return sweep_nearest(ro, rd, scene.packed, scene.statics, tmin)
    if plain:
        return dense_nearest_plain(ro, rd, scene.tri_pack, tmin, live)
    return dense_nearest(ro, rd, scene.tri_pack, tmin, live, records=scene.tri_rec)


def fold_hit(ro: Vec3, rd: Vec3, scene: ModularScene, t: torch.Tensor, idx: torch.Tensor,
             tmin: float = 0.0) -> SceneHit:
    """The finite table's nearest (t, row) as a ``SceneHit`` with the planes
    folded in, as the JAX package's ``integrator/path.py:_nearest`` does."""
    hit = SceneHit(t, idx, torch.zeros_like(t, dtype=torch.bool), torch.isfinite(t))
    if scene.statics.num_planes > 0:
        hit = _fold_in_planes(ro, rd, scene, hit, tmin)
    return hit


def nearest_hit(ro: Vec3, rd: Vec3, scene: ModularScene, tmin: float = 0.0,
                plain: bool = False, live: torch.Tensor | None = None) -> SceneHit:
    """Nearest hit over the finite table (``nearest_table``) and the planes
    (``fold_hit``)."""
    return fold_hit(ro, rd, scene, *nearest_table(ro, rd, scene, tmin, plain, live), tmin)


def _box_entry(lo: Vec3, hi: Vec3, ro: Vec3, inv: Vec3, tmin: float, limit: torch.Tensor):
    """``box_entry`` of csrc/bvh_traverse.cu: the rays' entry distance into
    the boxes (lo, hi), inf where the slab interval misses [tmin, limit];
    fmin/fmax leave a NaN slab out, as fminf/fmaxf do. Broadcasts."""
    x0, x1 = (lo.x - ro.x) * inv.x, (hi.x - ro.x) * inv.x
    y0, y1 = (lo.y - ro.y) * inv.y, (hi.y - ro.y) * inv.y
    z0, z1 = (lo.z - ro.z) * inv.z, (hi.z - ro.z) * inv.z
    fmin, fmax = torch.fmin, torch.fmax
    near = fmax(fmax(fmin(x0, x1), fmin(y0, y1)), fmax(fmin(z0, z1), torch.full_like(x0, tmin)))
    far = fmin(fmin(fmax(x0, x1), fmax(y0, y1)), fmin(fmax(z0, z1), limit))
    return torch.where(near <= far, near, float("inf"))


def _sel(v: Vec3, rays) -> Vec3:
    return Vec3(v.x[rays], v.y[rays], v.z[rays])


def _col(v: Vec3) -> Vec3:
    return Vec3(v.x[:, None], v.y[:, None], v.z[:, None])


class _Walk:
    """What the two walk models share: each ray's best hit, its stack and
    its primitive tests, over a batch of rays in lockstep."""

    def __init__(self, ro: Vec3, rd: Vec3, scene: ModularScene, tmin: float, entries: int,
                 live: torch.Tensor | None = None):
        self.ro, self.rd, self.scene, self.tmin = ro, rd, scene, tmin
        dev, r = ro.x.device, ro.x.shape[0]
        self.inv = Vec3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
        self.best_t = torch.full((r,), float("inf"), device=dev)
        self.best_i = torch.zeros((r,), dtype=torch.int64, device=dev)
        self.tests = torch.zeros((r,), dtype=torch.int64, device=dev)
        self.stack_node = torch.zeros((r, entries), dtype=torch.int64, device=dev)
        self.stack_t = torch.zeros((r, entries), device=dev)
        self.sp = torch.zeros((r,), dtype=torch.int64, device=dev)
        self.node = torch.zeros((r,), dtype=torch.int64, device=dev)
        self.go = torch.ones((r,), dtype=torch.bool, device=dev) if live is None else live.clone()

    def leaf(self, rays, start, count) -> None:
        """Rays ``rays`` test rows start .. start + count, in order."""
        for off in range(int(count.max()) if count.numel() else 0):
            m = off < count
            rr, rows = rays[m], start[m] + off
            t = _prim_ts(_sel(self.ro, rr), _sel(self.rd, rr),
                         prim_ref_from_table(self.scene.packed, rows), self.scene.statics,
                         self.tmin)
            self.tests[rr] += 1
            bt, bi = self.best_t[rr], self.best_i[rr]
            better = (t < bt) | ((t == bt) & (rows < bi))
            self.best_t[rr] = torch.where(better, t, bt)
            self.best_i[rr] = torch.where(better, rows, bi)

    def push(self, rays, node, t) -> None:
        self.stack_node[rays, self.sp[rays]] = node
        self.stack_t[rays, self.sp[rays]] = t
        self.sp[rays] += 1

    def pop(self, rays) -> None:
        """Each of ``rays`` pops until a node can still hold a hit, or stops."""
        self.go[rays] = False
        while rays.numel():
            rays = rays[self.sp[rays] > 0]
            self.sp[rays] -= 1
            ok = self.stack_t[rays, self.sp[rays]] <= self.best_t[rays]
            took = rays[ok]
            self.node[took] = self.stack_node[took, self.sp[took]]
            self.go[took] = True
            rays = rays[~ok]


def walk_reference(ro: Vec3, rd: Vec3, scene: ModularScene, tmin: float = 0.0,
                   live: torch.Tensor | None = None, n_top: int = WIDE_TOP):
    """K6's walk of the 4-wide tree modelled in PyTorch, every ray a wide
    node at a time in lockstep, node for node as the kernel walks: the four
    children's boxes tested against [tmin, best], the entered ones sorted
    by the kernel's keys (entry bits, the two low ones the slot, so unique),
    the internal ones pushed
    farthest first and the nearest kept, then the entered leaves tested in
    order of entry while their entry is still <= best, then the kept child
    entered if its entry is still <= best, else a pop. A lane whose ``live``
    flag is False walks nothing and gets (inf, 0). Returns (t, row, wide
    nodes visited, child boxes tested, primitives tested, visits to the
    first ``n_top`` nodes, the ones K6 reads from shared memory) per ray.
    Slow (one step of every ray per Python iteration): it counts the work
    of a sample of rays, and holds the walk against the sweep."""
    nodes = scene.bvh_nodes
    words = nodes[:, 24:32].contiguous().view(torch.int32)
    w = _Walk(ro, rd, scene, tmin, WIDE_STACK, live)
    inf = float("inf")
    visits = torch.zeros_like(w.sp)
    boxes = torch.zeros_like(w.sp)
    top = torch.zeros_like(w.sp)
    while bool(w.go.any()):
        act = torch.nonzero(w.go).squeeze(1)
        line, wd = nodes[w.node[act]], words[w.node[act]].long()
        word, cnt = wd[:, :WIDE], wd[:, WIDE:]
        valid = (word >= 0) | (cnt > 0)
        visits[act] += 1
        top[act] += w.node[act] < n_top
        boxes[act] += valid.sum(1)
        lo = Vec3(line[:, 0:4], line[:, 4:8], line[:, 8:12])
        hi = Vec3(line[:, 12:16], line[:, 16:20], line[:, 20:24])
        # an empty slot's box lies at +inf (build_bvh4_nodes): never entered
        t = _box_entry(lo, hi, _col(_sel(ro, act)), _col(_sel(w.inv, act)), tmin,
                       w.best_t[act][:, None]).contiguous()
        # the kernel's sort keys (slot_key): t's bits, two low bits the slot;
        # a miss (inf) keys kMiss | slot
        slot = torch.arange(WIDE, device=t.device)
        key = ((t.view(torch.int32).long() & 0x7FFFFFFC) | slot).sort(dim=1).values
        kt = (key & 0x7FFFFFFC).to(torch.int32).view(torch.float32)
        entered = key < 0x7F800000
        ws, cs = word.gather(1, key & 3), cnt.gather(1, key & 3)
        nxt = torch.full_like(act, -1)
        t_nxt = torch.full_like(w.best_t[act], inf)
        for q in range(WIDE - 1, -1, -1):  # internal children: farthest pushed first
            m = entered[:, q] & (ws[:, q] >= 0)
            p = m & (nxt >= 0)
            w.push(act[p], nxt[p], t_nxt[p])
            nxt, t_nxt = torch.where(m, ws[:, q], nxt), torch.where(m, kt[:, q], t_nxt)
        for q in range(WIDE):  # entered leaves, nearest first
            m = entered[:, q] & (ws[:, q] < 0) & (kt[:, q] <= w.best_t[act])
            w.leaf(act[m], ws[m, q] & 0x7FFFFFFF, cs[m, q])
        enter = (nxt >= 0) & (t_nxt <= w.best_t[act])
        w.node[act[enter]] = nxt[enter]
        w.pop(act[~enter])
    return w.best_t, w.best_i.to(torch.int32), visits, boxes, w.tests, top


def walk_binary(ro: Vec3, rd: Vec3, scene: ModularScene, nodes: torch.Tensor,
                tmin: float = 0.0):
    """A walk of the binary tree (K6's first design), modelled as
    ``walk_reference``: at an internal node both children's boxes are
    tested, the nearer entered and the farther pushed; a popped node whose
    entry lies beyond the best hit is dropped. ``nodes``
    is ``ops/bvh.py:build_bvh_nodes`` of the scene's binary tree. Returns
    (t, row, internal nodes visited, leaves visited, primitives tested) per
    ray: the counts that K6's bound is reckoned from, so that the bound of
    one kernel is comparable with another's."""
    words = nodes[:, [3, 7]].contiguous().view(torch.int32)
    w = _Walk(ro, rd, scene, tmin, BVH_STACK)
    inf = float("inf")
    inner_n = torch.zeros_like(w.sp)
    leaf_n = torch.zeros_like(w.sp)

    def box(rows, rays):
        return _box_entry(Vec3(*nodes[rows, 0:3].T), Vec3(*nodes[rows, 4:7].T),
                          _sel(ro, rays), _sel(w.inv, rays), tmin, w.best_t[rays])

    w.go = box(w.node, torch.arange(ro.x.shape[0], device=ro.x.device)) != inf
    while bool(w.go.any()):
        act = torch.nonzero(w.go).squeeze(1)
        a, b = words[w.node[act], 0].long(), words[w.node[act], 1].long()
        leaf = b < 0
        pop = act[leaf]
        leaf_n[pop] += 1
        inner_n[act[~leaf]] += 1
        w.leaf(pop, a[leaf], b[leaf] & 0x7FFFFFFF)
        inner, left, right = act[~leaf], a[~leaf], b[~leaf]
        tl, tr = box(left, inner), box(right, inner)
        enter = (tl != inf) | (tr != inf)
        first = tl <= tr
        t_far = torch.where(first, tr, tl)
        push = enter & (t_far != inf)
        w.push(inner[push], torch.where(first, right, left)[push], t_far[push])
        w.node[inner[enter]] = torch.where(first, left, right)[enter]
        w.pop(torch.cat([pop, inner[~enter]]))
    return w.best_t, w.best_i.to(torch.int32), inner_n, leaf_n, w.tests
