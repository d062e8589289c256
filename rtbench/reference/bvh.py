"""The benchmark's own binary BVH: a binned-SAH build over the primitives'
boxes and a plain walk of it in PyTorch.

The build is the course's rule (its ``bvh.rs``): boxes of the primitives
(a rotated box or ellipsoid by its 8 rotated corners) padded by 1e-4; top
down, 16 centroid bins per axis, a leaf at 4 primitives or fewer or where
the best split costs no less than area x count. The walk is the usual
nearest-hit walk of a binary tree: at an internal node both children's
boxes are tested against [0, best], the nearer entered and the farther
pushed; a popped node whose entry lies beyond the best hit is dropped. It
serves the reference's nearest hit and, with its counts of internal nodes
and primitive tests per ray, the K6 roofline's model of the stage's work
(``metrics/bvh_nearest_roofline.py``).

A tree depends only on the boxes, so it is kept on disk beside the
benchmark (``rtbench/.cache``, under the hash of the boxes): only the first
run in a checkout builds it.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from .vec import V3

LEAF_SIZE = 4
NUM_BINS = 16
AABB_EPS = 1e-4
STACK = 64
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")


class Tree(NamedTuple):
    lo: np.ndarray  # (M, 3) f32 node boxes
    hi: np.ndarray
    left: np.ndarray  # (M,) internal: left child; leaf: first position in ``order``
    right: np.ndarray  # internal: right child; leaf: primitive count
    leaf: np.ndarray  # (M,) bool
    order: np.ndarray  # (N,) primitive row at each tree position


def _rot_mats(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)], 1)


def prim_boxes(kind, p0, p1, p2, position, rotation) -> tuple:
    """Padded world boxes (lo, hi) of the finite primitives (float64)."""
    p0, p1, p2 = (np.asarray(a, np.float64) for a in (p0, p1, p2))
    lo, hi = np.minimum(np.minimum(p0, p1), p2), np.maximum(np.maximum(p0, p1), p2)
    nt = np.asarray(kind) != 0
    if nt.any():
        signs = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], float)
        corners = signs[None] * p0[nt][:, None, :]
        world = (np.einsum("mij,mkj->mki", _rot_mats(np.asarray(rotation, np.float64)[nt]),
                           corners) + np.asarray(position, np.float64)[nt][:, None, :])
        lo[nt], hi[nt] = world.min(1), world.max(1)
    return lo - AABB_EPS, hi + AABB_EPS


def _area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def _split(amin, amax, cen, ids, bmin, bmax):
    n = len(ids)
    if n <= LEAF_SIZE:
        return None
    best = (np.inf, None, None)
    c = cen[ids]
    clo, chi = c.min(0), c.max(0)
    lo_ids, hi_ids = amin[ids], amax[ids]
    for ax in range(3):
        if chi[ax] - clo[ax] < 1e-12:
            continue
        scale = NUM_BINS * (1.0 - 1e-7) / (chi[ax] - clo[ax])
        b = ((c[:, ax] - clo[ax]) * scale).astype(np.int64)
        counts = np.bincount(b, minlength=NUM_BINS)
        srt = np.argsort(b, kind="stable")
        used = np.nonzero(counts)[0]
        starts = np.concatenate([[0], np.cumsum(counts[used])[:-1]])
        binmin = np.full((NUM_BINS, 3), np.inf)
        binmax = np.full((NUM_BINS, 3), -np.inf)
        binmin[used] = np.minimum.reduceat(lo_ids[srt], starts, axis=0)
        binmax[used] = np.maximum.reduceat(hi_ids[srt], starts, axis=0)
        lmin, lmax = np.minimum.accumulate(binmin, 0), np.maximum.accumulate(binmax, 0)
        rmin = np.minimum.accumulate(binmin[::-1], 0)[::-1]
        rmax = np.maximum.accumulate(binmax[::-1], 0)[::-1]
        lc = np.cumsum(counts)
        cost = lc[:-1] * _area(lmin[:-1], lmax[:-1]) + (n - lc[:-1]) * _area(rmin[1:], rmax[1:])
        k = int(np.argmin(cost))
        if cost[k] < best[0] and 0 < lc[k] < n:
            best = (cost[k], ax, clo[ax] + (k + 1) / scale)
    if best[1] is None or _area(bmin, bmax) * n < best[0]:
        return None
    return best[1], best[2]


def build(amin: np.ndarray, amax: np.ndarray) -> Tree:
    n = amin.shape[0]
    cen = (amin + amax) * 0.5
    order = np.arange(n, dtype=np.int64)
    lo, hi, left, right, leaf = [], [], [], [], []

    def alloc():
        for a, v in ((lo, None), (hi, None), (left, 0), (right, 0), (leaf, False)):
            a.append(v)
        return len(lo) - 1

    stack = [(0, n, alloc())]
    while stack:
        s, ln, nid = stack.pop()
        ids = order[s:s + ln]
        bmin, bmax = amin[ids].min(0), amax[ids].max(0)
        lo[nid], hi[nid] = bmin, bmax
        sp = _split(amin, amax, cen, ids, bmin, bmax)
        if sp is None:
            leaf[nid], left[nid], right[nid] = True, s, ln
            continue
        keys = cen[ids, sp[0]]
        m = keys < sp[1]
        nl = int(m.sum())
        if nl in (0, ln):
            order[s:s + ln] = ids[np.argsort(keys, kind="stable")]
            nl = ln // 2
        else:
            order[s:s + ln] = np.concatenate([ids[m], ids[~m]])
        a, b = alloc(), alloc()
        left[nid], right[nid] = a, b
        stack += [(s, nl, a), (s + nl, ln - nl, b)]
    return Tree(np.asarray(lo, np.float32), np.asarray(hi, np.float32),
                np.asarray(left, np.int64), np.asarray(right, np.int64),
                np.asarray(leaf, bool), order)


def cached_build(amin: np.ndarray, amax: np.ndarray) -> Tree:
    """``build``, kept in ``CACHE`` under the hash of the boxes."""
    h = hashlib.sha256(np.ascontiguousarray(amin).tobytes() + amax.tobytes()).hexdigest()[:24]
    path = os.path.join(CACHE, f"bvh-{h}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return Tree(*(z[f] for f in Tree._fields))
    tree = build(amin, amax)
    os.makedirs(CACHE, exist_ok=True)
    tmp = f"{path}.part.npz"
    np.savez(tmp, **tree._asdict())
    os.replace(tmp, path)
    return tree


class DeviceTree:
    """A ``Tree`` on a device, in the walk's dtype."""

    def __init__(self, tree: Tree, device, dtype):
        def t(a, dt=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)
        self.lo, self.hi = t(tree.lo, dtype), t(tree.hi, dtype)
        self.left, self.right = t(tree.left), t(tree.right)
        self.leaf, self.order = t(tree.leaf), t(tree.order)


def _entry(lo: V3, hi: V3, ro: V3, inv: V3, limit: torch.Tensor) -> torch.Tensor:
    """Entry distance of each ray into its box, inf where [0, limit] misses."""
    fmin, fmax = torch.fmin, torch.fmax
    x0, x1 = (lo.x - ro.x) * inv.x, (hi.x - ro.x) * inv.x
    y0, y1 = (lo.y - ro.y) * inv.y, (hi.y - ro.y) * inv.y
    z0, z1 = (lo.z - ro.z) * inv.z, (hi.z - ro.z) * inv.z
    near = fmax(fmax(fmin(x0, x1), fmin(y0, y1)), fmax(fmin(z0, z1), torch.zeros_like(x0)))
    far = fmin(fmin(fmax(x0, x1), fmax(y0, y1)), fmin(fmax(z0, z1), limit))
    return torch.where(near <= far, near, float("inf"))


def walk(ro: V3, rd: V3, tree: DeviceTree, prim_t, count: bool = False):
    """Nearest hit of each ray: (t (inf on a miss), primitive row). ``prim_t
    (ro, rd, rows)`` gives each ray's distance to its row (inf on a miss).
    With ``count`` also the internal nodes visited and the primitives tested
    per ray. Ties go to the lower row."""
    dev, r = ro.x.device, ro.x.shape[0]
    inf = float("inf")
    inv = V3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
    best_t = torch.full_like(ro.x, inf)
    best_i = torch.zeros(r, dtype=torch.int64, device=dev)
    stack_n = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((r, STACK), dtype=ro.x.dtype, device=dev)
    sp = torch.zeros(r, dtype=torch.int64, device=dev)
    node = torch.zeros(r, dtype=torch.int64, device=dev)
    inner = torch.zeros(r, dtype=torch.int64, device=dev)
    tests = torch.zeros(r, dtype=torch.int64, device=dev)

    def box(nodes, rays):
        return _entry(V3(*tree.lo[nodes].unbind(-1)), V3(*tree.hi[nodes].unbind(-1)),
                      ro.at(rays), inv.at(rays), best_t[rays])

    all_rays = torch.arange(r, device=dev)
    go = box(node, all_rays) != inf
    while bool(go.any()):
        act = torch.nonzero(go).squeeze(1)
        nd = node[act]
        is_leaf = tree.leaf[nd]
        la, ln = act[is_leaf], nd[is_leaf]
        start, cnt = tree.left[ln], tree.right[ln]
        for off in range(int(cnt.max()) if cnt.numel() else 0):
            m = off < cnt
            rr, rows = la[m], tree.order[start[m] + off]
            t = prim_t(ro.at(rr), rd.at(rr), rows)
            tests[rr] += 1
            bt, bi = best_t[rr], best_i[rr]
            better = (t < bt) | ((t == bt) & (rows < bi))
            best_t[rr] = torch.where(better, t, bt)
            best_i[rr] = torch.where(better, rows, bi)
        ia, ind = act[~is_leaf], nd[~is_leaf]
        inner[ia] += 1
        a, b = tree.left[ind], tree.right[ind]
        ta, tb = box(a, ia), box(b, ia)
        enter = (ta != inf) | (tb != inf)
        first = ta <= tb
        far_t = torch.where(first, tb, ta)
        push = enter & (far_t != inf)
        pr = ia[push]
        stack_n[pr, sp[pr]] = torch.where(first, b, a)[push]
        stack_t[pr, sp[pr]] = far_t[push]
        sp[pr] += 1
        node[ia[enter]] = torch.where(first, a, b)[enter]
        popping = torch.cat([la, ia[~enter]])
        go[popping] = False
        while popping.numel():
            popping = popping[sp[popping] > 0]
            sp[popping] -= 1
            ok = stack_t[popping, sp[popping]] <= best_t[popping]
            took = popping[ok]
            node[took] = stack_n[took, sp[took]]
            go[took] = True
            popping = popping[~ok]
    if count:
        return best_t, best_i, inner, tests
    return best_t, best_i
