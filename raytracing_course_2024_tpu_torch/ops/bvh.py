"""Host-side BVH construction (vectorized numpy binned SAH) and the arrays
the BVH nearest-hit kernel K6 walks (``ops/traverse.py``).

``primitive_aabbs``, ``build_bvh``, ``_find_split`` and ``validate_bvh``
are copies of the JAX package's ``ops/bvh.py`` (that module cannot be
imported here: importing the package loads jax), so both packages build the
same tree from the same boxes:

* AABBs once, vectorized (the reference's rotate-8-corners object AABB,
  src/aabb.rs:75-94), padded by ``AABB_EPS``;
* a top-down build with 16-bin SAH per axis, leaf when n <= LEAF_SIZE or
  when the best split is no cheaper than the trivial leaf cost area * n
  (the reference's leaf criterion, src/bvh.rs:88,127).

The C++ builder (``native/``) makes the same construction faster on 100k+
primitives; numpy is the fallback and the oracle.

K6 walks a 4-wide tree collapsed from the binary one (``build_bvh4_nodes``):
one 128-byte line a node, its children's boxes bit for bit the binary
nodes' boxes, so the walk finds the sweep's hit bit for bit. An empty
slot's box is +inf on every bound: the slab test misses it like any box
the ray does not meet, so K6 spends no test on the slot. A 64-byte node
with the boxes quantized to bytes halves the bytes a visit reads, but K6
is not bound by them on an H100: the decode's instructions made it slower
(PERF.md, PR 27).

``build_light_tree`` builds a second tree of the same rule over the
lights alone, for K3's light pdf above 32 lights (``csrc/light_tree.cuh``):
the reference's all-hits walk of its light BVH (SURVEY.md: ``bvh.rs``
``intersect_with_bvh_all_points``, ``scene.rs``'s ``bvh_light_sources``).

``attach_bvh`` differs from the JAX package's on purpose. The TPU cannot
gather per lane, so the JAX package cuts the tree into 128-slot treelets
and pads the table to them (``ops/treelet.py:3-4``). A GPU thread walks the
binary tree itself, so here the finite table is only put in the tree's
primitive order (leaf ranges are contiguous rows), the light list is
remapped to the new rows, and the tree goes beside it as ``BvhArrays``.
"""

from __future__ import annotations

import logging
import subprocess
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np

from ..runtime.profiling import span
from ..scene.build import build_packs
from ..scene.types import TRI, BvhArrays, LightCol, SceneArrays, SceneStatics
from .bounce import loop_records
from .sampling import UNROLL_MAX_LIGHTS

log = logging.getLogger("rt_torch")

LEAF_SIZE = 4
NUM_BINS = 16
AABB_EPS = 1e-4  # pad, reference src/aabb.rs:53-65 pads by EPS
# binary levels below the root that a tree may have: a deeper tree is
# refused at build time. K6 walks the 4-wide tree collapsed from it, whose
# walk can hold up to 3 entries per binary level (build_bvh4_nodes), so its
# stack holds WIDE_STACK entries (kStack, csrc/bvh_traverse.cu)
BVH_STACK = 64
WIDE = 4  # children per node of K6's tree
WIDE_STACK = (WIDE - 1) * BVH_STACK
WIDE_TOP = 85  # K6's wide nodes staged in shared memory: 1 + 4 + 16 + 64 (kTop)
LEAF_BIT = np.int32(-(2**31))  # a leaf's word carries it (both node layouts)
NODE_FLOATS = 8  # one node of the binary layout (the walk model's yardstick): two float4
WIDE_FLOATS = 32  # one node of K6's 4-wide layout: 128 bytes, one cache line


def _rot_mat(q: np.ndarray) -> np.ndarray:
    """(M,4) xyzw quaternions -> (M,3,3) rotation matrices."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=1,
    )


def primitive_aabbs(scn: SceneArrays) -> tuple:
    """(aabb_min (N,3), aabb_max (N,3)) for the finite table, world space.

    Triangles: vertex min/max (verts are pre-baked world space).
    Box/ellipsoid: local AABB = +-s, rotated via all 8 corners + position
    (reference src/aabb.rs:75-94)."""
    p0 = np.asarray(scn.p0, np.float64)
    p1 = np.asarray(scn.p1, np.float64)
    p2 = np.asarray(scn.p2, np.float64)
    ptype = np.asarray(scn.ptype)

    amin = np.minimum(np.minimum(p0, p1), p2)
    amax = np.maximum(np.maximum(p0, p1), p2)

    nontri = ptype != TRI
    if nontri.any():
        s = p0[nontri]  # half extents / radii
        q = np.asarray(scn.rotation, np.float64)[nontri]
        pos = np.asarray(scn.position, np.float64)[nontri]
        rot = _rot_mat(q)  # (M,3,3)
        # 8 corners of [-s, s]
        signs = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            np.float64,
        )  # (8,3)
        corners = signs[None, :, :] * s[:, None, :]  # (M,8,3)
        world = np.einsum("mij,mkj->mki", rot, corners) + pos[:, None, :]
        amin[nontri] = world.min(axis=1)
        amax[nontri] = world.max(axis=1)

    return amin - AABB_EPS, amax + AABB_EPS


class _HostBvh(NamedTuple):
    node_min: np.ndarray
    node_max: np.ndarray
    node_left: np.ndarray
    node_right: np.ndarray
    node_is_leaf: np.ndarray
    prim_order: np.ndarray


def build_bvh(amin: np.ndarray, amax: np.ndarray) -> _HostBvh:
    """Binned-SAH binary BVH over the given AABBs. Root is node 0."""
    n = amin.shape[0]
    centroid = (amin + amax) * 0.5

    order = np.arange(n, dtype=np.int64)
    node_min, node_max = [], []
    node_left, node_right, node_is_leaf = [], [], []

    # worklist of (start, length, node_id); nodes appended breadth-ish
    def alloc():
        node_min.append(None)
        node_max.append(None)
        node_left.append(0)
        node_right.append(0)
        node_is_leaf.append(False)
        return len(node_min) - 1

    root = alloc()
    stack = [(0, n, root)]
    while stack:
        start, length, nid = stack.pop()
        ids = order[start : start + length]
        bmin = amin[ids].min(axis=0)
        bmax = amax[ids].max(axis=0)
        node_min[nid] = bmin
        node_max[nid] = bmax

        split = _find_split(amin, amax, centroid, ids, bmin, bmax)
        if split is None:
            node_is_leaf[nid] = True
            node_left[nid] = start
            node_right[nid] = length
            continue
        axis, thresh = split
        keys = centroid[ids, axis]
        left_mask = keys < thresh
        nl = int(left_mask.sum())
        if nl == 0 or nl == length:  # degenerate (all centroids equal): median
            perm = np.argsort(keys, kind="stable")
            order[start : start + length] = ids[perm]
            nl = length // 2
        else:
            order[start : start + length] = np.concatenate(
                [ids[left_mask], ids[~left_mask]]
            )
        lid = alloc()
        rid = alloc()
        node_left[nid] = lid
        node_right[nid] = rid
        stack.append((start, nl, lid))
        stack.append((start + nl, length - nl, rid))

    return _HostBvh(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        node_left=np.asarray(node_left, np.int32),
        node_right=np.asarray(node_right, np.int32),
        node_is_leaf=np.asarray(node_is_leaf, bool),
        prim_order=order.astype(np.int32),
    )


def _sah_area(dmin, dmax):
    d = np.maximum(dmax - dmin, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def _find_split(amin, amax, centroid, ids, bmin, bmax):
    """Best (axis, centroid threshold) by 16-bin SAH, or None for a leaf.

    Leaf criteria mirror the reference (src/bvh.rs:88-90,127-129):
    n <= LEAF_SIZE, or the trivial cost area*n beats the best split."""
    length = len(ids)
    if length <= LEAF_SIZE:
        return None

    best = (np.inf, None, None)
    cmin = centroid[ids]
    lo = cmin.min(axis=0)
    hi = cmin.max(axis=0)
    for axis in range(3):
        if hi[axis] - lo[axis] < 1e-12:
            continue
        scale = NUM_BINS * (1.0 - 1e-7) / (hi[axis] - lo[axis])
        bin_idx = ((cmin[:, axis] - lo[axis]) * scale).astype(np.int64)
        # per-bin counts and bounds
        counts = np.bincount(bin_idx, minlength=NUM_BINS)
        binmin = np.full((NUM_BINS, 3), np.inf)
        binmax = np.full((NUM_BINS, 3), -np.inf)
        np.minimum.at(binmin, bin_idx, amin[ids])
        np.maximum.at(binmax, bin_idx, amax[ids])
        # prefix/suffix sweeps
        lmin = np.minimum.accumulate(binmin, axis=0)
        lmax = np.maximum.accumulate(binmax, axis=0)
        rmin = np.minimum.accumulate(binmin[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(binmax[::-1], axis=0)[::-1]
        lcount = np.cumsum(counts)
        rcount = length - lcount
        # split after bin k (k = 0..NUM_BINS-2)
        cost = lcount[:-1] * _sah_area(lmin[:-1], lmax[:-1]) + rcount[:-1] * _sah_area(
            rmin[1:], rmax[1:]
        )
        k = int(np.argmin(cost))
        if cost[k] < best[0] and 0 < lcount[k] < length:
            thresh = lo[axis] + (k + 1) / scale
            best = (cost[k], axis, thresh)

    trivial = _sah_area(bmin, bmax) * length  # reference src/bvh.rs:127
    if best[1] is None or trivial < best[0]:
        return None
    return best[1], best[2]


def validate_bvh(host_bvh, amin: np.ndarray, amax: np.ndarray) -> None:
    """Containment invariants on the host tree (the reference asserts these
    at the start of every render, src/bvh.rs:299-322 + rendering.rs:22; we
    check once at build/test time instead). amin/amax are in the ORIGINAL
    primitive order; host_bvh.prim_order maps sorted position -> old row."""
    nmin = np.asarray(host_bvh.node_min, np.float64)
    nmax = np.asarray(host_bvh.node_max, np.float64)
    left = np.asarray(host_bvh.node_left)
    right = np.asarray(host_bvh.node_right)
    leaf = np.asarray(host_bvh.node_is_leaf)
    order = np.asarray(host_bvh.prim_order)
    smin = amin[order]  # sorted order
    smax = amax[order]
    tol = 1e-5
    for nid in range(len(left)):
        if leaf[nid]:
            s, c = left[nid], right[nid]
            assert (smin[s : s + c] >= nmin[nid] - tol).all(), nid
            assert (smax[s : s + c] <= nmax[nid] + tol).all(), nid
        else:
            for ch in (left[nid], right[nid]):
                assert (nmin[ch] >= nmin[nid] - tol).all(), (nid, ch)
                assert (nmax[ch] <= nmax[nid] + tol).all(), (nid, ch)
    # the reorder must be a permutation covering every primitive
    assert (np.sort(order) == np.arange(len(order))).all()
    # leaves must tile [0, N) exactly
    covered = np.zeros(len(order), bool)
    for s, c in zip(left[leaf], right[leaf]):
        assert not covered[s : s + c].any()
        covered[s : s + c] = True
    assert covered.all()


def host_bvh(amin: np.ndarray, amax: np.ndarray) -> tuple:
    """(tree, builder): the C++ build (``native/``), or the numpy build when
    the native one cannot be compiled or loaded (with a warning: the two
    build different trees of the same SAH rule, so the table order and the
    row returned on a tie differ with the builder). Either builds on the
    host."""
    try:
        from ..native import native_build_bvh

        return native_build_bvh(amin, amax, LEAF_SIZE, NUM_BINS), "native"
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log.warning("native BVH builder unavailable (%s); building the BVH with numpy", e)
    return build_bvh(amin, amax), "numpy"


def tree_depth(bvh) -> int:
    """Levels below the root on the deepest path (the root alone: 0). Nodes
    are in build order, every child after its parent."""
    left = np.asarray(bvh.node_left)
    right = np.asarray(bvh.node_right)
    internal = ~np.asarray(bvh.node_is_leaf)
    level = np.array([0])
    depth = 0
    while True:
        inner = level[internal[level]]
        if inner.size == 0:
            return depth
        level = np.concatenate([left[inner], right[inner]])
        depth += 1


def attach_bvh(scn: SceneArrays, statics: SceneStatics) -> tuple:
    """(arrays, builder): the finite table in the tree's primitive order with
    the tree attached (``arrays.bvh``), and which builder made the tree
    ("native" or "numpy").

    Row i of every per-primitive field is the original row
    ``bvh.prim_order[i]``, so a leaf's range is contiguous rows and a row
    index K6 returns indexes ``packed`` directly. ``light_idx`` is remapped
    through the inverse permutation (the JAX package's ``slot_of_old``,
    ``ops/bvh.py:376-386``) and the packs are rebuilt. A scene without
    finite primitives (the table holds only its padding row) and a tree
    deeper than K6's stack (``BVH_STACK``) raise."""
    if statics.num_prims == 0:
        raise ValueError("the BVH backend needs at least one finite primitive; "
                         "the scene has only planes or nothing (use backend='dense')")
    amin, amax = primitive_aabbs(scn)
    tree, builder = host_bvh(amin, amax)
    depth = tree_depth(tree)
    if depth > BVH_STACK:
        raise ValueError(f"BVH depth {depth} exceeds the traversal stack of {BVH_STACK}")
    order = np.asarray(tree.prim_order, np.int64)
    n = order.shape[0]
    row_of_old = np.empty(n, np.int64)
    row_of_old[order] = np.arange(n)

    def place(a):
        return np.ascontiguousarray(np.asarray(a)[order])

    reordered = scn._replace(
        ptype=place(scn.ptype), p0=place(scn.p0), p1=place(scn.p1), p2=place(scn.p2),
        sn0=place(scn.sn0), sn1=place(scn.sn1), sn2=place(scn.sn2),
        position=place(scn.position), rotation=place(scn.rotation), color=place(scn.color),
        metallic=place(scn.metallic), roughness=place(scn.roughness),
        emission=place(scn.emission), ior=place(scn.ior), mkind=place(scn.mkind),
        light_idx=row_of_old[np.asarray(scn.light_idx)].astype(np.int32),
        bvh=BvhArrays(
            node_min=np.asarray(tree.node_min, np.float32),
            node_max=np.asarray(tree.node_max, np.float32),
            node_left=np.asarray(tree.node_left, np.int32),
            node_right=np.asarray(tree.node_right, np.int32),
            node_is_leaf=np.asarray(tree.node_is_leaf, bool),
            prim_order=np.asarray(tree.prim_order, np.int32),
        ),
    )
    log.debug("BVH (%s): %d primitives, %d nodes, depth %d", builder, n,
              tree.node_left.shape[0], depth)
    return build_packs(reordered), builder


def build_bvh_nodes(bvh: BvhArrays) -> np.ndarray:
    """(M, 8) f32 nodes of K6, two float4 each: ``(min.xyz, a) (max.xyz, b)``
    with the int32 words a, b stored bit for bit in the float slots. An
    internal node has a = left child, b = right child; a leaf a = its first
    primitive row, b = its count with the top bit set."""
    m = bvh.node_left.shape[0]
    nodes = np.zeros((m, NODE_FLOATS), np.float32)
    nodes[:, 0:3] = bvh.node_min
    nodes[:, 4:7] = bvh.node_max
    leaf = np.asarray(bvh.node_is_leaf, bool)
    words = np.empty((m, 2), np.int32)
    words[:, 0] = bvh.node_left
    words[:, 1] = np.where(leaf, np.asarray(bvh.node_right, np.int32) | LEAF_BIT,
                           bvh.node_right)
    nodes[:, 3] = words[:, 0].view(np.float32)
    nodes[:, 7] = words[:, 1].view(np.float32)
    return np.ascontiguousarray(nodes)


def build_bvh_records(scn: SceneArrays, statics: SceneStatics) -> np.ndarray:
    """(N, 12) f32 primitive records of K6 in table order, the fused loop's
    record layout (``ops/bounce.py:loop_records``) with the code ``kind |
    rotated << 2``. A primitive counts as rotated exactly where the plain
    sweep rotates the ray (``statics.any_rotation`` and a quaternion that is
    not the identity), so that the two compute the same bits."""
    p0 = np.asarray(scn.p0, np.float32)
    rot = np.asarray(scn.rotation, np.float32)
    rotated = statics.any_rotation & (rot != np.array([0, 0, 0, 1], np.float32)).any(axis=1)
    codes = np.asarray(scn.ptype, np.int32) | (rotated.astype(np.int32) << 2)
    return loop_records(codes, p0, np.asarray(scn.p1, np.float32) - p0,
                        np.asarray(scn.p2, np.float32) - p0, scn.position, rot)


class Bvh4(NamedTuple):
    """K6's tree: the 4-wide nodes and the stack entries their walk can need."""

    nodes: np.ndarray  # (W, WIDE_FLOATS) f32, breadth-first, root 0
    stack: int  # the most, over root-to-leaf paths, of sum(children - 1)


def _collapse(n: int, left, right, leaf, area) -> list:
    """The binary nodes that stand as children of the wide node made from
    binary node ``n``: starting from its two children, the internal child
    with the largest box area (the first of equal ones) is replaced by its
    two children until there are WIDE or only leaves are left. A leaf root
    stands alone."""
    if leaf[n]:
        return [n]
    ch = [int(left[n]), int(right[n])]
    while len(ch) < WIDE:
        inner = [c for c in ch if not leaf[c]]
        if not inner:
            break
        c = max(inner, key=lambda c: area[c])
        k = ch.index(c)
        ch[k:k + 1] = [int(left[c]), int(right[c])]
    return ch


def build_bvh4_nodes(bvh) -> Bvh4:
    """K6's 4-wide tree, collapsed from the binary tree ``bvh`` (``BvhArrays``
    or the host tree) by ``_collapse``, wide nodes in breadth-first order so
    that the top levels are one contiguous range (K6 stages it in shared
    memory). A wide node is 32 f32, 128 bytes: its children's boxes as
    structure of arrays, ``lo.x[4] lo.y[4] lo.z[4] hi.x[4] hi.y[4]
    hi.z[4]`` (bit for bit the binary nodes' boxes), then 4 int32 child
    words stored bit for bit in the float slots (a wide node's index; a leaf
    as its first row | ``LEAF_BIT``; an empty slot ``LEAF_BIT`` with count
    0), then 4 int32 counts (a leaf's rows, else 0). An empty slot's box is
    +inf on every bound: every slab of it lies at +-inf, so no ray enters it
    and K6 needs no test of the slot. Leaves are exactly the
    binary tree's, so the table order stays. ``stack``: the most, over
    root-to-leaf paths, of sum(children - 1) along the path: the walk pushes
    at most children - 1 entries per wide node it goes through."""
    left = np.asarray(bvh.node_left, np.int64)
    right = np.asarray(bvh.node_right, np.int64)
    leaf = np.asarray(bvh.node_is_leaf, bool)
    nmin = np.asarray(bvh.node_min, np.float32)
    nmax = np.asarray(bvh.node_max, np.float32)
    area = _sah_area(nmin.astype(np.float64), nmax.astype(np.float64))
    wide = [_collapse(0, left, right, leaf, area)]
    index = [[-1] * len(wide[0])]  # wide index of each internal child
    i = 0
    while i < len(wide):  # breadth-first: children get the next indices
        for k, c in enumerate(wide[i]):
            if not leaf[c]:
                index[i][k] = len(wide)
                wide.append(_collapse(c, left, right, leaf, area))
                index.append([-1] * len(wide[-1]))
        i += 1
    w = len(wide)
    child = np.full((w, WIDE), -1, np.int64)  # the binary node of each slot
    sub = np.full((w, WIDE), -1, np.int64)  # the wide node of an internal slot
    for i, (ch, ix) in enumerate(zip(wide, index)):
        child[i, :len(ch)] = ch
        sub[i, :len(ix)] = ix
    used = child >= 0
    c = np.where(used, child, 0)
    nodes = np.zeros((w, WIDE_FLOATS), np.float32)
    for axis in range(3):
        nodes[:, 4 * axis:4 * axis + 4] = np.where(used, nmin[c, axis], np.inf)
        nodes[:, 12 + 4 * axis:16 + 4 * axis] = np.where(used, nmax[c, axis], np.inf)
    is_leaf = used & leaf[c]
    words = np.where(is_leaf, left[c].astype(np.int32) | LEAF_BIT,
                     np.where(used, sub, LEAF_BIT)).astype(np.int32)
    counts = np.where(is_leaf, right[c], 0).astype(np.int32)
    nodes[:, 24:28] = words.view(np.float32)
    nodes[:, 28:32] = counts.view(np.float32)
    bound = [0] * w
    for i in range(w - 1, -1, -1):  # children come after their parent
        below = [bound[j] for j in index[i] if j >= 0]
        bound[i] = len(wide[i]) - 1 + max(below, default=0)
    return Bvh4(np.ascontiguousarray(nodes), int(bound[0]))


# a light's record in K3's light tables above 32 lights (csrc/light_tree.cuh
# LightRecs): its LightCol rows, its spec word (ptype | rotated << 2) stored
# bit for bit in a float slot, a pad; 80 bytes, one row per light
LIGHT_REC = 20
LIGHT_REC_SPEC = LightCol.COUNT


class LightTree(NamedTuple):
    """The lights' own tree (``build_light_tree``): K6's 4-wide layout over
    a binary SAH tree of the light table's boxes. Leaf ranges index
    ``order``, the light at each tree position."""

    nodes: np.ndarray  # (W, WIDE_FLOATS) f32, breadth-first, root 0
    stack: int  # Bvh4.stack of the tree
    order: np.ndarray  # (L,) i32: the light (column of light_packed) at tree position i


def light_records(light_packed: np.ndarray, lspec) -> np.ndarray:
    """(L, LIGHT_REC) f32: light j's LightCol rows, then its spec word."""
    lp = np.asarray(light_packed, np.float32)
    rec = np.zeros((lp.shape[1], LIGHT_REC), np.float32)
    rec[:, :LightCol.COUNT] = lp.T
    rec[:, LIGHT_REC_SPEC] = np.asarray(lspec, np.int32).view(np.float32)
    return rec


def light_aabbs(light_packed: np.ndarray, num_lights: int) -> tuple:
    """``primitive_aabbs`` of the real lights, from the light pack's rows
    (world vertices of a triangle; half extents, position and rotation of a
    box or an ellipsoid), padded as the scene's."""
    lp = np.asarray(light_packed, np.float64)[:, :num_lights]

    def rows(k, n):
        return np.ascontiguousarray(lp[k:k + n].T)

    return primitive_aabbs(SimpleNamespace(
        ptype=lp[LightCol.PTYPE].astype(np.int32), p0=rows(LightCol.P0, 3),
        p1=rows(LightCol.P1, 3), p2=rows(LightCol.P2, 3), position=rows(LightCol.POS, 3),
        rotation=rows(LightCol.ROT, 4)))


def build_light_tree(light_packed: np.ndarray, statics: SceneStatics) -> LightTree | None:
    """The lights' tree, or None at ``UNROLL_MAX_LIGHTS`` lights or fewer
    (K3 then stages the whole table in shared memory). The host builder of
    the scene's tree (``host_bvh``) over ``light_aabbs``, which are
    conservative: every intersection of a ray with a light lies inside its
    padded box, so a walk that tests the boxes against [0, inf) reaches
    every light the ray meets. A tree deeper than the stack raises. Runs in
    the span ``rt.setup.lights`` (inside ``rt.setup.device`` when the
    renderer builds its ``ModularScene``)."""
    n = statics.num_lights
    if n <= UNROLL_MAX_LIGHTS:
        return None
    with span("rt.setup.lights"):
        amin, amax = light_aabbs(light_packed, n)
        tree, _ = host_bvh(amin, amax)
        depth = tree_depth(tree)
        if depth > BVH_STACK:
            raise ValueError(f"light BVH depth {depth} exceeds the traversal stack of "
                             f"{BVH_STACK}")
        wide = build_bvh4_nodes(tree)
    return LightTree(wide.nodes, wide.stack, np.asarray(tree.prim_order, np.int32))

