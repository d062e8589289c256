"""PyTorch port, K6's 4-wide tree and its walk on the CPU.

* ``build_bvh4_nodes``: on a triangle soup, a 5,120-triangle mesh and a soup
  of rotated boxes, ellipsoids and triangles with planes, the leaf ranges
  are the binary tree's and cover every row once, each child box is bit for
  bit the binary node's box it stands for, an empty slot's box is +inf,
  nodes are 128-byte rows in
  breadth-first order, and the stack bound equals a brute force over the
  root-to-leaf paths.
* ``walk_reference`` (K6's walk, node for node) equals the sweep bit for
  bit (t and row) and the JAX package's treelet traversal within the
  tolerance of ``test_torch_bvh.py:test_nearest_hit_matches_jax_treelet``,
  with and without a live mask; on duplicate triangles (the lowest row
  wins), rays that start inside boxes and axis-parallel rays (infinite
  ``inv``, NaN slabs).
* Empty slots, whose boxes lie at +inf, miss every ray; the walk counts
  its visits to K6's staged top.
* Two binary trees of depth ``BVH_STACK`` built directly, a chain and the
  shape whose wide walk pushes 3 entries per binary level: their stack
  bounds are exact, K6's stack takes both, and the walk equals the sweep on
  them.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from meshes import displaced_organic_mesh, mesh_scene_desc
from raytracing_course_2024_tpu.ops import bvh as jbvh
from raytracing_course_2024_tpu.ops.traverse import nearest_hit_bvh as j_nearest_hit_bvh
from raytracing_course_2024_tpu.ops.vec import Vec3 as JVec3
from raytracing_course_2024_tpu.scene import build_scene_arrays as jbuild
from raytracing_course_2024_tpu_torch.ops import bvh as tbvh
from raytracing_course_2024_tpu_torch.ops.scene_intersect import (
    SceneHit,
    _fold_in_planes,
    modular_scene,
)
from raytracing_course_2024_tpu_torch.ops.traverse import (
    _box_entry,
    bvh_nearest_plain,
    check_stack,
    walk_reference,
)
from raytracing_course_2024_tpu_torch.ops.vec import Vec3
from raytracing_course_2024_tpu_torch.scene import build_scene_arrays as tbuild
from raytracing_course_2024_tpu_torch.scene.types import (
    TRI,
    BvhArrays,
    CameraDesc,
    PrimitiveDesc,
    RenderSettings,
    SceneDesc,
)
from test_torch_bvh import _desc, _key_rows, _rays
from torch_parity import to_jnp

NAMES = ["soup", "mesh", "mixed_planes"]


def _split(nodes):
    """(lo (W,4,3), hi (W,4,3), words (W,4), counts (W,4)) of wide nodes."""
    w = nodes.shape[0]
    lo = nodes[:, 0:12].reshape(w, 3, 4).transpose(0, 2, 1)
    hi = nodes[:, 12:24].reshape(w, 3, 4).transpose(0, 2, 1)
    words = nodes[:, 24:28].copy().view(np.int32)
    counts = nodes[:, 28:32].copy().view(np.int32)
    return lo, hi, words, counts


def _paths_brute(nodes):
    """The most, over every root-to-leaf path of the wide tree, of the sum
    of (children - 1) along it: every path enumerated."""
    _, _, words, counts = _split(nodes)
    kids = (words >= 0) | (counts > 0)
    best, todo = 0, [(0, 0)]
    while todo:
        n, acc = todo.pop()
        acc += int(kids[n].sum()) - 1
        inner = [int(c) for c in words[n][words[n] >= 0]]
        if not inner:
            best = max(best, acc)
        if kids[n].sum() > len(inner):  # a leaf child ends a path here
            best = max(best, acc)
        todo += [(c, acc) for c in inner]
    return best


def _check_layout(bvh):
    wide = tbvh.build_bvh4_nodes(bvh)
    nodes = wide.nodes
    assert nodes.dtype == np.float32 and nodes.shape[1] * 4 == 128
    assert nodes.flags.c_contiguous
    lo, hi, words, counts = _split(nodes)
    leaf_b = np.asarray(bvh.node_is_leaf)
    nmin, nmax = np.asarray(bvh.node_min), np.asarray(bvh.node_max)
    # leaf ranges: exactly the binary leaves, each row in one range
    is_leaf = (words < 0) & (counts > 0)
    first = words[is_leaf] & 0x7FFFFFFF
    ranges = sorted(zip(first.tolist(), counts[is_leaf].tolist()))
    binary = sorted(zip(np.asarray(bvh.node_left)[leaf_b].tolist(),
                        np.asarray(bvh.node_right)[leaf_b].tolist()))
    assert ranges == binary
    n_rows = np.asarray(bvh.prim_order).shape[0]
    cover = np.zeros(n_rows, np.int64)
    for s, c in ranges:
        cover[s:s + c] += 1
    assert (cover == 1).all()
    # each leaf slot's box is its binary leaf's, bit for bit
    by_range = {(int(a), int(b)): i for i, (a, b) in enumerate(
        zip(bvh.node_left, bvh.node_right)) if leaf_b[i]}
    for n, j in zip(*np.nonzero(is_leaf)):
        i = by_range[(int(words[n, j] & 0x7FFFFFFF), int(counts[n, j]))]
        assert lo[n, j].tobytes() == nmin[i].tobytes() and hi[n, j].tobytes() == nmax[i].tobytes()
    # an internal slot's box is a binary internal node's and the union of its
    # wide node's slots; the wide root's slots unite to the binary root's box
    inner_boxes = {nmin[i].tobytes() + nmax[i].tobytes() for i in np.nonzero(~leaf_b)[0]}
    used = (words >= 0) | (counts > 0)

    def union(m):
        return lo[m][used[m]].min(0), hi[m][used[m]].max(0)

    for n, j in zip(*np.nonzero(words >= 0)):
        m = words[n, j]
        ulo, uhi = union(m)
        assert lo[n, j].tobytes() == ulo.tobytes() and hi[n, j].tobytes() == uhi.tobytes()
        assert lo[n, j].tobytes() + hi[n, j].tobytes() in inner_boxes
    rlo, rhi = union(0)
    assert rlo.tobytes() == nmin[0].tobytes() and rhi.tobytes() == nmax[0].tobytes()
    # breadth-first: the internal slots, read row by row, name 1, 2, 3, ...
    assert np.array_equal(words[words >= 0], np.arange(1, nodes.shape[0]))
    # empty slots: the leaf bit, count 0, boxes at +inf, packed after the used ones
    assert not (used[:, 1:] & ~used[:, :-1]).any()
    assert (words[~used] == np.int32(tbvh.LEAF_BIT)).all() and (counts[~used] == 0).all()
    assert np.isposinf(lo[~used]).all() and np.isposinf(hi[~used]).all()
    assert np.isfinite(lo[used]).all() and np.isfinite(hi[used]).all()
    assert wide.stack == _paths_brute(nodes)
    return wide


@pytest.mark.parametrize("name", NAMES)
def test_build_bvh4_nodes_layout(name):
    _, td = _desc(name)
    ta, ts = tbuild(td)
    ra, _ = tbvh.attach_bvh(ta, ts)
    wide = _check_layout(ra.bvh)
    depth = tbvh.tree_depth(ra.bvh)
    # a wide level spans at least one binary level and pushes at most 3
    assert 0 < wide.stack <= 3 * depth <= tbvh.WIDE_STACK
    assert wide.nodes.shape[0] < ra.bvh.node_left.shape[0] / 2


def _torch_rays(o, d):
    return (Vec3(*[torch.from_numpy(o[:, i].copy()) for i in range(3)]),
            Vec3(*[torch.from_numpy(d[:, i].copy()) for i in range(3)]))


def _walk_equals_sweep(ro, rd, scene, tmin=0.0, live=None):
    """The wide walk against the sweep, bit for bit; returns the walk."""
    t_s, i_s = bvh_nearest_plain(ro, rd, scene, tmin, live)
    out = walk_reference(ro, rd, scene, tmin, live)
    assert torch.equal(out[0], t_s) and torch.equal(out[1], i_s)
    if live is not None:
        assert (out[2][~live] == 0).all() and (out[4][~live] == 0).all()
    return out


@pytest.mark.parametrize("name", NAMES)
def test_wide_walk_matches_sweep_and_jax_treelet(name):
    jd, td = _desc(name)
    ja, js = jbuild(jd)
    ta, ts = tbuild(td)
    jarr = jbvh.attach_bvh(ja, js)
    tarr, _ = tbvh.attach_bvh(ta, ts)
    scene = modular_scene(tarr, ts, "cpu")
    rng = np.random.default_rng(7)
    b = 1536
    o, d = _rays(rng, b, *((-0.9, 0.9) if name == "mesh" else (-8, 8)))
    ro, rd = _torch_rays(o, d)
    t_w, i_w, visits, boxes, tests, top = _walk_equals_sweep(ro, rd, scene)
    live = torch.from_numpy(rng.uniform(size=b) < 0.6)
    t_m, i_m, *_ = _walk_equals_sweep(ro, rd, scene, live=live)
    assert torch.equal(t_m[live], t_w[live]) and torch.isinf(t_m[~live]).all()
    assert (i_m[~live] == 0).all()
    hit = torch.isfinite(t_w)
    assert (visits[hit] > 0).all() and (boxes >= visits).all() and (boxes <= 4 * visits).all()
    assert (top <= visits).all() and (top[hit] > 0).all()  # a walk starts at the root
    assert (tests[hit] > 0).all() and tests.sum() < 0.25 * b * ta.ptype.shape[0]

    # against the JAX treelet: the planes folded in as nearest_hit does
    jh = j_nearest_hit_bvh(JVec3(*[jax.numpy.asarray(o[:, i]) for i in range(3)]),
                           JVec3(*[jax.numpy.asarray(d[:, i]) for i in range(3)]),
                           to_jnp(jarr), js)
    th = SceneHit(t_w, i_w, torch.zeros_like(hit), hit)
    if ts.num_planes > 0:
        th = _fold_in_planes(ro, rd, scene, th, 0.0)
    valid = np.asarray(jh.valid)
    assert np.array_equal(th.valid.numpy(), valid) and valid.mean() > 0.05
    assert np.array_equal(th.is_plane.numpy(), np.asarray(jh.is_plane))
    tt, jt = th.t.numpy()[valid], np.asarray(jh.t)[valid]
    np.testing.assert_allclose(tt, jt, rtol=1e-5 if name == "mesh" else 1e-3)
    assert np.isclose(tt, jt, rtol=1e-5, atol=0).mean() >= 0.99
    fin = valid & ~np.asarray(jh.is_plane)
    orig = {k: i for i, k in enumerate(_key_rows(ta, np.arange(ta.ptype.shape[0])))}
    j_rows = np.asarray([orig[k] for k in _key_rows(jarr, np.asarray(jh.idx)[fin])])
    same = j_rows == tarr.bvh.prim_order[th.idx.numpy()[fin]]
    assert same.all() if name == "mesh" else same.mean() >= 0.99, same.mean()


def _mesh_scene(duplicate=False):
    v, f, vn = displaced_organic_mesh(subdiv=3)
    desc = mesh_scene_desc(v, f, vn)
    if duplicate:  # every triangle twice, the copies far apart in the table
        desc = dataclasses.replace(desc, primitives=desc.primitives + desc.primitives)
    ta, ts = tbuild(desc)
    tarr, _ = tbvh.attach_bvh(ta, ts)
    return tarr, modular_scene(tarr, ts, "cpu")


def test_wide_walk_on_duplicate_triangles_takes_the_lowest_row():
    tarr, scene = _mesh_scene(duplicate=True)
    n = tarr.ptype.shape[0] // 2
    o, d = _rays(np.random.default_rng(8), 1024, -0.9, 0.9)
    ro, rd = _torch_rays(o, d)
    t, row, *_ = _walk_equals_sweep(ro, rd, scene)
    hit = torch.isfinite(t)
    assert hit.float().mean() > 0.5
    # the other copy of each hit triangle lies at a higher row
    orig = tarr.bvh.prim_order
    twin = {}
    for r_new, r_old in enumerate(orig):
        twin.setdefault(r_old % n, []).append(r_new)
    for r in row[hit].tolist():
        assert r == min(twin[orig[r] % n])


def test_wide_walk_from_inside_boxes_and_past_tmin():
    tarr, scene = _mesh_scene()
    rng = np.random.default_rng(9)
    rows = rng.integers(0, tarr.ptype.shape[0], 1024)
    cen = ((tarr.p0 + tarr.p1 + tarr.p2) / 3.0)[rows]
    o = (cen + rng.normal(0, 1e-3, cen.shape)).astype(np.float32)  # inside leaf boxes
    _, d = _rays(rng, 1024)
    ro, rd = _torch_rays(o, d)
    for tmin in (0.0, 1e-3):
        t, *_ = _walk_equals_sweep(ro, rd, scene, tmin)
        assert torch.isfinite(t).float().mean() > 0.5


def test_wide_walk_on_axis_parallel_rays():
    """Directions along the axes (inv = +-inf) from random origins and from
    origins on box planes (a slab product 0 * inf = NaN)."""
    tarr, scene = _mesh_scene()
    rng = np.random.default_rng(10)
    lo, hi, words, counts = _split(scene.bvh_nodes.numpy())
    used = (words >= 0) | (counts > 0)
    planes = np.concatenate([lo[used], hi[used]])
    b = 1200
    axis = rng.integers(0, 3, b)
    d = np.zeros((b, 3), np.float32)
    d[np.arange(b), axis] = rng.choice([-1.0, 1.0], b)
    neg = np.arange(b // 3, b)[::2]  # a negative zero in another component
    d[neg, (axis[neg] + 2) % 3] = -0.0
    d[np.arange(b)[: b // 6], (axis[: b // 6] + 1) % 3] = 0.6  # two axes, one zero
    o = rng.uniform(-1.2, 1.2, (b, 3)).astype(np.float32)
    on = rng.uniform(size=(b, 3)) < 0.5  # put coordinates on slab planes
    o = np.where(on, planes[rng.integers(0, planes.shape[0], b)], o).astype(np.float32)
    ro, rd = _torch_rays(o, d)
    t, *_ = _walk_equals_sweep(ro, rd, scene)
    assert torch.isfinite(t).any() and not torch.isfinite(t).all()


# --- binary trees of depth BVH_STACK, built directly ------------------------


def _tri_scene(centres, size=0.1):
    cam = CameraDesc(position=np.zeros(3), right=np.array([1.0, 0, 0]),
                     up=np.array([0, 1.0, 0]), forward=np.array([0, 0, -1.0]), fov_x=1.0,
                     fov_y=1.0)
    prims = [PrimitiveDesc(ptype=TRI, p0=c, p1=c + [size, 0, 0], p2=c + [0, size, 0],
                           color=np.ones(3)) for c in np.asarray(centres, np.float64)]
    return tbuild(SceneDesc(settings=RenderSettings(width=8, height=8, samples=1, ray_depth=2,
                                                    bg_color=(0.0, 0.0, 0.0), camera=cam),
                            primitives=prims, planes=[]))


def _tree(shape, amin, amax) -> BvhArrays:
    """A binary tree of nested pairs (leaf: a row), parents before children,
    node boxes the union of their rows' boxes."""
    lo, hi, left, right, leaf = [], [], [], [], []

    def alloc():
        for a in (lo, hi, left, right, leaf):
            a.append(None)
        return len(lo) - 1

    def build(sh, n):
        if isinstance(sh, int):
            lo[n], hi[n], left[n], right[n], leaf[n] = amin[sh], amax[sh], sh, 1, True
            return
        a, b = alloc(), alloc()
        build(sh[0], a)
        build(sh[1], b)
        lo[n], hi[n] = np.minimum(lo[a], lo[b]), np.maximum(hi[a], hi[b])
        left[n], right[n], leaf[n] = a, b, False

    build(shape, alloc())
    return BvhArrays(node_min=np.asarray(lo, np.float32), node_max=np.asarray(hi, np.float32),
                     node_left=np.asarray(left, np.int32), node_right=np.asarray(right, np.int32),
                     node_is_leaf=np.asarray(leaf, bool),
                     prim_order=np.arange(amin.shape[0], dtype=np.int32))


def _chain():
    """A leaf and the rest at every level: 65 rows, depth 64. Each wide node
    opens the internal child twice (4 children, 3 binary levels), the last
    has 2: the bound is 21 x 3 + 1."""
    d = tbvh.BVH_STACK
    centres = [[float(i), 0.0, 0.0] for i in range(d + 1)]
    shape = d
    for i in range(d - 1, -1, -1):
        shape = (i, shape)
    return centres, shape, 21 * 3 + 1


def _worst():
    """Spine S_k = (S_k+1, Y) with Y = ((leaf, leaf), leaf), Y's boxes larger
    than S_k+1's, so that the collapse opens Y and its internal child and
    leaves S_k+1 unopened: every wide node on the spine has 4 children and
    descends one binary level. 62 such levels and a last (leaf, leaf): depth
    64 (Y's leaves lie 3 below their S), bound 62 x 3 + 1."""
    m = tbvh.BVH_STACK - 2
    centres, rows = [], []

    def leaf(c):
        centres.append(c)
        return len(centres) - 1

    for k in range(m):
        r = 1.1 ** (m - k)
        rows.append((leaf([-r, -r, 0.0]), leaf([r, r, 0.0]), leaf([r, -r, 0.0])))
    last = (leaf([0.0, 0.0, 0.0]), leaf([0.05, 0.05, 0.0]))
    shape = last
    for a, b, c in reversed(rows):
        shape = (shape, ((a, b), c))
    return centres, shape, m * 3 + 1


@pytest.mark.parametrize("which", ["chain", "worst"])
def test_trees_of_the_deepest_depth_fit_the_wide_stack(which):
    centres, shape, want = (_chain if which == "chain" else _worst)()
    ta, ts = _tri_scene(centres)
    tree = _tree(shape, *tbvh.primitive_aabbs(ta))
    tbvh.validate_bvh(tree, *tbvh.primitive_aabbs(ta))
    assert tbvh.tree_depth(tree) == tbvh.BVH_STACK
    wide = _check_layout(tree)
    assert wide.stack == want <= tbvh.WIDE_STACK
    check_stack(wide.stack)  # the launcher's check takes it
    with pytest.raises(ValueError, match="stack"):
        check_stack(tbvh.WIDE_STACK + 1)
    scene = modular_scene(ta._replace(bvh=tree), ts, "cpu")
    assert scene.bvh_stack == want
    rng = np.random.default_rng(12)
    span = 1.1 ** tbvh.BVH_STACK if which == "worst" else tbvh.BVH_STACK
    o = rng.uniform(-span, span, (512, 3)).astype(np.float32)
    o[:, 2] = rng.choice([-3.0, 3.0], 512)
    d = np.stack([rng.normal(0, 2e-3, 512), rng.normal(0, 2e-3, 512), -np.sign(o[:, 2])], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o[:256, :2] = np.asarray(centres, np.float32)[rng.integers(0, len(centres), 256), :2] + 0.02
    ro, rd = _torch_rays(o, d)
    t, *_ = _walk_equals_sweep(ro, rd, scene)
    assert torch.isfinite(t).float().mean() > 0.3


# --- empty slots and the staged top --------------------------------------------

SCENES = NAMES + ["mesh3"]


def _scene(name):
    """The modular scene of a ``NAMES`` fixture or of the ``_mesh_scene`` mesh."""
    if name in NAMES:
        _, td = _desc(name)
        ta, ts = tbuild(td)
        tarr, _ = tbvh.attach_bvh(ta, ts)
        return modular_scene(tarr, ts, "cpu")
    return _mesh_scene()[1]


@pytest.mark.parametrize("name", SCENES)
def test_empty_slots_miss_every_ray(name):
    """K6 tests an empty slot's box as any other (no check of the slot): its
    bounds at +inf give every slab +-inf, never NaN, so the box test misses
    on random directions, on directions along one or two axes (an infinite
    ``inv``, of either sign) and on origins inside and outside the scene,
    whatever tmin and the best so far."""
    scene = _scene(name)
    lo, hi, words, counts = _split(scene.bvh_nodes.numpy())
    empty = (words < 0) & (counts == 0)
    assert empty.any()
    rng = np.random.default_rng(14)
    b = 2048
    o, d = _rays(rng, b, -8, 8)
    axis = rng.integers(0, 3, b // 2)
    d[: b // 2] = 0.0
    d[np.arange(b // 2), axis] = rng.choice([-1.0, 1.0], b // 2)
    d[: b // 4, (axis[: b // 4] + 1) % 3] = rng.choice([-0.6, 0.6, -0.0], b // 4)
    inv = 1.0 / torch.from_numpy(d.astype(np.float32))
    ro = torch.from_numpy(o.astype(np.float32))
    e_lo = torch.from_numpy(lo[empty][None])  # (1, E, 3)
    e_hi = torch.from_numpy(hi[empty][None])
    for tmin, limit in ((0.0, float("inf")), (1e-3, float("inf")), (0.0, 5.0)):
        t = _box_entry(Vec3(e_lo[..., 0], e_lo[..., 1], e_lo[..., 2]),
                       Vec3(e_hi[..., 0], e_hi[..., 1], e_hi[..., 2]),
                       Vec3(*(ro[:, i, None] for i in range(3))),
                       Vec3(*(inv[:, i, None] for i in range(3))), tmin,
                       torch.full((b, 1), limit))
        assert torch.isposinf(t).all()


@pytest.mark.parametrize("name", SCENES)
def test_walk_counts_the_visits_to_the_staged_top(name):
    """``walk_reference``'s sixth output: the visits to the first ``n_top``
    nodes. At most the visits, one (the root) a walked ray at ``n_top`` 1,
    all of them once ``n_top`` spans the table, and K6's ``kTop`` by
    default."""
    scene = _scene(name)
    rng = np.random.default_rng(15)
    o, d = _rays(rng, 512, *((-1.2, 1.2) if name.startswith("mesh") else (-8, 8)))
    ro, rd = _torch_rays(o, d)
    live = torch.from_numpy(rng.uniform(size=512) < 0.7)
    _, _, visits, _, _, top = walk_reference(ro, rd, scene, live=live)
    assert (top <= visits).all() and (visits[live] > 0).all() and (top[~live] == 0).all()
    assert torch.equal(walk_reference(ro, rd, scene, live=live, n_top=1)[5], (visits > 0).long())
    every = walk_reference(ro, rd, scene, live=live, n_top=scene.bvh_nodes.shape[0])[5]
    assert torch.equal(every, visits)
    assert tbvh.WIDE_TOP == 85 and torch.equal(
        walk_reference(ro, rd, scene, live=live, n_top=85)[5], top)
