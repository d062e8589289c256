"""PyTorch port, the BVH backend's host build and nearest hit on the CPU,
against the JAX package.

* The build: ``primitive_aabbs`` and ``build_bvh`` of the port equal the
  JAX package's array for array on the same scene (the same numpy code, so
  exactly); ``validate_bvh`` holds on a triangle soup, a 5,120-triangle mesh
  and a soup of rotated boxes and ellipsoids; the native builder gives a
  valid tree of comparable SAH cost and handles degenerate boxes
  (tests/test_native.py does the same for the JAX package's).
* ``attach_bvh``: the reordered table is a permutation of the original,
  each light's emission is the original light's, the tree fits K6's stack,
  and K6's node and record layouts decode to the tree and the table.
* The nearest hit: the port's plain version (the sweep) against the JAX
  package's treelet traversal on the same rays: ``valid`` and ``is_plane``
  equal, t to 1e-5 relative, and the hit primitive equal after mapping both
  indices to the original table's row (the JAX index is a padded treelet
  slot, the port's a position in the tree's primitive order). On the
  triangle mesh that holds on every lane. With rotated ellipsoids it holds
  on >= 99 % of the hits and t within 1e-3 on all: a grazing hit's
  discriminant cancels, and XLA rounds it differently from one compiled
  program to the next (the JAX package's own treelet and dense sweep differ
  by 1.2e-5 relative on such a lane). The walk model of K6
  (``walk_reference``, the 4-wide tree) and of the binary walk that its
  bound is counted from (``walk_binary``) equal the sweep bit for bit.
"""

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
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
from raytracing_course_2024_tpu_torch.ops.traverse import (
    bvh_nearest,
    bvh_nearest_plain,
    nearest_hit,
    walk_binary,
    walk_reference,
)
from raytracing_course_2024_tpu_torch.ops.vec import Vec3
from raytracing_course_2024_tpu_torch.scene import build_scene_arrays as tbuild
from raytracing_course_2024_tpu_torch.scene import parse_text_scene
from test_bvh import _soup_desc
from torch_parity import to_jnp


def _mixed_text(rng, n=200, planes=False):
    """Rotated boxes and ellipsoids (tests/test_bvh.py:test_bvh_mixed_shapes),
    a few triangles, and with ``planes`` two infinite planes."""
    blocks = []
    for i in range(n):
        s = rng.uniform(0.2, 1.0, 3)
        pos = rng.uniform(-6, 6, 3)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        if i % 5 == 4:
            a = pos + rng.normal(0, 0.7, 3)
            b = pos + rng.normal(0, 0.7, 3)
            blocks.append(f"NEW_PRIMITIVE\nTRIANGLE {' '.join(map(str, [*pos, *a, *b]))}\n"
                          "COLOR 1 1 1\n")
            continue
        kind = ["BOX", "ELLIPSOID"][i % 2]
        blocks.append(f"NEW_PRIMITIVE\n{kind} {s[0]} {s[1]} {s[2]}\n"
                      f"POSITION {pos[0]} {pos[1]} {pos[2]}\n"
                      f"ROTATION {q[0]} {q[1]} {q[2]} {q[3]}\nCOLOR 1 1 1\n")
    if planes:
        blocks.append("NEW_PRIMITIVE\nPLANE 0 1 0\nPOSITION 0 -7 0\nCOLOR 1 1 1\n")
        blocks.append("NEW_PRIMITIVE\nPLANE 1 0 0\nPOSITION -7.5 0 0\n"
                      "ROTATION 0 0 0.1305262 0.9914449\nCOLOR 1 1 1\n")
    return "DIMENSIONS 8 8\n" + "\n".join(blocks)


def _desc(name):
    """(JAX desc, port desc) of one fixture: the JAX soup and mesh
    descriptions carry only attributes, which both builders read."""
    rng = np.random.default_rng(11)
    if name == "soup":
        d = _soup_desc(rng, n=500)
        return d, d
    if name == "mesh":
        v, f, vn = displaced_organic_mesh(subdiv=4)
        d = mesh_scene_desc(v, f, vn)
        return d, d
    text = _mixed_text(rng, planes=name == "mixed_planes")
    from raytracing_course_2024_tpu.scene import parse_text_scene as jparse

    return jparse(text), parse_text_scene(text)


@pytest.mark.parametrize("name", ["soup", "mesh", "mixed"])
def test_build_matches_jax_and_validates(name):
    jd, td = _desc(name)
    ja, js = jbuild(jd)
    ta, ts = tbuild(td)
    jmin, jmax = jbvh.primitive_aabbs(ja)
    tmin, tmax = tbvh.primitive_aabbs(ta)
    np.testing.assert_array_equal(tmin, jmin)
    np.testing.assert_array_equal(tmax, jmax)
    jtree, ttree = jbvh.build_bvh(jmin, jmax), tbvh.build_bvh(tmin, tmax)
    for field in ttree._fields:
        np.testing.assert_array_equal(getattr(ttree, field), getattr(jtree, field), field)
    tbvh.validate_bvh(ttree, tmin, tmax)
    assert 0 < tbvh.tree_depth(ttree) <= tbvh.BVH_STACK


@pytest.fixture(scope="module")
def native():
    try:
        from raytracing_course_2024_tpu_torch.native import load_native, native_build_bvh

        load_native()
    except (OSError, RuntimeError) as e:
        pytest.skip(f"native builder unavailable: {e}")
    return native_build_bvh


def _sah_cost(t):
    d = np.maximum(t.node_max - t.node_min, 0)
    area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    leaf = t.node_is_leaf
    return (area[leaf] * t.node_right[leaf]).sum() + area[~leaf].sum() * 0.25


@pytest.mark.parametrize("case", ["boxes", "mesh", "degenerate"])
def test_native_builder_valid_and_comparable(native, case):
    """A valid tree whose SAH cost is within 15 % of the numpy build's (on
    degenerate input: 300 identical boxes, median splits all the way)."""
    if case == "boxes":
        rng = np.random.default_rng(3)
        amin = rng.uniform(-100, 100, (5000, 3))
        amax = amin + rng.uniform(0.01, 2.0, (5000, 3))
    elif case == "mesh":
        amin, amax = tbvh.primitive_aabbs(tbuild(_desc("mesh")[1])[0])
    else:
        amin, amax = np.zeros((300, 3)), np.ones((300, 3))
    tree = native(amin, amax, tbvh.LEAF_SIZE, tbvh.NUM_BINS)
    tbvh.validate_bvh(tree, amin, amax)
    assert _sah_cost(tree) < 1.15 * _sah_cost(tbvh.build_bvh(amin, amax))
    assert tbvh.tree_depth(tree) <= tbvh.BVH_STACK


@pytest.mark.parametrize("name", ["mesh", "mixed_planes"])
def test_attach_bvh_reorders_the_table(name):
    _, td = _desc(name)
    ta, ts = tbuild(td)
    ra, builder = tbvh.attach_bvh(ta, ts)
    assert builder in ("native", "numpy")
    order = ra.bvh.prim_order
    assert np.array_equal(np.sort(order), np.arange(order.shape[0]))
    for field in ("ptype", "p0", "p1", "p2", "sn0", "position", "rotation", "color",
                  "emission", "mkind"):
        np.testing.assert_array_equal(getattr(ra, field), getattr(ta, field)[order], field)
    np.testing.assert_array_equal(ra.packed, ta.packed[:, order])
    # each light is the same primitive, at its new row
    np.testing.assert_array_equal(ra.emission[ra.light_idx], ta.emission[ta.light_idx])
    np.testing.assert_array_equal(order[ra.light_idx], ta.light_idx)
    np.testing.assert_array_equal(ra.light_packed, ta.light_packed)
    tbvh.validate_bvh(ra.bvh, *tbvh.primitive_aabbs(ta))
    depth = tbvh.tree_depth(ra.bvh)
    assert 0 < depth <= tbvh.BVH_STACK

    # K6's layouts: node words decode to the tree, records to the table
    nodes = tbvh.build_bvh_nodes(ra.bvh)
    words = nodes[:, [3, 7]].copy().view(np.int32)
    leaf = ra.bvh.node_is_leaf
    assert np.array_equal(words[:, 1] < 0, leaf)
    np.testing.assert_array_equal(words[:, 0], ra.bvh.node_left)
    np.testing.assert_array_equal(words[:, 1] & 0x7FFFFFFF, ra.bvh.node_right)
    np.testing.assert_array_equal(nodes[:, 0:3], ra.bvh.node_min)
    rec = tbvh.build_bvh_records(ra, ts).reshape(-1, 3, 4)
    code = rec[:, 0, 3].copy().view(np.int32)
    np.testing.assert_array_equal(code & 3, ra.ptype)
    tri = ra.ptype == 0
    np.testing.assert_array_equal(rec[tri, 1, :3], (ra.p1 - ra.p0)[tri])
    np.testing.assert_array_equal(rec[~tri, 2], ra.rotation[~tri])
    assert ((code >> 2) & 1).any() == (name == "mixed_planes")


def test_attach_bvh_refuses_a_tree_deeper_than_the_stack(monkeypatch):
    _, td = _desc("soup")
    ta, ts = tbuild(td)
    monkeypatch.setattr(tbvh, "BVH_STACK", 3)
    with pytest.raises(ValueError, match="stack"):
        tbvh.attach_bvh(ta, ts)


def test_host_bvh_falls_back_to_numpy_with_a_warning(monkeypatch, caplog):
    """Where the native builder cannot be built or loaded, the numpy build
    makes the tree, and the fallback is logged as a warning."""
    import raytracing_course_2024_tpu_torch.native as tnative

    def unavailable(*_):
        raise OSError("no compiler")

    monkeypatch.setattr(tnative, "native_build_bvh", unavailable)
    amin, amax = tbvh.primitive_aabbs(tbuild(_desc("soup")[1])[0])
    with caplog.at_level("WARNING", logger="rt_torch"):
        tree, builder = tbvh.host_bvh(amin, amax)
    assert builder == "numpy"
    for got, want in zip(tree, tbvh.build_bvh(amin, amax)):
        np.testing.assert_array_equal(got, want)
    assert any(r.levelname == "WARNING" and "numpy" in r.getMessage() for r in caplog.records)


def _rays(rng, b, lo=-8, hi=8):
    o = rng.uniform(lo, hi, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _key_rows(a, rows):
    """Bytes of each row's geometry: the key that maps a row of one table
    to the same primitive in another."""
    cols = [np.asarray(a.ptype)[rows, None].astype(np.float32)] + [
        np.asarray(getattr(a, f), np.float32)[rows] for f in ("p0", "p1", "p2", "position",
                                                              "rotation")]
    return [r.tobytes() for r in np.concatenate(cols, axis=1)]


@pytest.mark.parametrize("case", ["mesh", "mixed_planes", "odd_batch"])
def test_nearest_hit_matches_jax_treelet(case):
    name = "mesh" if case == "odd_batch" else case
    jd, td = _desc(name)
    ja, js = jbuild(jd)
    ta, ts = tbuild(td)
    jarr = jbvh.attach_bvh(ja, js)
    tarr, _ = tbvh.attach_bvh(ta, ts)
    scene = modular_scene(tarr, ts, "cpu")
    rng = np.random.default_rng(5)
    b = 1000 if case == "odd_batch" else 2048
    o, d = _rays(rng, b, *((-0.9, 0.9) if name == "mesh" else (-8, 8)))
    jh = j_nearest_hit_bvh(JVec3(*[jax.numpy.asarray(o[:, i]) for i in range(3)]),
                           JVec3(*[jax.numpy.asarray(d[:, i]) for i in range(3)]),
                           to_jnp(jarr), js)
    ro = Vec3(*[torch.from_numpy(o[:, i].copy()) for i in range(3)])
    rd = Vec3(*[torch.from_numpy(d[:, i].copy()) for i in range(3)])
    th = nearest_hit(ro, rd, scene, plain=True)
    valid = np.asarray(jh.valid)
    assert np.array_equal(th.valid.numpy(), valid)
    assert valid.mean() > 0.3 and (name == "mesh" or not valid.all())
    assert np.array_equal(th.is_plane.numpy(), np.asarray(jh.is_plane))
    tt, jt = th.t.numpy()[valid], np.asarray(jh.t)[valid]
    close = np.isclose(tt, jt, rtol=1e-5, atol=0)
    np.testing.assert_allclose(tt, jt, rtol=1e-5 if name == "mesh" else 1e-3)
    assert close.mean() >= 0.99, close.mean()
    # the hit primitive: both indices mapped to the original table's row
    fin = valid & ~np.asarray(jh.is_plane)
    orig = {k: i for i, k in enumerate(_key_rows(ta, np.arange(ta.ptype.shape[0])))}
    j_rows = np.asarray([orig[k] for k in _key_rows(jarr, np.asarray(jh.idx)[fin])])
    t_rows = tarr.bvh.prim_order[th.idx.numpy()[fin]]
    same = j_rows == t_rows
    assert same.all() if name == "mesh" else same.mean() >= 0.99, same.mean()
    on_plane = valid & np.asarray(jh.is_plane)
    assert np.array_equal(th.idx.numpy()[on_plane], np.asarray(jh.idx)[on_plane])

    # K6's walk of the 4-wide tree, modelled node for node, and the binary
    # walk of the yardstick both find the sweep's hit bit for bit
    t_s, i_s = bvh_nearest_plain(ro, rd, scene)
    t_w, i_w, visits, boxes, tests, top = walk_reference(ro, rd, scene)
    assert torch.equal(t_w, t_s) and torch.equal(i_w, i_s)
    assert (boxes[torch.isfinite(t_s)] > 0).all() and (tests >= 0).all()
    assert (top <= visits).all() and (top[torch.isfinite(t_s)] > 0).all()
    assert tests.sum() < 0.25 * b * ta.ptype.shape[0]  # the walk prunes
    nodes = torch.from_numpy(tbvh.build_bvh_nodes(tarr.bvh))
    t_b, i_b, inner, leaves, tests_b = walk_binary(ro, rd, scene, nodes)
    assert torch.equal(t_b, t_s) and torch.equal(i_b, i_s)
    assert (leaves[torch.isfinite(t_s)] > 0).all() and inner.sum() > visits.sum()


def test_bvh_wrapper_on_cpu_takes_the_plain_version():
    """On the CPU ``bvh_nearest`` is the sweep and counts no launch; with a
    live mask, masked lanes get the miss (inf, 0)."""
    _, td = _desc("mesh")
    ta, ts = tbuild(td)
    scene = modular_scene(tbvh.attach_bvh(ta, ts)[0], ts, "cpu")
    o, d = _rays(np.random.default_rng(2), 777, -0.9, 0.9)
    ro = Vec3(*[torch.from_numpy(o[:, i].copy()) for i in range(3)])
    rd = Vec3(*[torch.from_numpy(d[:, i].copy()) for i in range(3)])
    live = torch.from_numpy(np.random.default_rng(3).uniform(size=777) < 0.5)
    kernels.reset_launches()
    t, i = bvh_nearest(ro, rd, scene, live=live)
    tp, ip = bvh_nearest_plain(ro, rd, scene)
    assert kernels.LAUNCHES["bvh"] == 0
    assert torch.equal(t[live], tp[live]) and torch.equal(i[live], ip[live])
    assert torch.isinf(t[~live]).all() and (i[~live] == 0).all()
    assert torch.isfinite(t[live]).any()
    with pytest.raises(ValueError):
        bvh_nearest(Vec3(*(c.to("meta") for c in ro)), rd, scene)
