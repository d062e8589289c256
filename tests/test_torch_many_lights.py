"""PyTorch port, scenes of more than 32 lights: the course's practice6_1
(``rtbench/scenes/practice6_1.py``: 16,910 triangles, 1,164 of them lights)
and K3's light pdf by an all-hits walk of the lights' own tree.

On the CPU:

* the scene builder's counts;
* the lights' tree (``ops/bvh.py:build_light_tree``): its leaves hold every
  light exactly once, and every box holds what lies below it (a leaf slot's
  box each of its lights' triangles, an internal slot's box every box of the
  node it points to);
* ``modular_scene`` builds the tables K3 walks above 32 lights (the light
  records in light order and in the tree's order, the tree's nodes and
  stack bound) once, in the span ``rt.setup.lights``, and none at 32 lights
  or fewer;
* the ``Renderer`` on the BVH backend and its default engine, the counter
  wavefront, at 16x9 and 2 spp, against the benchmark's plain reference
  (``rtbench/reference/tracer.py:render_pixels``) on every pixel: no judged
  pixel off (``rtbench/check.py:compare``) and the same path vertices; its
  set-up builds the tree once, in the span ``rt.setup.lights`` inside
  ``rt.setup.device``.

On a card (marked ``cuda``; skipped here): K3 above 32 lights, in the batch
layout and in lane mode, against its plain version on random states of the
scene, a third of them just off the torus tube so that light-sampled
directions graze it; and its persistent warps (``csrc/light_tree.cuh``)
with ``need`` all set, about 5 % scattered and none, on fewer lanes than one
warp's chunk and on more than the grid's first draw, two launches and the
replay of a captured graph bit for bit equal (the tickets come back to 0).
"""

import json
import os

import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops import rng as trng
from raytracing_course_2024_tpu_torch.ops.bvh import (LEAF_BIT, WIDE, attach_bvh,
                                                      build_light_tree, light_records)
from raytracing_course_2024_tpu_torch.ops.sampler import sample_mixture_kernel, sampler_plain
from raytracing_course_2024_tpu_torch.ops.sampling import UNROLL_MAX_LIGHTS
from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
from raytracing_course_2024_tpu_torch.ops.vec import Vec3
from raytracing_course_2024_tpu_torch.runtime import profiling
from raytracing_course_2024_tpu_torch.scene import build_scene_arrays
from raytracing_course_2024_tpu_torch.scene.types import LightCol as LC
from rtbench import check, run, scenes
from rtbench.program import System, scene_desc
from rtbench.reference import tracer
from rtbench.reference.rng import frame_seed32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "rtbench", "configs")
SEED = 3_000_000_019
K = 4


def _spec(w=16, h=9):
    with open(os.path.join(CONFIGS, "practice6_1.json")) as f:
        conf = json.load(f)
    return conf, scenes.build(conf["scene"], CONFIGS, w, h)


@pytest.fixture(scope="module")
def built():
    """The scene's arrays on the BVH backend and its modular scene on the
    CPU."""
    _, spec = _spec()
    arrays, statics = build_scene_arrays(scene_desc(spec, 1))
    arrays, _ = attach_bvh(arrays, statics)
    return arrays, statics, modular_scene(arrays, statics, "cpu")


def test_scene_builder_counts():
    conf, spec = _spec(8, 4)
    emissive = np.linalg.norm(spec.prims["emission"], axis=1) > 1e-5
    assert spec.num_prims == conf["triangles"] == 16_910
    assert int(emissive.sum()) == conf["lights"] == 1_164
    assert (spec.prims["kind"] == scenes.TRI).all()


def test_light_tree_holds_every_light_once_in_boxes_that_hold_it(built):
    arrays, statics, scene = built
    tree = build_light_tree(arrays.light_packed, statics)
    assert statics.num_lights == 1_164 > UNROLL_MAX_LIGHTS
    order = np.asarray(tree.order)
    assert np.array_equal(np.sort(order), np.arange(statics.num_lights))
    nodes = tree.nodes
    lo, hi = nodes[:, 0:12].reshape(-1, 3, WIDE), nodes[:, 12:24].reshape(-1, 3, WIDE)
    words = nodes[:, 24:28].view(np.int32)
    counts = nodes[:, 28:32].view(np.int32)
    lp = np.asarray(arrays.light_packed)
    verts = np.stack([lp[LC.P0 + 3 * k:LC.P0 + 3 * k + 3].T for k in range(3)], 1)  # (L, 3, 3)
    seen = np.zeros(statics.num_lights, np.int64)
    for i in range(nodes.shape[0]):
        for k in range(WIDE):
            w, c = int(words[i, k]), int(counts[i, k])
            if w < 0 and c == 0:
                continue
            box_lo, box_hi = lo[i, :, k], hi[i, :, k]
            if w < 0:
                first = w & ~int(LEAF_BIT)
                lights = order[first:first + c]
                seen[first:first + c] += 1
                v = verts[lights]
                assert (v >= box_lo[None, None, :]).all() and (v <= box_hi[None, None, :]).all()
            else:
                used = (words[w] >= 0) | (counts[w] > 0)
                assert (lo[w][:, used] >= box_lo[:, None]).all()
                assert (hi[w][:, used] <= box_hi[:, None]).all()
    assert (seen == 1).all()
    np.testing.assert_array_equal(scene.light_leaf.numpy(), scene.light_rec.numpy()[order])
    assert scene.light_nodes.shape[0] == nodes.shape[0] and scene.light_stack == tree.stack


def _rays(arrays, statics, n, seed=0):
    """(origins, directions): a third aimed at points of random lights, a
    third in random directions from around the scene, a third leaving points
    just off the torus tube along its tangent plane (grazing the tube)."""
    g = np.random.default_rng(seed)
    lp = np.asarray(arrays.light_packed, np.float64)
    m = n // 3
    pts = g.uniform([-2.5, 0.0, -1.0], [1.5, 2.5, 2.0], (n, 3))
    j = g.integers(0, statics.num_lights, m)
    u = g.uniform(0.0, 0.5, (m, 2))
    p0, p1, p2 = (lp[LC.P0 + 3 * k:LC.P0 + 3 * k + 3].T[j] for k in range(3))
    aim = p0 + (p1 - p0) * u[:, :1] + (p2 - p0) * u[:, 1:]
    dirs = g.normal(size=(n, 3))
    dirs[:m] = aim - pts[:m]
    # the torus's triangles: the lights of type TRI in the first 1,152 of the table
    tor = np.arange(1_152)
    centre = (lp[LC.P0:LC.P0 + 3, tor].T + lp[LC.P1:LC.P1 + 3, tor].T
              + lp[LC.P2:LC.P2 + 3, tor].T) / 3.0
    fn = np.cross(lp[LC.P1:LC.P1 + 3, tor].T - lp[LC.P0:LC.P0 + 3, tor].T,
                  lp[LC.P2:LC.P2 + 3, tor].T - lp[LC.P0:LC.P0 + 3, tor].T)
    fn /= np.linalg.norm(fn, axis=1, keepdims=True)
    k = g.integers(0, 1_152, n - 2 * m)
    t = np.cross(fn[k], g.normal(size=(n - 2 * m, 3)))
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    pts[2 * m:] = centre[k] + 2e-3 * fn[k] - 0.05 * t
    dirs[2 * m:] = t + 0.02 * g.normal(size=(n - 2 * m, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return pts.astype(np.float32), dirs.astype(np.float32)


def test_modular_scene_builds_the_light_tables_once_in_their_span(built):
    arrays, statics, _ = built
    profiling.SPANS.clear()
    scene = modular_scene(arrays, statics, "cpu")
    assert profiling.span_totals()["rt.setup.lights"][0] == 1
    tree = build_light_tree(arrays.light_packed, statics)
    rec = light_records(scene.lp_np, scene.lspec.numpy())
    np.testing.assert_array_equal(scene.light_rec.numpy(), rec)
    np.testing.assert_array_equal(scene.light_leaf.numpy(), rec[tree.order])
    np.testing.assert_array_equal(scene.light_nodes.numpy(), tree.nodes)
    few = arrays._replace(light_packed=arrays.light_packed[:, :UNROLL_MAX_LIGHTS])
    profiling.SPANS.clear()
    small = modular_scene(few, statics._replace(
        num_lights=UNROLL_MAX_LIGHTS, light_types=statics.light_types[:UNROLL_MAX_LIGHTS],
        light_rotated=statics.light_rotated[:UNROLL_MAX_LIGHTS]), "cpu")
    assert "rt.setup.lights" not in profiling.span_totals()
    assert small.light_rec is small.light_leaf is small.light_nodes is small.light_stack is None


def test_renderer_agrees_with_the_reference_on_every_pixel():
    conf, spec = _spec()
    spp = 2
    profiling.SPANS.clear()
    system = System(spec, spp, 1, conf["backend"], conf["max_tries"], False, device="cpu")
    assert system.engine == "wavefront" and system.r.scene.light_nodes is not None
    totals = profiling.span_totals()
    assert totals["rt.setup.lights"][0] == 1 and totals["rt.setup.device"][0] == 1
    img, verts = system.frame(run.frame_seed(SEED, 0))
    ref_scene = tracer.Scene(spec, "cpu", tree=True)
    n = spec.width * spec.height
    ref, rv = tracer.render_pixels(ref_scene, frame_seed32(run.frame_seed(SEED, 0)),
                                   torch.arange(n), spp, True, conf["max_tries"], False)
    assert float(rv.sum()) == verts
    nums = check.compare([(img, verts)], [(ref, rv.sum())], n, n)
    assert nums == {"pixel_mismatch_pct": 0.0, "verts_rel_err_pct": 0.0}
    assert float(img.mean()) > 0.05


def test_few_lights_build_no_tree(built):
    _, statics, _ = built
    lp = np.zeros((LC.COUNT, 32), np.float32)
    assert build_light_tree(lp, statics._replace(num_lights=32)) is None


# --- on the card ------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 runs only there")
    return torch.device("cuda", 0)


def _states(arrays, statics, n, dev, seed=5):
    """Random sampler inputs of the scene on ``dev``: points around it, a
    third just off the torus tube with its face normal (light-sampled
    directions then graze the tube)."""
    g = np.random.default_rng(seed)
    pts, dirs = _rays(arrays, statics, n, seed)
    nrm = g.normal(size=(n, 3))
    m = n - 2 * (n // 3)
    nrm[2 * (n // 3):] = np.cross(dirs[2 * (n // 3):], g.normal(size=(m, 3)))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    v = g.normal(size=(n, 3))
    v *= np.where((v * nrm).sum(1) < 0, -1.0, 1.0)[:, None]
    v /= np.linalg.norm(v, axis=1, keepdims=True)

    def vec(a):
        return Vec3(*torch.from_numpy(a.T.astype(np.float32).copy()).to(dev))

    rough = torch.from_numpy(g.uniform(0.1, 1.0, n).astype(np.float32)).to(dev)
    need = torch.from_numpy(g.random(n) < 0.9).to(dev)
    wid = torch.from_numpy((np.arange(n) * 13 - 500).astype(np.int32)).to(dev)
    return wid, (vec(pts), vec(nrm), vec(nrm), vec(v), rough, need, K)


@pytest.mark.cuda
@pytest.mark.parametrize("lane", [False, True], ids=["batch", "lane"])
def test_k3_above_32_lights_matches_plain_on_the_card(card, built, lane):
    """``ok`` and ``l`` equal to the plain version's on >= 99.9 % of the
    lanes, ``l`` and the pdf within rtol 1e-4 on >= 99.9 % of the lanes
    both accept (the walk sums in another order than the sweep)."""
    arrays, statics, _ = built
    scene = modular_scene(arrays, statics, card)
    wid, ins = _states(arrays, statics, 30_000, card)
    if lane:
        depth = torch.from_numpy(np.random.default_rng(3).integers(0, 6, 30_000)
                                 .astype(np.int32)).to(card)
        kl, kpdf, kok = sample_mixture_kernel(scene, SEED, wid, 0, trng.lane_ctr(0, K), *ins,
                                              depth)
        pl, ppdf, pok = sampler_plain(scene, SEED, wid, 0, trng.lane_ctr(depth, K), *ins)
    else:
        ctr = trng.batch_ctr(2 * trng.draws_per_bounce(K), K)
        kl, kpdf, kok = sample_mixture_kernel(scene, SEED, wid, 77, ctr, *ins)
        pl, ppdf, pok = sampler_plain(scene, SEED, wid, 77, ctr, *ins)
    torch.cuda.synchronize()
    assert (kok == pok).float().mean().item() >= 0.999
    both = kok & pok
    assert both.float().mean().item() > 0.5
    for a, w in zip((*kl, kpdf), (*pl, ppdf)):
        close = (a[both] - w[both]).abs() <= 1e-4 * w[both].abs() + 1e-7
        assert close.float().mean().item() >= 0.999


def _plain_lanes(scene, seed, wid, off, depth, ins, chunk=32_768):
    """``sampler_plain`` in the lane layout, ``chunk`` lanes at a time (its
    (B, L) sweep holds several (lanes, lights) floats at once)."""
    parts = []
    for a in range(0, wid.shape[0], chunk):
        cut = [Vec3(*(c[a:a + chunk] for c in x)) if isinstance(x, Vec3)
               else x[a:a + chunk] if isinstance(x, torch.Tensor) else x for x in ins]
        parts.append(sampler_plain(scene, seed, wid[a:a + chunk], off,
                                   trng.lane_ctr(depth[a:a + chunk], K), *cut))
    return (Vec3(*(torch.cat([getattr(p[0], c) for p in parts]) for c in "xyz")),
            torch.cat([p[1] for p in parts]), torch.cat([p[2] for p in parts]))


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["under-a-chunk", "over-the-first-draw"])
@pytest.mark.parametrize("need", ["all", "scattered", "none"])
def test_k3_above_32_lights_persistent_warps_on_the_card(card, built, need, size):
    """K3 above 32 lights in lane mode on 20 lanes (fewer than one warp's
    chunk of 32) or on more lanes than the persistent grid's warps draw
    first: ``ok`` equal to the plain version's and l, pdf at its gate on the
    lanes that sample, the idle stores on the others; two launches back to
    back and the replay of a graph that captured a third give the same
    outputs bit for bit, so each launch left the tickets at 0."""
    arrays, statics, _ = built
    scene = modular_scene(arrays, statics, card)
    geom = kernels.launch_geometry()
    first = geom["sms"] * geom["resident_blocks"]["sampler_many"] * geom["block"]
    n = 20 if size == "under-a-chunk" else first + 12_345
    wid, ins = _states(arrays, statics, n, card, seed=11)
    g = np.random.default_rng(17)
    flags = {"all": np.ones(n, bool), "scattered": g.random(n) < 0.05,
             "none": np.zeros(n, bool)}[need]
    if need == "scattered":
        flags[n // 2] = True
    need_t = torch.from_numpy(flags).to(card)
    ins = (*ins[:5], need_t, K)
    depth = torch.from_numpy(g.integers(0, 6, n).astype(np.int32)).to(card)
    pair = torch.tensor([SEED, 5], dtype=torch.int64, device=card)

    def launch():
        return sample_mixture_kernel(scene, pair[0], wid, pair[1], trng.lane_ctr(0, K), *ins,
                                     depth)

    first_out, second = launch(), launch()
    stream = torch.cuda.Stream(card)
    kernels.prepare_stream(card, stream)
    stream.wait_stream(torch.cuda.current_stream(card))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = launch()
    graph.replay()
    torch.cuda.synchronize()
    flat = lambda o: (*o[0], o[1], o[2])  # noqa: E731
    for a, b, c in zip(flat(first_out), flat(second), flat(captured)):
        assert torch.equal(a, b) and torch.equal(a, c)
    kl, kpdf, kok = first_out
    idle = ~need_t
    assert not kok[idle].any()
    assert (kl.x[idle] == 0).all() and (kl.y[idle] == 0).all() and (kl.z[idle] == 1).all()
    assert (kpdf[idle] == 1e-9).all()
    if need == "none":
        return
    pl, ppdf, pok = _plain_lanes(scene, SEED, wid, 5, depth, ins)
    torch.cuda.synchronize()
    assert (kok == pok).float().mean().item() >= 0.999
    both = kok & pok
    assert both.any()
    for a, w in zip((*kl, kpdf), (*pl, ppdf)):
        close = (a[both] - w[both]).abs() <= 1e-4 * w[both].abs() + 1e-7
        assert close.float().mean().item() >= 0.999
