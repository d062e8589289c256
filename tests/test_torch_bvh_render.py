"""PyTorch port, whole frames on the BVH backend on the CPU (the plain
version of K6, K3 and the rest), against the JAX package's BVH backend.

* Each engine on the inline MIXED text scene (planes, boxes, an ellipsoid,
  rotations, MIRROR and DIELECTRIC) with ``backend="bvh"`` asked for, 32x24
  at 2 spp: the lane engines against the JAX Renderer with the same engine
  and lanes (both draw the lane layout's counter streams), the batch engine
  against the JAX package's stages fed the port's counter draws
  (``test_torch_render._jax_counter_loop`` with the JAX package's BVH).
* The engine the port picks for a 5,120-triangle mesh, 12x8 at 2 spp: the
  counter wavefront, as the JAX Renderer picks it for its BVH backend.
* ``backend=None`` picks the BVH backend above ``BVH_THRESHOLD``; the
  Renderer exposes ``desc``, ``statics``, ``arrays``, ``backend`` and
  ``render_radiance(with_stats=True)`` with the JAX package's RenderStats
  fields.
* The counter wavefront's flush: a frame split into passes of whole samples
  equals the one-pass frame.

Tolerance as tests/test_torch_wavefront.py states it: >= 99 % of pixels
within 1e-4 and path vertices within 1 %. The MIXED frames are 32x24, not
16x12: on MIXED the port's lane engines and the JAX package's part on about
five paths whatever the frame size (a dielectric or acceptance decision at
a rounding boundary; on the dense backend as on the BVH one, whose frames
in the JAX package equal its dense ones), and at 192 pixels those are more
than 1 %.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest

from meshes import displaced_organic_mesh, mesh_scene_desc
from raytracing_course_2024_tpu.integrator import path as jpath
from raytracing_course_2024_tpu.runtime.profiling import RenderStats as JRenderStats
from raytracing_course_2024_tpu.runtime.render import Renderer as JRenderer
from raytracing_course_2024_tpu.scene import build_scene_arrays as jbuild
from raytracing_course_2024_tpu_torch.integrator import wavefront as W
from raytracing_course_2024_tpu_torch.runtime import render as R
from raytracing_course_2024_tpu_torch.runtime.profiling import RenderStats
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
import test_torch_render as TR
from test_torch_render import _jax_counter_loop
from test_torch_wavefront import SEED, SEED32, _agree
from torch_parity import descs

LANES = 256  # lane engines: fewer lanes than work items, so lanes refill


def _mesh(w, h, spp):
    v, f, vn = displaced_organic_mesh(subdiv=4)
    d = mesh_scene_desc(v, f, vn, width=w, height=h, samples=spp)
    return d, d


def _jax_frame(jd, engine, w, h, spp, monkeypatch):
    """The JAX package's BVH frame: the Renderer for the lane engines, the
    counter-draw loop for the batch engine (its level function jitted: the
    treelet loop otherwise compiles anew at every level)."""
    if engine != "batch":
        jr = JRenderer(jd, backend="bvh", engine=engine, batch_size=LANES)
        outs, verts = jr.render_frame_device(seed=SEED)
        return np.asarray(outs[0]), float(verts)
    monkeypatch.setattr(TR, "_collect_hit", jax.jit(jpath._collect_hit, static_argnums=(2, 3)))
    ja, js = jbuild(jd)
    return _jax_counter_loop(jd, ja, js, w, h, spp, SEED32, jd.settings.ray_depth,
                             backend="bvh")


def _port_frame(td, engine, **kw):
    """The port's frame; the batch engine in one batch (a padded last batch
    would count its repeated lanes' path vertices, as the JAX package's
    batch engine does, and the JAX-driven loop has none)."""
    lanes = None if engine == "batch" else LANES
    r = Renderer(td, device="cpu", engine=engine, batch_size=lanes, **kw)
    assert r.backend == "bvh" and r.scene.bvh_nodes is not None and not r.fused
    outs, verts = r.render_frame_device(seed=SEED)
    if engine == "batch":
        s = td.settings
        return r._assemble(outs).reshape(s.height * s.width, 3).T, verts
    return outs[0].numpy(), verts


@pytest.mark.parametrize("engine", ["batch", "wavefront", "sticky"])
def test_mixed_bvh_frames_match_jax(engine, monkeypatch):
    w, h, spp = 32, 24, 2
    jd, td = descs("mixed", w, h, spp)
    got, verts = _port_frame(td, engine, backend="bvh")
    want, want_verts = _jax_frame(jd, engine, w, h, spp, monkeypatch)
    _agree(got, want, verts, want_verts)


def test_mesh_frame_on_the_chosen_engine_matches_jax(monkeypatch):
    """5,121 primitives: the BVH backend by default, on the counter
    wavefront, the JAX Renderer's default engine there (and the fastest of
    the three on the card's BVH frame, PERF.md)."""
    w, h, spp = 12, 8, 2
    jd, td = _mesh(w, h, spp)
    r = Renderer(td, device="cpu")
    assert r.backend == "bvh" and r.engine == "wavefront" == JRenderer(jd).engine
    got, verts = _port_frame(td, r.engine)
    want, want_verts = _jax_frame(jd, r.engine, w, h, spp, monkeypatch)
    _agree(got, want, verts, want_verts)


def test_renderer_describes_the_scene_as_the_jax_renderer(monkeypatch):
    """``backend=None`` picks the BVH backend above BVH_THRESHOLD finite
    primitives and the dense one below, and ``engine=None`` the JAX
    Renderer's engine on each (the counter wavefront on the BVH backend, the
    batch engine on the dense one), as the JAX Renderer does; ``engine=``
    and ``RT_ENGINE`` still override it. The Renderer carries the
    description, statics, numpy arrays (on the BVH backend in the tree's
    order, with the tree) and the builder's name."""
    _, mesh = _mesh(8, 6, 1)
    j_mixed, mixed = descs("mixed", 8, 6, 1)
    monkeypatch.delenv("RT_ENGINE", raising=False)
    for jd, td, backend in ((mesh, mesh, "bvh"), (j_mixed, mixed, "dense")):
        r = Renderer(td, device="cpu")
        jr = JRenderer(jd)
        assert r.backend == jr.backend == backend
        assert r.engine == jr.engine == ("wavefront" if backend == "bvh" else "batch")
        assert Renderer(td, device="cpu", engine="sticky").engine == "sticky"
        with monkeypatch.context() as m:
            m.setenv("RT_ENGINE", "batch")
            assert Renderer(td, device="cpu").engine == "batch"
            assert Renderer(td, device="cpu", engine="wavefront").engine == "wavefront"
        assert r.desc is td and tuple(r.statics) == tuple(jr.statics)
        assert (r.arrays.bvh is not None) == (backend == "bvh")
        assert (r.bvh_builder in ("native", "numpy")) == (backend == "bvh")
        assert isinstance(r.arrays.packed, np.ndarray)
    assert R.BVH_THRESHOLD == 2048 and len(mesh.primitives) > R.BVH_THRESHOLD
    with pytest.raises(ValueError, match="backend"):
        Renderer(mixed, device="cpu", backend="treelet")


@pytest.mark.parametrize("engine", ["batch", "sticky"])
def test_render_radiance_with_stats_matches_jax(engine, caplog):
    """``render_radiance(progress=, with_stats=)``: the image and a
    RenderStats with the JAX package's fields; on the sticky engine (both
    packages draw the same streams) the same image and path vertices as the
    JAX Renderer's."""
    jd, td = descs("mixed", 16, 12, 2)
    r = Renderer(td, device="cpu", engine=engine)
    with caplog.at_level(logging.INFO, logger="rt_torch"):
        img, stats = r.render_radiance(seed=SEED, progress=True, with_stats=True)
    assert isinstance(stats, RenderStats)
    assert ([f.name for f in dataclasses.fields(stats)]
            == [f.name for f in dataclasses.fields(JRenderStats)])
    assert (stats.width, stats.height, stats.samples, stats.ray_depth, stats.primary_rays) == (
        16, 12, 2, td.settings.ray_depth, 16 * 12 * 2)
    assert stats.wall_seconds > 0 and stats.primary_rays <= stats.path_vertices
    assert stats.mrays_per_sec > 0 and "path vertices" in str(stats)
    assert np.array_equal(img, r.render_radiance(seed=SEED))
    assert any("render progress" in m for m in caplog.messages) == (engine == "batch")
    if engine == "sticky":
        jr = JRenderer(jd, engine=engine)
        jr.arrays = jr.arrays._replace(tri_pack=None)
        jimg, jstats = jr.render_radiance(seed=SEED, with_stats=True)
        _agree(img.reshape(-1, 3).T, jimg.reshape(-1, 3).T, stats.path_vertices,
               jstats.path_vertices)
        assert dataclasses.astuple(stats)[:4] == dataclasses.astuple(jstats)[:4]
        assert stats.primary_rays == jstats.primary_rays


def test_counter_wavefront_in_passes_equals_one_pass(monkeypatch):
    """Every work item's radiance lands in its own column, and a frame above
    ``WF_MAX_WORK`` work items runs in passes of whole samples: the same
    paths, so the same image within the rounding of the weighted sum, and
    the same bits for the same seed every time."""
    _, td = descs("mixed", 16, 12, 4)
    r = Renderer(td, device="cpu", engine="wavefront", backend="bvh", batch_size=LANES)
    one = r.render_radiance(seed=SEED)
    rounds = r.rounds
    monkeypatch.setattr(W, "WF_MAX_WORK", 16 * 12 + 5)  # one sample a pass
    passes = r.render_radiance(seed=SEED)
    assert r.rounds > rounds
    np.testing.assert_allclose(passes, one, rtol=1e-6, atol=1e-6)
    assert np.array_equal(passes, r.render_radiance(seed=SEED))
    assert one.max() > 0
