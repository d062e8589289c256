"""PyTorch port, what picks the route and the sampler, on the CPU.

* The route (fused or modular) follows from the scene and the integrator's
  settings alone (``mega_gate``): the dense backend, no roulette, no
  faithful acceptance and a scene inside the fused gate take the fused
  route; every other combination the modular one. The truth table runs
  backend x roulette x faithful x a scene inside the gate (MIXED) and one
  outside it (41 lights, above K3's 32 unrolled), and holds ``mega_gate``,
  ``Renderer.fused`` and the type of the renderer's device scene to it.
* The modular core of every engine (the batch route, the counter wavefront,
  the sticky engine) samples in K3 unless acceptance is faithful, whatever
  the light count (above 32 lights K3 walks the lights' own tree; the JAX
  package takes its XLA formulation there), and takes the XLA formulation
  when it is. The route is read from spies on the two sampler entry points
  of ``integrator/path.py``.
* K2 (the camera ray and bounce 0 in one kernel) equals the camera stage N4
  followed by K1 at bounce 0 on the same draws, through the wrappers and
  through the plain versions: the lane engines still open a path with K1
  on N4's rays, so the two agree.
* A Cornell frame on the modular route agrees with the JAX ``Renderer``'s
  frame as ``test_torch_render.py``'s MIXED frame does: channel means
  within 3 sigma of the difference of two estimates.
"""

import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.runtime.render import Renderer as JRenderer
from raytracing_course_2024_tpu_torch.integrator import path as P
from raytracing_course_2024_tpu_torch.integrator import wavefront as W
from raytracing_course_2024_tpu_torch.ops import bounce as B
from raytracing_course_2024_tpu_torch.ops.camera import (camera_from_row, camera_state,
                                                         camera_state_plain)
from raytracing_course_2024_tpu_torch.ops.sampling import UNROLL_MAX_LIGHTS
from raytracing_course_2024_tpu_torch.ops.scene_intersect import ModularScene, modular_scene
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from raytracing_course_2024_tpu_torch.scene import build_scene_arrays
from meshes import icosphere, mesh_scene_desc
from torch_parity import descs

SEED = 11


def _many_lights_desc():
    """40 emissive triangles (41 lights with the mesh's own): above K3's 32."""
    verts, faces = icosphere(1)
    desc = mesh_scene_desc(verts, faces[:40], width=8, height=6, samples=1)
    for p in desc.primitives:
        p.emission = np.ones(3)
    return desc


def _desc(scene):
    return _many_lights_desc() if scene == "many_lights" else descs(scene, 8, 6, 1)[1]


@pytest.mark.parametrize("scene", ["mixed", "many_lights"])
@pytest.mark.parametrize("faithful", [False, True], ids=["fast", "faithful"])
@pytest.mark.parametrize("rr", [False, True], ids=["no-rr", "rr"])
@pytest.mark.parametrize("backend", ["dense", "bvh"])
def test_route_follows_the_scene_and_settings(backend, rr, faithful, scene):
    td = _desc(scene)
    r = Renderer(td, device="cpu", backend=backend, russian_roulette=rr, faithful=faithful)
    assert (r.statics.num_lights > UNROLL_MAX_LIGHTS) == (scene == "many_lights")
    want = backend == "dense" and not rr and not faithful and scene == "mixed"
    assert P.mega_gate(r.cfg, r.statics) is want
    assert r.fused is want
    assert isinstance(r.scene, B.BounceScene if want else ModularScene)
    assert P.TraceConfig._fields == ("ray_depth", "bg_color", "max_tries", "backend",
                                     "faithful", "rr")


@pytest.mark.parametrize("faithful", [False, True], ids=["fast", "faithful"])
@pytest.mark.parametrize("scene", ["mixed", "many_lights"])
@pytest.mark.parametrize("engine", ["batch", "wavefront", "sticky"])
def test_modular_core_takes_k3_unless_faithful(monkeypatch, engine, scene, faithful):
    """A depth-2 frame (one modular bounce per path) on a ``ModularScene``;
    every call of the sampler goes to K3 (its wrapper) unless acceptance is
    faithful, and to the XLA formulation, faithful, when it is."""
    td = _desc(scene)
    arrays, statics = build_scene_arrays(td)
    calls = []
    kernel, plain = P.sample_mixture_kernel, P.sampler_plain
    monkeypatch.setattr(P, "sample_mixture_kernel",
                        lambda *a: calls.append(("kernel", None)) or kernel(*a))
    monkeypatch.setattr(P, "sampler_plain",
                        lambda *a, faithful: calls.append(("xla", faithful))
                        or plain(*a, faithful=faithful))
    cfg = P.TraceConfig(ray_depth=2, bg_color=(0.1, 0.1, 0.1), faithful=faithful)
    scn = modular_scene(arrays, statics, "cpu")
    r = Renderer(td, device="cpu")
    w, h = td.settings.width, td.settings.height
    if engine == "batch":
        outs, rays = P.render_batches(scn, 7, r.cam_row, cfg, w, h, 1, 1 << 20)
        out = torch.cat(outs, dim=1)
    else:
        render = W.render_wavefront if engine == "wavefront" else W.render_wavefront_sticky
        out, rays, _ = render(7, 0, 0, r.cam, scn, cfg, w, h, w * h, 1, w * h)
    want = ("xla", True) if faithful else ("kernel", None)
    assert calls and set(calls) == {want}
    assert np.isfinite(out.numpy()).all() and w * h <= float(rays) <= 2 * w * h


@pytest.mark.parametrize("name", ["mixed", "cornell"])
@pytest.mark.parametrize("plain", [False, True], ids=["wrappers", "plain"])
def test_k2_equals_camera_stage_then_k1_at_bounce_0(name, plain):
    """K2 against N4 then K1 at bounce 0, on every pixel of a 24x16 frame
    at its second sample: the states within 1e-4, the same lanes alive, and
    both counting every lane as a path vertex of bounce 0."""
    _, td = descs(name, 24, 16, 2)
    arrays, statics = build_scene_arrays(td)
    scene = B.bounce_scene(arrays, statics, "cpu")
    cam_row = Renderer(td, device="cpu").cam_row
    cam = camera_from_row(cam_row)
    w, h = td.settings.width, td.settings.height
    bg, k = tuple(td.settings.bg_color), 4
    wid = torch.arange(w * h, dtype=torch.int32)
    px, py = (wid % w).float(), (wid // w).float()
    seed, off = (SEED * 2654435761) & 0xFFFFFFFF, w * h
    if plain:
        k2 = B.primary_plain(scene, cam_row, px, py, wid, off, seed, bg, k, w, h)
        fresh = camera_state_plain(seed, wid, off, px, py, cam, w, h)
        count = (fresh[12] > 0.5).sum()
        k1 = B.bounce_plain(scene, fresh, wid, off, seed, 0, bg, k)
    else:
        k2 = B.primary_bounce(scene, cam_row, px, py, wid, off, seed, bg, k, w, h)
        fresh = camera_state(seed, wid, off, px, py, cam, cam_row, w, h)
        count = torch.zeros((), dtype=torch.int64)
        k1 = B.bounce(scene, fresh, wid, off, seed, 0, bg, k, count=count)
    assert int(count) == w * h
    assert torch.equal(k2[12] > 0.5, k1[12] > 0.5) and 0 < int((k2[12] > 0.5).sum()) < w * h
    np.testing.assert_allclose(k1.numpy(), k2.numpy(), rtol=0, atol=1e-4)


def test_cornell_xla_sampler_frame_matches_jax_renderer_statistically():
    """Cornell, 32x18 x 32 spp: the port's modular route on a
    ``ModularScene`` (on the CPU K3's wrapper runs its plain version, the
    XLA formulation fed the counter draws) against the JAX ``Renderer`` (on
    the CPU its XLA path with threefry draws): per-channel frame means
    within 3 sigma, sigma the standard error of a frame mean from the port's
    per-pixel sample variance, times sqrt(2) for the difference of two
    estimates."""
    w, h, spp = 32, 18, 32
    jd, td = descs("cornell", w, h, spp)
    want = JRenderer(jd, max_tries=4).render_radiance(seed=SEED, samples=spp)
    arrays, statics = build_scene_arrays(td)
    cfg = P.TraceConfig(ray_depth=td.settings.ray_depth, bg_color=tuple(td.settings.bg_color))
    scene = modular_scene(arrays, statics, "cpu")
    cam = camera_from_row(Renderer(td, device="cpu").cam_row)
    idx = torch.arange(w * h, dtype=torch.int32)
    seed32 = (SEED * 2654435761) & 0xFFFFFFFF
    samples = np.stack([
        P._modular_sample(scene, seed32, idx, s * w * h, (idx % w).float(),
                          (idx // w).float(), cam, cfg, w, h, False)[0].numpy()
        for s in range(spp)])  # (spp, 3, n_pix)
    got = samples.mean(axis=0)
    sigma = np.sqrt(samples.var(axis=0, ddof=1).sum(axis=1) / spp) / (w * h)
    diff = np.abs(got.mean(axis=1) - want.mean(axis=(0, 1)))
    assert want.shape == (h, w, 3) and np.isfinite(got).all() and (sigma > 0).all()
    assert (diff < 3.0 * np.sqrt(2.0) * sigma).all(), (diff, sigma)
