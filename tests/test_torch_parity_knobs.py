"""PyTorch port, the JAX package's integrator switches: ``TraceConfig.sampler``
(``"auto" | "xla" | "pallas"``) and ``RT_MEGA_CAM=0``, on the CPU.

* ``sampler``: ``"xla"`` turns the fused path off (``mega_gate``) and the
  modular bounce takes the XLA formulation; ``"pallas"`` and ``"auto"``
  take K3 unless acceptance is faithful, whatever the light count (above 32
  lights K3 walks the lights' own tree; the JAX package's ``"auto"`` takes
  its XLA formulation there). ``"xla"`` is refused on a CUDA device by both engine
  families before they launch anything (``check_sampler``). The route is read from spies on the two sampler entry points
  of ``integrator/path.py``. A Cornell frame on the ``"xla"`` sampler agrees
  with the JAX ``Renderer``'s frame as ``test_torch_render.py``'s MIXED frame
  does: channel means within 3 sigma of the difference of two estimates.
* ``RT_MEGA_CAM=0``: bounce 0 runs in K1 on the camera stage's rays instead
  of K2, from the same draws, so the frame equals the default frame within
  1e-4 (through the wrappers and through the plain versions).
"""

import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.runtime.render import Renderer as JRenderer
from raytracing_course_2024_tpu_torch.integrator import path as P
from raytracing_course_2024_tpu_torch.ops import bounce as B
from raytracing_course_2024_tpu_torch.ops.camera import camera_from_row
from raytracing_course_2024_tpu_torch.ops.sampling import UNROLL_MAX_LIGHTS
from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
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


@pytest.mark.parametrize("sampler,fused", [("auto", True), ("pallas", True), ("xla", False)])
def test_sampler_gates_the_fused_path(sampler, fused):
    _, td = descs("mixed", 8, 6, 1)
    _, statics = build_scene_arrays(td)
    cfg = P.TraceConfig(ray_depth=4, bg_color=(0.0, 0.0, 0.0), sampler=sampler)
    assert P.mega_gate(cfg, statics) is fused
    assert P.TraceConfig._fields.index("sampler") == P.TraceConfig._fields.index("backend") + 1


@pytest.mark.parametrize("scene,sampler,faithful,want", [
    ("mixed", "auto", False, ("kernel", None)),
    ("mixed", "pallas", False, ("kernel", None)),
    ("mixed", "xla", False, ("xla", False)),
    ("mixed", "xla", True, ("xla", True)),
    ("mixed", "pallas", True, ("xla", True)),
    ("mixed", "auto", True, ("xla", True)),
    ("many_lights", "auto", False, ("kernel", None)),
    ("many_lights", "pallas", False, ("kernel", None)),
])
def test_modular_bounce_takes_the_sampler_asked_for(monkeypatch, scene, sampler, faithful,
                                                    want):
    """One depth-2 sample (one modular bounce) per case; every call of the
    bounce goes to the sampler the JAX package's rule picks."""
    if scene == "many_lights":
        td = _many_lights_desc()
    else:
        _, td = descs(scene, 8, 6, 1)
    arrays, statics = build_scene_arrays(td)
    assert (statics.num_lights > UNROLL_MAX_LIGHTS) == (scene == "many_lights")
    calls = []
    kernel, plain = P.sample_mixture_kernel, P.sampler_plain
    monkeypatch.setattr(P, "sample_mixture_kernel",
                        lambda *a: calls.append(("kernel", None)) or kernel(*a))
    monkeypatch.setattr(P, "sampler_plain",
                        lambda *a, faithful: calls.append(("xla", faithful))
                        or plain(*a, faithful=faithful))
    cfg = P.TraceConfig(ray_depth=2, bg_color=(0.1, 0.1, 0.1), sampler=sampler,
                        faithful=faithful)
    r = Renderer(td, device="cpu")
    out, rays = P.render_batches(modular_scene(arrays, statics, "cpu"), 7, r.cam_row, cfg,
                                 8, 6, 1, 1 << 20)
    assert calls == [want]
    assert np.isfinite(out[0].numpy()).all() and 48 <= float(rays) <= 96


@pytest.mark.parametrize("sampler,device,refused", [
    ("xla", "cuda", True), ("xla", torch.device("cuda", 1), True), ("xla", "cpu", False),
    ("auto", "cuda", False), ("pallas", "cuda", False), ("XLA", "cpu", True),
])
def test_check_sampler_refuses_xla_on_a_card(sampler, device, refused):
    cfg = P.TraceConfig(ray_depth=4, bg_color=(0.0, 0.0, 0.0), sampler=sampler)
    if refused:
        with pytest.raises(ValueError, match="sampler"):
            P.check_sampler(cfg, device)
    else:
        P.check_sampler(cfg, device)


@pytest.mark.parametrize("engine", ["batch", "wavefront", "sticky"])
def test_every_engine_checks_the_sampler_on_its_device(monkeypatch, engine):
    """Each engine asks ``check_sampler`` with its scene's device before it
    renders; told the device is a card, ``"xla"`` raises there."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as WF

    seen, check = [], P.check_sampler

    def as_card(cfg, device):
        seen.append(torch.device(device).type)
        check(cfg, "cuda")

    monkeypatch.setattr(P, "check_sampler", as_card)
    monkeypatch.setattr(WF, "check_sampler", as_card)
    _, td = descs("mixed", 8, 6, 1)
    r = Renderer(td, device="cpu", engine=engine)
    r.render_radiance(seed=SEED)  # "auto": allowed on a card
    assert seen and set(seen) == {"cpu"}
    r.cfg = r.cfg._replace(sampler="xla")
    with pytest.raises(ValueError, match='sampler="xla"'):
        r.render_radiance(seed=SEED)


def test_xla_sampler_frame_equals_k3_plain_frame_bit_for_bit():
    """On the CPU, K3's wrapper runs its plain version, which is the XLA
    formulation fed the same draws: the two routes give the same frame."""
    _, td = descs("cornell", 24, 16, 2)
    arrays, statics = build_scene_arrays(td)
    scene = modular_scene(arrays, statics, "cpu")
    cam_row = Renderer(td, device="cpu").cam_row
    frames = []
    for sampler in ("auto", "xla"):
        cfg = P.TraceConfig(ray_depth=td.settings.ray_depth,
                            bg_color=tuple(td.settings.bg_color), sampler=sampler)
        outs, rays = P.render_batches(scene, 9, cam_row, cfg, 24, 16, 2, 1 << 20)
        frames.append((torch.cat(outs, dim=1).numpy(), float(rays)))
    np.testing.assert_array_equal(frames[0][0], frames[1][0])
    assert frames[0][1] == frames[1][1] > 0


def test_cornell_xla_sampler_frame_matches_jax_renderer_statistically():
    """Cornell, 32x18 x 32 spp: the port's modular route on the ``"xla"``
    sampler against the JAX ``Renderer`` (on the CPU its XLA path with
    threefry draws): per-channel frame means within 3 sigma, sigma the
    standard error of a frame mean from the port's per-pixel sample
    variance, times sqrt(2) for the difference of two estimates."""
    w, h, spp = 32, 18, 32
    jd, td = descs("cornell", w, h, spp)
    want = JRenderer(jd, max_tries=4).render_radiance(seed=SEED, samples=spp)
    arrays, statics = build_scene_arrays(td)
    cfg = P.TraceConfig(ray_depth=td.settings.ray_depth, bg_color=tuple(td.settings.bg_color),
                        sampler="xla")
    assert not P.mega_gate(cfg, statics)
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


@pytest.mark.parametrize("name", ["mixed", "cornell"])
@pytest.mark.parametrize("plain", [False, True], ids=["wrappers", "plain"])
def test_mega_cam_off_frame_equals_the_default_frame(monkeypatch, name, plain):
    """``RT_MEGA_CAM=0``: no K2, bounce 0 in K1 (one more K1 per sample),
    the same frame within 1e-4 and the same path vertices."""
    _, td = descs(name, 24, 16, 2)
    r = Renderer(td, device="cpu", plain=plain)
    assert r.fused
    base, base_stats = r.render_radiance(seed=SEED, with_stats=True)
    calls = {"primary": 0, "bounce": 0}
    if not plain:
        for fn_name, key in (("primary_bounce", "primary"), ("bounce", "bounce")):
            fn = getattr(B, fn_name)
            monkeypatch.setattr(B, fn_name, lambda *a, _fn=fn, _k=key, **k: calls.__setitem__(
                _k, calls[_k] + 1) or _fn(*a, **k))
    monkeypatch.setenv("RT_MEGA_CAM", "0")
    got, stats = r.render_radiance(seed=SEED, with_stats=True)
    np.testing.assert_allclose(got, base, rtol=0, atol=1e-4)
    assert stats.path_vertices == base_stats.path_vertices
    if not plain:  # one batch; each replica lane renders 2 / replicas samples
        _, replicas = r._plan(24 * 16, 2)
        assert calls == {"primary": 0, "bounce": 2 // replicas * td.settings.ray_depth}
