"""PyTorch port, whole-frame rendering on the CPU (plain versions of the
kernels): against the JAX renderer statistically and against a JAX loop
fed the same counter draws pixel by pixel; batch-size invariance,
determinism, the CLI, the configurations off the fused route, and those the
port still refuses (the BVH backend; the lane engines are in
test_torch_wavefront.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.integrator.path import (
    RR_START,
    TraceConfig as JTraceConfig,
    _collect_hit,
    _finish_bounce,
    _PathState,
)
from raytracing_course_2024_tpu.ops import rng as jrng
from raytracing_course_2024_tpu.ops.bvh import attach_bvh as j_attach_bvh
from raytracing_course_2024_tpu.ops.camera import camera_arrays as j_camera
from raytracing_course_2024_tpu.ops.camera import generate_rays_u as j_rays
from raytracing_course_2024_tpu.ops.sampling import sample_mixture
from raytracing_course_2024_tpu.ops.vec import Vec3 as JV
from raytracing_course_2024_tpu.runtime.render import Renderer as JRenderer
from raytracing_course_2024_tpu.scene import build_scene_arrays as jbuild
from raytracing_course_2024_tpu.scene.types import DIELECTRIC, MIRROR
from raytracing_course_2024_tpu_torch.integrator.path import (
    TraceConfig,
    render_pixels,
    trace_sample,
)
from raytracing_course_2024_tpu_torch.ops import rng as trng
from raytracing_course_2024_tpu_torch.ops.bounce import N_STATE, bounce_scene
from raytracing_course_2024_tpu_torch.runtime import cli
from raytracing_course_2024_tpu_torch.runtime.image_io import read_png, read_ppm
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from raytracing_course_2024_tpu_torch.scene import parse_text_scene
from meshes import icosphere, mesh_scene_desc
from torch_parity import CORNELL, builds, descs, to_jnp

SEED = 5


def _lanes(w, h):
    idx = torch.arange(w * h, dtype=torch.int32)
    return idx, (idx % w).float(), (idx // w).float()


def test_renderer_matches_jax_renderer_statistically():
    """MIXED scene, 32x24 x 64 spp: per-channel frame means agree within
    3 sigma, sigma = the Monte-Carlo standard error of a 64-spp frame mean
    estimated from the port's per-pixel sample variance, times sqrt(2) for
    the difference of two independent estimates. (The JAX renderer on the
    CPU takes its XLA path with threefry draws: same estimator, different
    random numbers.)"""
    jd, td = descs("mixed")
    w, h, spp = 32, 24, 64
    want = JRenderer(jd, max_tries=4).render_radiance(seed=SEED, samples=spp)
    r = Renderer(td, device="cpu")
    got = r.render_radiance(seed=SEED, samples=spp)
    assert got.shape == want.shape == (h, w, 3)

    # per-pixel sample variance from single-sample frames of the same wids
    idx, px, py = _lanes(w, h)
    state = torch.empty((N_STATE, w * h))
    samples = []
    for s in range(spp):
        st, _ = trace_sample(r.scene, state, 123, idx, s * w * h, px, py,
                             r.cam_row, r.cfg, w, h)
        samples.append(st[9:12].clone().numpy())
    samples = np.stack(samples)  # (spp, 3, n_pix)
    var = samples.var(axis=0, ddof=1)  # (3, n_pix)
    sigma = np.sqrt(var.sum(axis=1) / spp) / (w * h)
    diff = np.abs(got.mean(axis=(0, 1)) - want.mean(axis=(0, 1)))
    assert (sigma > 0).all()
    assert (diff < 3.0 * np.sqrt(2.0) * sigma).all(), (diff, sigma)
    assert np.isfinite(got).all() and (got >= 0).all()


def _jax_counter_loop(jd, ja, js, w, h, spp, seed32, depth, rr=False, faithful=False,
                      backend="dense"):
    """The port's estimator composed from the JAX package's stages:
    generate_rays_u, then per bounce _collect_hit + sample_mixture + _finish_bounce
    (with the roulette draw when ``rr``), and a final _collect_hit, all fed
    the port's counter draws. ``backend="bvh"`` attaches the JAX package's
    BVH and takes its nearest hit (the treelet traversal). Returns ((3,
    n_pix) radiance, path vertices)."""
    n_pix, k = w * h, 4
    pix = np.arange(n_pix, dtype=np.int32)
    cam = j_camera(jd.settings.camera)
    cfg = JTraceConfig(ray_depth=depth, bg_color=tuple(jd.settings.bg_color), max_tries=k,
                       faithful=faithful, rr=rr, backend=backend)
    if backend == "bvh":
        ja = j_attach_bvh(ja, js)
    arrays = to_jnp(ja)
    acc = np.zeros((3, n_pix), np.float64)
    rays = 0.0
    for s in range(spp):
        key = jrng.work_key(jnp.uint32(seed32), jnp.asarray(pix + s * n_pix))
        ro, rd = j_rays(cam, jnp.asarray(pix % w), jnp.asarray(pix // w), w, h,
                        jrng.uniform_ctr(key, 0), jrng.uniform_ctr(key, 1))
        one, zero = jnp.ones((n_pix,)), jnp.zeros((n_pix,))
        st = _PathState(ro, rd, JV(one, one, one), JV(zero, zero, zero), one > 0)
        for b in range(depth - 1):
            rays += float(jnp.sum(st.alive))
            base = b * trng.draws_per_bounce(k)
            st2, surf, _ = _collect_hit(st, arrays, js, cfg)
            rows = [jnp.concatenate([jrng.uniform_ctr(key, base + trng.ctr_mix(t, r))
                                     for t in range(k)]) for r in range(7)]
            delta = (surf.mkind == MIRROR) | (surf.mkind == DIELECTRIC)
            l, pdf, ok = sample_mixture(None, surf.point, surf.n_geom, surf.n_shade,
                                        -st.rd, surf.roughness, arrays, js,
                                        need=st2.alive & ~delta, max_tries=k,
                                        faithful=faithful, uniforms=rows)
            u_diel = jrng.uniform_ctr(key, base + trng.ctr_diel(k))
            rr_kw = {}
            if rr:
                rr_kw = dict(u_rr=jrng.uniform_ctr(key, base + trng.ctr_rr(k)),
                             rr_mask=jnp.full((n_pix,), b >= RR_START))
            st = _finish_bounce(st2, surf, l, pdf, ok, u_diel, cfg, **rr_kw)
        rays += float(jnp.sum(st.alive))
        st, _, _ = _collect_hit(st, arrays, js, cfg)
        acc += np.stack([np.asarray(c) for c in st.radiance])
    return acc / spp, rays


def test_render_pixels_matches_jax_stages_with_counter_draws():
    """Depth 3 (bounce 0, one full bounce, the final level), 16x12 x 2 spp
    on the MIXED scene: >= 99 % of the pixels within 1e-4 of the JAX loop
    (a flipped accept or Fresnel decision changes a whole path)."""
    w, h, spp, depth = 16, 12, 2, 3
    (jd, ja, js), (td, ta, ts) = builds("mixed", w, h, spp)
    seed32 = (SEED * 2654435761) & 0xFFFFFFFF
    want, want_rays = _jax_counter_loop(jd, ja, js, w, h, spp, seed32, depth)
    idx, px, py = _lanes(w, h)
    cfg = TraceConfig(ray_depth=depth, bg_color=tuple(td.settings.bg_color))
    from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays, pack_camera_row

    cam = torch.from_numpy(pack_camera_row(camera_arrays(td.settings.camera))[0])
    got, rays = render_pixels(bounce_scene(ta, ts, "cpu"), seed32, idx, px, py, cam,
                              cfg, w, h, spp, w * h)
    ok = (np.abs(got.numpy() - want) <= 1e-4).all(axis=0)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(float(rays) - want_rays) <= 0.01 * want_rays


def test_image_independent_of_batch_size_and_replicas():
    """Every draw is keyed by (seed, sample, pixel): one full-frame batch and
    256-lane batches give bit-identical images; splitting the samples over
    8 replicas per pixel changes only the averaging order."""
    _, td = descs("mixed", 20, 15, 8)
    full_r = Renderer(td, device="cpu", batch_size=300)
    small_r = Renderer(td, device="cpu", batch_size=256)
    assert full_r._plan(300, 8) == (300, 1) and small_r._plan(300, 8) == (256, 1)
    full = full_r.render_radiance(seed=2)
    assert np.array_equal(small_r.render_radiance(seed=2), full)
    replicas = Renderer(td, device="cpu")
    assert replicas._plan(300, 8) == (300, 8)
    np.testing.assert_allclose(replicas.render_radiance(seed=2), full,
                               rtol=1e-6, atol=1e-7)


def test_render_deterministic_per_seed():
    _, td = descs("cornell", 24, 16, 2)
    r = Renderer(td, device="cpu")
    a, b, c = r.render_u8(seed=1), r.render_u8(seed=1), r.render_u8(seed=2)
    assert a.dtype == np.uint8 and a.shape == (16, 24, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    outs, verts = r.render_frame_device(seed=1)
    n = 24 * 16 * 2
    assert n < verts <= n * td.settings.ray_depth


def test_cli_writes_ppm_and_png(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the CLI logs to ./out.log like the reference
    rc = cli.main([CORNELL, "24", "16", "2", "img.ppm", "img"], device="cpu")
    assert rc == 0
    ppm, png = read_ppm("img.ppm"), read_png("img.png")
    assert ppm.shape == (16, 24, 3) and np.array_equal(ppm, png)
    assert ppm.std() > 0
    out = capsys.readouterr().out
    assert "Scene finite primitives: 36, light sources: 2, planes: 0" in out
    assert cli.main([CORNELL]) == 2  # usage


def test_cuda_requests_raise_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, td = descs("mixed")
    with pytest.raises(RuntimeError, match="cuda"):
        Renderer(td, device="cuda")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([CORNELL, "8", "8", "1", "x.ppm"])
    assert not os.path.exists("x.ppm")


def _configuration(case, w=16, h=12, spp=2):
    """(JAX desc, port desc, Renderer keywords) of one configuration off
    the default fused route."""
    jd, td = descs("mixed", w, h, spp)
    kw = {}
    if case in ("many_prims", "bvh_size", "many_lights"):
        # 320 triangles > 128: modular sweep; > 2048: BVH backend; 40
        # emissive triangles > 32 lights: vectorized light pdf
        verts, faces = icosphere({"many_prims": 2, "bvh_size": 4, "many_lights": 1}[case])
        jd = td = mesh_scene_desc(verts, faces[:40] if case == "many_lights" else faces,
                                  width=w, height=h, samples=spp)
        if case == "many_lights":
            for p in td.primitives:
                p.emission = np.ones(3)
    elif case == "depth1":
        jd.settings.ray_depth = td.settings.ray_depth = 1
    else:
        kw = {"faithful": dict(faithful=True), "roulette": dict(russian_roulette=True),
              "bvh": dict(backend="bvh")}[case]
    return jd, td, kw


@pytest.mark.parametrize("case", ["many_prims", "many_lights", "depth1", "faithful",
                                  "roulette"])
def test_modular_and_depth1_configurations_render(case):
    """Configurations the fused gate refuses render on the modular dense
    path (depth 1 on the fused route's final level) and match the JAX-driven
    loop: >= 99 % of the pixels within 1e-4, path vertices within 1 %."""
    w, h, spp = 16, 12, 2
    jd, td, kw = _configuration(case, w, h, spp)
    r = Renderer(td, device="cpu", **kw)
    assert r.fused == (case == "depth1")
    outs, verts = r.render_frame_device(seed=SEED)
    got = r._assemble(outs).reshape(-1, 3).T
    ja, js = jbuild(jd)
    want, want_rays = _jax_counter_loop(jd, ja, js, w, h, spp, (SEED * 2654435761) & 0xFFFFFFFF,
                                        td.settings.ray_depth, rr=case == "roulette",
                                        faithful=case == "faithful")
    ok = (np.abs(got - want) <= 1e-4).all(axis=0)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(verts - want_rays) <= 0.01 * want_rays
    assert got.max() > 0


@pytest.mark.parametrize("case", ["bvh_size", "bvh"])
def test_out_of_gate_configurations_raise(case):
    """The two configurations the port refused before it had a BVH backend
    now render on it (batch engine): a 5121-primitive mesh (above
    BVH_THRESHOLD, so the BVH backend by default) and MIXED with
    ``backend="bvh"`` asked for. Both match the JAX-driven loop as the
    modular cases do (the BVH walk's plain version computes the dense nearest
    hit exactly); what still raises is a backend that does not exist."""
    w, h, spp = 16, 12, 2
    jd, td, kw = _configuration(case, w, h, spp)
    r = Renderer(td, device="cpu", engine="batch", **kw)
    assert r.backend == "bvh" and not r.fused and r.arrays.bvh is not None
    assert r.bvh_builder in ("native", "numpy")
    outs, verts = r.render_frame_device(seed=SEED)
    got = r._assemble(outs).reshape(-1, 3).T
    ja, js = jbuild(jd)
    want, want_rays = _jax_counter_loop(jd, ja, js, w, h, spp, (SEED * 2654435761) & 0xFFFFFFFF,
                                        td.settings.ray_depth)
    ok = (np.abs(got - want) <= 1e-4).all(axis=0)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(verts - want_rays) <= 0.01 * want_rays
    assert got.max() > 0
    with pytest.raises(ValueError, match="backend"):
        Renderer(td, device="cpu", backend="grid")


def test_text_scene_overrides_and_planes_only_scene():
    text = """
DIMENSIONS 12 8
RAY_DEPTH 3
BG_COLOR 0.2 0.3 0.5
CAMERA_POSITION 0 1 6
CAMERA_FORWARD 0 0 -1
NEW_PRIMITIVE
PLANE 0 1 0
POSITION 0 -2 0
COLOR 0.7 0.6 0.5
"""
    td = parse_text_scene(text)
    img = Renderer(td, device="cpu").render_radiance(seed=0, samples=2)
    assert img.shape == (8, 12, 3) and np.isfinite(img).all()
    # upper rows see the background, lower rows the lit-by-sky plane
    np.testing.assert_allclose(img[0, 0], (0.2, 0.3, 0.5), atol=1e-6)
