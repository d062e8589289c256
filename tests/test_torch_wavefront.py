"""PyTorch port, the lane engines on the CPU (plain versions of K1 in lane
mode, K5 and K4): whole frames against the JAX package's engines, which on
the CPU draw the same counter streams through their XLA core, so the two
agree image for image; the port's own invariants (lane-count invariance on
every engine, sticky against counter refill, determinism, the exact mirror
answer, the furnace band); and ``RT_ENGINE``.

Tolerances: frames against JAX >= 99 % of pixels within 1e-4 and path
vertices within 1 % (a flipped accept or Fresnel decision changes a whole
path); the port against itself as tests/test_wavefront.py holds the JAX
engines (rtol 1e-4, atol 1e-5 across lane counts; 1e-5 sticky against
counter refill: the same paths, summed in another order).
"""

import numpy as np
import pytest

from raytracing_course_2024_tpu.integrator import wavefront as jwf
from raytracing_course_2024_tpu.integrator.path import TraceConfig as JTraceConfig
from raytracing_course_2024_tpu.ops.camera import camera_arrays as j_camera
from raytracing_course_2024_tpu.runtime.render import Renderer as JRenderer
from raytracing_course_2024_tpu_torch.integrator import path as P
from raytracing_course_2024_tpu_torch.integrator import wavefront as W
from raytracing_course_2024_tpu_torch.ops.bounce import bounce_scene
from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays
from raytracing_course_2024_tpu_torch.runtime import cli
from raytracing_course_2024_tpu_torch.runtime.image_io import read_ppm
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from raytracing_course_2024_tpu_torch.scene import parse_text_scene
from test_wavefront import CORNELL as BOX_SCENE
from test_wavefront import FURNACE_SCENE, MIRROR_SCENE
from torch_parity import CORNELL, builds, descs, to_jnp

SEED = 5
SEED32 = (SEED * 2654435761) & 0xFFFFFFFF


def _agree(got, want, got_verts, want_verts):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all() and got.max() > 0
    ok = (np.abs(got - want) <= 1e-4).all(axis=0)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(got_verts - want_verts) <= 0.01 * want_verts, (got_verts, want_verts)


# (scene, engine, Renderer keywords, the route the port must take)
CASES = {
    "sticky_fused": ("mixed", "sticky", {}, "k5"),
    "sticky_lanes_below_pixels": ("mixed", "sticky", dict(batch_size=100), "k1"),
    "wavefront": ("mixed", "wavefront", dict(batch_size=256), "k1"),
    "sticky_roulette": ("mixed", "sticky", dict(russian_roulette=True), "xla"),
    "sticky_faithful": ("mixed", "sticky", dict(faithful=True), "xla"),
    "cornell_sticky_fused": ("cornell", "sticky", {}, "k5"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_frames_match_jax_engines(case):
    """The port (device="cpu") against the JAX Renderer with the same
    engine and batch_size, 16x12 (Cornell 24x18) at 2 spp."""
    name, engine, kw, route = CASES[case]
    w, h = (24, 18) if name == "cornell" else (16, 12)
    jd, td = descs(name, w, h, 2)
    jr = JRenderer(jd, engine=engine, **kw)
    # the XLA dense sweep in place of the interpret-mode triangle kernel:
    # the same nearest hit, far less CPU time
    jr.arrays = jr.arrays._replace(tri_pack=None)
    jouts, jverts = jr.render_frame_device(seed=SEED)
    r = Renderer(td, device="cpu", engine=engine, **kw)
    assert r.fused == (route != "xla")
    outs, verts = r.render_frame_device(seed=SEED)
    assert len(outs) == 1 and tuple(outs[0].shape) == (3, w * h)
    _agree(outs[0].numpy(), jouts[0], verts, jverts)
    if route == "k5":  # one lane per pixel: 2 spp of at most ray_depth rounds each
        assert 2 <= r.rounds <= 2 * td.settings.ray_depth


def test_render_wavefront_tile_matches_jax_function():
    """A direct call on a tile: pixels [37, 37 + 100) of the MIXED frame at
    samples 4..5 (pix_base 37, samp_base 4) on 64 lanes."""
    w, h = 16, 12
    (jd, ja, js), (td, ta, ts) = builds("mixed", w, h, 2)
    bg = tuple(jd.settings.bg_color)
    depth = jd.settings.ray_depth
    jimg, jverts = jwf.render_wavefront(
        np.uint32(SEED32), np.int32(37), np.int32(4), j_camera(jd.settings.camera), to_jnp(ja),
        js, JTraceConfig(ray_depth=depth, bg_color=bg, max_tries=4), w, h, 100, 2, 64)
    cfg = P.TraceConfig(ray_depth=depth, bg_color=bg, max_tries=4)
    img, verts, rounds = W.render_wavefront(
        SEED32, 37, 4, camera_arrays(td.settings.camera), bounce_scene(ta, ts, "cpu"), cfg,
        w, h, 100, 2, 64)
    assert tuple(img.shape) == (3, 100) and rounds > 2 * depth
    _agree(img.numpy(), jimg, verts, float(jverts))


def _box(engine, samples=16, **kw):
    r = Renderer(parse_text_scene(BOX_SCENE), device="cpu", engine=engine, **kw)
    return r.render_radiance(seed=0, samples=samples), r


def test_lane_count_invariance():
    """The image does not depend on the lane count: counter refill on 512
    lanes against lanes >= all work; sticky on 128 lanes (K1 lane mode,
    four pixels per lane) against one K5 lane per pixel."""
    big, r_big = _box("wavefront")
    small, r_small = _box("wavefront", batch_size=512)
    assert r_small.rounds > r_big.rounds
    np.testing.assert_allclose(small, big, rtol=1e-4, atol=1e-5)
    fused, r_fused = _box("sticky")
    lanes128, r_128 = _box("sticky", batch_size=128)
    assert r_128.rounds > r_fused.rounds
    np.testing.assert_allclose(lanes128, fused, rtol=1e-4, atol=1e-5)


def test_sticky_matches_counter_wavefront():
    """Both engines trace the same work-item streams: the same paths,
    accumulated in another order."""
    wf, _ = _box("wavefront", samples=8)
    st, _ = _box("sticky", samples=8)
    np.testing.assert_allclose(st, wf, rtol=1e-5, atol=1e-5)
    assert wf.max() > 0.1


def test_sticky_fused_raises_on_work_left_at_the_round_cap(monkeypatch):
    """The fused sticky loop stops at samples x ray_depth rounds; a frame
    whose lanes still report work there raises instead of being cut short."""
    _, r = _box("sticky", samples=2)
    assert r.fused and 2 <= r.rounds <= 2 * parse_text_scene(BOX_SCENE).settings.ray_depth
    real = W.persistent_plain

    def never_done(*args):
        state, live, more = real(*args)
        return state, live, more + 1

    monkeypatch.setattr(W, "persistent_plain", never_done)
    with pytest.raises(RuntimeError, match="work left"):
        _box("sticky", samples=2, plain=True)


@pytest.mark.parametrize("engine", ["wavefront", "sticky"])
def test_lane_engines_deterministic_per_seed(engine):
    r = Renderer(parse_text_scene(BOX_SCENE), device="cpu", engine=engine)
    a, b, c = (r.render_radiance(seed=s, samples=4) for s in (1, 1, 7))
    assert np.array_equal(a, b) and not np.array_equal(a, c)


@pytest.mark.parametrize("engine", ["wavefront", "sticky"])
def test_mirror_exact(engine):
    rad = Renderer(parse_text_scene(MIRROR_SCENE), device="cpu",
                   engine=engine).render_radiance(seed=0)
    np.testing.assert_allclose(rad, np.broadcast_to((0.3, 0.5, 0.7), rad.shape), atol=1e-4)


def test_lambertian_furnace_wavefront():
    """The reference-faithful rejection-inflated value the JAX engines pin
    (tests/test_wavefront.py::test_lambertian_furnace_wavefront)."""
    rad = Renderer(parse_text_scene(FURNACE_SCENE), device="cpu",
                   engine="wavefront").render_radiance(seed=0)
    assert 0.62 < rad.mean() < 0.71, rad.mean()


def test_rt_engine_selects_the_engine(monkeypatch, tmp_path):
    """``RT_ENGINE`` picks the engine in the Renderer and therefore in the
    CLI; an explicit ``engine=`` wins."""
    _, td = descs("cornell", 16, 12, 2)
    assert Renderer(td, device="cpu").engine == "batch"
    monkeypatch.setenv("RT_ENGINE", "sticky")
    r = Renderer(td, device="cpu")
    assert r.engine == "sticky"
    outs, _ = r.render_frame_device(seed=1)
    assert len(outs) == 1 and r.rounds > 0  # one lane-engine frame, not batches
    assert Renderer(td, device="cpu", engine="batch").engine == "batch"
    monkeypatch.setenv("RT_ENGINE", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        Renderer(td, device="cpu")

    monkeypatch.chdir(tmp_path)
    frames = {}
    for engine in ("batch", "sticky", "wavefront"):
        monkeypatch.setenv("RT_ENGINE", engine)
        assert cli.main([CORNELL, "16", "12", "2", f"{engine}.ppm"], device="cpu") == 0
        frames[engine] = read_ppm(f"{engine}.ppm")
        assert f"engine={engine}" in (tmp_path / "out.log").read_text()
    # the lane engines draw another stream than the batch engine
    assert not np.array_equal(frames["sticky"], frames["batch"])
    assert np.abs(frames["sticky"].astype(int) - frames["wavefront"].astype(int)).max() <= 1
