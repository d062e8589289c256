"""PyTorch port, the multi-device renderer (``parallel/shard.py``,
``ShardedRenderer``) on meshes of repeated ``cpu`` devices, and the launch
wrappers of ``ops/kernels.py`` under several devices and threads.

Every draw is keyed by the global (seed, sample, pixel), so a sharded frame
equals the single-device frame up to the order of the sums: rtol 1e-4,
atol 1e-5, the tolerances of the JAX package's
``test_wavefront_sharded_mesh_invariance``, on every mesh and engine. The
lane engines against the JAX package's ``render_frame_sharded`` on its
8-device virtual mesh: image for image (>= 99 % of pixels within 1e-4); the
batch engine, whose JAX twin folds a threefry key per shard, within 3 sigma
of the frame mean. Nothing here needs a card: the launch wrappers run
against a stubbed kernel library."""

import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.integrator.path import TraceConfig as JTraceConfig
from raytracing_course_2024_tpu.ops.camera import camera_arrays as j_camera
from raytracing_course_2024_tpu.parallel import make_mesh as j_make_mesh
from raytracing_course_2024_tpu.parallel import render_frame_sharded as j_render_frame_sharded
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.parallel import make_mesh, render_frame_sharded
from raytracing_course_2024_tpu_torch.runtime import render as R
from raytracing_course_2024_tpu_torch.runtime.render import Renderer, ShardedRenderer
from test_torch_checkpoint import resume_is_bit_exact
from torch_parity import builds, descs, to_jnp

SEED = 5
ENGINES = ("batch", "wavefront", "sticky")
CPU8 = ["cpu"] * 8


def _mesh(n_tiles, n_spp):
    return make_mesh(n_tiles, n_spp, devices=CPU8)


def _frames(engine, mesh_shape, w=16, h=12, spp=4, **kw):
    """(sharded frame, single-device frame, the ShardedRenderer, the two
    frames' path vertices) of MIXED, frames (H, W, 3)."""
    _, td = descs("mixed", w, h, spp)
    single, stats = Renderer(td, device="cpu", engine=engine, **kw).render_radiance(
        seed=SEED, with_stats=True)
    sr = ShardedRenderer(td, mesh=_mesh(*mesh_shape), engine=engine, **kw)
    got, sstats = sr.render_radiance(seed=SEED, with_stats=True)
    return got, single, sr, (sstats.path_vertices, stats.path_vertices)


@pytest.mark.parametrize("shape", [(2, 2), (8, 1), (1, 2), (3, 1)])
def test_make_mesh_shapes(shape):
    devs = [torch.device("cpu", i) for i in range(8)]  # distinct objects, to see the order
    mesh = make_mesh(*shape, devices=devs)
    assert mesh.shape == {"tile": shape[0], "spp": shape[1]}
    assert mesh.axis_names == ("tile", "spp")
    flat = [d for row in mesh.devices for d in row]
    assert flat == devs[:shape[0] * shape[1]]  # tile-major, the first n
    assert _mesh(*shape).distinct() == [torch.device("cpu")]


def test_make_mesh_needs_enough_devices(monkeypatch):
    with pytest.raises(ValueError, match="needs 9 devices, have 8"):
        make_mesh(3, 3, devices=CPU8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh(2, 1).devices == ((torch.device("cuda", 0),), (torch.device("cuda", 1),))
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        make_mesh(2, 2)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (1, 2), (2, 1)])
def test_sharded_frame_equals_single_device(engine, shape):
    """MIXED 16x12 at 4 spp (12 rows over 8 tiles: 2 rows each, the last
    two tiles all padding past row 11, cropped). The shards trace the
    single frame's paths, so without padded rows the path vertices are
    equal too."""
    got, want, sr, (verts, single_verts) = _frames(engine, shape)
    assert got.shape == want.shape == (12, 16, 3) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.array(sr.rounds).shape == shape
    assert (np.array(sr.rounds) > 0).all() == (engine != "batch")
    if 12 % shape[0] == 0:
        assert verts == single_verts
    else:
        assert verts > single_verts


@pytest.mark.parametrize("engine", ENGINES)
def test_nondivisible_height_is_cropped(engine):
    """13 rows over 4 tiles: 4 rows a tile, the last tile one real row and
    three copies of it; the camera keeps the true 13-row mapping."""
    got, want, _, _ = _frames(engine, (4, 2), h=13)
    assert got.shape == (13, 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bvh_backend_sharded_equals_single_device():
    """The BVH backend (K6's plain version, the modular bounce with K3's)
    on a (2, 2) mesh; on the BVH backend's default engine, the counter
    wavefront, as the JAX Renderer picks it."""
    got, want, sr, (verts, single_verts) = _frames(None, (2, 2), backend="bvh")
    assert verts == single_verts
    assert sr.backend == "bvh" and sr.engine == "wavefront" and sr.arrays.bvh is not None
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sharded_frame_is_deterministic():
    _, td = descs("mixed", 16, 12, 4)
    sr = ShardedRenderer(td, mesh=_mesh(4, 2), engine="wavefront")
    a, b, c = (sr.render_radiance(seed=s) for s in (1, 1, 2))
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def _jax_sharded(engine, w, h, spp):
    (jd, ja, js), _ = builds("mixed", w, h, spp)
    # the XLA dense sweep in place of the interpret-mode triangle kernel
    arrays = to_jnp(ja._replace(tri_pack=None))
    cfg = JTraceConfig(ray_depth=jd.settings.ray_depth, bg_color=tuple(jd.settings.bg_color),
                       max_tries=4)
    img = j_render_frame_sharded(jax.random.PRNGKey(SEED), arrays, js,
                                 j_camera(jd.settings.camera), cfg, w, h, spp,
                                 j_make_mesh(2, 2), engine=engine)
    return np.moveaxis(np.asarray(img), 0, -1)


@pytest.mark.parametrize("engine", ["wavefront", "sticky"])
def test_lane_engines_match_jax_sharded(engine):
    """16x12 at 2 spp on the JAX package's make_mesh(2, 2) of virtual CPU
    devices against the port's (2, 2) mesh: the JAX lane engines key their
    draws by (PRNGKey(seed) -> seed32, global pixel, global sample) as the
    port does."""
    want = _jax_sharded(engine, 16, 12, 2)
    _, td = descs("mixed", 16, 12, 2)
    got = ShardedRenderer(td, mesh=_mesh(2, 2), engine=engine).render_radiance(seed=SEED)
    assert got.shape == want.shape == (12, 16, 3) and got.max() > 0
    ok = (np.abs(got - want) <= 1e-4).all(axis=-1)
    assert ok.mean() >= 0.99, ok.mean()


def test_batch_engine_matches_jax_sharded_statistically():
    """24x16 at 8 spp on (2, 2) meshes: per-channel frame means within 3
    sigma, sigma the standard error of an 8-spp frame mean from the port's
    per-pixel variance over 8 one-sample frames, times sqrt(2)."""
    w, h, spp = 24, 16, 8
    want = _jax_sharded("batch", w, h, spp)
    _, td = descs("mixed", w, h, spp)
    got = ShardedRenderer(td, mesh=_mesh(2, 2)).render_radiance(seed=SEED)
    r = Renderer(td, device="cpu")
    singles = np.stack([r.render_radiance(seed=100 + s, samples=1) for s in range(8)])
    sigma = np.sqrt(singles.var(axis=0, ddof=1).sum(axis=(0, 1)) / spp) / (w * h)
    diff = np.abs(got.mean(axis=(0, 1)) - want.mean(axis=(0, 1)))
    assert (sigma > 0).all()
    assert (diff < 3.0 * np.sqrt(2.0) * sigma).all(), (diff, sigma)


@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_renderer_resumes_bit_exact(engine, tmp_path):
    """``ShardedRenderer`` inside ``render_with_checkpoints`` on a (2, 2)
    mesh: 8 spp in 2-spp chunks, interrupted before chunk 2, resumed."""
    _, td = descs("mixed", 16, 12, 8)
    resume_is_bit_exact(ShardedRenderer(td, mesh=_mesh(2, 2), engine=engine), tmp_path, 8, 2,
                        stop=2)


def test_render_frame_sharded_checks_its_split():
    _, td = descs("mixed", 16, 12, 3)
    sr = ShardedRenderer(td, mesh=_mesh(1, 1))
    with pytest.raises(ValueError, match="do not split"):
        render_frame_sharded(SEED, sr.scenes, sr.cfg, sr.cam, 16, 12, 3, _mesh(1, 2))
    with pytest.raises(ValueError, match="unknown engine"):
        render_frame_sharded(SEED, sr.scenes, sr.cfg, sr.cam, 16, 12, 2, _mesh(1, 2),
                             engine="bogus")


def test_render_scene_sharded_refuses_batch_size():
    _, td = descs("mixed", 16, 12, 2)
    with pytest.raises(ValueError, match="batch_size"):
        R._render_scene_sharded(td, batch_size=4096)


@pytest.mark.parametrize("device,cards,sharded", [
    ("cuda", 2, True), ("cuda", 1, False), ("cuda:1", 2, False), ("cpu", 2, False),
    (torch.device("cuda"), 4, True),
])
def test_render_scene_shards_only_a_bare_cuda_on_several_cards(monkeypatch, device, cards,
                                                               sharded):
    """Spies in place of both renderers and of the card count."""
    calls = []
    monkeypatch.setattr(R.torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(R, "_render_scene_sharded",
                        lambda desc, seed, **kw: calls.append(("sharded", kw)) or "S")

    class Single:
        def __init__(self, desc, device, **kw):
            calls.append(("single", device))
            self.backend, self.bvh_builder, self.engine, self.rounds = "dense", None, "batch", 0

        def render_u8(self, seed):
            return "U"

    monkeypatch.setattr(R, "Renderer", Single)
    _, td = descs("mixed", 16, 12, 2)
    out = R.render_scene(td, seed=1, device=device, engine="batch")
    if sharded:
        assert out == "S" and calls == [("sharded", {"engine": "batch"})]
    else:
        assert out == "U" and calls == [("single", device)]


@pytest.mark.parametrize("cards,samples,want", [(4, 8, (2, 2)), (3, 8, (3, 1)),
                                                (4, 7, (4, 1)), (2, 4, (1, 2))])
def test_sharded_renderer_default_mesh(monkeypatch, cards, samples, want):
    """2 cards on the spp axis when the card count and the samples are even,
    the rest on tile (the JAX package's ShardedRenderer)."""
    asked = []
    monkeypatch.setattr(R.torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(R, "make_mesh",
                        lambda t, s, devices=None: asked.append((t, s, devices)) or _mesh(t, s))
    _, td = descs("mixed", 16, 12, samples)
    sr = ShardedRenderer(td)
    assert asked == [(*want, None)] and sr.mesh.shape == {"tile": want[0], "spp": want[1]}
    assert list(sr.scenes) == [torch.device("cpu")]  # one scene per distinct device


# --- the launch wrappers of ops/kernels.py, against a stubbed library -------


class FakeTensor:
    """What a launcher reads of a tensor: device, shape, data_ptr()."""

    def __init__(self, device, shape=(64,)):
        self.device, self.shape = device, shape

    def data_ptr(self):
        return 4096


def _launches(dev):
    """Each launcher with tensors on ``dev``: (name, its LAUNCHES key, call)."""
    t = lambda *shape: FakeTensor(dev, shape or (64,))  # noqa: E731
    scene = types.SimpleNamespace(geo=t(35, 8), rec=t(8, 16), lp=t(12, 2), lspec=t(2),
                                  statics=types.SimpleNamespace(num_lights=1))
    ctr = types.SimpleNamespace(base=0, cand=1, row=2, diel=3)
    bg = (0.1, 0.2, 0.3)
    rays = [t() for _ in range(6)]
    return [
        ("bounce", "bounce", lambda: kernels.launch_bounce(
            scene, t(13, 64), t(13, 64), t(), t(2), ctr, None, 0, bg, 4, False)),
        ("final", "final", lambda: kernels.launch_bounce(
            scene, t(13, 64), t(13, 64), t(), t(2), ctr, t(), 7, bg, 4, True, t())),
        ("primary", "primary", lambda: kernels.launch_primary(
            scene, t(128), t(), t(), t(13, 64), t(), t(2), ctr, bg, 4, 16, 12)),
        ("persistent", "persistent", lambda: kernels.launch_persistent(
            scene, t(18, 64), t(18, 64), t(), t(), t(), t(128), 16, 12, t(3), 192, ctr, 7,
            4, bg, 4, t(6), t(2), t(3))),
        ("nearest", "nearest", lambda: kernels.launch_dense_nearest(
            rays, t(8, 16), 0.0, t(), t(), t())),
        ("bvh", "bvh", lambda: kernels.launch_bvh_nearest(
            rays, t(5, 8), 3, t(8, 12), 0.0, None, t(), t())),
        ("sampler", "sampler", lambda: kernels.launch_sampler(
            [t() for _ in range(13)], t(), t(), t(2), ctr, None, 64, t(12, 2), t(2), 1, 4,
            t(4, 64), t())),
        ("sampler-lane-mode", "sampler", lambda: kernels.launch_sampler(
            [t() for _ in range(13)], t(), t(), t(2), ctr, t(), 64, t(12, 2), t(2), 1, 4,
            t(4, 64), t())),
        ("sampler-many-lights", "sampler_many", lambda: kernels.launch_sampler_many(
            [t() for _ in range(13)], t(), t(), t(2), ctr, t(), 64, t(40, 20), t(40, 20),
            t(5, 32), 3, 4, t(4, 64), t())),
        ("refill", "refill", lambda: kernels.launch_refill(
            t(13, 64), t(), t(), t(3, 164), t(), t(), t(2), t(128), t(2), 50, 2, 16, 12, t(2))),
        ("restart", "restart", lambda: kernels.launch_restart(
            t(13, 64), t(), t(), t(), t(3, 64), t(2), t(128), t(2), 50, 2, 16, 12)),
        ("shade", "shade", lambda: kernels.launch_shade(
            t(13, 64), t(), t(), t(8, 40), t(20, 1), t(1), 1, True, True, t(), 5, bg, False,
            (t(13, 64), t(64, 8)), t())),
        ("camera", "camera", lambda: kernels.launch_camera(
            t(), t(), t(), t(2), t(128), 16, 12, t(13, 64))),
        ("loop", "loop", lambda: kernels.launch_round_tail(
            0, 2, t(13, 64), t(), t(), None, None, 64, 0, 0, 5, t(()), 256, 8, t(6), t(2),
            t(3))),
        ("loop-sticky", "loop", lambda: kernels.launch_round_tail(
            1, 1, None, t(), t(), t(), None, 64, 50, 2, 5, None, 0, 1, t(6), t(2), t(3))),
        ("finish", "finish", lambda: kernels.launch_finish(
            t(13, 64), (t(13, 64), t(64, 8)), [t() for _ in range(4)], t(), t(), t(2), 2, 64, 63,
            62, t(),
            0, True, 2, False, t())),
    ]


@pytest.fixture
def stub_cuda(monkeypatch):
    """A kernel library that records the current device and the stream of
    each call, ``torch.cuda.device`` / ``current_stream`` that track a
    current device without a card, fresh counters and tickets."""
    current = [torch.device("cuda", 0)]
    calls = []

    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                calls.append((name, current[0], args[-1]))
                return 0
            return launch

    class Device:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            self.prev, current[0] = current[0], self.dev

        def __exit__(self, *exc):
            current[0] = self.prev

    monkeypatch.setattr(kernels, "library", Lib)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=1000 + dev.index))
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES, 0))
    monkeypatch.setattr(kernels, "_TICKETS", {
        (torch.device("cuda", i), 1000 + i): torch.zeros(2, dtype=torch.int32)
        for i in range(4)})
    return calls, current


@pytest.mark.parametrize("name", [n for n, _, _ in _launches(torch.device("cuda", 3))])
def test_launchers_launch_on_their_tensors_device(stub_cuda, name):
    """Tensors on cuda:3 while cuda:0 is current: the launch happens with
    cuda:3 current, on cuda:3's stream, and is counted once; the current
    device is restored."""
    calls, current = stub_cuda
    dev = torch.device("cuda", 3)
    (key, launch), = [(k, f) for n, k, f in _launches(dev) if n == name]
    launch()
    assert len(calls) == 1 and calls[0][1] == dev and calls[0][2] == 1003
    assert current[0] == torch.device("cuda", 0)
    assert kernels.LAUNCHES == {k: int(k == key) for k in kernels.LAUNCHES}


def test_failed_launch_is_not_counted(stub_cuda, monkeypatch):
    monkeypatch.setattr(kernels, "library",
                        lambda: types.SimpleNamespace(rt_launch_dense_nearest=lambda *a: 700))
    dev = torch.device("cuda", 1)
    (launch,) = [f for n, _, f in _launches(dev) if n == "nearest"]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        launch()
    assert not any(kernels.LAUNCHES.values())


def test_counts_and_tickets_are_thread_safe(monkeypatch):
    """8 threads count 2,000 launches each and ask for one (device, stream)
    ticket pair at once, with the interpreter switching threads every
    microsecond: no count is lost and one pair is made."""
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.LAUNCHES, 0))
    monkeypatch.setattr(kernels, "_TICKETS", {})
    start = threading.Barrier(8)
    pairs = []

    def work():
        start.wait(timeout=30)
        pairs.append(kernels._tickets(torch.device("cpu"), 7))
        for _ in range(2000):
            kernels._count("bounce")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert kernels.LAUNCHES["bounce"] == 16_000
    assert len(kernels._TICKETS) == 1 and all(p is pairs[0] for p in pairs) and len(pairs) == 8
