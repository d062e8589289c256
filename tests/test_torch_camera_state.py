"""PyTorch port, the modular route's camera stage: N4 (``csrc/camera.cu``)
and its plain version ``ops/camera.py:camera_state_plain``.

* ``camera_state_plain`` against the JAX package on the same seed, work
  ids, offsets, pixels and camera, made with numpy: the JAX package's
  ``work_key`` and ``uniform_ctr`` (``ops/rng.py``) for the draws, its
  ``generate_rays_u`` for the rays and ``trace_paths``' initial rows for the
  rest. Keys and draws bit for bit, rays within 1e-6, throughput, radiance
  and alive bit for bit.
* ``camera_state_plain`` against the fused route's former
  ``_first_level_state`` (written out here): bit for bit but the sign of a
  zero radiance, which follows the origin's x in the modular state (as in
  the JAX package's ``trace_paths``) and was +0 there.
* ``_modular_sample`` on the plain path and through the CPU wrappers
  against the route as it was before N4, its ops written out here (the work
  key, the draws, ``generate_rays_u``, the fresh rows, the level loop):
  radiance and path vertices bit for bit, ints or device scalars.
* ``camera_state`` on the CPU: the plain version, into ``out`` too, no
  launch counted; a meta tensor raises.
* On a card (marked ``cuda``; skipped here): N4 bit for bit against the
  plain version at four lane counts, a ragged one and 921,600 among them,
  eagerly and inside a captured CUDA graph replayed with a changed seed
  pair; one modular sample launches N4 once and calls no plain camera stage.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.ops import camera as jcam
from raytracing_course_2024_tpu.ops import rng as jrng
from raytracing_course_2024_tpu_torch.integrator import path as P
from raytracing_course_2024_tpu_torch.ops import bounce as B
from raytracing_course_2024_tpu_torch.ops import camera as C
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops import rng as trng
from raytracing_course_2024_tpu_torch.ops.vec import Vec3
from test_torch_graphs import _bvh_mesh, _dense_rr
from torch_parity import descs

SEED32 = 0x5EED1234
M32 = 0xFFFFFFFF
OFFSETS = (0, 3 * 24 * 16, 2**32 + 17)  # the last wraps past 2^32, as the device pair's low bits


def _i64(x):
    return torch.tensor(x, dtype=torch.int64)


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def _random_camera(seed: int) -> C.CameraArrays:
    """A camera from numpy: an orthonormal basis around a random forward
    direction, a position with a negative, a zero and a negative-zero
    coordinate (so a zero's sign reaches the state), random fields of
    view."""
    g = np.random.default_rng(seed)
    fwd = g.normal(size=3)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    pos = f32([-g.uniform(1, 5), 0.0, -0.0])
    return C.CameraArrays(position=pos, right=f32(right), up=f32(up), forward=f32(fwd),
                          tan_half_fov_x=np.float32(g.uniform(0.3, 1.2)),
                          tan_half_fov_y=np.float32(g.uniform(0.2, 0.9)))


def _camera(name: str):
    """(CameraArrays, width, height) of a fixture camera."""
    if name == "random":
        return _random_camera(5), 24, 16
    _, td = descs(name, 24, 16, 1)
    return C.camera_arrays(td.settings.camera), 24, 16


def _lanes(w, h, seed=7):
    """Work ids (a permutation of the pixels, then some past the frame) and
    their pixels, from numpy."""
    g = np.random.default_rng(seed)
    n = w * h
    wid = np.concatenate([g.permutation(n), g.integers(n, 2**31 - 1, 64)]).astype(np.int32)
    pix = wid.astype(np.int64) % n
    return (torch.from_numpy(wid), torch.from_numpy((pix % w).astype(np.float32)),
            torch.from_numpy((pix // w).astype(np.float32)))


def _jax_camera(cam: C.CameraArrays):
    return jcam.CameraArrays(*(jnp.asarray(x) for x in cam))


@pytest.mark.parametrize("camera", ["random", "cornell", "mixed"])
@pytest.mark.parametrize("off", OFFSETS)
def test_camera_state_plain_matches_jax(camera, off):
    cam, w, h = _camera(camera)
    wid, px, py = _lanes(w, h)
    st = C.camera_state_plain(SEED32, wid, off, px, py, cam, w, h)
    assert st.shape == (13, wid.shape[0]) and st.dtype == torch.float32
    ids = ((wid.numpy().astype(np.int64) + off) & M32).astype(np.uint32)
    jkey = jrng.work_key(jnp.uint32(SEED32), jnp.asarray(ids))
    tkey = trng.work_key(SEED32, trng.offset_ids(wid, off))
    assert np.array_equal(np.asarray(jkey).astype(np.int64), tkey.numpy())
    ju = [jrng.uniform_ctr(jkey, trng.CTR_JITTER + d) for d in (0, 1)]
    tu = [trng.uniform_ctr(tkey, trng.CTR_JITTER + d) for d in (0, 1)]
    for a, b in zip(ju, tu):
        assert np.array_equal(np.asarray(a).view(np.int32), _bits(b))
    ro, rd = jcam.generate_rays_u(_jax_camera(cam), jnp.asarray(px.numpy()),
                                  jnp.asarray(py.numpy()), w, h, ju[0], ju[1])
    zeros = ro.x * 0.0
    ones = zeros + 1.0
    alive = (zeros < 1.0).astype(jnp.float32)
    want = np.stack([np.asarray(x) for x in (*ro, *rd, ones, ones, ones, zeros, zeros, zeros,
                                             alive)])
    np.testing.assert_allclose(st[:6].numpy(), want[:6], rtol=0, atol=1e-6)
    assert np.array_equal(_bits(st[6:]), want[6:].view(np.int32))


def _first_level_state_before(seed, wid, wid_off, px, py, cam, w, h):
    """The fused route's fresh state as it was computed before N4
    (``integrator/path.py:_first_level_state``)."""
    draw = B.lane_draws(seed, wid, wid_off)
    ro, rd = C.generate_rays_u(cam, px, py, w, h, draw(trng.CTR_JITTER),
                               draw(trng.CTR_JITTER + 1))
    zero = px * 0.0
    one = zero + 1.0
    return B._pack(ro, rd, Vec3(one, one, one), Vec3(zero, zero, zero), zero < 1.0)


@pytest.mark.parametrize("camera", ["random", "cornell"])
def test_camera_state_plain_equals_the_first_level_state(camera):
    cam, w, h = _camera(camera)
    wid, px, py = _lanes(w, h)
    got = C.camera_state_plain(SEED32, wid, 2**32 + 5, px, py, cam, w, h)
    want = _first_level_state_before(SEED32, wid, 2**32 + 5, px, py, cam, w, h)
    assert torch.equal(got, want)  # as values: +0 == -0
    keep = [*range(9), 12]
    assert np.array_equal(_bits(got[keep]), _bits(want[keep]))
    # the radiance's zero: -0 exactly where the origin's x is negative (or -0)
    neg = torch.signbit(got[0])
    assert torch.equal(torch.signbit(got[9:12]), neg.expand(3, -1))
    assert not torch.signbit(want[9:12]).any()
    assert bool(neg.all()) == (camera == "random")


def _modular_sample_before(scene, seed, wid, wid_off, px, py, cam, cfg, w, h, plain):
    """``_modular_sample`` as it was before N4: the camera stage's ops, then
    ``trace_paths`` on the rays (fresh rows, the level loop)."""
    key = trng.work_key(seed, trng.offset_ids(wid, wid_off))
    ro, rd = C.generate_rays_u(cam, px, py, w, h, trng.uniform_ctr(key, trng.CTR_JITTER),
                               trng.uniform_ctr(key, trng.CTR_JITTER + 1))
    zero = ro.x * 0.0
    one = zero + 1.0
    st = torch.stack([*ro, *rd, one, one, one, zero, zero, zero, one])
    live = st[12] > 0.5
    rays = torch.zeros((), dtype=torch.float64)
    for i in range(cfg.ray_depth - 1):
        rays += live.sum(dtype=torch.float64)
        st, live = P._bounce(st, scene, cfg, seed, wid, wid_off, i, plain, live)
    rays += live.sum(dtype=torch.float64)
    st, _, _ = P._collect_hit(st, scene, cfg, plain, live, final=True)
    return st[9:12], rays


SCENES = {"dense-rr": lambda: _dense_rr()[1:], "bvh-mesh": _bvh_mesh}


@pytest.mark.parametrize("scene_name", list(SCENES))
@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrappers"])
@pytest.mark.parametrize("scalars", ["ints", "device"])
def test_modular_sample_equals_the_route_before_n4(scene_name, plain, scalars):
    d, scene, cfg = SCENES[scene_name]()
    w, h = d.settings.width, d.settings.height
    wid = torch.arange(w * h, dtype=torch.int32)
    px, py = (wid % w).float(), (wid // w).float()
    cam = C.camera_arrays(d.settings.camera)
    off = 5 * w * h
    seed, wid_off = (SEED32, off) if scalars == "ints" else (_i64(SEED32), _i64(off))
    want = _modular_sample_before(scene, SEED32, wid, off, px, py, cam, cfg, w, h, plain)
    got = P._modular_sample(scene, seed, wid, wid_off, px, py, cam, cfg, w, h, plain)
    assert np.array_equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1]) and float(got[1]) > w * h


def test_camera_state_on_the_cpu_runs_the_plain_version():
    cam, w, h = _camera("cornell")
    wid, px, py = _lanes(w, h)
    row = torch.from_numpy(C.pack_camera_row(cam)[0])
    kernels.reset_launches()
    want = C.camera_state_plain(SEED32, wid, 9, px, py, cam, w, h)
    assert torch.equal(C.camera_state(SEED32, wid, 9, px, py, cam, row, w, h), want)
    out = torch.full_like(want, float("nan"))
    assert C.camera_state(SEED32, wid, 9, px, py, cam, None, w, h, out=out) is out
    assert np.array_equal(_bits(out), _bits(want))
    assert not any(kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="no camera kernel"):
        C.camera_state(SEED32, wid.to("meta"), 9, px.to("meta"), py.to("meta"), cam, row, w, h)


# --- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: N4 runs only there")
    return torch.device("cuda", 0)


CARD_SIZES = ((64, 1), (997, 1), (512, 512), (1280, 720))  # lanes = w x h; 997 is ragged


def _card_lanes(w, h, card):
    wid = torch.arange(w * h, dtype=torch.int32, device=card)
    return wid, (wid % w).float(), (wid // w).float()


@pytest.mark.cuda
@pytest.mark.parametrize("size", CARD_SIZES, ids=lambda s: f"{s[0] * s[1]}")
def test_camera_kernel_equals_plain_on_the_card(card, size):
    w, h = size
    cam = _random_camera(11)
    row = torch.from_numpy(C.pack_camera_row(cam)[0]).to(card)
    wid, px, py = _card_lanes(w, h, card)
    for seed, off in ((SEED32, 0), (M32, 2**32 + 3 * w * h)):
        pair = torch.tensor([seed, off], dtype=torch.int64, device=card)
        kernels.reset_launches()
        got = C.camera_state(pair[0], wid, pair[1], px, py, cam, row, w, h)
        assert kernels.LAUNCHES["camera"] == 1
        want = C.camera_state_plain(seed, wid, off, px, py, cam, w, h)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("size", CARD_SIZES, ids=lambda s: f"{s[0] * s[1]}")
def test_camera_kernel_in_a_graph_equals_plain_on_the_card(card, size):
    """One capture, replayed after the seed pair changed on the device."""
    w, h = size
    cam = C.camera_arrays(descs("cornell", w, h, 1)[1].settings.camera)
    row = torch.from_numpy(C.pack_camera_row(cam)[0]).to(card)
    wid, px, py = _card_lanes(w, h, card)
    pair = torch.tensor([1, 0], dtype=torch.int64, device=card)
    out = torch.empty((13, w * h), dtype=torch.float32, device=card)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):  # warm-up: the library, the allocator
        C.camera_state(pair[0], wid, pair[1], px, py, cam, row, w, h, out=out)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with kernels.recording() as rec, torch.cuda.graph(graph):
        C.camera_state(pair[0], wid, pair[1], px, py, cam, row, w, h, out=out)
    assert rec == {"camera": 1}
    for seed, off in ((SEED32, 7 * w * h), (M32, 2**32 + 11)):
        pair.copy_(torch.tensor([seed, off], dtype=torch.int64))
        out.fill_(float("nan"))
        graph.replay()
        want = C.camera_state_plain(seed, wid, off, px, py, cam, w, h)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", list(SCENES))
def test_modular_sample_on_the_card_runs_n4(card, scene_name, monkeypatch):
    """One modular sample on the card launches N4 once and calls no plain
    camera stage."""
    d, scene, cfg = SCENES[scene_name]()
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    r = Renderer(d, device=card, engine="batch", russian_roulette=cfg.rr, eager=True,
                 backend=cfg.backend)
    assert not r.fused
    w, h = d.settings.width, d.settings.height
    wid, px, py = _card_lanes(w, h, card)

    def refuse(*a, **k):
        raise AssertionError("the plain camera stage ran on the card")

    body, run = P.sample_body(r.scene, r.cam_row, r.cfg, w, h, w * h)
    body.load(SEED32, wid, px, py)
    body.at(w * h)
    monkeypatch.setattr(P, "camera_state_plain", refuse)
    kernels.reset_launches()
    run()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["camera"] == 1 and kernels.LAUNCHES["shade"] == cfg.ray_depth
    assert float(body.nrays) > w * h
