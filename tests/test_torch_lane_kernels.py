"""PyTorch port, the lane engines' round stages on the CPU: the sampler in
the lane layout (K3's plain version, ``ops/sampler.py``), the counter
refill and the sticky restart (N2a's and N2b's plain versions,
``ops/refill.py``) against the JAX package's own functions on the same
inputs, made with numpy from a seed.

* the sampler: ``sampler_plain`` given ``lane_ctr(depth)`` and K3's wrapper
  given the depth-0 layout and the depths (its CPU route), against JAX
  ``sample_mixture`` fed the rows of its lane core
  (``raytracing_course_2024_tpu/integrator/wavefront.py:167-173``) at random
  depths: ``ok`` equal, and where it holds l within the tolerance of
  ``test_torch_sampler.py`` (the batch layout's test of the same function)
  and the pdf within its GGX tolerance (rtol 1e-3) on 99.5 % of the lanes.
  1e-6 does not hold: the two formulations round a few ulp apart, which
  GGX's pdf amplifies, and a direction that grazes a light's silhouette
  can change its light pdf by far more, on one lane in a few thousand. The
  two port routes are equal bit for bit;
* the refill: ``refill_plain`` against the refill of
  ``wavefront.py:236-274`` written out with the JAX package's
  ``work_key``, ``uniform_ctr`` and ``generate_rays_u``, the flush going to
  one column per work item as the port keeps it, from a counter near the
  end of the work so that some dead lanes take nothing;
* the restart: ``restart_plain`` against ``wavefront.py:455-500`` likewise,
  with lanes that own several pixels (jmax > 1) and lanes with no path left;
  ``sticky_kmax``, the closed form N2b computes from the lane index, equal
  to the JAX package's count of owned pixels.

Work items, work ids, depths, counters, the flushed radiance and the
state are equal bit for bit, except the camera rays' directions: XLA's
normalisation rounds up to 2 ulp apart from PyTorch's op-by-op one. The lane frames themselves against the JAX
engines are ``test_torch_wavefront.py``'s ``CASES``. On a card (marked
``cuda``; skipped here) N2a and N2b are held against their plain versions
bit for bit (N2a's one launch over more than 4,096 tiles, and three
launches on one scratch), and K3 in lane mode against ``sampler_plain`` at
K3's gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.ops import rng as jrng
from raytracing_course_2024_tpu.ops import sampling as jsamp
from raytracing_course_2024_tpu.ops.camera import camera_arrays as j_camera
from raytracing_course_2024_tpu.ops.camera import generate_rays_u as j_rays
from raytracing_course_2024_tpu_torch.integrator import wavefront as W
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops import refill as RF
from raytracing_course_2024_tpu_torch.ops import rng as trng
from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays, pack_camera_row
from raytracing_course_2024_tpu_torch.ops.sampler import sample_mixture_kernel, sampler_plain
from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from raytracing_course_2024_tpu_torch.scene import parse_text_scene
from test_torch_sampler import SEED, _case, _many_lights, jv, tv
from test_torch_sampling import GGX_TOL, PDF_FRAC, close
from test_wavefront import CORNELL as BOX_SCENE
from torch_parity import builds, descs, to_jnp

K = 4
SEED32 = 0x5EED1234
W_, H_ = 24, 16
PIX_BASE, SAMP_BASE = 37, 3


# --- the sampler in the lane layout ---------------------------------------------


def _depths(n, seed=3):
    return np.random.default_rng(seed).integers(0, 8, n).astype(np.int32)


def _jax_lane_sampler(c, depth, faithful):
    """JAX ``sample_mixture`` fed the rows its lane core builds: candidate
    ``c`` row ``r`` at ``2 + 64 depth + r k + c``."""
    key = jrng.work_key(jnp.uint32(SEED), jnp.asarray(c["wid"]))
    base = 2 + jnp.asarray(depth) * 64
    rows = [jnp.concatenate([jrng.uniform_ctr(key, base + r * K + t) for t in range(K)])
            for r in range(7)]
    return jsamp.sample_mixture(
        None, jv(c["point"]), jv(c["n"]), jv(c["ns"]), jv(c["v"]), jnp.asarray(c["rough"]),
        to_jnp(c["ja"]), c["js"], need=jnp.asarray(c["need"]), max_tries=K,
        faithful=faithful, uniforms=rows)


def _port_args(c):
    return (tv(c["point"]), tv(c["n"]), tv(c["ns"]), tv(c["v"]), torch.from_numpy(c["rough"]),
            torch.from_numpy(c["need"]), K)


@pytest.mark.parametrize("name", ["lights", "mixed", "cornell", "many_lights"])
@pytest.mark.parametrize("faithful", [False, True], ids=["fast", "faithful"])
def test_lane_sampler_matches_jax_lane_core_rows(name, faithful):
    c = _case(name)
    depth = _depths(len(c["wid"]))
    jl, jpdf, jok = _jax_lane_sampler(c, depth, faithful)
    tdepth = torch.from_numpy(depth)
    wid = torch.from_numpy(c["wid"])
    got = [sampler_plain(c["scene"], SEED, wid, 0, trng.lane_ctr(tdepth, K), *_port_args(c),
                         faithful=faithful)]
    if not faithful:  # K3's wrapper on the CPU: the depth-0 layout and the depths
        got.append(sample_mixture_kernel(c["scene"], SEED, wid, 0, trng.lane_ctr(0, K),
                                         *_port_args(c), tdepth))
    ok = np.asarray(jok)
    assert ok.mean() > 0.5 and not ok[~c["need"]].any()
    for tl, tpdf, tok in got:
        assert np.array_equal(tok.numpy(), ok)
        close(tuple(x.numpy()[ok] for x in tl), tuple(np.asarray(x)[ok] for x in jl))
        near = np.isclose(tpdf.numpy()[ok], np.asarray(jpdf)[ok], **GGX_TOL)
        assert near.mean() >= PDF_FRAC, near.mean()
    for a, b in zip((*got[0][0], *got[0][1:]), (*got[-1][0], *got[-1][1:])):
        assert torch.equal(a, b)


def test_lane_ctr_is_the_depth_zero_layout_moved_per_level():
    depth = torch.from_numpy(_depths(64))
    a, b = trng.lane_ctr(depth, K), trng.lane_ctr(0, K).at_depth(depth, trng.WF_STRIDE)
    assert torch.equal(a.base, b.base) and a[1:] == b[1:]
    assert all(torch.equal(a.mix(t, r), b.mix(t, r)) for t in range(K) for r in range(7))


# --- the refill and the restart ---------------------------------------------------


def _cams():
    jd, td = descs("mixed", W_, H_, 2)
    cam = camera_arrays(td.settings.camera)
    return j_camera(jd.settings.camera), cam


def _frame(cam, n_pix, samples, dev="cpu"):
    row = torch.from_numpy(pack_camera_row(cam)[0]).to(dev)
    return RF.LaneFrame(cam, row, W_, H_, n_pix, samples)


def _lane_state(rng, b):
    """(13, b) f32: random rays, throughput and radiance; about half alive."""
    return np.concatenate([rng.uniform(-1, 1, (6, b)), rng.uniform(0.2, 1.0, (3, b)),
                           rng.uniform(0.0, 2.0, (3, b)),
                           (rng.random((1, b)) < 0.5)]).astype(np.float32)


def _jax_camera(jcam, pixl, key):
    """(6, b) camera rays through pixel ``pixl`` of the pass (JAX)."""
    pixg = PIX_BASE + pixl
    ro, rd = j_rays(jcam, pixg % W_, jnp.minimum(pixg // W_, H_ - 1), W_, H_,
                    jrng.uniform_ctr(key, 0), jrng.uniform_ctr(key, 1))
    return np.stack([np.asarray(x) for x in (*ro, *rd)])


def _assert_states_equal(got, want):
    """Bit for bit, but the directions (rows 3-5) within 2 ulp."""
    rows = [r for r in range(13) if not 3 <= r < 6]
    assert np.array_equal(got[rows], want[rows])
    np.testing.assert_array_max_ulp(got[3:6], want[3:6], maxulp=2)


def _work(rng, alive, counter):
    """Each lane's work item, distinct as the counter hands them out: every
    live lane and most dead ones hold one of the ``counter`` items handed
    out, the other dead lanes none (-1)."""
    holds = alive | (rng.random(alive.shape[0]) < 0.7)
    work = np.full(alive.shape[0], -1, np.int64)
    work[holds] = rng.permutation(counter)[:int(holds.sum())]
    return work


def _restarted(state, take, rays, depth):
    """The JAX refill's and restart's update of the taken lanes."""
    st = state.copy()
    st[0:6] = np.where(take, rays, st[0:6])
    st[6:9] = np.where(take, np.float32(1.0), st[6:9])
    st[12] = np.where(take, np.float32(1.0), st[12])
    return st, np.where(take, 0, depth).astype(np.int32)


REFILL_CASES = {  # name -> (lanes, pixels of the pass, samples, work items left)
    "tail": (256, 300, 2, 40),
    "plenty": (256, 600, 2, 500),
    "exhausted": (192, 100, 3, 0),
}


@pytest.mark.parametrize("case", list(REFILL_CASES))
def test_refill_plain_matches_jax_refill(case):
    b, n_pix, samples, left = REFILL_CASES[case]
    total = n_pix * samples
    counter = total - left
    rng = np.random.default_rng(17)
    state = _lane_state(rng, b)
    alive = state[12] > 0.5
    work = _work(rng, alive, counter)
    depth = rng.integers(0, 6, b).astype(np.int32)
    jcam, cam = _cams()

    # the JAX package's refill (wavefront.py:236-274), flushing to work columns
    dead = ~alive
    flush = dead & (work >= 0)
    done = np.zeros((3, total), np.float32)
    done[:, work[flush]] = state[9:12][:, flush]
    want = state.copy()
    want[9:12] = np.where(dead, np.float32(0.0), state[9:12])
    new_id = counter + np.cumsum(dead) - 1
    take = dead & (new_id < total)
    work2 = np.where(take, new_id, np.where(dead, -1, work))
    wc = np.maximum(work2, 0)
    wid = (SAMP_BASE + wc // n_pix) * (W_ * H_) + PIX_BASE + wc % n_pix
    key = jrng.work_key(jnp.uint32(SEED32), jnp.asarray(wid, jnp.int32))
    want, want_depth = _restarted(want, take, _jax_camera(jcam, jnp.asarray(wc % n_pix), key),
                                  depth)
    assert (take.sum() > 0) == (left > 0) and (case == "plenty" or (dead & ~take).any())

    t_state, t_work = torch.from_numpy(state), torch.from_numpy(work.astype(np.int64))
    t_counter = torch.tensor(counter, dtype=torch.int64)
    t_done = torch.zeros((3, total + b), dtype=torch.float32)
    t_depth, t_wid = torch.from_numpy(depth), torch.zeros(b, dtype=torch.int32)
    seed_off = torch.tensor([SEED32, 0], dtype=torch.int64)
    bases = torch.tensor([PIX_BASE, SAMP_BASE], dtype=torch.int64)
    kernels.reset_launches()
    RF.refill(t_state, t_work, t_counter, t_done, t_depth, t_wid, seed_off, bases,
              _frame(cam, n_pix, samples))
    assert kernels.LAUNCHES["refill"] == 0  # the CPU route is the plain version
    assert np.array_equal(t_work.numpy(), work2)
    assert int(t_counter) == counter + int(take.sum())
    assert np.array_equal(t_wid.numpy(), wid.astype(np.int32))
    assert np.array_equal(t_depth.numpy(), want_depth)
    _assert_states_equal(t_state.numpy(), want)
    assert np.array_equal(t_done[:, :total].numpy(), done)


@pytest.mark.parametrize("lanes,n_pix,samples", [(128, 300, 2), (256, 100, 3), (7, 3, 5),
                                                 (1000, 1000, 1), (64, 5 * 64 + 1, 16),
                                                 (96, 95, 4)])
def test_sticky_kmax_equals_the_owned_pixels(lanes, n_pix, samples):
    """``sticky_kmax`` (N2b's closed form) equals the JAX package's count of
    the pixels ``l + j * lanes < n_pix`` each lane owns, times the samples
    (``wavefront.py:438-442``), with lanes past the pixels (lanes > n_pix)
    and lanes owning several (jmax > 1)."""
    jmax = max(-(-n_pix // lanes), 1)
    lane = jnp.arange(lanes, dtype=jnp.int32)
    n_owned = jnp.zeros((lanes,), jnp.int32)
    for j in range(jmax):
        n_owned = n_owned + (lane + j * lanes < n_pix).astype(jnp.int32)
    got = RF.sticky_kmax(lanes, n_pix, samples, "cpu")
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(n_owned * samples))


def test_restart_plain_matches_jax_restart():
    b, n_pix, samples = 128, 300, 2  # jmax = 3: lanes 0..43 own three pixels
    jmax = -(-n_pix // b)
    lane = np.arange(b)
    n_owned = sum((lane + j * b < n_pix).astype(np.int64) for j in range(jmax))
    kmax = n_owned * samples
    rng = np.random.default_rng(23)
    state = _lane_state(rng, b)
    alive = state[12] > 0.5
    k = rng.integers(0, kmax + 1)
    k[::7] = kmax[::7]  # lanes with no path left
    k = np.where(alive, np.maximum(k, 1), k)
    acc = rng.uniform(0.0, 3.0, (3, jmax * b)).astype(np.float32)
    depth = rng.integers(0, 6, b).astype(np.int32)
    jcam, cam = _cams()

    def path_coords(kk):
        cur = np.maximum(kk - 1, 0)
        j = cur // samples
        return j, np.minimum(lane + j * b, n_pix - 1), cur % samples

    # the JAX package's restart (wavefront.py:455-500), acc[j] as slots j * b + l
    dead = ~alive
    flush = dead & (k > 0)
    jf, _, _ = path_coords(k)
    want_acc = acc.copy()
    for j in range(jmax):
        sl = slice(j * b, (j + 1) * b)
        want_acc[:, sl] = np.where(flush & (jf == j), acc[:, sl] + state[9:12], acc[:, sl])
    want = state.copy()
    want[9:12] = np.where(dead, np.float32(0.0), state[9:12])
    take = dead & (k < kmax)
    k2 = np.where(take, k + 1, k)
    _, pixl, samp = path_coords(k2)
    wid = (SAMP_BASE + samp) * (W_ * H_) + PIX_BASE + pixl
    key = jrng.work_key(jnp.uint32(SEED32), jnp.asarray(wid, jnp.int32))
    want, want_depth = _restarted(want, take, _jax_camera(jcam, jnp.asarray(pixl), key), depth)
    assert take.any() and (dead & (k == kmax)).any() and flush.any() and (jf > 0).any()

    t_state, t_k = torch.from_numpy(state), torch.from_numpy(k.astype(np.int64))
    t_acc, t_depth = torch.from_numpy(acc.copy()), torch.from_numpy(depth)
    t_wid = torch.zeros(b, dtype=torch.int32)
    kernels.reset_launches()
    RF.restart(t_state, t_k, torch.from_numpy(kmax.astype(np.int64)), t_depth, t_wid, t_acc,
               torch.tensor([SEED32, 0], dtype=torch.int64),
               torch.tensor([PIX_BASE, SAMP_BASE], dtype=torch.int64),
               _frame(cam, n_pix, samples))
    assert kernels.LAUNCHES["restart"] == 0
    assert np.array_equal(t_k.numpy(), k2)
    assert np.array_equal(t_wid.numpy(), wid.astype(np.int32))
    assert np.array_equal(t_depth.numpy(), want_depth)
    _assert_states_equal(t_state.numpy(), want)
    assert np.array_equal(t_acc.numpy(), want_acc)


def test_wrappers_refuse_other_devices():
    b = 8
    meta = torch.zeros((13, b), device="meta")
    i64 = torch.zeros(b, dtype=torch.int64, device="meta")
    i32 = torch.zeros(b, dtype=torch.int32, device="meta")
    frame = _frame(_cams()[1], 4, 2)
    with pytest.raises(ValueError, match="refill"):
        RF.refill(meta, i64, i64[0], torch.zeros((3, 16), device="meta"), i32, i32, i64[:2],
                  i64[:2], frame)
    with pytest.raises(ValueError, match="restart"):
        RF.restart(meta, i64, i64, i32, i32, torch.zeros((3, b), device="meta"), i64[:2],
                   i64[:2], frame)


@pytest.mark.parametrize("plain", [False, True], ids=["wrapper", "plain"])
def test_engine_counts_the_refills_it_runs(monkeypatch, plain):
    """``integrator/wavefront.py:REFILLS`` counts one refill per call of the
    refill on every pass, the count a caller holds N2a's launches to."""
    ran = []
    monkeypatch.setattr(RF, "refill_plain", lambda *a, f=RF.refill_plain: (ran.append(1), f(*a)))
    W.REFILLS[0] = 0
    r = Renderer(parse_text_scene(BOX_SCENE), device="cpu", engine="wavefront", batch_size=64,
                 plain=plain)
    r.render_radiance(seed=0, samples=2)
    assert len(ran) > 1 and W.REFILLS[0] == len(ran) and r.rounds > len(ran)


# --- on the card ---------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: N2a, N2b and K3 run only there")
    return torch.device("cuda", 0)


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _refill_on_card(rng, b, n_pix, samples, left, card):
    """A refill's buffers and arguments on the card: random lanes, about
    half dead, ``left`` work items of ``n_pix * samples`` not handed out."""
    total = n_pix * samples
    state = torch.from_numpy(_lane_state(rng, b)).to(card)
    work = _work(rng, (state[12] > 0.5).cpu().numpy(), total - left)
    bufs = [state, torch.from_numpy(work).to(card),
            torch.tensor(total - left, dtype=torch.int64, device=card),
            torch.zeros((3, total + b), device=card),
            torch.from_numpy(rng.integers(0, 6, b).astype(np.int32)).to(card),
            torch.zeros(b, dtype=torch.int32, device=card)]
    args = (torch.tensor([SEED32, 0], dtype=torch.int64, device=card),
            torch.tensor([PIX_BASE, SAMP_BASE], dtype=torch.int64, device=card),
            _frame(_cams()[1], n_pix, samples, card))
    return bufs, args


def _refill_equals_plain(bufs, args, scan) -> bool:
    """N2a on ``scan`` and the plain version on copies of ``bufs``: every
    output bit for bit (``done``'s columns of the work items)."""
    total = args[2].n_pix * args[2].samples
    kern, plain = [x.clone() for x in bufs], [x.clone() for x in bufs]
    RF.refill(*kern, *args, scan)
    RF.refill_plain(*plain, *args)
    torch.cuda.synchronize()
    kern[3], plain[3] = kern[3][:, :total], plain[3][:, :total]
    return all(_bit_equal(a, w) for a, w in zip(kern, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(REFILL_CASES))
def test_refill_kernel_equals_plain_on_the_card(card, case):
    """Three launches in a row on one scratch, each on a state of its own,
    each equal to the plain version; then the scratch's invariant: its
    ticket has counted every tile of the three launches, and every tile's
    status word holds the last launch's epoch (2) and an inclusive prefix,
    so the next launch needs no reset."""
    b, n_pix, samples, left = REFILL_CASES[case]
    b, n_pix, left = 33 * b, 40 * n_pix, 33 * left  # several tiles, the last one ragged
    rng = np.random.default_rng(5)
    scan = RF.refill_scan(b, card)
    for _ in range(3):
        assert _refill_equals_plain(*_refill_on_card(rng, b, n_pix, samples, left, card), scan)
    tiles = -(-b // RF.REFILL_TILE_LANES)
    words = scan[1:].cpu().numpy().view(np.uint64)
    assert int(scan[0]) == 3 * tiles and words.shape == (tiles,)
    assert ((words >> np.uint64(62)) == 2).all()
    assert ((words >> np.uint64(34)) & np.uint64((1 << 28) - 1) == 2).all()


@pytest.mark.cuda
def test_refill_kernel_over_many_tiles_on_the_card(card):
    """One launch over 4,097 tiles, the last one ragged: more tiles than a
    look-back step reads (128), with a counter that runs out midway."""
    b = 4096 * RF.REFILL_TILE_LANES + RF.REFILL_TILE_LANES // 3
    rng = np.random.default_rng(11)
    bufs, args = _refill_on_card(rng, b, b, 2, b // 3, card)
    scan = RF.refill_scan(b, card)
    assert scan.shape[0] == 1 + 4097
    assert _refill_equals_plain(bufs, args, scan)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_pix,samples", [(4096, 10_000, 3), (5000, 3000, 2),
                                             (1000, 7013, 16), (1 << 20, 921_600, 16)])
def test_restart_kernel_equals_plain_on_the_card(card, b, n_pix, samples):
    """N2b, which computes each lane's ``kmax`` from its index, against the
    plain version given the owned-pixel count: lanes owning several pixels,
    and lanes past the pixels (b > n_pix) owning none; the small states on
    its part-sector route, 1,048,576 lanes on its whole-sector one."""
    assert (b > kernels.launch_geometry()["restart_whole_above_lanes"]) == (b == 1 << 20)
    jmax = -(-n_pix // b)
    lane = torch.arange(b, device=card)
    kmax = sum((lane + j * b < n_pix).to(torch.int64) for j in range(jmax)) * samples
    rng = np.random.default_rng(9)
    state = torch.from_numpy(_lane_state(rng, b)).to(card)
    k = torch.from_numpy(rng.integers(0, kmax.cpu().numpy() + 1)).to(card)
    bufs = [state, k, kmax, torch.from_numpy(rng.integers(0, 6, b).astype(np.int32)).to(card),
            torch.zeros(b, dtype=torch.int32, device=card),
            torch.from_numpy(rng.uniform(0, 3, (3, jmax * b)).astype(np.float32)).to(card)]
    args = (torch.tensor([SEED32, 0], dtype=torch.int64, device=card),
            torch.tensor([PIX_BASE, SAMP_BASE], dtype=torch.int64, device=card),
            _frame(_cams()[1], n_pix, samples, card))
    kern, plain = [x.clone() for x in bufs], [x.clone() for x in bufs]
    RF.restart(*kern, *args)
    RF.restart_plain(*plain, *args)
    torch.cuda.synchronize()
    assert all(_bit_equal(a, w) for a, w in zip(kern, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lights", "cornell", "many_lights"])
def test_lane_mode_sampler_kernel_matches_plain_on_the_card(card, name):
    """K3 in lane mode against ``sampler_plain`` in the lane layout: ``ok``
    equal on >= 99.9 % of lanes, l and pdf within atol = rtol = 1e-4 on >=
    99.9 % of the lanes both accept (K3's gate; above it, 41 lights, the
    walk of the lights' tree against the plain (B, L) sweep)."""
    c = _case(name)
    depth = torch.from_numpy(_depths(len(c["wid"]))).to(card)
    wid = torch.from_numpy(c["wid"]).to(card)
    if name == "many_lights":
        _, _, ta, ts = _many_lights()
    else:
        _, (_, ta, ts) = builds(name)
    scene = modular_scene(ta, ts, card)
    ins = [x.to(card) if isinstance(x, torch.Tensor) else
           (type(x)(*(v.to(card) for v in x)) if isinstance(x, tuple) else x)
           for x in _port_args(c)]
    kl, kpdf, kok = sample_mixture_kernel(scene, SEED, wid, 0, trng.lane_ctr(0, K), *ins, depth)
    pl, ppdf, pok = sampler_plain(scene, SEED, wid, 0, trng.lane_ctr(depth, K), *ins)
    assert (kok == pok).float().mean().item() >= 0.999
    both = kok & pok
    for a, w in zip((*kl, kpdf), (*pl, ppdf)):
        close = (a[both] - w[both]).abs() <= 1e-4 + 1e-4 * w[both].abs()
        assert close.float().mean().item() >= 0.999
