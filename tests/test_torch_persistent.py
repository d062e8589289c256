"""PyTorch port, one round of the lane engines' bounce on the CPU: the plain
version of K5 (``ops/persistent.py``) and the fused core (K1 in lane mode,
``integrator/wavefront.py``) against the JAX package's stages on the same
counter draws: the sticky restart arithmetic, ``generate_rays_u`` and the
JAX ``_make_bounce_core`` core, which takes its XLA formulation on the CPU.

Tolerance, as for one bounce in test_torch_bounce.py: alive flags differ on
at most 0.1 % of lanes, and each row within atol = rtol = 1e-4 on >= 99.9 %
of lanes (rays and throughput on the lanes alive on both sides; a 1-ulp
difference can flip an accept or a Fresnel decision on a lane).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.integrator.path import TraceConfig as JTraceConfig
from raytracing_course_2024_tpu.integrator.wavefront import _make_bounce_core as j_core
from raytracing_course_2024_tpu.ops import rng as jrng
from raytracing_course_2024_tpu.ops.camera import camera_arrays as j_camera
from raytracing_course_2024_tpu.ops.camera import generate_rays_u as j_rays
from raytracing_course_2024_tpu.ops.sampling import sample_mixture as j_sample_mixture
from raytracing_course_2024_tpu.ops.vec import Vec3 as JV
from raytracing_course_2024_tpu_torch.integrator import path as P
from raytracing_course_2024_tpu_torch.integrator import wavefront as W
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops import rng as trng
from raytracing_course_2024_tpu_torch.ops.bounce import bounce_scene
from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays, pack_camera_row
from raytracing_course_2024_tpu_torch.ops.mixture import mixture_body
from raytracing_course_2024_tpu_torch.ops.loop import COUNTER, TAIL_FUSED, LoopState, round_tail
from raytracing_course_2024_tpu_torch.ops.persistent import ids, persistent_plain, persistent_round
from test_torch_bounce import _assert_states_agree
from test_torch_sampling import GGX_TOL, PDF_FRAC, _mixture_case, close, jv, tv
from torch_parity import builds, to_jnp

SEED32 = 0x5EED1234
K = 4
KMAX = 4
SIZES = {"mixed": (48, 32), "cornell": (48, 27)}
PIX_BASE, SAMP_BASE = 7, 3
LANE_FRAC = 0.999


def _case(name):
    """Both builds plus an 18-row sticky state of every kind of lane: dead
    lanes that flush and restart (0 < k < kmax), finished lanes (k = kmax),
    fresh lanes (k = 0), and live lanes at every depth including the last,
    on jittered camera rays of their pixel."""
    w, h = SIZES[name]
    (jd, ja, js), (td, ta, ts) = builds(name, w, h, KMAX)
    depth_n = td.settings.ray_depth
    b = w * h - PIX_BASE
    lane = np.arange(b)
    pix = PIX_BASE + lane
    rng = np.random.default_rng(11)
    key = jrng.work_key(jnp.uint32(SEED32), jnp.asarray(pix + 90_000, jnp.int32))
    ro, rd = j_rays(j_camera(jd.settings.camera), jnp.asarray(pix % w), jnp.asarray(pix // w),
                    w, h, jrng.uniform_ctr(key, 0), jrng.uniform_ctr(key, 1))
    kind = lane % 6
    alive = kind >= 3
    k = np.where(kind == 0, rng.integers(1, KMAX, b),
                 np.where(kind == 1, KMAX, np.where(kind == 2, 0, rng.integers(1, KMAX + 1, b))))
    depth = np.where(alive, lane % depth_n, rng.integers(0, 9, b))
    rows = [*map(np.asarray, ro), *map(np.asarray, rd),
            *rng.uniform(0.5, 1.0, (3, b)), *rng.uniform(0.0, 0.3, (3, b)),
            alive, k, depth, *rng.uniform(0.0, 2.0, (3, b))]
    state = np.stack(rows).astype(np.float32)
    return dict(jd=jd, ja=ja, js=js, td=td, ta=ta, ts=ts, w=w, h=h, b=b, pix=pix,
                state=state, bg=tuple(jd.settings.bg_color), depth_n=depth_n)


def _jax_round(c):
    """The reference round: the restart arithmetic of render_wavefront_sticky
    (jmax = 1), generate_rays_u, the JAX core, then the counts."""
    s = c["state"]
    w, h = c["w"], c["h"]
    alive, k, depth = s[12] > 0.5, s[13].copy(), s[14].copy()
    rad, acc, thr = s[9:12].copy(), s[15:18].copy(), s[6:9].copy()
    dead = ~alive
    acc = np.where(dead & (k > 0.5), acc + rad, acc)
    rad = np.where(dead, 0.0, rad).astype(np.float32)
    take = dead & (k < KMAX)
    k = np.where(take, k + 1, k)
    depth = np.where(take, 0, depth)
    thr = np.where(take, 1.0, thr).astype(np.float32)
    pix = c["pix"]
    wid = (SAMP_BASE + np.maximum(k - 1, 0)).astype(np.int64) * (w * h) + pix
    keyl = jrng.work_key(jnp.uint32(SEED32), jnp.asarray(wid.astype(np.int32)))
    ro_n, rd_n = j_rays(j_camera(c["jd"].settings.camera), jnp.asarray(pix % w),
                        jnp.asarray(pix // w), w, h, jrng.uniform_ctr(keyl, 0),
                        jrng.uniform_ctr(keyl, 1))
    ro = np.where(take, np.stack([np.asarray(x) for x in ro_n]), s[0:3])
    rd = np.where(take, np.stack([np.asarray(x) for x in rd_n]), s[3:6])
    alive = alive | take
    cfg = JTraceConfig(ray_depth=c["depth_n"], bg_color=c["bg"], max_tries=K)
    arrays = to_jnp(c["ja"])._replace(tri_pack=None)  # the XLA sweep: same hit, fast
    core, fused = j_core(cfg, arrays, c["js"])
    assert not fused  # off the TPU the JAX engines take their XLA core
    ro2, rd2, thr2, rad2, cont = core(
        keyl, jnp.asarray(depth.astype(np.int32)), JV(*map(jnp.asarray, ro)),
        JV(*map(jnp.asarray, rd)), JV(*map(jnp.asarray, thr)), JV(*map(jnp.asarray, rad)),
        jnp.asarray(alive))
    cont = np.asarray(cont)
    out = np.stack([np.asarray(x, np.float32) for v in (ro2, rd2, thr2, rad2) for x in v]
                   + [cont.astype(np.float32), k, depth + 1, *acc]).astype(np.float32)
    return out, int(alive.sum()), int((cont | (k < KMAX)).sum())


def _port_args(c):
    cam = torch.from_numpy(pack_camera_row(camera_arrays(c["td"].settings.camera))[0])
    pix = torch.from_numpy(c["pix"])
    return (bounce_scene(c["ta"], c["ts"], "cpu"), cam, (pix % c["w"]).float(),
            (pix // c["w"]).float(), torch.full((c["b"],), float(KMAX)),
            torch.from_numpy(c["state"]))


@pytest.mark.parametrize("name", ["mixed", "cornell"])
def test_persistent_plain_round_matches_jax_stages(name):
    c = _case(name)
    want, want_live, want_more = _jax_round(c)
    got, live, more = persistent_plain(*_port_args(c), SEED32, c["w"] * c["h"], PIX_BASE,
                                       SAMP_BASE, c["bg"], K, c["depth_n"], c["w"], c["h"])
    got = got.numpy()
    _assert_states_agree(got[:13], want[:13], live_min=0.1)
    np.testing.assert_array_equal(got[13:15], want[13:15])  # k, depth + 1
    for r in range(15, 18):  # the accumulators: flushed radiance only
        np.testing.assert_allclose(got[r], want[r], rtol=1e-6, atol=1e-7)
    assert int(live) == want_live
    assert abs(int(more) - want_more) <= (1.0 - LANE_FRAC) * c["b"]
    # every kind of lane is there: restarts, finished lanes, capped lanes
    s = c["state"]
    assert ((s[12] < 0.5) & (s[13] == KMAX)).any() and ((s[12] < 0.5) & (s[13] == 0)).any()
    assert ((s[12] > 0.5) & (s[14] == c["depth_n"] - 1)).any()
    assert 0 < want_more < c["b"]


def test_persistent_round_cpu_wrapper_runs_plain_and_counts_nothing():
    c = _case("mixed")
    args = (SEED32, c["w"] * c["h"], PIX_BASE, SAMP_BASE, c["bg"], K, c["depth_n"], c["w"],
            c["h"])
    want, live, more = persistent_plain(*_port_args(c), *args)
    kernels.reset_launches()
    ls = LoopState("cpu")
    scene, cam, px, py, kmax, state = _port_args(c)
    k5 = (ids(SEED32, PIX_BASE, SAMP_BASE, "cpu"), *args[1:2], *args[4:])
    persistent_round(scene, cam, px, py, kmax, state, ls, *k5, out=state)
    assert torch.equal(state, want)
    # the round's counts end the round as its loop test: lanes with work
    # left, another round, the lanes alive after the restart as path vertices
    assert ls.loop.tolist() == [int(more), 1, 0, int(live), 1, 0]
    assert ls.preds.tolist() == [True, False]
    assert not any(kernels.LAUNCHES.values())
    with pytest.raises(ValueError):
        persistent_round(scene, cam, px, py, kmax, state.to("meta"), ls, *k5)


@pytest.mark.parametrize("name", ["mixed", "cornell"])
def test_fused_core_lane_mode_matches_jax_core(name):
    """K1 in lane mode (plain) + the round's tail (the depth cap and park,
    ``ops/loop.py:round_tail`` with ``TAIL_FUSED``, its plain version here)
    against the JAX core on the same keys and per-lane depths."""
    c = _case(name)
    s = c["state"][:13].copy()
    depth = c["state"][14].astype(np.int32) % c["depth_n"]
    wid = (c["pix"] * 5 + 321).astype(np.int32)
    cfg = JTraceConfig(ray_depth=c["depth_n"], bg_color=c["bg"], max_tries=K)
    core, _ = j_core(cfg, to_jnp(c["ja"])._replace(tri_pack=None), c["js"])
    keyl = jrng.work_key(jnp.uint32(SEED32), jnp.asarray(wid))
    jout = core(keyl, jnp.asarray(depth), *(JV(*map(jnp.asarray, s[i:i + 3]))
                                           for i in (0, 3, 6, 9)), jnp.asarray(s[12] > 0.5))
    want = np.stack([np.asarray(x, np.float32) for v in jout[:4] for x in v]
                    + [np.asarray(jout[4], np.float32)])

    tcfg = P.TraceConfig(ray_depth=c["depth_n"], bg_color=c["bg"], max_tries=K)
    tcore, fused = W._make_bounce_core(tcfg, bounce_scene(c["ta"], c["ts"], "cpu"), SEED32)
    assert fused
    got = tcore(torch.from_numpy(s), torch.from_numpy(wid), torch.from_numpy(depth))
    ls, tdepth = LoopState("cpu"), torch.from_numpy(depth.copy())
    round_tail(ls, COUNTER, got, tdepth, TAIL_FUSED, c["depth_n"] - 1,
               counter=torch.tensor(0), total=1)
    assert torch.equal(tdepth, torch.from_numpy(depth) + 1)
    got = got.numpy()
    _assert_states_agree(got, want, live_min=0.1)
    dead = (got[12] < 0.5) & (want[12] < 0.5)  # parked alike on both sides
    np.testing.assert_array_equal(got[0:6][:, dead], want[0:6][:, dead])
    assert (got[12][depth == c["depth_n"] - 1] == 0).all()  # the depth cap


@pytest.mark.parametrize("depth", [0, 3])
def test_mixture_body_lane_layout_matches_jax_rows(depth):
    """The kernels' sampler stage at the lane engines' counters (row r of
    candidate t at 2 + 64 d + r K + t, per-lane d) against JAX sample_mixture
    fed the engine's candidate-major rows (wavefront.py:167-173), with
    test_torch_sampling.py's tolerances."""
    ja, js, ta, ts, n, ns, v, rough, point = _mixture_case("mixed", 41)
    b = n.shape[1]
    d = (depth + np.arange(b) % 2).astype(np.int32)
    wid = np.arange(b, dtype=np.int32) * 3 + 11
    jkey = jrng.work_key(jnp.uint32(SEED32), jnp.asarray(wid))
    base = 2 + 64 * jnp.asarray(d)
    rows = [jnp.concatenate([jrng.uniform_ctr(jkey, base + r * K + t) for t in range(K)])
            for r in range(7)]
    jl, jpdf, jok = j_sample_mixture(None, jv(point), jv(n), jv(ns), jv(v),
                                     jnp.asarray(rough), to_jnp(ja), js,
                                     need=jnp.ones((b,), bool), max_tries=K, uniforms=rows)
    tkey = trng.work_key(SEED32, torch.from_numpy(wid))
    ctr = trng.lane_ctr(torch.from_numpy(d), K)
    for r, row in enumerate(trng.mixture_rows(tkey, ctr, K)):  # the XLA core's rows
        np.testing.assert_array_equal(row.numpy(), np.asarray(rows[r]))
    tl, tpdf, tok = mixture_body(lambda cc: trng.uniform_ctr(tkey, cc), ctr, tv(point),
                                 tv(n), tv(ns), tv(v), torch.from_numpy(rough),
                                 ta.light_packed, ts, K)
    ok = np.asarray(jok)
    assert np.array_equal(tok.numpy(), ok) and ok.mean() > 0.9
    close(tuple(c.numpy()[ok] for c in tl), tuple(np.asarray(c)[ok] for c in jl))
    close(tpdf.numpy()[ok], np.asarray(jpdf)[ok], frac=PDF_FRAC, **GGX_TOL)


def test_lane_layout_fits_its_block():
    ctr = trng.lane_ctr(torch.tensor([0, 2]), 8)
    assert ctr.base.tolist() == [2, 130] and (ctr.cand, ctr.row, ctr.diel, ctr.rr) == (1, 8, 63, 62)
    used = {ctr.mix(t, r) for t in range(8) for r in range(7)}
    assert max(int(u.max()) for u in used) - 130 < 62  # below the roulette draw
    with pytest.raises(ValueError):
        trng.lane_ctr(0, 9)  # 7 x 9 = 63 draws overflow the block of 62
