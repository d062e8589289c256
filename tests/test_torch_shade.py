"""PyTorch port, the modular bounce's shade and finish passes (``ops/shade.py``:
the CUDA kernels N1a and N1b and their plain versions), on the CPU, where
the wrappers run the plain versions.

The same numpy-seeded state (camera rays and random rays from inside the
scene's bounds, so that back faces and the insides of dielectrics are hit;
throughput in [0.5, 1], radiance in [0, 0.2], every third lane dead), the
same nearest hit over the finite table (the JAX package's XLA sweep with the
planes left out) and the same counter draws go through:

* ``shade`` against the JAX package's ``_collect_hit`` (``_nearest``, i.e.
  the sweep and ``_fold_in_planes``, ``surface_detail``, the emission /
  background accumulation): radiance on every lane, alive, the surface rows
  and the sampler's ``need`` on the lanes alive on both sides;
* ``finish`` against JAX ``_finish_bounce``, fed the JAX sampler's (l, pdf,
  ok) on the same draws: roulette off, on below and at ``RR_START``,
  faithful acceptance; the final level (emission only);
* the lane layout with mixed per-lane depths: ``shade`` (final-depth rule),
  the XLA sampler and ``finish`` (lane counters, ``park``) against the JAX
  package's lane core (``integrator/wavefront.py:_make_bounce_core``).

Scenes: MIXED (planes, rotated boxes, an ellipsoid, MIRROR and
DIELECTRIC), LIGHTS (rotated box, ellipsoid and triangle lights), an
80-triangle icosphere with smooth vertex normals and the Cornell glTF.
Tolerance: test_torch_bounce.py's (alive masks differ on at most 0.1 % of
lanes; each row within atol = rtol = 1e-4 on >= 99.9 % of the lanes alive
on both sides; the radiance on every lane). On a card (marked ``cuda``; skipped here) each kernel is held against
its plain version at the same tolerance.

``shade(count=)`` adds the lanes alive on entry to an int64 counter and
changes no output: on the CPU through the plain version; on a card N1a's
count against the alive row's sum on the modular route's camera, bounce-1
and bounce-3 states and on sparse and dead-warp states, its outputs bit for
bit against a launch without a counter, and a graphed modular sample under
``torch.profiler``: no ATen reduction, its path vertices and radiance those
of the route before N1a counted (per-level sums of the alive mask) through
the same kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracing_course_2024_tpu.scene as jscene
import raytracing_course_2024_tpu_torch.scene as tscene

from raytracing_course_2024_tpu.integrator import wavefront as jwf
from raytracing_course_2024_tpu.integrator.path import (
    RR_START,
    TraceConfig as JTraceConfig,
    _collect_hit as j_collect,
    _finish_bounce as j_finish,
    _PathState,
)
from raytracing_course_2024_tpu.ops import rng as jrng
from raytracing_course_2024_tpu.ops.camera import camera_arrays as j_camera
from raytracing_course_2024_tpu.ops.camera import generate_rays_u as j_rays
from raytracing_course_2024_tpu.ops.sampling import sample_mixture as j_sample
from raytracing_course_2024_tpu.ops.scene_intersect import nearest_hit_dense
from raytracing_course_2024_tpu.ops.vec import Vec3 as JV
from raytracing_course_2024_tpu.scene.types import DIELECTRIC, MIRROR
from raytracing_course_2024_tpu_torch.integrator import path as P
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops import rng as trng
from raytracing_course_2024_tpu_torch.ops import shade as SH
from raytracing_course_2024_tpu_torch.ops.sampling import sample_mixture as t_sample
from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
from raytracing_course_2024_tpu_torch.ops.vec import Vec3 as TV
from raytracing_course_2024_tpu_torch.scene.types import PrimCol as PC
from meshes import icosphere, mesh_scene_desc
from test_torch_bounce import ATOL, LANE_FRAC, RTOL, _assert_states_agree
from test_torch_modular import route_before
from torch_parity import builds, random_unit, to_jnp

SEED = 1234
K = 4
DEPTH = 4  # ray_depth of every case: the lane layout's last depth is 3
SIZES = {"mixed": (32, 24), "lights": (32, 24), "mesh": (24, 16), "cornell": (32, 18)}
SCENE_NAMES = list(SIZES)
# the surface values compared, by their place in ``Surf.columns()`` (the
# rows, then the record's fields), and the JAX Surface field of each
_REC = SH.SURF_ROWS
SURF_FIELDS = (("point", SH.SF_POINT, 3), ("n_geom", SH.SF_NGEOM, 3),
               ("n_shade", SH.SF_NSHADE, 3), ("roughness", SH.SF_ROUGH, 1),
               ("color", _REC + SH.SR_COLOR, 3), ("metallic", _REC + SH.SR_METAL, 1),
               ("ior", _REC + SH.SR_IOR, 1), ("mkind", _REC + SH.SR_MKIND, 1),
               ("is_outer", _REC + SH.SR_OUTER, 1), ("t", _REC + SH.SR_T, 1))


def _bounds(ta) -> tuple:
    """(lo, hi) of the finite primitives' vertices and positions."""
    g = ta.packed
    pts = [g[PC.POS:PC.POS + 3]]
    tri = g[PC.PTYPE] == 0
    for r in (PC.P0, PC.P1, PC.P2):
        pts.append(g[r:r + 3][:, tri])
    pts = np.concatenate(pts, axis=1)
    return pts.min(axis=1), pts.max(axis=1)


def _builds(name, w, h):
    """``torch_parity.builds``; the mesh with smooth vertex normals (the
    fixture's flat mesh has zero shading normals, on which the sampler
    accepts nothing)."""
    if name != "mesh":
        return builds(name, w, h, 2)
    verts, faces = icosphere(1)
    d = mesh_scene_desc(verts, faces, verts / np.linalg.norm(verts, axis=1, keepdims=True),
                        width=w, height=h, samples=2)
    ja, js = jscene.build_scene_arrays(d)
    ta, ts = tscene.build_scene_arrays(d)
    return (d, ja, js), (d, ta, ts)


def _case(name):
    """Both builds and a numpy-seeded state: the first half of the lanes on
    the camera's jittered rays, the second on random rays from inside the
    scene's bounds."""
    w, h = SIZES[name]
    (jd, ja, js), (td, ta, ts) = _builds(name, w, h)
    n = w * h
    b = 2 * n
    idx = np.arange(b, dtype=np.int32)
    key = jrng.work_key(jnp.uint32(SEED), jnp.asarray(idx[:n]))
    ro, rd = j_rays(j_camera(jd.settings.camera), jnp.asarray(idx[:n] % w),
                    jnp.asarray(idx[:n] // w), w, h, jrng.uniform_ctr(key, 0),
                    jrng.uniform_ctr(key, 1))
    g = np.random.default_rng(7)
    lo, hi = _bounds(ta)
    ro2 = g.uniform(lo, hi, (n, 3)).T.astype(np.float32)
    rd2 = random_unit(g, n)
    rows = np.concatenate([
        np.concatenate([np.stack([np.asarray(c) for c in ro]), ro2], axis=1),
        np.concatenate([np.stack([np.asarray(c) for c in rd]), rd2], axis=1),
        g.uniform(0.5, 1.0, (3, b)), g.uniform(0.0, 0.2, (3, b)),
        ((idx % 3) != 0)[None].astype(np.float32)]).astype(np.float32)
    return dict(jd=jd, ja=ja, js=js, ta=ta, ts=ts, b=b, idx=idx, rows=rows,
                bg=tuple(jd.settings.bg_color), scene=modular_scene(ta, ts, "cpu"))


def _jstate(rows):
    r = [jnp.asarray(x) for x in rows]
    return _PathState(JV(*r[0:3]), JV(*r[3:6]), JV(*r[6:9]), JV(*r[9:12]), r[12] > 0.5)


def _jarrays(c):
    """The JAX scene on its XLA sweep: the same nearest hit as the
    interpret-mode triangle kernel, far less CPU time."""
    return to_jnp(c["ja"])._replace(tri_pack=None)


def _table_hit(c):
    """The nearest hit over the finite table, planes left out: (t, idx) as
    the port's ``nearest_table`` hands them to ``shade``."""
    st = _jstate(c["rows"])
    hit = nearest_hit_dense(st.ro, st.rd, _jarrays(c), c["js"]._replace(num_planes=0))
    return (torch.from_numpy(np.array(hit.t, np.float32)),
            torch.from_numpy(np.array(hit.idx, np.int32)))


def _np(x):
    return np.array(x, np.float32)


def _rows(out):
    """A JAX _PathState as (13, B) rows."""
    return np.stack([_np(x) for v in out[:4] for x in v] + [_np(out[4])])


def _close_share(got, want):
    return float((np.abs(got - want) <= ATOL + RTOL * np.abs(want)).mean())


def _assert_surface_agrees(c, state, surf, need, jst2, jsurf):
    """``shade``'s outputs against JAX ``_collect_hit``'s."""
    got = state.numpy()
    want = _rows(jst2)
    _assert_states_agree(got, want, live_min=0.1)
    both = (got[12] > 0.5) & (want[12] > 0.5)
    s = np.stack([x.numpy() for x in surf.columns()])
    for field, row, width in SURF_FIELDS:
        jv = getattr(jsurf, field)
        comps = list(jv) if width == 3 else [jv]
        for k, comp in enumerate(comps):
            share = _close_share(s[row + k][both], _np(comp)[both])
            assert share >= LANE_FRAC, (field, k, share)
    v = -np.asarray(c["rows"][3:6])
    for k in range(3):
        assert _close_share(s[SH.SF_V + k][both], v[k][both]) == 1.0
    jdelta = (_np(jsurf.mkind) == MIRROR) | (_np(jsurf.mkind) == DIELECTRIC)
    assert (need.numpy() != (want[12] > 0.5) & ~jdelta).mean() <= 1.0 - LANE_FRAC


def _jax_sampler(c, jst2, jsurf, base, need, faithful):
    """(key, JAX ``sample_mixture`` on the batch layout's draws at ``base``)."""
    key = jrng.work_key(jnp.uint32(SEED), jnp.asarray(c["idx"]))
    rows = [jnp.concatenate([jrng.uniform_ctr(key, base + trng.ctr_mix(t, r)) for t in range(K)])
            for r in range(7)]
    return key, j_sample(None, jsurf.point, jsurf.n_geom, jsurf.n_shade, -jst2.rd,
                         jsurf.roughness, _jarrays(c), c["js"], need=need, max_tries=K,
                         faithful=faithful, uniforms=rows)


MODES = {  # name -> (roulette, faithful, bounce_i)
    "plain": (False, False, 1),
    "roulette-below-start": (True, False, RR_START - 1),
    "roulette-at-start": (True, False, RR_START),
    "faithful": (False, True, 1),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", SCENE_NAMES)
def test_shade_and_finish_match_jax_stages(name, mode):
    rr, faithful, bounce_i = MODES[mode]
    c = _case(name)
    jcfg = JTraceConfig(ray_depth=DEPTH, bg_color=c["bg"], max_tries=K, rr=rr,
                        faithful=faithful)
    jst2, jsurf, _ = j_collect(_jstate(c["rows"]), _jarrays(c), c["js"], jcfg)
    t, idx = _table_hit(c)
    state, surf, need = SH.shade(torch.from_numpy(c["rows"]), t, idx, c["scene"], c["bg"])
    _assert_surface_agrees(c, state, surf, need, jst2, jsurf)
    # the layout N1a writes and N1b reads: K3's inputs as rows, the rest one
    # row-major 32-byte record per lane, read back by surface_of
    b = c["b"]
    assert surf.rows.shape == (SH.SURF_ROWS, b) and surf.rec.shape == (b, SH.SURF_REC)
    assert surf.rows.is_contiguous() and surf.rec.is_contiguous()
    back = SH.surface_of(surf)
    both = (state[12] > 0.5).numpy() & np.asarray(jst2.alive)
    for field in ("color", "metallic", "ior", "mkind", "t"):
        got_f, want_f = getattr(back, field), getattr(jsurf, field)
        for g, w in zip(*((got_f, want_f) if field == "color" else ([got_f], [want_f]))):
            assert _close_share(g.numpy()[both], _np(w)[both]) >= LANE_FRAC, field
    assert (back.is_outer.numpy()[both] == np.asarray(jsurf.is_outer)[both]).mean() >= LANE_FRAC

    # finish, fed the JAX sampler's output on the bounce's counter draws
    base = bounce_i * trng.draws_per_bounce(K)
    jdelta = (jsurf.mkind == MIRROR) | (jsurf.mkind == DIELECTRIC)
    key, (l, pdf, ok) = _jax_sampler(c, jst2, jsurf, base, jst2.alive & ~jdelta, faithful)
    kw = {}
    if rr:
        kw = dict(u_rr=jrng.uniform_ctr(key, base + trng.ctr_rr(K)),
                  rr_mask=jnp.full((c["b"],), bounce_i >= RR_START))
    want = _rows(j_finish(jst2, jsurf, l, pdf, ok, jrng.uniform_ctr(key, base + trng.ctr_diel(K)),
                          jcfg, **kw))
    cfg = P.TraceConfig(ray_depth=DEPTH, bg_color=c["bg"], max_tries=K, rr=rr, faithful=faithful)
    wid = torch.from_numpy(c["idx"])
    got, live = SH.finish(state, surf, TV(*(torch.from_numpy(_np(x)) for x in l)),
                          torch.from_numpy(_np(pdf)), torch.from_numpy(np.array(ok)), wid,
                          SEED, 0, cfg, bounce_i)
    _assert_states_agree(got.numpy(), want, live_min=0.05)
    assert torch.equal(live, got[12] > 0.5)
    if rr and bounce_i >= RR_START:  # roulette killed some lanes and boosted others
        assert (want[12] > 0.5).sum() < (_rows(jst2)[12] > 0.5).sum()
        assert (got[6:9][:, live] > 1.0).any()


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_final_shade_collects_emission_only(name):
    """The batch scan's last level: radiance and alive as JAX _collect_hit
    leaves them; no surface rows."""
    c = _case(name)
    jcfg = JTraceConfig(ray_depth=DEPTH, bg_color=c["bg"], max_tries=K)
    jst2, _, _ = j_collect(_jstate(c["rows"]), _jarrays(c), c["js"], jcfg)
    t, idx = _table_hit(c)
    state, surf, need = SH.shade(torch.from_numpy(c["rows"]), t, idx, c["scene"], c["bg"],
                                 final=True)
    assert surf is None and need is None
    want = _rows(jst2)
    got = state.numpy()
    assert np.array_equal(got[12], want[12])
    assert _close_share(got[9:12], want[9:12]) == 1.0
    assert np.array_equal(got[0:9], c["rows"][0:9])  # the ray and throughput stay


@pytest.mark.parametrize("rr", [False, True], ids=["no-roulette", "roulette"])
@pytest.mark.parametrize("name", SCENE_NAMES)
def test_lane_layout_matches_jax_lane_core(name, rr):
    """Per-lane depths 0..3 at ray_depth 4: a lane at depth 3 dies after
    collecting emission, roulette rolls from depth 2; dead lanes parked."""
    c = _case(name)
    b = c["b"]
    depth = (np.arange(b) * 7 // 3 % DEPTH).astype(np.int32)
    jcfg = JTraceConfig(ray_depth=DEPTH, bg_color=c["bg"], max_tries=K, rr=rr)
    core, fused = jwf._make_bounce_core(jcfg, _jarrays(c), c["js"])
    assert not fused
    st = _jstate(c["rows"])
    key = jrng.work_key(jnp.uint32(SEED), jnp.asarray(c["idx"]))
    want = _rows(core(key, jnp.asarray(depth), st.ro, st.rd, st.throughput, st.radiance,
                      st.alive))

    cfg = P.TraceConfig(ray_depth=DEPTH, bg_color=c["bg"], max_tries=K, rr=rr)
    t, idx = _table_hit(c)
    tdepth = torch.from_numpy(depth)
    wid = torch.from_numpy(c["idx"])
    state, surf, need = SH.shade(torch.from_numpy(c["rows"]), t, idx, c["scene"], c["bg"],
                                 depth=tdepth, last=DEPTH - 1)
    l, pdf, ok = t_sample(trng.mixture_rows(trng.work_key(SEED, wid), trng.lane_ctr(tdepth, K),
                                            K), *SH.sampler_inputs(surf), c["scene"].lp_np,
                          c["ts"], K, need=need)
    got, live = SH.finish(state, surf, l, pdf, ok, wid, SEED, 0, cfg, depth=tdepth)
    got = got.numpy()
    _assert_states_agree(got, want, live_min=0.05)
    dead = got[12] < 0.5
    assert (got[0:3][:, dead] == np.float32(SH.PARK_ORIGIN)).all()
    assert (got[3:6][:, dead] == np.float32(SH.PARK_DIR)).all()
    assert not live[tdepth == DEPTH - 1].any()


def test_wrappers_on_the_cpu_count_nothing_and_refuse_other_devices():
    c = _case("mixed")
    kernels.reset_launches()
    t, idx = _table_hit(c)
    st = torch.from_numpy(c["rows"])
    out = SH.shade(st, t, idx, c["scene"], c["bg"])
    plain = SH.shade_plain(st, t, idx, c["scene"], c["bg"])
    assert torch.equal(out[0], plain[0]) and torch.equal(out[2], plain[2])
    assert not torch.equal(out[0], st) and out[1].rows.shape == (SH.SURF_ROWS, c["b"])
    assert all(torch.equal(a, b) for a, b in zip(out[1], plain[1]))
    assert kernels.LAUNCHES["shade"] == kernels.LAUNCHES["finish"] == 0
    with pytest.raises(ValueError, match="no shade kernel"):
        SH.shade(st.to("meta"), t, idx, c["scene"], c["bg"])
    cfg = P.TraceConfig(ray_depth=DEPTH, bg_color=c["bg"], max_tries=K)
    l = TV(*(torch.zeros(c["b"]) for _ in range(3)))
    with pytest.raises(ValueError, match="no finish kernel"):
        SH.finish(st.to("meta"), out[1], l, l.x, out[2], torch.from_numpy(c["idx"]), SEED, 0,
                  cfg)


@pytest.mark.parametrize("layout", ["batch", "lane", "final"])
def test_shade_count_adds_the_lanes_alive_on_entry(layout):
    """``shade(count=)`` on the CPU adds the alive row's sum to what the
    counter held and leaves every output as a call without one gives it."""
    c = _case("mixed")
    t, idx = _table_hit(c)
    rows = torch.from_numpy(c["rows"])
    depth = torch.from_numpy((np.arange(c["b"]) % DEPTH).astype(np.int32))
    kw = dict(depth=depth, last=DEPTH - 1) if layout == "lane" else dict(final=layout == "final")
    count = torch.full((), 5, dtype=torch.int64)
    got = SH.shade(rows.clone(), t, idx, c["scene"], c["bg"], count=count, **kw)
    want = SH.shade(rows.clone(), t, idx, c["scene"], c["bg"], **kw)
    assert count.dtype == torch.int64 and int(count) == 5 + int((rows[12] > 0.5).sum())
    assert torch.equal(got[0], want[0])
    if layout == "final":
        assert got[1:] == want[1:] == (None, None)
        return
    assert torch.equal(got[2], want[2])
    for a, w in zip(got[1].columns(), want[1].columns()):
        assert torch.equal(a, w)


@pytest.mark.parametrize("name", ["bvh-mesh", "mixed", "mixed-bvh"])
def test_prim_records_hold_the_packed_columns(name):
    """``ModularScene.prim_rec``, N1a's row-major winner records, holds
    exactly ``packed``'s columns in ``PREC_COLS``' order, zeros in the
    padding, 160 bytes a primitive: on the 5,120-triangle mesh (the BVH
    backend's reordered table) and on MIXED (rotated boxes, an ellipsoid,
    planes) on the dense and the BVH backend."""
    from meshes import displaced_organic_mesh
    from raytracing_course_2024_tpu_torch.ops.scene_intersect import PREC_COLS, PREC_WIDTH
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    if name == "mixed":  # the modular route's dense scene
        _, ta, ts = builds("mixed", 8, 6, 1)[1]
        scene = modular_scene(ta, ts, "cpu")
    else:
        if name == "bvh-mesh":
            v, f, vn = displaced_organic_mesh(subdiv=4)
            r = Renderer(mesh_scene_desc(v, f, vn, width=8, height=6, samples=1), device="cpu")
        else:
            r = Renderer(builds("mixed", 8, 6, 1)[1][0], device="cpu", backend="bvh")
        assert r.backend == "bvh"
        scene = r.scene
    packed, rec = scene.packed.numpy(), scene.prim_rec.numpy()
    n = packed.shape[1]
    assert rec.shape == (n, PREC_WIDTH) and rec.dtype == np.float32 and rec.nbytes == 160 * n
    assert scene.prim_rec.is_contiguous()
    assert sorted(c for c in PREC_COLS if c >= 0) == list(range(PC.COUNT))
    for k, col in enumerate(PREC_COLS):
        want = packed[col] if col >= 0 else np.zeros(n, np.float32)
        assert np.array_equal(rec[:, k].view(np.int32), want.view(np.int32)), (k, col)
    # what a triangle lane reads is the first 128 bytes: type, vertices,
    # shading normals, the material
    line = {PREC_COLS[k] for k in range(32)}
    assert set(range(PC.PTYPE, PC.POS)) | set(range(PC.COLOR, PC.COUNT)) <= line
    if name != "bvh-mesh":
        kinds = set(packed[PC.PTYPE].tolist())
        assert {1.0, 2.0} <= kinds and scene.statics.num_planes > 0
        assert scene.statics.any_rotation


# --- on the card -----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: N1a and N1b run only there")
    return torch.device("cuda", 0)


def _on(x, dev):
    if isinstance(x, TV):
        return TV(*(c.to(dev) for c in x))
    return x.to(dev) if isinstance(x, torch.Tensor) else x


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["batch-roulette", "batch-faithful", "lane", "final"])
@pytest.mark.parametrize("name", ["mixed", "cornell"])
def test_kernels_match_plain_versions_on_the_card(card, name, layout):
    """N1a and N1b against their plain versions on the same inputs, on the
    card: radiance and alive everywhere, the other rows on the lanes alive
    on both sides (atol = rtol = 1e-4 on >= 99.9 %), ``need`` and ``live``
    equal on >= 99.9 % of the lanes."""
    c = _case(name)
    scene = modular_scene(c["ta"], c["ts"], card)
    t, idx = (x.to(card) for x in _table_hit(c))
    rows = torch.from_numpy(c["rows"]).to(card)
    b = c["b"]
    depth = torch.from_numpy((np.arange(b) % DEPTH).astype(np.int32)).to(card)
    lane = layout == "lane"
    kw = dict(depth=depth, last=DEPTH - 1) if lane else dict(final=layout == "final")
    ks, ksurf, kneed = SH.shade(rows.clone(), t, idx, scene, c["bg"], **kw)
    ps, psurf, pneed = SH.shade_plain(rows.clone(), t, idx, scene, c["bg"], **kw)
    _assert_states_agree(ks.cpu().numpy(), ps.cpu().numpy(), live_min=0.05)
    if layout == "final":
        return
    both = (ks[12] > 0.5) & (ps[12] > 0.5)
    for r, (a, w) in enumerate(zip(ksurf.columns(), psurf.columns())):
        assert _close_share(a[both].cpu().numpy(), w[both].cpu().numpy()) >= LANE_FRAC, r
    assert (kneed != pneed).float().mean().item() <= 1.0 - LANE_FRAC
    cfg = P.TraceConfig(ray_depth=DEPTH, bg_color=c["bg"], max_tries=K,
                        rr=layout != "batch-faithful", faithful=layout == "batch-faithful")
    wid = torch.from_numpy(c["idx"]).to(card)
    args = (scene, SEED, wid, 0, trng.batch_ctr(RR_START * trng.draws_per_bounce(K), K),
            *SH.sampler_inputs(psurf), pneed, K)
    from raytracing_course_2024_tpu_torch.ops.sampler import sampler_plain

    l, pdf, ok = sampler_plain(*args, faithful=cfg.faithful)
    fkw = dict(depth=depth) if lane else dict(bounce_i=RR_START)
    kf, klive = SH.finish(ps.clone(), psurf, l, pdf, ok, wid, SEED, 0, cfg, **fkw)
    pf, plive = SH.finish_plain(ps.clone(), psurf, l, pdf, ok, wid, SEED, 0, cfg, **fkw)
    _assert_states_agree(kf.cpu().numpy(), pf.cpu().numpy(), live_min=0.05)
    assert (klive != plive).float().mean().item() <= 1.0 - LANE_FRAC


def _modular_renderer(scene_name, card):
    """A Renderer on the modular batch route: a 5,120-triangle mesh on the
    BVH backend, or a scene of ``builds`` (``cornell-rr``, ``mixed-rr``)
    with roulette, 64 x 36 or 64 x 48 pixels at 2 spp."""
    from meshes import displaced_organic_mesh
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    if scene_name == "bvh-mesh":
        v, f, vn = displaced_organic_mesh(subdiv=4)
        r = Renderer(mesh_scene_desc(v, f, vn, width=64, height=48, samples=2), device=card)
        assert r.backend == "bvh"
    else:
        r = Renderer(builds(scene_name.removesuffix("-rr"), 64, 36, 2)[1][0], device=card,
                     russian_roulette=True)
    assert not r.fused
    return r


def _lanes_of(r, card):
    """Every pixel of ``r``'s frame once: (wid, px, py) on the card."""
    w = r.settings.width
    wid = torch.arange(w * r.settings.height, device=card, dtype=torch.int32)
    return wid, (wid % w).float(), (wid // w).float()


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["bvh-mesh", "cornell-rr"])
def test_modular_sample_on_the_card_runs_no_plain_stage(card, scene_name, monkeypatch):
    """One sample of the modular batch route on the card (a 5,120-triangle
    mesh on the BVH backend: K6, N1a, K3, N1b; the Cornell glTF with
    roulette: K4 in place of K6): the plain stages are never called, and the
    sample dispatches at most 200 ATen ops beside its kernels, where the
    shade and finish work alone was about 430 ops per level."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from raytracing_course_2024_tpu_torch.ops import traverse as TR

    for mod, stage in ((TR, "_fold_in_planes"), (SH, "surface_detail"), (SH, "_finish_bounce")):
        def refuse(*a, _stage=stage, **k):
            raise AssertionError(f"{_stage} ran on the card")
        monkeypatch.setattr(mod, stage, refuse)
    r = _modular_renderer(scene_name, card)
    s = r.settings
    n = s.width * s.height
    wid = torch.arange(n, device=card, dtype=torch.int32)
    body, run = P.sample_body(r.scene, r.cam_row, r.cfg, s.width, s.height, n)
    body.load(1, wid, (wid % s.width).float(), (wid // s.width).float())
    body.at(0)
    run()
    ops = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            view = any(x.alias_info is not None and not x.alias_info.is_write
                       for x in func._schema.returns)
            if not view and not str(func).startswith("aten.empty"):
                ops.append(str(func))
            return func(*args, **(kwargs or {}))

    kernels.reset_launches()
    with Count():
        run()
    torch.cuda.synchronize()
    depth = s.ray_depth
    assert kernels.LAUNCHES["shade"] == depth and kernels.LAUNCHES["finish"] == depth - 1
    assert len(ops) <= 200, (len(ops), sorted(set(ops)))


def _bits(x):
    return x.contiguous().view(torch.int32)


def _sparse_rows(c, n, pattern):
    """The first ``n`` lanes of ``c``'s state with few live lanes: 4 % at
    random (``sparse``), whole warps in every third warp of every other
    block (``dead-warps``), or none (``all-dead``)."""
    i = np.arange(n)
    if pattern == "sparse":
        keep = np.random.default_rng(3).random(n) < 0.04
        assert 0 < keep.mean() <= 0.05
    elif pattern == "dead-warps":
        keep = ((i // 32) % 3 == 0) & ((i // 256) % 2 == 0)
    else:
        keep = np.zeros(n, bool)
    rows = c["rows"][:, :n].copy()
    rows[12] = keep
    return torch.from_numpy(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["batch", "lane"])
@pytest.mark.parametrize("pattern", ["sparse", "dead-warps", "all-dead"])
def test_kernels_bit_equal_on_sparse_and_dead_warp_states(card, pattern, layout):
    """N1a and N1b on MIXED (planes staged in shared memory) with few live
    lanes, over a ragged last block: 4 % of the lanes live at random
    (``sparse``), whole warps live in every third warp of every other
    block and the other warps and blocks all dead (``dead-warps``), or no
    live lane. Against the plain versions bit for bit: N1a's state and
    ``need`` on every lane and its surface on the lanes that hit; N1b's
    ``live``, radiance and alive on every lane (in the lane layout the
    whole state: dead lanes parked) and every row of the lanes live on
    entry."""
    from raytracing_course_2024_tpu_torch.ops.sampler import sampler_plain

    c = _case("mixed")
    n = c["b"] - 77
    i = np.arange(n)
    rows = _sparse_rows(c, n, pattern).to(card)
    scene = modular_scene(c["ta"], c["ts"], card)
    assert scene.statics.num_planes > 0
    t, idx = (x[:n].to(card) for x in _table_hit(c))
    depth = torch.from_numpy((i % DEPTH).astype(np.int32)).to(card)
    lane = layout == "lane"
    kw = dict(depth=depth, last=DEPTH - 1) if lane else {}
    ks, ksurf, kneed = SH.shade(rows.clone(), t, idx, scene, c["bg"], **kw)
    ps, psurf, pneed = SH.shade_plain(rows.clone(), t, idx, scene, c["bg"], **kw)
    assert torch.equal(_bits(ks), _bits(ps)) and torch.equal(kneed, pneed)
    hit = SH.shade_plain(rows.clone(), t, idx, scene, c["bg"])[0][12] > 0.5  # batch: alive = hit
    for r, (a, w) in enumerate(zip(ksurf.columns(), psurf.columns())):
        assert torch.equal(_bits(a[hit]), _bits(w[hit])), r

    cfg = P.TraceConfig(ray_depth=DEPTH, bg_color=c["bg"], max_tries=K, rr=True)
    wid = torch.from_numpy(c["idx"][:n]).to(card)
    l, pdf, ok = sampler_plain(scene, SEED, wid, 0,
                               trng.batch_ctr(RR_START * trng.draws_per_bounce(K), K),
                               *SH.sampler_inputs(psurf), pneed, K)
    fkw = dict(depth=depth) if lane else dict(bounce_i=RR_START)
    kf, klive = SH.finish(ps.clone(), psurf, l, pdf, ok, wid, SEED, 0, cfg, **fkw)
    pf, plive = SH.finish_plain(ps.clone(), psurf, l, pdf, ok, wid, SEED, 0, cfg, **fkw)
    assert torch.equal(klive, plive)
    every = slice(0, SH.N_STATE) if lane else slice(9, SH.N_STATE)
    assert torch.equal(_bits(kf[every]), _bits(pf[every]))
    live_in = ps[12] > 0.5
    assert torch.equal(_bits(kf[:, live_in]), _bits(pf[:, live_in]))


def _assert_shade_outputs_equal(a, b):
    """Two launches of N1a on one input: the state and ``need`` bit for bit,
    the surface on the lanes that hit (the batch layout's alive)."""
    assert torch.equal(_bits(a[0]), _bits(b[0]))
    if a[1] is None:
        assert b[1] is None and a[2] is None and b[2] is None
        return
    assert torch.equal(a[2], b[2])
    hit = a[0][12] > 0.5
    for r, (x, y) in enumerate(zip(a[1].columns(), b[1].columns())):
        assert torch.equal(_bits(x[hit]), _bits(y[hit])), r


@pytest.mark.cuda
@pytest.mark.parametrize("level", ["camera", "bounce-1", "bounce-3", "bounce-3-final"])
@pytest.mark.parametrize("scene_name", ["cornell-rr", "mixed-rr"])
def test_shade_count_on_the_modular_route_states(card, scene_name, level):
    """N1a (after K4, as ``_collect_hit`` runs it) on the modular route's
    state at a level, on the Cornell glTF and on MIXED (planes staged in
    shared memory), roulette on: its count adds the lanes alive on entry,
    ``(st[12] > 0.5).sum()``, to what the counter held, and every output
    equals a launch's without a counter bit for bit."""
    from raytracing_course_2024_tpu_torch.ops.camera import camera_state

    r = _modular_renderer(scene_name, card)
    w, h = r.settings.width, r.settings.height
    wid, px, py = _lanes_of(r, card)
    st = camera_state(SEED, wid, 0, px, py, P.camera_from_row(r.cam_row), r.cam_row, w, h)
    live = None
    for i in range(0 if level == "camera" else int(level.split("-")[1])):
        st, live = P._bounce(st, r.scene, r.cfg, SEED, wid, 0, i, False, live)
    want = int((st[12] > 0.5).sum())
    assert 0 < want <= w * h
    final = level.endswith("final")
    count = torch.full((), 3, dtype=torch.int64, device=card)
    got = P._collect_hit(st.clone(), r.scene, r.cfg, False, live, final=final, count=count)
    base = P._collect_hit(st.clone(), r.scene, r.cfg, False, live, final=final)
    torch.cuda.synchronize()
    assert int(count) == 3 + want
    _assert_shade_outputs_equal(got, base)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["batch", "lane"])
@pytest.mark.parametrize("pattern", ["sparse", "dead-warps", "all-dead"])
def test_shade_count_on_sparse_and_dead_warp_states(card, pattern, layout):
    """N1a's count on MIXED with few live lanes over a ragged last block
    (``_sparse_rows``; blocks and warps without a live lane leave early):
    the lanes alive on entry, and every output as without a counter."""
    c = _case("mixed")
    n = c["b"] - 77
    rows = _sparse_rows(c, n, pattern).to(card)
    scene = modular_scene(c["ta"], c["ts"], card)
    t, idx = (x[:n].to(card) for x in _table_hit(c))
    depth = torch.from_numpy((np.arange(n) % DEPTH).astype(np.int32)).to(card)
    kw = dict(depth=depth, last=DEPTH - 1) if layout == "lane" else {}
    count = torch.zeros((), dtype=torch.int64, device=card)
    got = SH.shade(rows.clone(), t, idx, scene, c["bg"], count=count, **kw)
    base = SH.shade(rows.clone(), t, idx, scene, c["bg"], **kw)
    torch.cuda.synchronize()
    assert int(count) == int((rows[12] > 0.5).sum())
    _assert_shade_outputs_equal(got, base)


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["cornell-rr", "bvh-mesh"])
def test_graphed_modular_sample_launches_no_reduction(card, scene_name):
    """One modular sample replayed from its CUDA graph, under
    ``torch.profiler``: the card runs N1a and no ATen reduction, and the
    body's path vertices (N1a's count) and radiance are those of the route
    before N1a counted (the alive mask summed per level), run eagerly
    through the same kernels on the same sample."""
    from torch.profiler import ProfilerActivity, profile

    from raytracing_course_2024_tpu_torch.ops.camera import camera_state

    r = _modular_renderer(scene_name, card)
    assert r.graphs is not None
    w, h = r.settings.width, r.settings.height
    wid, px, py = _lanes_of(r, card)
    body, run = P.sample_body(r.scene, r.cam_row, r.cfg, w, h, w * h, graphs=r.graphs)
    body.load(SEED, wid, px, py)
    body.at(0)
    run()  # the capture
    off = w * h  # the frame's second sample
    body.load(SEED, wid, px, py)
    body.at(off)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("shade_kernel" in k for k in names), names
    assert not any("reduce_kernel" in k for k in names), names
    assert body.nrays.dtype == torch.int64
    st = camera_state(SEED, wid, off, px, py, P.camera_from_row(r.cam_row), r.cam_row, w, h)
    rad, terms = route_before(r.scene, st, r.cfg, SEED, wid, off, False)
    want = torch.zeros_like(body.acc)
    want += rad
    torch.cuda.synchronize()
    assert int(body.nrays) == sum(terms) > w * h
    assert torch.equal(_bits(body.acc), _bits(want))
