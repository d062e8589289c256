"""PyTorch port, the modular dense path on the CPU (plain versions of K3 and
K4): one bounce against the JAX package's stages fed the same counter
draws (roulette off and on, faithful acceptance), whole ``render_pixels``
against the JAX-driven loop, and the port's fused and modular routes
against each other. The modular route's path vertices, which N1a counts
(``shade(count=)``), against the per-level sums of the alive mask the route
took before, with the radiance bit for bit, on a dense and a BVH scene.

Tolerances: a bounce as in test_torch_bounce.py (alive masks differ on at
most 0.1 % of lanes, each state row within atol = rtol = 1e-4 on >= 99.9 %);
frames >= 99 % of pixels within 1e-4 of the JAX loop and path vertices
within 1 % (a flipped accept, Fresnel or roulette decision changes a whole
path); fused against modular >= 99 % of pixels within 1e-3 (same counter
draws, but the two routes round differently: the fused kernel intersects
and shades in one pass, the modular path re-intersects the winner).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from raytracing_course_2024_tpu.ops.sampling import sample_mixture
from raytracing_course_2024_tpu.ops.vec import Vec3 as JV
from raytracing_course_2024_tpu.scene.types import DIELECTRIC, MIRROR
from raytracing_course_2024_tpu_torch.integrator import path as P
from raytracing_course_2024_tpu_torch.ops import rng as trng
from raytracing_course_2024_tpu_torch.ops.camera import (camera_arrays, camera_state_plain,
                                                          pack_camera_row)
from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from test_torch_bounce import _assert_states_agree
from test_torch_graphs import _bvh_mesh, _dense_rr
from test_torch_render import _jax_counter_loop
from torch_parity import builds, descs, to_jnp

SEED = 31
K = 4
SIZES = {"mixed": (48, 32), "cornell": (48, 27)}


def _state(name):
    """Both builds plus a bounce's input state: jittered camera rays,
    throughput in [0.5, 1], every third lane dead."""
    w, h = SIZES[name]
    (jd, ja, js), (td, ta, ts) = builds(name, w, h, 2)
    b = w * h
    idx = np.arange(b, dtype=np.int32)
    key = jrng.work_key(jnp.uint32(SEED), jnp.asarray(idx))
    ro, rd = j_rays(j_camera(jd.settings.camera), jnp.asarray(idx % w),
                    jnp.asarray(idx // w), w, h, jrng.uniform_ctr(key, 0),
                    jrng.uniform_ctr(key, 1))
    thr = np.random.default_rng(2).uniform(0.5, 1.0, (3, b)).astype(np.float32)
    alive = (idx % 3) != 0
    rows = [*map(np.asarray, ro), *map(np.asarray, rd), *thr,
            *np.zeros((3, b), np.float32)]
    return dict(jd=jd, ja=ja, js=js, ta=ta, ts=ts, idx=idx, b=b,
                rows=[r.astype(np.float32) for r in rows], alive=alive)


def _jax_bounce(c, cfg, bounce_i):
    r = [jnp.asarray(x) for x in c["rows"]]
    st = _PathState(JV(*r[0:3]), JV(*r[3:6]), JV(*r[6:9]), JV(*r[9:12]),
                    jnp.asarray(c["alive"]))
    # the XLA sweep (tri_pack None): the same nearest hit as the
    # interpret-mode triangle kernel, far less CPU time
    arrays = to_jnp(c["ja"])._replace(tri_pack=None)
    st2, surf, _ = j_collect(st, arrays, c["js"], cfg)
    key = jrng.work_key(jnp.uint32(SEED), jnp.asarray(c["idx"]))
    base = bounce_i * trng.draws_per_bounce(K)
    rows = [jnp.concatenate([jrng.uniform_ctr(key, base + trng.ctr_mix(t, q))
                             for t in range(K)]) for q in range(7)]
    delta = (surf.mkind == MIRROR) | (surf.mkind == DIELECTRIC)
    l, pdf, ok = sample_mixture(None, surf.point, surf.n_geom, surf.n_shade, -st.rd,
                                surf.roughness, arrays, c["js"], need=st2.alive & ~delta,
                                max_tries=K, faithful=cfg.faithful, uniforms=rows)
    u_diel = jrng.uniform_ctr(key, base + trng.ctr_diel(K))
    kw = {}
    if cfg.rr:
        kw = dict(u_rr=jrng.uniform_ctr(key, base + trng.ctr_rr(K)),
                  rr_mask=jnp.full((c["b"],), bounce_i >= RR_START))
    out = j_finish(st2, surf, l, pdf, ok, u_diel, cfg, **kw)
    return np.stack([np.asarray(x, np.float32) for v in out[:4] for x in v]
                    + [np.asarray(out[4], np.float32)])


@pytest.mark.parametrize("name,bounce_i,mode", [
    ("mixed", 1, "plain"), ("mixed", 2, "roulette"), ("mixed", 1, "roulette"),
    ("mixed", 2, "faithful"), ("cornell", 3, "roulette"),
])
def test_modular_bounce_matches_jax_stages(name, bounce_i, mode):
    c = _state(name)
    bg = tuple(c["jd"].settings.bg_color)
    rr, faithful = mode == "roulette", mode == "faithful"
    want = _jax_bounce(c, JTraceConfig(ray_depth=6, bg_color=bg, max_tries=K, rr=rr,
                                       faithful=faithful), bounce_i)
    st = torch.from_numpy(np.stack([*c["rows"], c["alive"].astype(np.float32)]))
    wid = torch.from_numpy(c["idx"])
    cfg = P.TraceConfig(ray_depth=6, bg_color=bg, max_tries=K, rr=rr, faithful=faithful)
    out, live = P._bounce(st, modular_scene(c["ta"], c["ts"], "cpu"), cfg, SEED, wid, 0,
                          bounce_i)
    got = out.numpy()
    assert torch.equal(live, out[12] > 0.5)
    _assert_states_agree(got, want)
    if rr and bounce_i >= RR_START:  # roulette killed some lanes and boosted others
        alive_in = c["alive"]
        assert (got[12] > 0.5).sum() < alive_in.sum()
        assert (got[6:9][:, got[12] > 0.5] > 1.0).any()


@pytest.mark.parametrize("name", ["mixed", "cornell"])
def test_render_pixels_modular_matches_jax_loop_with_roulette(name):
    w, h, spp = 32, 18, 2
    (jd, ja, js), (td, ta, ts) = builds(name, w, h, spp)
    depth = td.settings.ray_depth
    seed32 = (SEED * 2654435761) & 0xFFFFFFFF
    want, want_rays = _jax_counter_loop(jd, ja, js, w, h, spp, seed32, depth, rr=True)
    idx = torch.arange(w * h, dtype=torch.int32)
    cam = torch.from_numpy(pack_camera_row(camera_arrays(td.settings.camera))[0])
    cfg = P.TraceConfig(ray_depth=depth, bg_color=tuple(td.settings.bg_color), rr=True)
    got, rays = P.render_pixels(modular_scene(ta, ts, "cpu"), seed32, idx,
                                (idx % w).float(), (idx // w).float(), cam, cfg, w, h, spp,
                                w * h)
    ok = (np.abs(got.numpy() - want) <= 1e-4).all(axis=0)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(float(rays) - want_rays) <= 0.01 * want_rays
    assert got.numpy().max() > 0


@pytest.mark.parametrize("name", ["mixed", "cornell"])
def test_fused_and_modular_routes_agree(name):
    """The same scene and seed on the fused route (the Renderer's) and on
    the modular route (a ``ModularScene`` of the same build, rendered by the
    batch engine)."""
    _, td = descs(name, 32, 18, 4)
    fused = Renderer(td, device="cpu")
    assert fused.fused
    a_out, a_verts = fused.render_frame_device(seed=3)
    modular = modular_scene(fused.arrays, fused.statics, "cpu")
    b_out, b_verts = P.render_batches(modular, (3 * 2654435761) & 0xFFFFFFFF, fused.cam_row,
                                      fused.cfg, 32, 18, 4, fused.batch_size)
    a, b = fused._assemble(a_out), fused._assemble(b_out)
    b_verts = float(b_verts)
    assert np.isfinite(b).all() and b.max() > 0
    ok = (np.abs(a - b) <= 1e-3).all(axis=-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(a_verts - b_verts) <= 0.01 * a_verts


def test_rt_rr_turns_roulette_on(monkeypatch):
    _, td = descs("cornell", 16, 12, 2)
    assert not Renderer(td, device="cpu").cfg.rr
    monkeypatch.setenv("RT_RR", "1")
    r = Renderer(td, device="cpu")
    assert r.cfg.rr and not r.fused
    assert not Renderer(td, device="cpu", russian_roulette=False).cfg.rr


# --- the path-vertex count -------------------------------------------------

COUNT_SCENES = {"dense": lambda: _dense_rr(32, 24)[1:], "bvh": _bvh_mesh}
# a depth at which lanes are still alive on entry to the final level: the
# mesh's rays escape to the background by bounce 2
FINAL_DEPTH = {"dense": 6, "bvh": 2}


def _fresh(name, depth, rr):
    """A modular scene, its cfg at ``depth`` with roulette ``rr``, the lanes'
    work ids and the fresh state on the camera rays."""
    d, scene, cfg = COUNT_SCENES[name]()
    cfg = cfg._replace(ray_depth=depth, rr=rr)
    w, h = d.settings.width, d.settings.height
    wid = torch.arange(w * h, dtype=torch.int32)
    st = camera_state_plain(SEED, wid, 0, (wid % w).float(), (wid // w).float(),
                            camera_arrays(d.settings.camera), w, h)
    return scene, cfg, wid, st


def route_before(scene, st, cfg, seed, wid, wid_off, plain):
    """``trace_paths`` as it was before N1a counted: the alive mask summed in
    float64 at every level. Returns ((3, B) radiance, the levels' terms)."""
    live = st[12] > 0.5
    terms = []
    for i in range(cfg.ray_depth - 1):
        terms.append(float(live.sum(dtype=torch.float64)))
        st, live = P._bounce(st, scene, cfg, seed, wid, wid_off, i, plain, live)
    terms.append(float(live.sum(dtype=torch.float64)))
    st, _, _ = P._collect_hit(st, scene, cfg, plain, live, final=True)
    return st[9:12], terms


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("plain", [False, True], ids=["wrappers", "plain"])
@pytest.mark.parametrize("depth", [1, 2, 6])
@pytest.mark.parametrize("rr", [False, True], ids=["no-roulette", "roulette"])
@pytest.mark.parametrize("name", list(COUNT_SCENES))
def test_modular_count_equals_the_per_level_live_sums(name, rr, depth, plain):
    """``trace_paths`` adds its path vertices to the counter it is given (an
    int64, returned as it), as many as the route's per-level sums of the
    alive mask, and its radiance is the route's before N1a counted, bit for
    bit; without a counter it makes its own."""
    scene, cfg, wid, st = _fresh(name, depth, rr)
    want_rad, terms = route_before(scene, st.clone(), cfg, SEED, wid, 0, plain)
    assert len(terms) == depth and terms[0] == st.shape[1]
    count = torch.full((), 7, dtype=torch.int64)
    rad, got = P.trace_paths(scene, st.clone(), SEED, wid, 0, cfg, plain, count)
    assert got is count and got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == 7 + sum(terms)
    assert torch.equal(_bits(rad), _bits(want_rad))
    _, own = P.trace_paths(scene, st.clone(), SEED, wid, 0, cfg, plain)
    assert own.dtype == torch.int64 and int(own) == sum(terms)


@pytest.mark.parametrize("term", ["level-0", "final"])
@pytest.mark.parametrize("name", list(COUNT_SCENES))
def test_modular_count_terms(name, term):
    """N1a's term at level 0 is every lane of the fresh state (all alive on
    the camera rays); at the final level (``final``, emission only) the
    lanes N1b left alive, which misses (and roulette) have thinned."""
    scene, cfg, wid, st = _fresh(name, FINAL_DEPTH[name], True)
    b = st.shape[1]
    count = torch.zeros((), dtype=torch.int64)
    if term == "level-0":
        P._collect_hit(st, scene, cfg, count=count)
        assert int(count) == int((st[12] > 0.5).sum()) == b
        return
    live = None
    for i in range(cfg.ray_depth - 1):
        st, live = P._bounce(st, scene, cfg, SEED, wid, 0, i, False, live)
    want = int(live.sum())
    assert 0 < want < b
    P._collect_hit(st, scene, cfg, False, live, final=True, count=count)
    assert int(count) == want
