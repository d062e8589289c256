"""PyTorch port, per-ray sampling math against the JAX package, pointwise
on the same numpy-seeded inputs.

Tolerance: at least 99.9 % of the lanes within atol 1e-5 + rtol 1e-5, and
every lane within rtol 1e-2 (atol 1e-4). Both sides run float32 and differ
by a few ulp of rsqrt / cos / pow (XLA's CPU versions, partly fused,
against PyTorch's one-op-at-a-time rounding); a few ill-conditioned lanes
amplify that: grazing views in the VNDF frame, grazing hits in the light
pdf (1 / |n.l|), pdfs of 1e3-1e4 near grazing angles where one ulp exceeds
an absolute 1e-5. The counter draws themselves are bit-exact
(test_torch_rng.py).

Quantities through the GGX distribution (pdf_vndf, the mixture pdf, the PBR
BRDF) get rtol 1e-3 in place of 1e-5: D = a^2 / (pi ((a^2 - 1)(h.n)^2 + 1)^2)
cancels near its peak, which amplifies a 1-ulp difference of h.n by
~1/a^2. Roughness is drawn from [0.1, 1], so 1/a^2 <= 1e4.

The mixture pdf of a sampled direction is held on 99.5 % of the lanes: the
light pdf is discontinuous in l at light edges and tangent hits, so a
1e-7 difference of a sampled l moves it by up to 1 % there (measured: with
the same l, every pdf term is identical)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.ops import brdf as jbrdf
from raytracing_course_2024_tpu.ops import rng as jrng
from raytracing_course_2024_tpu.ops import sampling as jsamp
from raytracing_course_2024_tpu.ops import tonemap as jtone
from raytracing_course_2024_tpu.ops.vec import Vec3 as JV
from raytracing_course_2024_tpu_torch.ops import brdf as tbrdf
from raytracing_course_2024_tpu_torch.ops import rng as trng
from raytracing_course_2024_tpu_torch.ops import sampling as tsamp
from raytracing_course_2024_tpu_torch.ops import tonemap as ttone
from raytracing_course_2024_tpu_torch.ops.mixture import mixture_body
from raytracing_course_2024_tpu_torch.ops.vec import Vec3 as TV
from torch_parity import builds, random_unit, to_jnp

B = 4096
TOL = dict(atol=1e-5, rtol=1e-5)
GGX_TOL = dict(atol=1e-5, rtol=1e-3)
OUTLIER_TOL = dict(atol=1e-4, rtol=1e-2)
LANE_FRAC = 0.999
PDF_FRAC = 0.995  # mixture pdf of a sampled direction
LIGHT_SCENES = ("lights", "mixed", "cornell")


def jv(a):
    return JV(*(jnp.asarray(c) for c in a))


def tv(a):
    return TV(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def close(got, want, frac=None, **tol):
    tol = tol or TOL
    frac = frac or LANE_FRAC
    got = [np.asarray(g) for g in (got if isinstance(got, tuple) else (got,))]
    want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
    for g, w in zip(got, want):
        ok = np.isclose(g, w, equal_nan=True, **tol)
        assert ok.mean() >= frac, (ok.mean(), g[~ok][:5], w[~ok][:5])
        np.testing.assert_allclose(g, w, **OUTLIER_TOL)


def _inputs(seed):
    r = np.random.default_rng(seed)
    n = random_unit(r, B)
    v = random_unit(r, B)
    v = v * np.where((v * n).sum(0) < 0, -1.0, 1.0).astype(np.float32)
    u = r.random((7, B), dtype=np.float32)
    rough = r.uniform(0.1, 1.0, B).astype(np.float32)
    point = r.uniform(-2.5, 2.5, (3, B)).astype(np.float32)
    return r, n, v, u, rough, point


@pytest.mark.parametrize("seed", [0, 1])
def test_cosine_and_vndf_samplers(seed):
    _, n, v, u, rough, _ = _inputs(seed)
    want = jsamp.sample_cosine_u(jnp.asarray(u[0]), jnp.asarray(u[1]), jv(n))
    got = tsamp.sample_cosine_u(torch.from_numpy(u[0]), torch.from_numpy(u[1]), tv(n))
    close(tuple(got), tuple(want))
    want = jsamp.sample_vndf_u(jnp.asarray(u[0]), jnp.asarray(u[1]), jv(n), jv(v),
                               jnp.asarray(rough))
    got = tsamp.sample_vndf_u(torch.from_numpy(u[0]), torch.from_numpy(u[1]), tv(n),
                              tv(v), torch.from_numpy(rough))
    close(tuple(got), tuple(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_cosine_and_vndf_pdfs(seed):
    r, n, v, _, rough, _ = _inputs(seed)
    l = random_unit(r, B)
    close(tsamp.pdf_cosine(tv(n), tv(l)), jsamp.pdf_cosine(jv(n), jv(l)))
    close(tsamp.pdf_vndf(tv(n), tv(l), tv(v), torch.from_numpy(rough)),
          jsamp.pdf_vndf(jv(n), jv(l), jv(v), jnp.asarray(rough)), **GGX_TOL)


@pytest.mark.parametrize("name", LIGHT_SCENES)
def test_light_sampling_and_pdf(name):
    """Box, ellipsoid and triangle lights, rotated and not."""
    (_, ja, js), (_, ta, ts) = builds(name)
    if name == "lights":
        assert set(ts.light_types) == {0, 1, 2} and any(ts.light_rotated)
        assert not all(ts.light_rotated)
    _, _, _, u, _, point = _inputs(7)
    ju = [jnp.asarray(c) for c in u[1:7]]
    tu = [torch.from_numpy(c) for c in u[1:7]]
    want = jsamp.sample_light_dir_u(ju, jv(point), jnp.asarray(ja.light_packed), js)
    got = tsamp.sample_light_dir_u(tu, tv(point), ta.light_packed, ts)
    close(tuple(got), tuple(want))
    # pdf along the sampled directions (they hit a light) and random ones
    dirs = np.stack([np.asarray(c) for c in want]).astype(np.float32)
    rand = random_unit(np.random.default_rng(3), B)
    for d in (dirs, rand):
        w = jsamp.pdf_lights_lp(jv(point), jv(d), jnp.asarray(ja.light_packed), js)
        g = tsamp.pdf_lights_lp(tv(point), tv(d), ta.light_packed, ts)
        close(g, w)
    assert (np.asarray(w) > 0).mean() > 0.0


@pytest.mark.parametrize("mkind", [0, 3])
def test_eval_brdf(mkind):
    r, n, v, _, rough, _ = _inputs(11)
    l = random_unit(r, B)
    l = l * np.where((l * n).sum(0) < 0, -1.0, 1.0).astype(np.float32)
    color = r.random((3, B), dtype=np.float32)
    metal = r.random(B, dtype=np.float32)
    mk = np.full(B, mkind, np.int32)
    want = jbrdf.eval_brdf(jv(l), jv(n), jv(v), jv(color), jnp.asarray(metal),
                           jnp.asarray(rough), jnp.asarray(mk))
    got = tbrdf.eval_brdf(tv(l), tv(n), tv(v), tv(color), torch.from_numpy(metal),
                          torch.from_numpy(rough), torch.from_numpy(mk))
    close(tuple(got), tuple(want), **(GGX_TOL if mkind else TOL))


def test_tonemap():
    x = np.random.default_rng(5).gamma(0.6, 1.0, (64, 48, 3)).astype(np.float32)
    x[0, :4, 0] = [0.0, 1e-7, 50.0, 1e4]
    close(ttone.aces_tonemap(torch.from_numpy(x)), jtone.aces_tonemap(jnp.asarray(x)))
    got = ttone.color_to_u8(torch.from_numpy(x)).numpy()
    want = np.asarray(jtone.color_to_u8(jnp.asarray(x)))
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def _mixture_case(name, seed):
    (_, ja, js), (_, ta, ts) = builds(name)
    r, n, v, _, rough, point = _inputs(seed)
    # shading normal: the geometric one, tilted a little (smooth shading)
    ns = n + 0.2 * random_unit(r, B)
    ns = (ns / np.linalg.norm(ns, axis=0)).astype(np.float32)
    return ja, js, ta, ts, n, ns, v, rough, point


@pytest.mark.parametrize("name", LIGHT_SCENES)
def test_uniforms_in_mixture_matches_jax(name):
    ja, js, ta, ts, n, ns, v, rough, point = _mixture_case(name, 21)
    k = 4
    u7 = np.random.default_rng(22).random((7, k * B), dtype=np.float32)
    jl, jpdf, jok = jsamp.sample_mixture(
        None, jv(point), jv(n), jv(ns), jv(v), jnp.asarray(rough), to_jnp(ja), js,
        need=jnp.ones((B,), bool), max_tries=k,
        uniforms=[jnp.asarray(c) for c in u7])
    tl, tpdf, tok = tsamp.sample_mixture(
        [torch.from_numpy(c) for c in u7], tv(point), tv(n), tv(ns), tv(v),
        torch.from_numpy(rough), ta.light_packed, ts, max_tries=k)
    ok = np.asarray(jok)
    assert np.array_equal(tok.numpy(), ok) and ok.mean() > 0.9
    close(tuple(c.numpy()[ok] for c in tl), tuple(np.asarray(c)[ok] for c in jl))
    close(tpdf.numpy()[ok], np.asarray(jpdf)[ok], frac=PDF_FRAC, **GGX_TOL)


@pytest.mark.parametrize("name", LIGHT_SCENES)
def test_mixture_body_matches_jax_with_counter_draws(name):
    """The kernels' sampler (first accept over K candidates, counter draws)
    against JAX sample_mixture fed the same draws as its 7 candidate-major
    rows: identical on every lane both accept."""
    ja, js, ta, ts, n, ns, v, rough, point = _mixture_case(name, 31)
    k, seed, bounce_i = 4, 99, 2
    wid = np.arange(B, dtype=np.int32) * 7 - 1000
    base = bounce_i * trng.draws_per_bounce(k)
    jkey = jrng.work_key(jnp.uint32(seed), jnp.asarray(wid))
    rows = [jnp.concatenate([jrng.uniform_ctr(jkey, base + trng.ctr_mix(c, row))
                             for c in range(k)]) for row in range(7)]
    jl, jpdf, jok = jsamp.sample_mixture(
        None, jv(point), jv(n), jv(ns), jv(v), jnp.asarray(rough), to_jnp(ja), js,
        need=jnp.ones((B,), bool), max_tries=k, uniforms=rows)

    tkey = trng.work_key(seed, torch.from_numpy(wid))
    tl, tpdf, tok = mixture_body(
        lambda c: trng.uniform_ctr(tkey, c), trng.batch_ctr(base, k), tv(point), tv(n),
        tv(ns), tv(v),
        torch.from_numpy(rough), ta.light_packed, ts, k)
    ok = np.asarray(jok)
    assert np.array_equal(tok.numpy(), ok) and ok.mean() > 0.9
    close(tuple(c.numpy()[ok] for c in tl), tuple(np.asarray(c)[ok] for c in jl))
    close(tpdf.numpy()[ok], np.asarray(jpdf)[ok], frac=PDF_FRAC, **GGX_TOL)
    # no accepted candidate: the kernel keeps (0, 0, 1), XLA returns 0
    rej = ~ok
    if rej.any():
        assert (tl.z.numpy()[rej] == 1.0).all()
