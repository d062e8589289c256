"""PyTorch port, the standalone mixture sampler (K3's wrapper and plain
version, ``ops/sampler.py``) against the JAX package's XLA
``sample_mixture`` fed the same counter draws, on the CPU.

Both acceptance rules (fast and faithful), light tables of up to 32 lights
(the unrolled light pdf) and of 40 lights (the vectorized (B, L) pdf).
Tolerance as in test_torch_sampling.py: ok masks equal; l within
atol = rtol = 1e-5 and the pdf within rtol 1e-3 (GGX) on the lanes both
accept, with the outlier bounds stated there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.ops import rng as jrng
from raytracing_course_2024_tpu.ops import sampling as jsamp
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.ops import rng as trng
from raytracing_course_2024_tpu_torch.ops import sampling as tsamp
from raytracing_course_2024_tpu_torch.ops.sampler import sample_mixture_kernel, sampler_plain
from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
from test_torch_sampling import GGX_TOL, PDF_FRAC, close, jv, tv
from torch_parity import builds, random_unit, to_jnp

import raytracing_course_2024_tpu.scene as jscene
import raytracing_course_2024_tpu_torch.scene as tscene
from meshes import icosphere, mesh_scene_desc

NB = 2048
K = 4
SEED = 4242


def _many_lights():
    """40 emissive triangles: above the 32 lights the kernels take."""
    verts, faces = icosphere(1)
    desc = mesh_scene_desc(verts, faces[:40])
    for p in desc.primitives:
        p.emission = np.ones(3)
    ja, js = jscene.build_scene_arrays(desc)
    ta, ts = tscene.build_scene_arrays(desc)
    assert ts.num_lights == 41 > tsamp.UNROLL_MAX_LIGHTS
    return ja, js, ta, ts


def _case(name, seed=5):
    if name == "many_lights":
        ja, js, ta, ts = _many_lights()
    else:
        (_, ja, js), (_, ta, ts) = builds(name)
    r = np.random.default_rng(seed)
    n = random_unit(r, NB)
    v = random_unit(r, NB)
    v = v * np.where((v * n).sum(0) < 0, -1.0, 1.0).astype(np.float32)
    ns = n + 0.2 * random_unit(r, NB)
    ns = (ns / np.linalg.norm(ns, axis=0)).astype(np.float32)
    rough = r.uniform(0.1, 1.0, NB).astype(np.float32)
    point = r.uniform(-2.5, 2.5, (3, NB)).astype(np.float32)
    need = r.random(NB) < 0.9
    wid = (np.arange(NB, dtype=np.int64) * 13 - 500).astype(np.int32)
    return dict(ja=ja, js=js, scene=modular_scene(ta, ts, "cpu"), n=n, v=v, ns=ns,
                rough=rough, point=point, need=need, wid=wid)


def _jax(c, wid_off, base, faithful):
    key = jrng.work_key(jnp.uint32(SEED), jnp.asarray(c["wid"]) + jnp.int32(wid_off))
    rows = [jnp.concatenate([jrng.uniform_ctr(key, base + trng.ctr_mix(t, r))
                             for t in range(K)]) for r in range(7)]
    return jsamp.sample_mixture(
        None, jv(c["point"]), jv(c["n"]), jv(c["ns"]), jv(c["v"]), jnp.asarray(c["rough"]),
        to_jnp(c["ja"]), c["js"], need=jnp.asarray(c["need"]), max_tries=K,
        faithful=faithful, uniforms=rows)


def _port(fn, c, wid_off, base, **kw):
    return fn(c["scene"], SEED, torch.from_numpy(c["wid"]), wid_off, trng.batch_ctr(base, K),
              tv(c["point"]), tv(c["n"]), tv(c["ns"]), tv(c["v"]), torch.from_numpy(c["rough"]),
              torch.from_numpy(c["need"]), K, **kw)


@pytest.mark.parametrize("name", ["lights", "mixed", "cornell", "many_lights"])
@pytest.mark.parametrize("faithful", [False, True], ids=["fast", "faithful"])
def test_sampler_matches_jax_sample_mixture(name, faithful):
    c = _case(name)
    wid_off, base = 777, 3 * trng.draws_per_bounce(K)
    jl, jpdf, jok = _jax(c, wid_off, base, faithful)
    fn = sampler_plain if faithful else sample_mixture_kernel
    tl, tpdf, tok = _port(fn, c, wid_off, base, **({"faithful": True} if faithful else {}))
    ok = np.asarray(jok)
    assert np.array_equal(tok.numpy(), ok)
    assert not ok[~c["need"]].any() and ok.mean() > 0.8
    close(tuple(x.numpy()[ok] for x in tl), tuple(np.asarray(x)[ok] for x in jl))
    close(tpdf.numpy()[ok], np.asarray(jpdf)[ok], frac=PDF_FRAC, **GGX_TOL)


def test_sampler_wrapper_runs_plain_on_cpu_and_counts_nothing():
    c = _case("mixed", seed=6)
    kernels.reset_launches()
    got = _port(sample_mixture_kernel, c, 0, 0)
    want = _port(sampler_plain, c, 0, 0)
    assert all(torch.equal(g, w) for g, w in zip((*got[0], *got[1:]), (*want[0], *want[1:])))
    assert kernels.LAUNCHES["sampler"] == 0
    meta = tuple(torch.zeros(NB, device="meta") for _ in range(3))
    with pytest.raises(ValueError):
        sample_mixture_kernel(c["scene"], SEED, torch.zeros(NB, dtype=torch.int32,
                                                             device="meta"),
                              0, 0, *(tsamp.Vec3(*meta),) * 4, meta[0],
                              torch.zeros(NB, dtype=torch.bool, device="meta"), K)
