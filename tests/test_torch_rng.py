"""PyTorch port, counter RNG: work_key / uniform_ctr must match the JAX
package's ops/rng.py bit for bit (the CUDA kernels use the same hash)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.ops import rng as jrng
from raytracing_course_2024_tpu_torch.ops import rng as trng

SEEDS = [0, 1, 0xFFFFFFFF, 2654435761, 123456789]


def _wids(seed):
    r = np.random.default_rng(seed & 0xFFFF)
    return np.concatenate([
        np.array([0, 1, -1, -2, 2**31 - 1, -(2**31)], np.int32),
        r.integers(-(2**31), 2**31 - 1, size=4096).astype(np.int32),
    ])


@pytest.mark.parametrize("seed", SEEDS)
def test_work_key_bit_exact(seed):
    wid = _wids(seed)
    want = np.asarray(jrng.work_key(jnp.uint32(seed), jnp.asarray(wid)))
    got = trng.work_key(seed, torch.from_numpy(wid)).numpy()
    assert got.dtype == np.int64 and (got >= 0).all() and (got < 2**32).all()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_ctr_bit_exact(seed):
    wid = _wids(seed)
    jkey = jrng.work_key(jnp.uint32(seed), jnp.asarray(wid))
    tkey = trng.work_key(seed, torch.from_numpy(wid))
    for ctr in (0, 1, 2, 30, 31, 1000, 2**24 + 7, 2**31 - 1):
        want = np.asarray(jrng.uniform_ctr(jkey, ctr))
        got = trng.uniform_ctr(tkey, ctr).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want), ctr
    # per-lane counters, up to the full u32 range
    ctrs = np.random.default_rng(seed & 0xFF).integers(0, 2**32, size=wid.size,
                                                       dtype=np.uint64)
    want = np.asarray(jrng.uniform_ctr(jkey, jnp.asarray(ctrs.astype(np.uint32))))
    got = trng.uniform_ctr(tkey, torch.from_numpy(ctrs.astype(np.int64))).numpy()
    assert np.array_equal(got, want)
    assert (got >= 0.0).all() and (got < 1.0).all()


def test_draw_layout():
    """Counter layout of one bounce: jitter 0-1, 7 rows per mixture
    candidate, then the dielectric split and the roulette draw."""
    assert trng.draws_per_bounce(4) == 2 + 7 * 4 + 2
    seen = {trng.CTR_JITTER, trng.CTR_JITTER + 1, trng.ctr_diel(4), trng.ctr_rr(4)}
    seen |= {trng.ctr_mix(t, r) for t in range(4) for r in range(7)}
    assert seen == set(range(trng.draws_per_bounce(4)))
