"""PyTorch port, the lane round's tail (``ops/loop.py:round_tail``, N5's
tails), on the CPU.

* ``round_tail_plain`` (and the wrapper, which runs it on the CPU) in each
  tail and mode against the ATen steps the lane rounds ran before N5 took
  them over, written out here: the fused core's final-depth cap and park,
  the depth step, then ``round_test_plain`` with ``sticky_kmax``. Bit for
  bit: state rows, depths, counters and predicates.
* The fused tail's alive row and parked rays against the JAX lane core's
  own ``cont`` and ``park`` (``raytracing_course_2024_tpu/integrator/
  wavefront.py:122-127,141-142``), reached through the JAX
  ``_make_bounce_core`` with its bounce made the identity, on seeded numpy
  inputs with lanes at the final depth and lanes parked on entry.
* The wrappers refuse what the kernel cannot take: another device than the
  CPU or CUDA, unknown modes and tails, and tensors of the wrong dtype or
  shape (checked with stand-in CUDA tensors and the launch stubbed).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.integrator import wavefront as jwf
from raytracing_course_2024_tpu.integrator.path import TraceConfig as JTraceConfig
from raytracing_course_2024_tpu.ops import pallas_bounce as jpb
from raytracing_course_2024_tpu.ops.vec import Vec3 as JV
from raytracing_course_2024_tpu_torch.ops import loop as LP
from raytracing_course_2024_tpu_torch.ops.shade import PARK_DIR, PARK_ORIGIN

LAST = 5


def _state(n, seed):
    """(13, n) f32 state, int32 depths 0 .. LAST + 1 and int64 k from numpy:
    lanes alive, dead with a ray, and dead and parked on entry; a few alive
    flags off 0 and 1."""
    g = np.random.default_rng(seed)
    st = (g.random((13, n)) * 4.0 - 2.0).astype(np.float32)
    alive = (g.random(n) < 0.5).astype(np.float32)
    alive[g.random(n) < 0.03] = 0.75
    parked = (alive < 0.5) & (g.random(n) < 0.5)
    st[12] = alive
    st[0:3, parked] = np.float32(PARK_ORIGIN)
    st[3:6, parked] = np.float32(PARK_DIR)
    depth = g.integers(0, LAST + 2, n).astype(np.int32)
    depth[:8] = LAST  # lanes at the final depth, alive and dead
    st[12, :4] = 1.0
    k = g.integers(0, 8, n).astype(np.int64)
    return st, depth, k


def _by_hand(ls, mode, state, depth, tail, k, n_pix, samples, counter, total, thresh):
    """The end of a round as the ATen steps ran it: cap and park (fused),
    the depth step (depth, fused), the test on the alive row."""
    if tail == LP.TAIL_FUSED:
        cont = (state[12] > 0.5) & (depth < LAST)
        state[12] = cont.to(torch.float32)
        state[0:3] = torch.where(cont, state[0:3], PARK_ORIGIN)
        state[3:6] = torch.where(cont, state[3:6], PARK_DIR)
    if tail != LP.TAIL_NONE:
        depth += 1
    lane = torch.arange(state.shape[1])
    kmax = torch.where(lane < n_pix, ((n_pix - 1 - lane) // state.shape[1] + 1) * samples, 0)
    LP.round_test_plain(ls, mode, alive=state[12], k=k, kmax=kmax, counter=counter,
                        total=total, thresh=thresh)


@pytest.mark.parametrize("fn", [LP.round_tail_plain, LP.round_tail], ids=["plain", "wrapper"])
@pytest.mark.parametrize("tail", [LP.TAIL_NONE, LP.TAIL_DEPTH, LP.TAIL_FUSED],
                         ids=["none", "depth", "fused"])
@pytest.mark.parametrize("mode", [LP.COUNTER, LP.STICKY], ids=["counter", "sticky"])
@pytest.mark.parametrize("n", [300, 997])
def test_round_tail_equals_the_aten_steps(fn, tail, mode, n):
    """Three rounds in a row on one state from counters that are not zero:
    every row, the depths, the counters and the predicates bit for bit."""
    st, depth, k = _state(n, seed=n + 3 * tail + mode)
    n_pix, samples = (2 * n + n // 3, 2) if n % 2 == 0 else (n - n // 10, 3)
    got = (torch.from_numpy(st.copy()), torch.from_numpy(depth.copy()), LP.LoopState("cpu"))
    want = (torch.from_numpy(st.copy()), torch.from_numpy(depth.copy()), LP.LoopState("cpu"))
    for ls in (got[2], want[2]):
        ls.loop.copy_(torch.tensor([9, 1, 1, 100, 4, 2]))
    tk = torch.from_numpy(k)
    for step in range(3):
        counter = torch.tensor(3 * n + step)
        fn(got[2], mode, got[0], got[1], tail, LAST, k=tk, n_pix=n_pix, samples=samples,
           counter=counter, total=4 * n, thresh=n // 8)
        _by_hand(want[2], mode, want[0], want[1], tail, tk, n_pix, samples, counter, 4 * n,
                 n // 8)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), step
        assert torch.equal(got[1], want[1]) and torch.equal(got[2].loop, want[2].loop), step
        assert torch.equal(got[2].preds, want[2].preds), step
    if tail == LP.TAIL_FUSED:  # the lanes at the final depth died and were parked
        assert (got[0][12, :8] == 0).all() and (got[0][0:3, :8] == PARK_ORIGIN).all()
    assert not got[2].scratch.any()


def _jax_cont_and_park(st, depth, monkeypatch):
    """The JAX lane core's ``cont`` and parked rays on ``st``: its fused
    core (``_make_bounce_core`` on the megakernel route) with the bounce
    made the identity, so what comes out is its own cap and ``park``."""
    monkeypatch.setattr(jwf, "_use_megakernel", lambda *a: True)
    monkeypatch.setattr(jpb, "build_geo_rows", lambda *a: None)
    monkeypatch.setattr(jpb, "bounce_pallas", lambda key, ro, rd, thr, rad, alive, *a, **kw:
                        (ro, rd, thr, rad, alive))
    cfg = JTraceConfig(ray_depth=LAST + 1, bg_color=(0.0, 0.0, 0.0), max_tries=4)
    core, fused = jwf._make_bounce_core(cfg, None, None)
    assert fused
    rows = [JV(*(jnp.asarray(st[i + j]) for j in range(3))) for i in (0, 3, 6, 9)]
    ro, rd, _, _, cont = core(None, jnp.asarray(depth), *rows, jnp.asarray(st[12] > 0.5))
    return np.asarray(cont), np.stack([np.asarray(c, np.float32) for v in (ro, rd) for c in v])


@pytest.mark.parametrize("n", [256, 411])
def test_fused_tail_matches_the_jax_cont_and_park(n, monkeypatch):
    st, depth, k = _state(n, seed=40 + n)
    st[12] = (st[12] > 0.5).astype(np.float32)  # the JAX core holds alive as a bool
    cont, rays = _jax_cont_and_park(st, depth, monkeypatch)
    assert (~cont[depth >= LAST]).all() and cont.any() and (~cont).any()
    state, tdepth = torch.from_numpy(st.copy()), torch.from_numpy(depth.copy())
    LP.round_tail(LP.LoopState("cpu"), LP.STICKY, state, tdepth, LP.TAIL_FUSED, LAST,
                  k=torch.from_numpy(k), n_pix=n, samples=2)
    np.testing.assert_array_equal(state[12].numpy(), cont.astype(np.float32))
    np.testing.assert_array_equal(state[0:6].numpy().view(np.int32), rays.view(np.int32))
    np.testing.assert_array_equal(tdepth.numpy(), depth + 1)
    np.testing.assert_array_equal(state[6:12].numpy(), st[6:12])


# --- the wrappers' refusals, with stand-in CUDA tensors -------------------------------


class Fake:
    """What the wrappers read of a CUDA tensor: device, dtype, shape,
    contiguity, a row, a pointer."""

    def __init__(self, shape, dtype, device=torch.device("cuda", 0)):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device

    def is_contiguous(self):
        return True

    def __getitem__(self, i):
        return Fake(self.shape[1:], self.dtype, self.device)

    def data_ptr(self):
        return 4096


def _fake_state():
    return types.SimpleNamespace(loop=Fake((LP.N_LOOP,), torch.int64),
                                 preds=Fake((2,), torch.bool),
                                 scratch=Fake((3,), torch.int64))


def _good(n=64):
    return dict(state=Fake((13, n), torch.float32), depth=Fake((n,), torch.int32),
                k=Fake((n,), torch.int64), counter=Fake((), torch.int64))


# case -> (what is changed from a good call, the error's words, the modes that read it)
BAD_TAIL = {
    "state-dtype": ({"state": Fake((13, 64), torch.float64)}, "dtype", "cs"),
    "state-rows": ({"state": Fake((12, 64), torch.float32)}, "shape", "cs"),
    "depth-dtype": ({"depth": Fake((64,), torch.int64)}, "dtype", "cs"),
    "depth-lanes": ({"depth": Fake((63,), torch.int32)}, "shape", "cs"),
    "k-dtype": ({"k": Fake((64,), torch.int32)}, "dtype", "s"),
    "k-missing": ({"k": None}, "k", "s"),
    "counter-shape": ({"counter": Fake((1,), torch.int64)}, "shape", "c"),
    "n-pix-past-32-bits": ({"n_pix": 2**32}, "32 bits", "s"),
    "mode": ({"mode": 2}, "mode", "c"),
    "tail": ({"tail": 3}, "tail", "cs"),
    "scratch": ({"ls.scratch": Fake((2,), torch.int64)}, "shape", "cs"),
}
MODES = {"c": LP.COUNTER, "s": LP.STICKY}


@pytest.fixture
def launched(monkeypatch):
    calls = []
    monkeypatch.setattr(LP, "launch_round_tail", lambda *a: calls.append(a))
    return calls


@pytest.mark.parametrize("bad,mode", [(b, MODES[m]) for b, case in BAD_TAIL.items()
                                      for m in case[2]])
def test_round_tail_refuses_what_the_kernel_cannot_take(launched, bad, mode):
    change, match, _ = BAD_TAIL[bad]
    ins, ls = _good(), _fake_state()
    args = dict(mode=mode, tail=LP.TAIL_FUSED, n_pix=100, samples=2)
    for key, v in change.items():
        if key == "ls.scratch":
            ls.scratch = v
        elif key in ins:
            ins[key] = v
        else:
            args[key] = v
    rest = dict(k=ins["k"], counter=ins["counter"], n_pix=args["n_pix"],
                samples=args["samples"], total=256, thresh=8)
    with pytest.raises(ValueError, match=match):
        LP.round_tail(ls, args["mode"], ins["state"], ins["depth"], args["tail"], LAST, **rest)
    assert not launched
    good = _good()
    LP.round_tail(_fake_state(), mode, good["state"], good["depth"], LP.TAIL_FUSED, LAST,
                  k=good["k"], counter=good["counter"], n_pix=100, samples=2, total=256,
                  thresh=8)
    assert len(launched) == 1


@pytest.mark.parametrize("bad", ["alive-dtype", "kmax-lanes", "kmax-missing", "mode"])
def test_round_test_refuses_what_the_kernel_cannot_take(launched, bad):
    alive, k, kmax = Fake((64,), torch.float32), Fake((64,), torch.int64), Fake((64,),
                                                                                 torch.int64)
    mode = LP.STICKY
    if bad == "alive-dtype":
        alive = Fake((64,), torch.float16)
    elif bad == "kmax-lanes":
        kmax = Fake((65,), torch.int64)
    elif bad == "kmax-missing":
        kmax = None
    else:
        mode = 7
    with pytest.raises(ValueError):
        LP.round_test(_fake_state(), mode, alive=alive, k=k, kmax=kmax)
    assert not launched
    LP.round_test(_fake_state(), LP.STICKY, alive=Fake((64,), torch.float32), k=k,
                  kmax=Fake((64,), torch.int64))
    assert len(launched) == 1


def test_round_tail_refuses_other_devices():
    ls = LP.LoopState("meta")
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="round test"):
        LP.round_tail(ls, LP.COUNTER, torch.zeros((13, 8), device=meta),
                      torch.zeros(8, dtype=torch.int32, device=meta), LP.TAIL_DEPTH, LAST,
                      counter=torch.zeros((), dtype=torch.int64, device=meta), total=8)
