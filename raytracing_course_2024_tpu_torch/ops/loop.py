"""The lane round's tail and the loop test: the hand-written CUDA kernel
N5 (``csrc/loop.cu``) and its plain PyTorch version.

No Pallas kernel computes it. The JAX package runs each lane frame as one
``lax.while_loop`` under ``jax.jit``; the end of its body (the fused core's
final-depth cap and ``park``, the depth step:
``raytracing_course_2024_tpu/integrator/wavefront.py:122-127``,
``:141-142``, ``:291``, ``:513``), its ``cond``, the bounce's path-vertex
sum and the counter refill's ``lax.cond`` predicate (``:280-316``,
``:516``, ``:528``, ``:593``) are element-wise work and reductions that XLA
fuses inside the loop. Here one launch per round does the tail and writes
the test into a frame's ``LoopState``: the (6,) int64 counters ``loop``
(``N_ALIVE``, ``MORE``, ``REFILL``, ``NVERTS``, ``ROUNDS``, ``REFILLS``)
and the two bools the next round's IF nodes read (``more``,
``refill_pred``). Tails (``TAIL_NONE``, ``TAIL_DEPTH``, ``TAIL_FUSED``) and
modes (``COUNTER``, ``STICKY``) as ``csrc/loop.cu`` describes them. A round
is counted when the test admits it, so ``ROUNDS`` is the rounds run once
the test says stop, and the path vertices are the lanes that enter each
admitted bounce. K5 ends its own round with the same test
(``csrc/persistent.cu``, ``csrc/loop.cuh``); ``k5_round_plain`` is that
tail's plain version.

``round_tail`` and ``round_test`` (the test alone, on a given alive row and
``kmax``) run the plain version only for tensors on the CPU. On a CUDA
tensor they launch the kernel or raise, and count the launch in
``ops/kernels.py:LAUNCHES["loop"]``. The tail moves values and the test
counts integers: the two agree exactly.
"""

from __future__ import annotations

import torch

from .kernels import check, launch_round_tail
from .refill import sticky_kmax
from .shade import N_STATE, park

COUNTER, STICKY = 0, 1
TAIL_NONE, TAIL_DEPTH, TAIL_FUSED = 0, 1, 2
N_LOOP = 6
N_ALIVE, MORE, REFILL, NVERTS, ROUNDS, REFILLS = range(N_LOOP)


class LoopState:
    """A lane frame's loop control on ``dev``: ``loop`` (6,) int64, the
    IF nodes' predicates ``preds`` (2,) bool (views ``more``,
    ``refill_pred``), and the scratch of N5 and K5 (K5's two partial counts
    and its block ticket; N5's count and ticket in one word, the third),
    zero between launches."""

    def __init__(self, dev):
        self.loop = torch.zeros((N_LOOP,), dtype=torch.int64, device=dev)
        self.preds = torch.zeros((2,), dtype=torch.bool, device=dev)
        self.more, self.refill_pred = self.preds[0], self.preds[1]
        self.scratch = torch.zeros((3,), dtype=torch.int64, device=dev)

    def reset(self) -> None:
        self.loop.zero_()
        self.preds.zero_()


def _write_round(ls: LoopState, n, more, refill, verts) -> None:
    """``csrc/loop.cuh:write_round`` on tensors."""
    loop = ls.loop
    loop[N_ALIVE] = n
    loop[MORE] = more
    loop[REFILL] = refill
    loop[NVERTS] += verts
    loop[ROUNDS] += more
    loop[REFILLS] += refill
    ls.preds[0] = more
    ls.preds[1] = refill


def round_test_plain(ls: LoopState, mode: int, alive=None, k=None, kmax=None, counter=None,
                     total: int = 0, thresh: int = 1) -> None:
    """Plain version of ``round_test``: the same outputs from ATen ops on
    the device, reading nothing from the host."""
    on = alive > 0.5
    if mode == STICKY:
        on = on | (k < kmax)
    n = on.sum()
    if mode == COUNTER:
        dead = alive.shape[0] - n
        more = (counter < total) | (n > 0)
        refill = more & (dead >= thresh)
        enter = n + torch.where(refill, torch.minimum(dead, total - counter), 0)
    else:
        more, refill, enter = n > 0, torch.zeros_like(n > 0), n
    _write_round(ls, n, more, refill, torch.where(more, enter, 0))


def k5_round_plain(ls: LoopState, live, left) -> None:
    """Plain version of the round test that ends a K5 round: ``live``
    lanes alive after the restart go to the path vertices, ``left`` lanes
    alive or with paths left are the loop's ``n``, and another round runs
    while there are any. 0-dim tensors or ints."""
    live = torch.as_tensor(live, dtype=torch.int64, device=ls.loop.device)
    n = torch.as_tensor(left, dtype=torch.int64, device=ls.loop.device)
    more = n > 0
    _write_round(ls, n, more, torch.zeros_like(more), live)


def round_tail_plain(ls: LoopState, mode: int, state, depth=None, tail: int = TAIL_NONE,
                     last: int = 0, k=None, n_pix: int = 0, samples: int = 0, counter=None,
                     total: int = 0, thresh: int = 1) -> None:
    """Plain version of ``round_tail``: the ATen steps the kernel fuses, on
    the same tensors: ``park`` with the final-depth cap (``TAIL_FUSED``),
    the depth step (``TAIL_DEPTH`` and ``TAIL_FUSED``), then
    ``round_test_plain`` on the alive row, ``kmax`` from ``sticky_kmax``."""
    if tail == TAIL_FUSED:
        park(state, (state[12] > 0.5) & (depth < last))
    if tail != TAIL_NONE:
        depth += 1
    kmax = sticky_kmax(state.shape[1], n_pix, samples, state.device) if mode == STICKY else None
    round_test_plain(ls, mode, alive=state[12], k=k, kmax=kmax, counter=counter, total=total,
                     thresh=thresh)


def round_tail(ls: LoopState, mode: int, state, depth=None, tail: int = TAIL_NONE,
               last: int = 0, k=None, n_pix: int = 0, samples: int = 0, counter=None,
               total: int = 0, thresh: int = 1) -> None:
    """One lane round's tail and loop test (N5): ``state`` the (13, b) f32
    path state, ``depth`` the lanes' (b,) int32 depths (``TAIL_DEPTH``,
    ``TAIL_FUSED``), ``last`` the final depth (``TAIL_FUSED``); in
    ``STICKY`` mode ``k`` (b,) int64 and the frame's ``n_pix`` and
    ``samples``, from which each lane's ``kmax`` follows
    (``ops/refill.py:sticky_kmax``; the kernel computes it from the lane
    index); in ``COUNTER`` mode the work ``counter``, a 0-dim int64,
    ``total`` and ``thresh``. Updates ``state``, ``depth`` and ``ls`` in
    place."""
    args = (ls, mode, state, depth, tail, last, k, n_pix, samples, counter, total, thresh)
    dev = ls.loop.device
    if dev.type == "cpu":
        return round_tail_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"no round test kernel for device {dev}")
    if tail not in (TAIL_NONE, TAIL_DEPTH, TAIL_FUSED):
        raise ValueError(f"unknown round tail {tail}")
    b = state.shape[1]
    check("state", state, torch.float32, (N_STATE, b), dev)
    if tail != TAIL_NONE:
        check("depth", depth, torch.int32, (b,), dev)
    _check_test(ls, mode, dev, b, k, counter)
    if mode == STICKY and not (0 <= n_pix < 2**32 and 0 <= samples < 2**32):
        raise ValueError(f"n_pix {n_pix} and samples {samples} must fit 32 bits")
    launch_round_tail(mode, tail, state if tail == TAIL_FUSED else None, state[12],
                      None if tail == TAIL_NONE else depth, k, None, b, n_pix, samples, last,
                      counter, total, thresh, ls.loop, ls.preds, ls.scratch)


def round_test(ls: LoopState, mode: int, alive=None, k=None, kmax=None, counter=None,
               total: int = 0, thresh: int = 1) -> None:
    """The loop test alone (N5, no tail): reads the lanes (``alive``, the
    (b,) f32 alive row; ``k``, ``kmax`` (b,) int64 in ``STICKY`` mode, both
    read from memory; the work ``counter``, a 0-dim int64, ``total`` and
    ``thresh`` in ``COUNTER`` mode), and updates ``ls`` in place."""
    args = (ls, mode, alive, k, kmax, counter, total, thresh)
    dev = ls.loop.device
    if dev.type == "cpu":
        return round_test_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"no round test kernel for device {dev}")
    b = alive.shape[0]
    check("alive", alive, torch.float32, (b,), dev)
    _check_test(ls, mode, dev, b, k, counter)
    if mode == STICKY:
        _present("kmax", kmax)
        check("kmax", kmax, torch.int64, (b,), dev)
    launch_round_tail(mode, TAIL_NONE, None, alive, None, k, kmax, b, 0, 0, 0, counter, total,
                      thresh, ls.loop, ls.preds, ls.scratch)


def _check_test(ls: LoopState, mode: int, dev, b: int, k, counter) -> None:
    """Refuses what the test of ``mode`` cannot read on ``dev``."""
    if mode not in (COUNTER, STICKY):
        raise ValueError(f"unknown round test mode {mode}")
    check_state(ls, dev)
    if mode == STICKY:
        _present("k", k)
        check("k", k, torch.int64, (b,), dev)
    else:
        _present("counter", counter)
        check("counter", counter, torch.int64, (), dev)


def _present(name: str, t) -> None:
    if t is None:
        raise ValueError(f"the round test reads {name}: none given")


def check_state(ls: LoopState, dev) -> None:
    """Refuses a ``LoopState`` that a kernel cannot write on ``dev``."""
    check("loop", ls.loop, torch.int64, (N_LOOP,), dev)
    check("preds", ls.preds, torch.bool, (2,), dev)
    check("scratch", ls.scratch, torch.int64, (3,), dev)
