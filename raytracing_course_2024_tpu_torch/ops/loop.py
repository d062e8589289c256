"""The lane loops' round test: the hand-written CUDA kernel N5
(``csrc/loop.cu``) and its plain PyTorch version.

No Pallas kernel computes it. The JAX package runs each lane frame as one
``lax.while_loop`` under ``jax.jit``; its ``cond``, the bounce's path-vertex
sum and the counter refill's ``lax.cond`` predicate
(``raytracing_course_2024_tpu/integrator/wavefront.py:280-316``, ``:516``,
``:528``, ``:593``) are reductions that XLA fuses inside the loop. Here one
launch per round writes them into a frame's ``LoopState``: the (6,) int64
counters ``loop`` (``N_ALIVE``, ``MORE``, ``REFILL``, ``NVERTS``,
``ROUNDS``, ``REFILLS``) and the two bools the next round's IF nodes read
(``more``, ``refill_pred``). Modes (``COUNTER``, ``STICKY``) as
``csrc/loop.cu`` describes them. A round is counted when the test admits
it, so ``ROUNDS`` is the rounds run once the test says stop, and the path
vertices are the lanes that enter each admitted bounce. K5 ends its own
round with the same test (``csrc/persistent.cu``, ``csrc/loop.cuh``);
``k5_round_plain`` is that tail's plain version.

``round_test`` runs the plain version only for tensors on the CPU. On a
CUDA tensor it launches the kernel or raises, and counts the launch in
``ops/kernels.py:LAUNCHES["loop"]``. Counts are integers: the two agree
exactly.
"""

from __future__ import annotations

import torch

from .kernels import check, launch_round_test

COUNTER, STICKY = 0, 1
N_LOOP = 6
N_ALIVE, MORE, REFILL, NVERTS, ROUNDS, REFILLS = range(N_LOOP)


class LoopState:
    """A lane frame's loop control on ``dev``: ``loop`` (6,) int64, the
    IF nodes' predicates ``preds`` (2,) bool (views ``more``,
    ``refill_pred``), and the scratch of N5 and K5 (two partial counts and
    a block ticket), zero between launches."""

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


def round_test(ls: LoopState, mode: int, alive=None, k=None, kmax=None, counter=None,
               total: int = 0, thresh: int = 1) -> None:
    """One loop test (N5): reads the lanes (``alive``, the (b,) f32 alive
    row; ``k``, ``kmax`` (b,) int64 in ``STICKY`` mode; the work
    ``counter``, a 0-dim int64, ``total`` and ``thresh`` in ``COUNTER``
    mode), and updates ``ls`` in place."""
    args = (ls, mode, alive, k, kmax, counter, total, thresh)
    dev = ls.loop.device
    if dev.type == "cpu":
        return round_test_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"no round test kernel for device {dev}")
    if mode not in (COUNTER, STICKY):
        raise ValueError(f"unknown round test mode {mode}")
    check_state(ls, dev)
    b = alive.shape[0]
    check("alive", alive, torch.float32, (b,), dev)
    if mode == STICKY:
        check("k", k, torch.int64, (b,), dev)
        check("kmax", kmax, torch.int64, (b,), dev)
    if mode == COUNTER:
        check("counter", counter, torch.int64, (), dev)
    launch_round_test(mode, alive, k, kmax, b, counter, total, thresh, ls.loop, ls.preds,
                      ls.scratch)


def check_state(ls: LoopState, dev) -> None:
    """Refuses a ``LoopState`` that a kernel cannot write on ``dev``."""
    check("loop", ls.loop, torch.int64, (N_LOOP,), dev)
    check("preds", ls.preds, torch.bool, (2,), dev)
    check("scratch", ls.scratch, torch.int64, (3,), dev)
