"""Counter-based per-work-item RNG, bit-exact with the JAX package's
``ops/rng.py`` (two rounds of the "lowbias32" 32-bit finalizer).

    key_lane = work_key(seed, wid)
    u        = uniform_ctr(key_lane, ctr)     # U[0,1), 24-bit mantissa

torch on the CPU has no ``>>`` for uint32, so the hash runs in int64 with
every intermediate masked to its low 32 bits. Products of two 32-bit
values are split into 16-bit halves so no int64 product overflows.

The same hash is written in ``csrc/bounce.cu`` (``fmix``/``work_key``/
``uniform_ctr``); the kernels and their plain versions therefore see the
same numbers.

Draw layout of the fused-bounce path (one key per (sample, pixel)):

* ``wid = sample_global * n_pix + pixel``, with
  ``sample_global = replica * (spp // replicas) + s``;
* draw ``d`` of bounce ``k`` is ``uniform_ctr(key, k * draws_per_bounce(T) + d)``:
  ``d = 0, 1`` camera jitter (bounce 0 only), ``d = 2 + 7 t + r`` row ``r``
  of mixture candidate ``t < T`` (rows: which, u1, u2, u3..u6 with the
  light pick last), ``d = 2 + 7 T`` the dielectric split, ``d = 3 + 7 T``
  the Russian-roulette draw (modular path only).

The fused kernels and the modular path read the same counters, so the two
routes trace the same paths from the same seed.

The image is therefore independent of batch size and replica count.

Draw layout of the lane engines (``integrator/wavefront.py``), the JAX
package's ``integrator/wavefront.py:57-63``, one key per (sample, pixel):

* ``wid = (samp_base + s) * frame_pix + pix_base + pixel``;
* draws 0, 1 camera jitter; the bounce at the lane's own depth ``d`` starts
  at ``base = 2 + 64 d``: row ``r`` of candidate ``t`` at ``base + r T + t``,
  the roulette draw at ``base + 62``, the dielectric split at ``base + 63``.

A ``Ctr`` says where one bounce's draws sit. The kernels take the same four
numbers (``csrc/common.cuh``: ``Ctr``), so K1, K3 and K5 read either layout.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

_M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
_C1 = 0x7FEB352D
_C2 = 0x846CA68B
_CTR_MUL = 0x85EBCA77
_CTR_ADD = 0x165667B1

CTR_JITTER = 0  # draws 0, 1
CTR_MIX = 2  # first mixture draw
MIX_ROWS = 7

# lane-engine layout: bounce d owns [WF_BOUNCE0 + WF_STRIDE d, ... + WF_STRIDE)
WF_BOUNCE0 = 2
WF_STRIDE = 64
WF_RR = 62
WF_DIEL = 63


def draws_per_bounce(max_tries: int) -> int:
    """Counter stride between bounces: jitter, mixture rows, dielectric,
    roulette."""
    return ctr_rr(max_tries) + 1


def ctr_mix(cand: int, row: int) -> int:
    return CTR_MIX + MIX_ROWS * cand + row


def ctr_diel(max_tries: int) -> int:
    return CTR_MIX + MIX_ROWS * max_tries


def ctr_rr(max_tries: int) -> int:
    return ctr_diel(max_tries) + 1


class Ctr(NamedTuple):
    """Counters of one bounce's draws: row ``r`` of mixture candidate ``t``
    at ``base + t * cand + r * row``; the dielectric split at
    ``base + diel``, the roulette draw at ``base + rr``. ``base`` is an int
    or, in the lane layout, an int64 tensor (one depth per lane)."""

    base: Union[int, torch.Tensor]
    cand: int
    row: int
    diel: int
    rr: int

    def mix(self, t: int, r: int):
        return self.base + t * self.cand + r * self.row

    def at_depth(self, depth: torch.Tensor, stride: int) -> "Ctr":
        """This layout moved by ``stride`` counters per level of each lane's
        ``depth`` (int tensor): what the kernels' ``at_depth`` computes in
        lane mode (``csrc/common.cuh``)."""
        return self._replace(base=self.base + stride * depth.to(torch.int64))


def batch_ctr(ctr_base: int, max_tries: int) -> Ctr:
    """The fused and modular paths' layout of the bounce whose draws start
    at ``ctr_base`` (``bounce_i * draws_per_bounce(max_tries)``)."""
    return Ctr(ctr_base + CTR_MIX, MIX_ROWS, 1, MIX_ROWS * max_tries,
               MIX_ROWS * max_tries + 1)


def lane_ctr(depth, max_tries: int) -> Ctr:
    """The lane engines' layout at per-lane depth ``depth`` (int tensor)."""
    if MIX_ROWS * max_tries >= WF_RR:
        raise ValueError(f"max_tries {max_tries} exceeds the lane engines' counter block")
    if isinstance(depth, torch.Tensor):
        depth = depth.to(torch.int64)
    return Ctr(WF_BOUNCE0 + WF_STRIDE * depth, 1, max_tries, WF_DIEL, WF_RR)


def mixture_rows(key_lane: torch.Tensor, ctr: Ctr, max_tries: int) -> list:
    """The 7 uniform rows of (K*B,), candidate-major, that the XLA
    ``sample_mixture`` takes (the JAX package's ``wavefront.py:167-173``)."""
    return [torch.cat([uniform_ctr(key_lane, ctr.mix(t, r)) for t in range(max_tries)])
            for r in range(MIX_ROWS)]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def work_key(seed, wid: torch.Tensor) -> torch.Tensor:
    """Per-work-item u32 key (held in int64) from a u32 seed and integer
    work ids (negative ids wrap like the JAX package's uint32 cast).
    ``seed`` is an int or a 0-dim integer tensor on ``wid``'s device: a
    tensor is read on the device, so a captured CUDA graph takes the value
    each replay finds there (its low 32 bits, as an int's)."""
    w = _mul32(wid.to(torch.int64) & _M32, _GOLD)
    if isinstance(seed, torch.Tensor):
        return _fmix(w ^ (seed.to(torch.int64) & _M32))
    return _fmix(w ^ (int(seed) & _M32))


def offset_ids(wid: torch.Tensor, wid_off) -> torch.Tensor:
    """``wid + wid_off`` in int64; ``wid_off`` an int or a 0-dim tensor."""
    return wid.to(torch.int64) + (wid_off if isinstance(wid_off, torch.Tensor)
                                  else int(wid_off))


def device_scalar(x, device) -> torch.Tensor:
    """``x`` as a 0-dim int64 tensor on ``device``: a tensor as it is, an
    int by a fill on the device (no host-to-device copy, so it may run
    inside a graph capture, where the value is then fixed)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.full((), int(x), dtype=torch.int64, device=device)


def seed_off(seed, wid_off, dev) -> torch.Tensor:
    """The (2,) int64 device tensor (seed, work-id offset) that K1, K2 and
    K3 read (the low 32 bits of each): the two scalars themselves when they
    are consecutive elements of one int64 tensor (the pair a route owns:
    ``SampleBody.seed_off`` and the lane engines' bodies), which costs no
    launch, else a stack of both (ints: tests and tools only)."""
    if (isinstance(seed, torch.Tensor) and isinstance(wid_off, torch.Tensor)
            and seed.dim() == 0 and seed.dtype == wid_off.dtype == torch.int64
            and seed.untyped_storage().data_ptr() == wid_off.untyped_storage().data_ptr()
            and wid_off.storage_offset() == seed.storage_offset() + 1):
        return seed.as_strided((2,), (1,))
    return torch.stack([device_scalar(seed, dev), device_scalar(wid_off, dev)])


# work ids are 32-bit: past this many (pixel, sample) items of one seed, two
# items would draw the same numbers
WORK_ID_LIMIT = 1 << 32


def check_work_ids(frame_pix: int, samp_base: int, samples: int) -> None:
    """Raises unless every work id of samples ``samp_base`` ..
    ``samp_base + samples - 1`` of a ``frame_pix``-pixel frame
    (``sample * frame_pix + pixel``) fits in 32 bits. Past that, ids wrap and
    two (pixel, sample) items share one uniform stream. A longer render goes
    through ``runtime/checkpoint.py:render_with_checkpoints``, whose chunks
    reseed, so each chunk only has to stay under the limit."""
    if frame_pix * (samp_base + samples) > WORK_ID_LIMIT:
        raise ValueError(
            f"{frame_pix} pixels x (samp_base {samp_base} + {samples} samples) work items "
            f"exceed the 2^32 work ids of one seed; render in chunks with "
            f"runtime/checkpoint.py:render_with_checkpoints, which reseeds each chunk")


def uniform_ctr(key_lane: torch.Tensor, ctr) -> torch.Tensor:
    """One U[0,1) f32 draw per lane at counter ``ctr`` (int or int tensor)."""
    if isinstance(ctr, torch.Tensor):
        c = ctr.to(torch.int64) & _M32
        cm = (_mul32(c, _CTR_MUL) + _CTR_ADD) & _M32
    else:
        cm = ((int(ctr) & _M32) * _CTR_MUL + _CTR_ADD) & _M32
    bits = _fmix(key_lane ^ cm)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
