"""Packed-table gathers (the JAX package's ``ops/gather.py``).

Gatherable tables are stored transposed and packed: one ``(C, N)`` float32
tensor whose rows are scalar attribute columns (``scene/types.py``
``PrimCol``, ``PlaneCol``, ``LightCol``). Integer attributes ride in the
float32 pack, exact up to 2^24.

The JAX package picks select chains, a one-hot einsum or an axis-1 take by
table size, all to dodge TPU relayouts; each returns the table's entries
exactly. On the GPU one ``index_select`` along the column axis computes
the same function.
"""

from __future__ import annotations

import torch


def take_packed(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Columns of a (C, N) pack at ``idx`` (any shape): a (C, *idx.shape)
    tensor whose row ``c`` is attribute ``c`` of each indexed entry."""
    flat = idx.reshape(-1)
    if flat.dtype != torch.int64:
        flat = flat.to(torch.int64)
    return packed.index_select(1, flat).reshape(packed.shape[0], *idx.shape)
