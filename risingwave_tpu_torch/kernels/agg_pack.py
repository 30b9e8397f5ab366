"""The unpack of the per-operator agg step's packed flags: a hand-written
CUDA kernel beside its plain PyTorch version.

| core         | replaces (risingwave_tpu/device/agg_step.py)          |
|--------------|-------------------------------------------------------|
| `agg_unpack` | `agg_epoch_step_packed` :338 (the unpack of `p8`)      |

`DeviceHashAgg.flush_epoch` ships an epoch's rows as two host matrices:
`p64` (int64 [1 + n, B]: keys, then each call's values) and `p8` (int8
[2 + n, B]: signs, the row mask, then each call's validity). The rows of
`p64` are views. `p8` becomes three tensors — signs int32 [B], mask bool
[B], valid bool [n, B] — which the JAX package's jitted step gets for
free from XLA's fusion and eager torch would make in 2 + n launches.

As in the package's `__init__`: the dispatch function sends CUDA tensors
to the kernel (`csrc/agg_pack.cu`, bound by `binding.py`) and CPU tensors
to `agg_unpack_plain`, with no switch and no fallback, and every launch
adds one to `LAUNCHES["agg_unpack"]`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import LAUNCHES, binding


def agg_unpack_plain(p8: torch.Tensor, n_calls: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(signs int32 [B], mask bool [B], valid bool [n_calls, B]) of a
    packed int8 [2 + n_calls, B] matrix (see `agg_unpack`)."""
    return p8[0].to(torch.int32), p8[1] != 0, p8[2:2 + n_calls] != 0


def agg_unpack(p8: torch.Tensor, n_calls: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unpack the agg step's int8 flag matrix `p8` [2 + n_calls, B]: row 0
    is each row's sign (sign-extended to int32), row 1 its mask, row 2 + i
    call i's validity (both as `!= 0`). Returns (signs, mask, valid) with
    valid [n_calls, B].

    CUDA: one launch; a thread takes four consecutive columns of every
    row, reading each row's four bytes as one 32-bit word where the rows
    are 4-byte aligned (byte loads in the last, partial group and where
    they are not), and writing its four signs as one 16-byte store."""
    if not p8.is_cuda:
        return agg_unpack_plain(p8, n_calls)
    signs, mask, valid = binding.agg_unpack(p8.contiguous(), int(n_calls))
    LAUNCHES["agg_unpack"] += 1
    return signs, mask, valid
