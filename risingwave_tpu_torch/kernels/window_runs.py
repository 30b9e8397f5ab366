"""The hop-window expansion: a hand-written CUDA kernel beside its plain
PyTorch version.

| core         | replaces (risingwave_tpu/device/fused.py)         |
|--------------|---------------------------------------------------|
| `hop_expand` | `HopNode.apply` :786 (jnp.repeat + arange arithmetic) |

As in the package's `__init__`: the dispatch function sends CUDA tensors
to the kernel (`csrc/window_runs.cu`, bound by `binding.py`) and CPU
tensors to `hop_expand_plain`, with no switch and no fallback, and every
launch adds one to `LAUNCHES["hop_expand"]`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import LAUNCHES, binding


def hop_expand_plain(cols: Sequence[torch.Tensor], time_col: int, hop: int,
                     size: int, pk: Optional[torch.Tensor],
                     sign: torch.Tensor, mask: torch.Tensor):
    """Windowed copies of every row (see `hop_expand`)."""
    n = size // hop
    rows = sign.shape[0]
    dev = sign.device

    def rep(a):
        return torch.repeat_interleave(a, n)
    ts = cols[time_col]
    first = torch.div(ts, hop, rounding_mode="floor") * hop
    k = torch.arange(n, dtype=torch.int64, device=dev).repeat(rows)
    starts = rep(first) - k * hop
    out = [rep(c) for c in cols] + [starts, starts + size]
    new_pk = rep(pk) * n + k if pk is not None else None
    return out, new_pk, rep(sign), rep(mask)


def hop_expand(cols: Sequence[torch.Tensor], time_col: int, hop: int,
               size: int, pk: Optional[torch.Tensor], sign: torch.Tensor,
               mask: torch.Tensor
               ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor],
                          torch.Tensor, torch.Tensor]:
    """HOP / TUMBLE expansion: n = size // hop copies of every row,
    row-major (input row i yields outputs i*n .. i*n+n-1). Returns
    (columns + [window_start, window_end], pk, sign, mask) where, for copy
    k, window_start = floor(ts / hop) * hop - k * hop (floored for
    negative ts too), window_end = window_start + size and pk = pk * n + k
    (wrapping int64; an absent pk stays absent).

    CUDA: one thread per output row writes every column in one pass."""
    if not sign.is_cuda:
        return hop_expand_plain(cols, time_col, hop, size, pk, sign, mask)
    *outs, start, end, new_pk, out_sign, out_mask = binding.hop_expand(
        [c.contiguous() for c in cols], cols[time_col].contiguous(), hop,
        size, size // hop, None if pk is None else pk.contiguous(),
        sign.to(torch.int32).contiguous(), mask.contiguous())
    LAUNCHES["hop_expand"] += 1
    return outs + [start, end], new_pk, out_sign, out_mask
