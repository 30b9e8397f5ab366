"""Sorted multiset state — retractable device min/max (PyTorch port of
`risingwave_tpu/device/minput.py`).

Instead of one extreme per group (append-only only), keep every distinct
(group, value) pair with its multiplicity, ordered by (group, value) in
fixed-capacity device tensors. Then

* retraction is exact: deleting the current extreme decrements its count;
  when it hits zero the pair compacts away and the next value — adjacent
  in the sorted run — becomes the extreme;
* the per-group min/max is a `searchsorted` range endpoint, not a scan;
* maintenance per epoch is the sort-merge pattern of `sorted_state.py`.

Floats participate via an order-preserving int64 encoding
(`order_encode_f64`); the host decodes on output.

Three of the four cores (`ms_batch_reduce`, `ms_merge`, `ms_find`) are
dispatch functions in `risingwave_tpu_torch.kernels`: CUDA tensors run
the hand-written kernels, CPU tensors the plain versions.
`ms_group_minmax` is two `torch.searchsorted` calls and clipped gathers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ms_batch_reduce, ms_find, ms_merge  # noqa: F401
from .sorted_state import EMPTY_KEY

_LOW63 = np.int64(0x7FFFFFFFFFFFFFFF)

# device bytes per multiset slot (k1 + k2 + cnt, all int64) — the
# capacity predictor's budget math (AggNode.cap_bytes)
MS_SLOT_BYTES = 24


def order_encode_f64(v: np.ndarray) -> np.ndarray:
    """Monotone float64 -> int64 (numpy): total order of the encoding
    matches the float order (negatives flipped; -0.0 sorts just below 0.0,
    NaN above +inf — the PG sort position)."""
    bits = np.ascontiguousarray(v, dtype=np.float64).view(np.int64)
    return np.where(bits >= 0, bits, bits ^ _LOW63)


def order_decode_f64(k: np.ndarray) -> np.ndarray:
    bits = np.where(k >= 0, k, k ^ _LOW63)
    return np.ascontiguousarray(bits, dtype=np.int64).view(np.float64)


class SortedMultiset(NamedTuple):
    """(k1, k2) pairs sorted lexicographically; cnt > 0 multiplicities.
    Slots >= count hold (EMPTY_KEY, EMPTY_KEY, 0)."""
    k1: torch.Tensor                    # int64 (C,) group key
    k2: torch.Tensor                    # int64 (C,) value (order-encoded)
    count: torch.Tensor                 # int32 scalar
    cnt: torch.Tensor                   # int64 (C,) multiplicity

    @property
    def capacity(self) -> int:
        return self.k1.shape[0]


def ms_make(capacity: int, device) -> SortedMultiset:
    return SortedMultiset(
        torch.full((capacity,), EMPTY_KEY, dtype=torch.int64, device=device),
        torch.full((capacity,), EMPTY_KEY, dtype=torch.int64, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        torch.zeros((capacity,), dtype=torch.int64, device=device))


def ms_grow(ms: SortedMultiset, new_capacity: int) -> SortedMultiset:
    """Re-pad to a larger capacity ((EMPTY_KEY, EMPTY_KEY, 0) tail)."""
    pad = new_capacity - ms.capacity
    if pad < 0:
        raise ValueError(f"ms_grow: {new_capacity} < capacity "
                         f"{ms.capacity}")
    dev = ms.k1.device

    def tail(fill):
        return torch.full((pad,), fill, dtype=torch.int64, device=dev)
    return SortedMultiset(torch.cat([ms.k1, tail(EMPTY_KEY)]),
                          torch.cat([ms.k2, tail(EMPTY_KEY)]), ms.count,
                          torch.cat([ms.cnt, tail(0)]))


def ms_group_minmax(ms: SortedMultiset, groups: torch.Tensor):
    """Per queried group: (found, min value, max value). Groups absent from
    the multiset return found=False (gate on it) — and still the values at
    the clipped range ends, as the reference does, since they flow into
    the change stream's masked slots. k1 is itself sorted because the
    pairs are lexicographic."""
    c = ms.capacity
    lo = torch.searchsorted(ms.k1, groups)
    hi = torch.searchsorted(ms.k1, groups, right=True)
    found = (hi > lo) & (groups != EMPTY_KEY)
    lo_c = torch.clamp(lo, max=c - 1)
    hi_c = torch.clamp(hi - 1, 0, c - 1)
    return found, ms.k2[lo_c], ms.k2[hi_c]
