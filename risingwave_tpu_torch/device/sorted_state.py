"""Sorted-run keyed state in device memory + functional epoch-merge ops.

Port of `risingwave_tpu/device/sorted_state.py`: a fixed-capacity,
key-sorted set of (key, payload...) slots. Every op is a function of
tensors with static shapes, so an epoch apply never waits on the host:

    delta rows --batch_reduce--> unique per-key deltas
               --merge--------> new state (+ needed-slot count for resize)
    queries    --lookup-------> gathered payloads

Empty slots hold EMPTY_KEY (int64 max) so they sort past every live key
and binary search stays valid. Capacity growth is host-driven: `merge`
reports how many slots it *needed*; when that exceeds capacity the host
re-pads the old state and re-runs. State tensors are never updated in
place — a snapshot is a reference to the old tensors.

The four sorted-run cores (`sort_cols`, `batch_reduce`, `merge`,
`compact_rows`) are dispatch functions in `risingwave_tpu_torch.kernels`:
CUDA tensors run the hand-written kernels, CPU tensors the plain
PyTorch versions beside them.
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

# RESERVED KEY: int64 max marks padding slots. A key equal to EMPTY_KEY
# would be masked from batch_reduce and dropped by merge; `sanitize_keys`
# remaps raw int64 keys at the push boundary.
EMPTY_KEY = int(np.iinfo(np.int64).max)


def sanitize_keys(keys: np.ndarray) -> np.ndarray:
    """Remap a legitimate key equal to the EMPTY_KEY sentinel to
    EMPTY_KEY-1 (the accepted, documented collision)."""
    keys = np.asarray(keys, dtype=np.int64)
    return np.where(keys == EMPTY_KEY, EMPTY_KEY - 1, keys)


class ReduceKind(enum.IntEnum):
    """How a payload column combines across rows of the same key."""
    SUM = 0      # additive (counts, sums; retraction = sign-weighted add)
    MIN = 1      # append-only min
    MAX = 2      # append-only max
    REPLACE = 3  # newest wins (MV upsert columns; delta overwrites state)


def _neutral(kind: ReduceKind, dtype: torch.dtype):
    """The storage neutral of a column: what empty slots hold."""
    if kind in (ReduceKind.SUM, ReduceKind.REPLACE) or dtype == torch.bool:
        return False if dtype == torch.bool else 0
    if dtype.is_floating_point:
        return float("inf") if kind == ReduceKind.MIN else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == ReduceKind.MIN else info.min


def _combine(kind: ReduceKind, a: torch.Tensor, b: torch.Tensor):
    """a = the state-side row, b = the delta-side row (the stable merge
    keeps state first within an equal-key pair)."""
    if kind == ReduceKind.SUM:
        return a | b if a.dtype == torch.bool else a + b
    if kind == ReduceKind.REPLACE:
        return b
    return torch.minimum(a, b) if kind == ReduceKind.MIN \
        else torch.maximum(a, b)


class SortedState(NamedTuple):
    """keys sorted ascending; slots >= count hold EMPTY_KEY / neutral vals."""
    keys: torch.Tensor                  # int64 (C,)
    count: torch.Tensor                 # int32 scalar — live slots
    vals: Tuple[torch.Tensor, ...]      # each (C,), payload columns

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def make_state(capacity: int, val_dtypes: Sequence[torch.dtype],
               kinds: Sequence[ReduceKind], device) -> SortedState:
    keys = torch.full((capacity,), EMPTY_KEY, dtype=torch.int64,
                      device=device)
    vals = tuple(torch.full((capacity,), _neutral(k, d), dtype=d,
                            device=device)
                 for d, k in zip(val_dtypes, kinds))
    return SortedState(keys, torch.zeros((), dtype=torch.int32,
                                         device=device), vals)


def grow_state(state: SortedState, new_capacity: int,
               kinds: Sequence[ReduceKind]) -> SortedState:
    """Re-pad to a larger capacity; sorted order is preserved because the
    pads are EMPTY_KEY at the tail."""
    c = state.capacity
    if new_capacity < c:
        raise ValueError(f"grow_state: {new_capacity} < capacity {c}")
    pad = new_capacity - c
    dev = state.keys.device
    keys = torch.cat([state.keys, torch.full((pad,), EMPTY_KEY,
                                             dtype=torch.int64, device=dev)])
    vals = tuple(
        torch.cat([v, torch.full((pad,), _neutral(k, v.dtype),
                                 dtype=v.dtype, device=dev)])
        for v, k in zip(state.vals, kinds))
    return SortedState(keys, state.count, vals)


def running_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of an int mask/count vector."""
    return torch.cumsum(x.to(torch.int64), dim=0)


def lookup(state: SortedState, qkeys: torch.Tensor
           ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Binary-search gather. Returns (found[B], vals at match — garbage
    where not found; gate on `found`)."""
    idx = torch.searchsorted(state.keys, qkeys)
    idx = torch.clamp(idx, max=state.capacity - 1)
    found = (state.keys[idx] == qkeys) & (qkeys != EMPTY_KEY)
    return found, tuple(v[idx] for v in state.vals)


from ..kernels import batch_reduce, compact_rows, merge, sort_cols  # noqa: E402,F401
