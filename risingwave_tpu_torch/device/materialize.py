"""Device-resident materialized-view table (PyTorch port of
`risingwave_tpu/device/materialize.py`).

An upsert table keyed by the MV primary key, living in device memory as a
SortedState whose payload columns use REPLACE semantics (newest write
wins). Consuming an agg change set never leaves the device: upserts come
from `new_found` rows, deletes from `old_found & ~new_found`; the host
pulls the MV only to serve a query.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .sorted_state import (EMPTY_KEY, ReduceKind, SortedState, compact_rows,
                           make_state, merge)


def make_mv_state(capacity: int, col_dtypes: Sequence[torch.dtype],
                  device) -> SortedState:
    """Payload col 0 = liveness (REPLACE, int32 0/1); then the MV columns,
    each paired with a REPLACE null flag."""
    dtypes = [torch.int32]
    for d in col_dtypes:
        dtypes += [d, torch.bool]
    return make_state(capacity, dtypes, [ReduceKind.REPLACE] * len(dtypes),
                      device)


def mv_kinds(n_cols: int):
    return tuple([ReduceKind.REPLACE] * (1 + 2 * n_cols))


def mv_apply_changes(state: SortedState, keys: torch.Tensor,
                     upsert: torch.Tensor, delete: torch.Tensor,
                     cols: Sequence[torch.Tensor],
                     nulls: Sequence[torch.Tensor]
                     ) -> Tuple[SortedState, torch.Tensor]:
    """Apply a change set (unique keys in ascending order, EMPTY_KEY
    padded — `batch_reduce` order) to the MV.

    upsert/delete are disjoint bool masks over keys; rows with neither are
    no-ops. The reference forces their keys to EMPTY in place, which
    leaves EMPTY holes inside the sorted run; here the touched rows are
    compacted to a sorted prefix instead, because `merge` on the device
    merges two sorted runs without re-sorting. The merged state is the
    same: EMPTY rows never survive a merge.
    """
    kinds = mv_kinds(len(cols))
    touched = upsert | delete
    live = upsert.to(torch.int32)  # delete -> 0 -> compacted away
    dvals = [live]
    for c, nl in zip(cols, nulls):
        dvals += [c.to(state.vals[len(dvals)].dtype), nl]
    dkeys, *dvals = compact_rows(touched, [keys], dvals, keys.shape[0],
                                 [EMPTY_KEY, 0] + [0, False] * len(cols))
    return merge(state, dkeys, dvals, kinds, drop_dead=True, dead_col=0)


def mv_rows(state: SortedState, col_dtypes: Sequence
            ) -> Tuple[np.ndarray, list, list]:
    """Host pull of the MV (query serving): (keys, cols, null masks)."""
    n = int(state.count)
    n_cols = len(col_dtypes)
    keys = state.keys[:n].cpu().numpy()
    cols = [state.vals[1 + 2 * i][:n].cpu().numpy() for i in range(n_cols)]
    nulls = [state.vals[2 + 2 * i][:n].cpu().numpy() for i in range(n_cols)]
    return keys, cols, nulls
