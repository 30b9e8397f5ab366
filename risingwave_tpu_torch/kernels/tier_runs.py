"""The state-tiering cores: hand-written CUDA kernels, each beside its
plain PyTorch version.

| core             | replaces (risingwave_tpu/device/fused.py)               |
|------------------|---------------------------------------------------------|
| `touch_stamp`    | `AggNode._tier_tail` :1186, the join touch tail :1584-1605, the promote cores' touch carry :1852-1860, :1891-1898 (searchsorted + where + sum) |
| `tier_partition` | the membership searchsorted and the `compact_rows` passes of `_agg_evict_core` :1758, `_mv_evict_core` :1788, `_join_evict_core` :1809 |

As in the package's `__init__`: each dispatch function sends CUDA tensors
to its kernel (`csrc/tier_runs.cu`, bound by `binding.py`) and CPU
tensors to the `*_plain` version, with no switch and no fallback, and
every launch adds one to `LAUNCHES[name]`.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from . import LAUNCHES, _fill_bits, binding, compact_rows_plain


def _empty() -> int:
    from ..device.sorted_state import EMPTY_KEY
    return EMPTY_KEY


def _first_at(sorted_keys: torch.Tensor, keys: torch.Tensor):
    """(found, index): the lower bound of each key in `sorted_keys`,
    clipped into range, and whether the key sits there (the reference's
    clip(searchsorted(...)) then an equality test)."""
    m = sorted_keys.shape[0]
    if m == 0:
        return (torch.zeros(keys.shape, dtype=torch.bool, device=keys.device),
                torch.zeros(keys.shape, dtype=torch.int64,
                            device=keys.device))
    idx = torch.clamp(torch.searchsorted(sorted_keys, keys), 0, m - 1)
    return sorted_keys[idx] == keys, idx


# ---------------------------------------------------------------------------
# touch_stamp
# ---------------------------------------------------------------------------


def touch_stamp_plain(keys: torch.Tensor, old_keys: torch.Tensor,
                      old_touch: torch.Tensor, src_keys: torch.Tensor,
                      src_vals: Optional[torch.Tensor], tick: torch.Tensor,
                      ttl: int, empty_key: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Touch stamps and (live, cold) counts (see `touch_stamp`)."""
    ofound, oidx = _first_at(old_keys, keys)
    carried = torch.where(ofound, old_touch[oidx] if old_keys.shape[0]
                          else torch.zeros_like(keys), 0)
    hit, sidx = _first_at(src_keys, keys)
    live = keys != empty_key
    if src_vals is None:
        stamp = torch.where(hit, tick, carried)
    else:
        pv = src_vals[sidx] if src_keys.shape[0] else torch.zeros_like(keys)
        stamp = torch.where(ofound, carried, torch.where(hit, pv, 0))
    stamp = torch.where(live, stamp, 0)
    counts = torch.stack([torch.sum(live, dtype=torch.int64),
                          torch.sum(live & (tick - stamp >= ttl),
                                    dtype=torch.int64)])
    return stamp, counts


def touch_stamp(keys: torch.Tensor, old_keys: torch.Tensor,
                old_touch: torch.Tensor, src_keys: torch.Tensor,
                src_vals: Optional[torch.Tensor], tick: torch.Tensor,
                ttl: int, empty_key: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One last-touched-epoch stamp per row of the new key table `keys`,
    and its int64 (live, cold) counts: rows whose key is not `empty_key`,
    and those of them with `tick - stamp >= ttl`.

    A row carries the stamp of the first row of `old_keys` (the table
    before the merge, sorted; its stamps `old_touch`) with the same key,
    else 0 — the first, since a join side holds many rows per key. With
    `src_vals` None (the epoch's stamp) a key found in `src_keys` (the
    sorted keys the epoch touched) takes `tick` instead. With `src_vals`
    (promotion) a key found in `src_keys` (the promoted keys, sorted)
    takes its promoted stamp only where the old table has none. Rows of
    `empty_key` get 0. `tick` is a 0-d int64 tensor. `keys`, `old_keys`
    and `src_keys` are each sorted ascending, `empty_key` only at the
    tail. Neither version checks that order (the callers sort; the tests
    hold every call of the fused paths to it).

    CUDA: one merge-path pass over the three sorted runs — a launch cuts
    their merged order into tiles by co-rank searches, then each block
    merges its tile's new, old and touched keys in shared memory, writes
    the stamps, and adds its (live, cold) counts with one 64-bit atomic
    pair (integer adds: the result does not depend on their order)."""
    if empty_key is None:
        empty_key = _empty()
    if not keys.is_cuda:
        return touch_stamp_plain(keys, old_keys, old_touch, src_keys,
                                 src_vals, tick, ttl, empty_key)
    out = binding.touch_stamp(
        keys.contiguous(), old_keys.contiguous(), old_touch.contiguous(),
        src_keys.contiguous(),
        None if src_vals is None else src_vals.contiguous(), tick, ttl,
        empty_key)
    LAUNCHES["touch_stamp"] += 1
    return out


# ---------------------------------------------------------------------------
# tier_partition
# ---------------------------------------------------------------------------


def tier_partition_plain(keys: torch.Tensor, cols: Sequence[torch.Tensor],
                         fills: Sequence[Any], dkeys: torch.Tensor,
                         hits: bool, empty_key: int):
    """Membership by searchsorted, then `compact_rows` of the kept rows
    and, with `hits`, of the hit rows (see `tier_partition`)."""
    n = keys.shape[0]
    found, _ = _first_at(dkeys, keys)
    hit = found & (keys != empty_key)
    alive = (keys != empty_key) & ~hit
    kept = compact_rows_plain(alive, [], cols, n, fills)
    gone = compact_rows_plain(hit, [], cols, n, fills) if hits else ()
    counts = torch.stack([torch.sum(alive), torch.sum(hit)]).to(torch.int32)
    return tuple(kept), tuple(gone), counts


def tier_partition(keys: torch.Tensor, cols: Sequence[torch.Tensor],
                   fills: Sequence[Any], dkeys: torch.Tensor,
                   hits: bool = False, empty_key: Optional[int] = None):
    """Split a key table by membership in `dkeys` (sorted, `empty_key`
    padded): -> (kept columns, hit columns — empty without `hits` —,
    int32 (kept, hits) counts).

    A row is a hit when its key (`keys`, one of `cols`) is not
    `empty_key` and is in `dkeys`; it is kept when its key is not
    `empty_key` and it is not a hit. Every column of `cols` keeps the
    table's length: the kept rows go to the front in their order, then
    `fills`; with `hits`, the hit rows likewise to a second set of
    columns.

    CUDA: one three-phase scan over a packed int64 flag (1 for a kept
    row, 2^32 for a hit) ranks every row in both prefixes at once, and
    one fill kernel writes the tails."""
    if empty_key is None:
        empty_key = _empty()
    if not keys.is_cuda:
        return tier_partition_plain(keys, cols, fills, dkeys, hits,
                                    empty_key)
    cols = [c.contiguous() for c in cols]
    kept, gone, counts = binding.tier_partition(
        keys.contiguous(), cols, _fill_bits(fills, cols),
        dkeys.contiguous(), hits, empty_key)
    LAUNCHES["tier_partition"] += 1
    return tuple(kept), tuple(gone), counts
