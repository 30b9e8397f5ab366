"""The four sorted-run cores: hand-written CUDA kernels, each beside its
plain PyTorch version. The three join-side cores (`join_runs.py`), the
three multiset cores (`multiset_runs.py`), the hop-window expansion
(`window_runs.py`), the two key-skew telemetry cores (`skew_runs.py`:
the CRC32 vnode histogram and the packed top-K) and the two
state-tiering cores (`tier_runs.py`: the touch stamp and the tier
partition) follow the same pattern and are re-exported here.

| core           | replaces (risingwave_tpu/device/sorted_state.py) |
|----------------|--------------------------------------------------|
| `sort_cols`    | `sort_cols` :189 (lax.sort)                       |
| `batch_reduce` | `batch_reduce` :108 (sort + segment ops)          |
| `merge`        | `merge` :227 (concat + sort + shifted compare)    |
| `compact_rows` | `compact_rows` :206 (sort on (dead, position))    |

Each dispatch function sends CUDA tensors to its kernel
(`csrc/sorted_runs.cu`, bound by `binding.py`) and CPU tensors to the
`*_plain` version in this module. There is no switch and no fallback: a
failed build or launch raises. The kernels are built from the sources at
first use into `build/torch_kernels/` at the repository root.

Every dispatch that launches a kernel adds one to `LAUNCHES[name]`, so a
run can show that its path went through the kernels.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Sequence, Tuple

import torch

from . import binding

LAUNCHES: Dict[str, int] = {"sort_cols": 0, "batch_reduce": 0, "merge": 0,
                            "compact_rows": 0, "batch_reduce_rows": 0,
                            "merge_side": 0, "probe": 0, "hop_expand": 0,
                            "ms_batch_reduce": 0, "ms_merge": 0,
                            "ms_find": 0, "vnode_hist": 0,
                            "topk_packed": 0, "touch_stamp": 0,
                            "tier_partition": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _ss():
    from ..device import sorted_state
    return sorted_state


def _bits(value: Any, dtype: torch.dtype) -> int:
    """A fill value as the raw 64-bit pattern the kernels store."""
    if dtype == torch.float64:
        return struct.unpack("<q", struct.pack("<d", float(value)))[0]
    if dtype == torch.bool:
        return int(bool(value))
    return int(value)


def _fill_bits(fills: Sequence[Any], cols: Sequence[torch.Tensor]
               ) -> List[int]:
    return [_bits(f, c.dtype) for f, c in zip(fills, cols)]


# ---------------------------------------------------------------------------
# sort_cols
# ---------------------------------------------------------------------------


def sort_cols_plain(keys: Sequence[torch.Tensor],
                    cols: Sequence[torch.Tensor]
                    ) -> Tuple[Tuple[torch.Tensor, ...],
                               Tuple[torch.Tensor, ...]]:
    """Stable sort of payload columns by 1–2 int64 key columns, by
    successive stable sorts from the least significant key."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(list(keys)):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return tuple(k[perm] for k in keys), tuple(c[perm] for c in cols)


def _sort_perm(keys: Sequence[torch.Tensor]):
    if len(keys) not in (1, 2):
        raise ValueError("sort_cols takes one or two key columns")
    k2 = keys[1].contiguous() if len(keys) == 2 else None
    perm, sk = binding.sort_perm(keys[0].contiguous(), k2)
    LAUNCHES["sort_cols"] += 1
    return perm, sk


def sort_cols(keys: Sequence[torch.Tensor], cols: Sequence[torch.Tensor]
              ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Stable sort of payload columns by key columns (equal keys keep
    their input order). CUDA: the one-sweep LSD radix sort kernel (dead
    digits skipped on the device, one launch per live pass), then a
    gather."""
    if not keys[0].is_cuda:
        return sort_cols_plain(keys, cols)
    perm, sk = _sort_perm(keys)
    return ((sk,) + tuple(k[perm] for k in keys[1:]),
            tuple(c[perm] for c in cols))


# ---------------------------------------------------------------------------
# batch_reduce
# ---------------------------------------------------------------------------


def batch_reduce_plain(keys: torch.Tensor, mask: torch.Tensor,
                       vals: Sequence[torch.Tensor], kinds: Sequence[Any]):
    """Pre-reduce a row batch to unique per-key deltas (see
    `batch_reduce`)."""
    ss = _ss()
    empty, kind_t = ss.EMPTY_KEY, ss.ReduceKind
    b = keys.shape[0]
    dev = keys.device
    keys = torch.where(mask, keys, empty)
    vals = [torch.where(mask, v, ss._neutral(k, v.dtype))
            for v, k in zip(vals, kinds)]
    (keys,), vals = sort_cols_plain([keys], vals)
    boundary = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          keys[1:] != keys[:-1]])
    is_last = torch.cat([keys[1:] != keys[:-1],
                         torch.ones(1, dtype=torch.bool, device=dev)])
    seg = ss.running_sum(boundary) - 1
    ukeys = torch.full((b,), empty, dtype=torch.int64, device=dev)
    ukeys[seg] = keys
    live = torch.arange(b, device=dev) <= seg[-1]
    out = []
    for v, k in zip(vals, kinds):
        neutral = ss._neutral(k, v.dtype)
        if k == kind_t.SUM:
            r = torch.zeros(b, dtype=v.dtype, device=dev).index_add_(0, seg, v)
        elif k == kind_t.REPLACE:
            # the last row of a segment is its last arrival (stable sort)
            r = torch.full((b + 1,), neutral, dtype=v.dtype, device=dev)
            r[torch.where(is_last, seg, b)] = v
            r = r[:b]
        else:
            # a bool column as 0 / 1: MIN is AND and MAX is OR, as the
            # reference's (the init never shows: slots of no rows are
            # neutral below)
            iv = v.to(torch.uint8) if v.dtype == torch.bool else v
            init = (torch.iinfo(iv.dtype).max if kind_t(k) == kind_t.MIN
                    else torch.iinfo(iv.dtype).min) \
                if not iv.dtype.is_floating_point else neutral
            r = torch.full((b,), init, dtype=iv.dtype, device=dev)
            r = r.scatter_reduce(0, seg, iv, "amin" if k == kind_t.MIN
                                 else "amax").to(v.dtype)
        r = torch.where(live, r, neutral)
        out.append(torch.where(ukeys == empty, neutral, r))
    ucount = torch.sum(boundary & (keys != empty)).to(torch.int32)
    return ukeys, tuple(out), ucount


def batch_reduce(keys: torch.Tensor, mask: torch.Tensor,
                 vals: Sequence[torch.Tensor], kinds: Sequence[Any]
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...],
                            torch.Tensor]:
    """Pre-reduce a row batch to unique per-key deltas.

    Masked-out rows are neutralized (key -> EMPTY_KEY). Returns
    (ukeys[B], uvals[B each], ucount) where only the first `ucount` slots
    are live; the rest are EMPTY_KEY with neutral values. Output is
    key-sorted; REPLACE takes the last arrival of each key. CUDA: the
    radix sort kernel, then the tiled segmented reduce: each tile of
    sorted rows reduces its runs and joins those that cross its threads
    by a block scan, and a second launch joins the segments that cross
    tiles, in tile order (an order fixed by B, so a float SUM is
    deterministic)."""
    if not keys.is_cuda:
        return batch_reduce_plain(keys, mask, vals, kinds)
    ss = _ss()
    mk = torch.where(mask, keys, ss.EMPTY_KEY)
    perm, sk = _sort_perm([mk])
    vals = [v.contiguous() for v in vals]
    fills = [_bits(ss._neutral(k, v.dtype), v.dtype)
             for v, k in zip(vals, kinds)]
    ukeys, ucount, *outs = binding.batch_reduce(
        sk, perm, vals, [int(k) for k in kinds], fills)
    LAUNCHES["batch_reduce"] += 1
    return ukeys, tuple(outs), ucount


# ---------------------------------------------------------------------------
# compact_rows
# ---------------------------------------------------------------------------


def compact_rows_plain(alive: torch.Tensor, keys: Sequence[torch.Tensor],
                       cols: Sequence[torch.Tensor], out_len: int,
                       fills: Sequence[Any]) -> Tuple[torch.Tensor, ...]:
    """Stable compaction of alive rows to the front (see `compact_rows`)."""
    n = alive.shape[0]
    pos = torch.arange(n, device=alive.device)
    rank = torch.where(alive, 0, n) + pos
    idx = torch.sort(rank).indices[:out_len]
    return tuple(torch.where(alive, a, f)[idx]
                 for a, f in zip(list(keys) + list(cols), fills))


def _compact(alive: torch.Tensor, cols: List[torch.Tensor], out_len: int,
             fills: Sequence[Any]):
    alive = alive.contiguous()
    if alive.shape[0] == 0:
        return (tuple(c[:0] for c in cols),
                torch.zeros((), dtype=torch.int32, device=alive.device))
    cols = [c.contiguous() for c in cols]
    *out, total = binding.compact_rows(alive, cols, int(out_len),
                                       _fill_bits(fills, cols))
    LAUNCHES["compact_rows"] += 1
    return tuple(out), total


def compact_rows(alive: torch.Tensor, keys: Sequence[torch.Tensor],
                 cols: Sequence[torch.Tensor], out_len: int,
                 fills: Sequence[Any]) -> Tuple[torch.Tensor, ...]:
    """Stable compaction of alive rows to the front, dead rows replaced by
    `fills`, result truncated to out_len. Row order among alive rows is
    preserved, so key-sorted input stays key-sorted. CUDA: a three-phase
    block scan of `alive` (tile sums, scan of the sums, tile scan plus
    offset) places each alive row; the tail gets the fills."""
    if not alive.is_cuda:
        return compact_rows_plain(alive, keys, cols, out_len, fills)
    out, _ = _compact(alive, list(keys) + list(cols), out_len, fills)
    return out


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


def check_delta_order(dkeys: torch.Tensor) -> None:
    """Raise unless `dkeys` is in `batch_reduce`'s order: unique keys
    ascending, then EMPTY_KEY padding to the end. Reads the tensor, so
    only the plain version calls it."""
    empty = _ss().EMPTY_KEY
    ok = (dkeys[1:] > dkeys[:-1]) | ((dkeys[1:] == empty)
                                     & (dkeys[:-1] == empty))
    if not bool(torch.all(ok)):
        raise ValueError("merge: delta keys must be unique and ascending "
                         "with EMPTY_KEY padding only at the tail")


def merge_plain(state, dkeys: torch.Tensor, dvals: Sequence[torch.Tensor],
                kinds: Sequence[Any], drop_dead: bool = True,
                dead_col: int = 0):
    """Merge unique per-key deltas into the state (see `merge`), placing
    rows by position as the kernel does; raises on a delta out of
    order."""
    check_delta_order(dkeys)
    ss = _ss()
    c = state.capacity
    b = dkeys.shape[0]
    dev = dkeys.device
    # state row i lands after the delta keys below it, delta row j after
    # the state keys at or below it: the state row comes first on a tie
    ps = torch.arange(c, device=dev) + torch.searchsorted(dkeys, state.keys)
    pd = torch.arange(b, device=dev) + torch.searchsorted(
        state.keys, dkeys, right=True)

    def place(sv, dv):
        out = torch.empty(c + b, dtype=sv.dtype, device=dev)
        out[ps] = sv
        out[pd] = dv.to(sv.dtype)
        return out

    keys = place(state.keys, dkeys)
    vals = [place(sv, dv) for sv, dv in zip(state.vals, dvals)]
    false = torch.zeros(1, dtype=torch.bool, device=dev)
    same_next = torch.cat([keys[:-1] == keys[1:], false])
    same_prev = torch.cat([false, keys[1:] == keys[:-1]])
    merged = []
    for v, k in zip(vals, kinds):
        nxt = torch.cat([v[1:], v[-1:]])
        merged.append(torch.where(same_next, ss._combine(k, v, nxt), v))
    alive = ~same_prev & (keys != ss.EMPTY_KEY)
    if drop_dead:
        alive &= merged[dead_col] != 0
    needed = torch.sum(alive).to(torch.int32)
    out = compact_rows_plain(alive, [keys], merged, c,
                             [ss.EMPTY_KEY] + [ss._neutral(k, v.dtype)
                                               for v, k in zip(merged, kinds)])
    new_count = torch.clamp(needed, max=c)
    return ss.SortedState(out[0], new_count, tuple(out[1:])), needed


def merge(state, dkeys: torch.Tensor, dvals: Sequence[torch.Tensor],
          kinds: Sequence[Any], drop_dead: bool = True, dead_col: int = 0):
    """Merge unique per-key deltas (from `batch_reduce`) into the state.

    Every key appears at most once in `state` and at most once in the
    delta, so after the stable merge (state side first on ties) each key
    forms a run of length <= 2, combined by one shifted compare. With
    `drop_dead`, rows whose combined `dead_col` payload hits 0 are
    dropped. Returns (new_state, needed) — `needed` > capacity means the
    merge was truncated and must be retried on a grown state.

    `dkeys` must be in `batch_reduce`'s order: unique, ascending, with
    EMPTY_KEY padding only at the tail (the reference re-sorts any
    order). Both runs being sorted, nothing is re-sorted: each row's
    merged position comes from a binary search of the other run. The
    plain version raises on a delta out of order; the kernel does not
    check (that would read the device), so a caller's order is proven on
    the CPU.

    CUDA: the combine kernel places the rows and writes the merged
    columns and alive flags, and the compact_rows kernel packs them into
    the capacity."""
    if not state.keys.is_cuda:
        return merge_plain(state, dkeys, dvals, kinds, drop_dead, dead_col)
    ss = _ss()
    c = state.capacity
    svals = [v.contiguous() for v in state.vals]
    dvals = [dv.to(sv.dtype).contiguous() for sv, dv in zip(svals, dvals)]
    mk, alive, *merged = binding.merge_combine(
        state.keys.contiguous(), svals, dkeys.contiguous(), dvals,
        [int(k) for k in kinds], bool(drop_dead), int(dead_col))
    LAUNCHES["merge"] += 1
    fills = [ss.EMPTY_KEY] + [ss._neutral(k, v.dtype)
                              for v, k in zip(merged, kinds)]
    out, needed = _compact(alive, [mk] + merged, c, fills)
    new_count = torch.clamp(needed, max=c)
    return ss.SortedState(out[0], new_count, tuple(out[1:])), needed


from .join_runs import (batch_reduce_rows, batch_reduce_rows_plain,  # noqa: E402,F401
                        check_side_order, merge_side, merge_side_plain,
                        probe, probe_plain)
from .multiset_runs import (ms_batch_reduce, ms_batch_reduce_plain,  # noqa: E402,F401
                            ms_find, ms_find_plain, ms_merge, ms_merge_plain)
from .window_runs import hop_expand, hop_expand_plain  # noqa: E402,F401
from .skew_runs import (topk_packed, topk_packed_plain, vnode_hist,  # noqa: E402,F401
                        vnode_hist_plain)
from .tier_runs import (tier_partition, tier_partition_plain,  # noqa: E402,F401
                        touch_stamp, touch_stamp_plain)
