"""The three join-side cores: hand-written CUDA kernels, each beside its
plain PyTorch version.

| core                | replaces (risingwave_tpu/device/join_step.py) |
|---------------------|-----------------------------------------------|
| `batch_reduce_rows` | `batch_reduce_rows` :57 (two-key sort + segment ops) |
| `merge_side`        | `merge_side` :83 (concat + sort + presence combine)  |
| `probe`             | `probe` :118 (searchsorted + cumsum expansion)       |

As in the package's `__init__`: each dispatch function sends CUDA
tensors to its kernel (`csrc/join_runs.cu`, bound by `binding.py`) and
CPU tensors to the `*_plain` version here, with no switch and no
fallback, and every launch adds one to `LAUNCHES[name]`.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import (LAUNCHES, _sort_perm, binding, compact_rows_plain,
               sort_cols_plain)


def _empty() -> int:
    from ..device.sorted_state import EMPTY_KEY
    return EMPTY_KEY


def _join_side():
    from ..device.join_step import JoinSide
    return JoinSide


# ---------------------------------------------------------------------------
# batch_reduce_rows
# ---------------------------------------------------------------------------


def batch_reduce_rows_plain(jk: torch.Tensor, pk: torch.Tensor,
                            signs: torch.Tensor, mask: torch.Tensor,
                            vals: Sequence[torch.Tensor]):
    """Unique (jk, pk) deltas (see `batch_reduce_rows`)."""
    empty = _empty()
    b = jk.shape[0]
    dev = jk.device
    jk = torch.where(mask, jk, empty)
    pk = torch.where(mask, pk, empty)
    signs = torch.where(mask, signs, 0)
    (jk, pk), out = sort_cols_plain([jk, pk], [signs] + list(vals))
    signs, vals = out[0], out[1:]
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      (jk[1:] == jk[:-1]) & (pk[1:] == pk[:-1])])
    seg = torch.cumsum((~same).to(torch.int64), 0) - 1
    usign = torch.zeros(b, dtype=torch.int32, device=dev).index_add_(
        0, seg, signs.to(torch.int32))
    ujk = torch.full((b,), empty, dtype=torch.int64, device=dev)
    ujk[seg] = jk
    upk = torch.full((b,), empty, dtype=torch.int64, device=dev)
    upk[seg] = pk
    # the last arrival of each segment (stable sort: its last row); the
    # masked segment and the slots past the last segment take row 0
    arrival = torch.where(jk != empty, torch.arange(b, device=dev), -1)
    last = torch.full((b,), torch.iinfo(torch.int64).min, dtype=torch.int64,
                      device=dev).scatter_reduce(0, seg, arrival, "amax")
    src = torch.clamp(last, min=0)
    uvals = tuple(v[src] for v in vals)
    usign = torch.where(ujk != empty, usign, 0)
    return ujk, upk, usign, uvals


def batch_reduce_rows(jk: torch.Tensor, pk: torch.Tensor,
                      signs: torch.Tensor, mask: torch.Tensor,
                      vals: Sequence[torch.Tensor]):
    """Unique (jk, pk) deltas of a masked row batch: the net sign (int32
    sum) and the payload of the key's last arrival. Returns (ujk, upk,
    usign, uvals), (jk, pk)-sorted with EMPTY_KEY padding; a key whose
    signs net to 0 stays live with sign 0 (merge_side drops it).

    Padding is not neutral: the slots past the last key, and the segment
    of masked rows, carry the payload of the first sorted row, as the
    reference's `segment_max` gather gives them.

    CUDA: the two-key radix sort kernel, then the tiled segmented reduce
    of `batch_reduce` in its two-key form (the pk read through the sort's
    permutation): a tile pass that finds the (jk, pk) boundaries, ids the
    segments by decoupled look-back, sums the signs (int32, wrapping) and
    notes each segment's last arrival; a pass that joins the sums of
    segments crossing tiles and pads; and a gather of the payload columns
    one after another through those last arrivals."""
    if not jk.is_cuda:
        return batch_reduce_rows_plain(jk, pk, signs, mask, vals)
    empty = _empty()
    mjk = torch.where(mask, jk, empty)
    mpk = torch.where(mask, pk, empty)
    perm, sk = _sort_perm([mjk, mpk])
    # a masked row's sign needs no zeroing: its (EMPTY_KEY, EMPTY_KEY)
    # segment is past the live ones, and those slots get sign 0
    ujk, upk, usign, *uvals = binding.reduce_rows(
        sk, mpk.contiguous(), perm, signs.to(torch.int32).contiguous(),
        [v.contiguous() for v in vals])
    LAUNCHES["batch_reduce_rows"] += 1
    return ujk, upk, usign, tuple(uvals)


# ---------------------------------------------------------------------------
# merge_side
# ---------------------------------------------------------------------------


def check_pair_order(k1: torch.Tensor, k2: torch.Tensor,
                     what: str) -> None:
    """Raise unless the (k1, k2) rows are in the two-key reducers' order
    (`batch_reduce_rows`, `ms_batch_reduce`): unique pairs ascending, then
    (EMPTY_KEY, EMPTY_KEY) padding to the end. Reads the tensors, so only
    the plain versions call it."""
    empty = _empty()
    asc = (k1[:-1] < k1[1:]) | ((k1[:-1] == k1[1:]) & (k2[:-1] < k2[1:]))
    pad = (k1[:-1] == empty) & (k2[:-1] == empty) & (k1[1:] == empty) \
        & (k2[1:] == empty)
    if not bool(torch.all(asc | pad)):
        raise ValueError(f"{what}: delta pairs must be unique and "
                         "ascending with EMPTY_KEY padding only at the "
                         "tail")


def check_side_order(jk: torch.Tensor, pk: torch.Tensor) -> None:
    """`check_pair_order` for a join side's (jk, pk) delta."""
    check_pair_order(jk, pk, "merge_side")


def merge_side_plain(side, djk: torch.Tensor, dpk: torch.Tensor,
                     dsign: torch.Tensor, dvals: Sequence[torch.Tensor]):
    """Apply unique (jk, pk) deltas to a side (see `merge_side`); raises
    on a delta out of order."""
    check_side_order(djk, dpk)
    empty = _empty()
    c = side.jk.shape[0]
    dev = side.jk.device
    jk = torch.cat([side.jk, djk])
    pk = torch.cat([side.pk, dpk])
    pres = torch.cat([(side.jk != empty).to(torch.int32),
                      dsign.to(torch.int32)])
    vals = [torch.cat([sv, dv.to(sv.dtype)])
            for sv, dv in zip(side.vals, dvals)]
    (jk, pk), out = sort_cols_plain([jk, pk], [pres] + vals)
    pres, vals = out[0], out[1:]
    false = torch.zeros(1, dtype=torch.bool, device=dev)
    same = (jk[:-1] == jk[1:]) & (pk[:-1] == pk[1:])
    same_next = torch.cat([same, false])
    same_prev = torch.cat([false, same])

    def nxt(a):
        return torch.cat([a[1:], a[-1:]])
    pres_m = torch.where(same_next, torch.clamp(pres + nxt(pres), 0, 1), pres)
    take = same_next & (nxt(pres) > 0)          # upsert: the delta payload
    vals_m = [torch.where(take, nxt(v), v) for v in vals]
    alive = ~same_prev & (jk != empty) & (pres_m > 0)
    needed = torch.sum(alive).to(torch.int32)
    out = compact_rows_plain(alive, [jk, pk], vals_m, c,
                             [empty, empty] + [0] * len(vals_m))
    return _join_side()(out[0], out[1], torch.clamp(needed, max=c),
                        tuple(out[2:])), needed


def merge_side(side, djk: torch.Tensor, dpk: torch.Tensor,
               dsign: torch.Tensor, dvals: Sequence[torch.Tensor]):
    """Apply unique (jk, pk) deltas to a (jk, pk)-sorted side: +1 insert
    or upsert, -1 delete, 0 no-op. A side row meeting its delta keeps
    presence clip(1 + sign, 0, 1) and takes the delta's payload when the
    sign is > 0; a lone delta is kept when its sign is > 0 (a net +2
    too); a lone delete is dropped. A bool payload column comes back
    int64, as the reference's (its compaction fills with 0). Returns
    (new side, needed): `needed` > capacity means the result was
    truncated to the capacity and the epoch must be replayed on a grown
    side.

    The delta must be in `batch_reduce_rows`' order (unique (jk, pk)
    ascending, EMPTY_KEY padding only at the tail); the reference
    re-sorts any order. The plain version raises on a delta out of order;
    the kernel does not check.

    CUDA: one merge-path pass (a co-rank search per 2048-row tile of the
    merged order, side row first on ties) that combines each row with its
    twin and writes the live rows, ranked by a scan with decoupled
    look-back, straight into the new side; a fill launch pads it. Nothing
    of size C + B is materialized, and the input side stays intact."""
    if not side.jk.is_cuda:
        return merge_side_plain(side, djk, dpk, dsign, dvals)
    c = side.jk.shape[0]
    svals = [v.contiguous() for v in side.vals]
    dvals = [dv.to(sv.dtype).contiguous() for sv, dv in zip(svals, dvals)]
    ojk, opk, *out, needed = binding.side_merge(
        side.jk.contiguous(), side.pk.contiguous(), svals,
        djk.contiguous(), dpk.contiguous(),
        dsign.to(torch.int32).contiguous(), dvals)
    LAUNCHES["merge_side"] += 1
    # the reference compacts with a fill of 0, which turns a bool payload
    # column into int64: so does the plain version, and so does this
    out = [o.to(torch.int64) if o.dtype == torch.bool else o for o in out]
    return _join_side()(ojk, opk, torch.clamp(needed, max=c),
                        tuple(out)), needed


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------


def probe_plain(side, qjk: torch.Tensor, qmask: torch.Tensor, m: int):
    """All matches of each probe key (see `probe`)."""
    empty = _empty()
    c, q = side.jk.shape[0], qjk.shape[0]
    qjk = torch.where(qmask, qjk, empty)
    lo = torch.searchsorted(side.jk, qjk)
    hi = torch.searchsorted(side.jk, qjk, right=True)
    cnt = torch.where(qmask & (qjk != empty), hi - lo, 0)
    off = torch.cumsum(cnt, 0)
    total = off[-1]
    t = torch.arange(m, device=qjk.device)
    row = torch.clamp(torch.searchsorted(off, t, right=True), 0, q - 1)
    prev = torch.where(row > 0, off[row - 1], 0)
    sidx = torch.clamp(lo[row] + (t - prev), 0, c - 1)
    return row.to(torch.int32), sidx, t < total, total


def probe(side, qjk: torch.Tensor, qmask: torch.Tensor, m: int):
    """All matches of each probe key in the side's sorted jk, expanded
    into m static output slots: (row int32[m], sidx int64[m], mask
    bool[m], total int64). Slot t < total is the (t - start)th match of
    the query `row`, at side index `sidx`; slots past the total are
    masked, with `row` clipped to the last query and `sidx` to the last
    side slot. `total` > m means matches were dropped (grow and replay).

    CUDA: one counting pass over tiles of 2048 queries (each tile's
    bounds searched in a shared-memory copy, or sample, of the side
    window its live keys span; its slot offset by a 64-bit decoupled
    look-back), then a merge path over (query ends, slots) in which
    each block finds its slots' queries in shared memory: a memset and
    two launches. Any query order; the main path's sorted order keeps
    the searches in shared memory."""
    if not side.jk.is_cuda:
        return probe_plain(side, qjk, qmask, m)
    row, sidx, mask, total = binding.probe(
        side.jk.contiguous(), qjk.contiguous(), qmask.contiguous(), int(m))
    LAUNCHES["probe"] += 1
    return row, sidx, mask, total
