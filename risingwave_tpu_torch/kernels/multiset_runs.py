"""The three multiset cores of the retractable min/max state:
hand-written CUDA kernels, each beside its plain PyTorch version.

| core              | replaces (risingwave_tpu/device/minput.py)         |
|-------------------|----------------------------------------------------|
| `ms_batch_reduce` | `ms_batch_reduce` :79 (two-key sort + segment_sum)  |
| `ms_merge`        | `ms_merge` :98 (concat + sort + shifted compare)    |
| `ms_find`         | `ms_find` :136 (unrolled composite binary search)   |

As in the package's `__init__`: each dispatch function sends CUDA
tensors to its kernel (`csrc/multiset_runs.cu`, bound by `binding.py`)
and CPU tensors to the `*_plain` version here, with no switch and no
fallback, and every launch adds one to `LAUNCHES[name]`.
"""
from __future__ import annotations

import torch

from . import LAUNCHES, _sort_perm, binding, compact_rows_plain, \
    sort_cols_plain
from .join_runs import check_pair_order


def _empty() -> int:
    from ..device.sorted_state import EMPTY_KEY
    return EMPTY_KEY


def _multiset():
    from ..device.minput import SortedMultiset
    return SortedMultiset


# ---------------------------------------------------------------------------
# ms_batch_reduce
# ---------------------------------------------------------------------------


def ms_batch_reduce_plain(k1: torch.Tensor, k2: torch.Tensor,
                          delta: torch.Tensor, mask: torch.Tensor):
    """Unique (k1, k2) pairs with summed deltas (see `ms_batch_reduce`)."""
    empty = _empty()
    b = k1.shape[0]
    dev = k1.device
    k1 = torch.where(mask, k1, empty)
    k2 = torch.where(mask, k2, empty)
    delta = torch.where(mask, delta, 0).to(torch.int64)
    (k1, k2), (delta,) = sort_cols_plain([k1, k2], [delta])
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      (k1[1:] == k1[:-1]) & (k2[1:] == k2[:-1])])
    seg = torch.cumsum((~same).to(torch.int64), 0) - 1
    ud = torch.zeros(b, dtype=torch.int64, device=dev).index_add_(0, seg,
                                                                  delta)
    u1 = torch.full((b,), empty, dtype=torch.int64, device=dev)
    u1[seg] = k1
    u2 = torch.full((b,), empty, dtype=torch.int64, device=dev)
    u2[seg] = k2
    ud = torch.where(u1 == empty, 0, ud)
    return u1, u2, ud


def ms_batch_reduce(k1: torch.Tensor, k2: torch.Tensor, delta: torch.Tensor,
                    mask: torch.Tensor):
    """Rows -> unique (k1, k2) pairs with summed int64 count deltas,
    (k1, k2)-sorted, EMPTY_KEY-padded: (u1, u2, ud), each [B]. Masked
    rows become (EMPTY_KEY, EMPTY_KEY, 0); `ud` is 0 wherever `u1` is
    EMPTY_KEY.

    CUDA: the two-key radix sort kernel, then the two-key tiled segmented
    reduce (`csrc/reduce_tiles.cuh`): segment ids by decoupled look-back,
    each thread summing its 8 rows' deltas, a block scan and a carry pass
    joining segments across threads and tiles."""
    if not k1.is_cuda:
        return ms_batch_reduce_plain(k1, k2, delta, mask)
    empty = _empty()
    m1 = torch.where(mask, k1, empty)
    m2 = torch.where(mask, k2, empty)
    md = torch.where(mask, delta, 0).to(torch.int64)
    perm, sk1 = _sort_perm([m1, m2])
    u1, u2, ud = binding.ms_reduce(sk1, m2.contiguous(), perm,
                                   md.contiguous())
    LAUNCHES["ms_batch_reduce"] += 1
    return u1, u2, ud


# ---------------------------------------------------------------------------
# ms_merge
# ---------------------------------------------------------------------------


def ms_merge_plain(ms, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor):
    """Merge unique pair deltas into the multiset (see `ms_merge`), by the
    reference's concat and stable sort; raises on a delta out of
    order."""
    check_pair_order(u1, u2, "ms_merge")
    empty = _empty()
    c = ms.k1.shape[0]
    dev = u1.device
    k1 = torch.cat([ms.k1, u1])
    k2 = torch.cat([ms.k2, u2])
    cnt = torch.cat([ms.cnt, ud.to(torch.int64)])
    (k1, k2), (cnt,) = sort_cols_plain([k1, k2], [cnt])
    false = torch.zeros(1, dtype=torch.bool, device=dev)
    same = (k1[:-1] == k1[1:]) & (k2[:-1] == k2[1:])
    same_next = torch.cat([same, false])
    same_prev = torch.cat([false, same])
    nxt = torch.cat([cnt[1:], cnt[-1:]])
    merged = torch.where(same_next, cnt + nxt, cnt)
    alive = ~same_prev & (k1 != empty) & (merged != 0)
    needed = torch.sum(alive).to(torch.int32)
    out = compact_rows_plain(alive, [k1, k2], [merged], c,
                             [empty, empty, 0])
    return _multiset()(out[0], out[1], torch.clamp(needed, max=c),
                       out[2]), needed


def ms_merge(ms, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor):
    """Merge unique (group, value) count deltas into the multiset; pairs
    whose multiplicity reaches 0 compact away (a count below 0 stays, as
    in the reference). Zero-count deltas add 0 to an existing pair and
    vanish alone. Returns (new multiset, needed int32): `needed` >
    capacity means the result was truncated to the capacity and the
    epoch must be replayed on a grown multiset.

    The delta must be in `ms_batch_reduce`'s order (unique (k1, k2)
    ascending, EMPTY_KEY padding only at the tail); the reference
    re-sorts any order. The plain version raises on a delta out of
    order; the kernel does not check.

    CUDA: one merge-path pass (`k_ms_merge_tiles`): tiles of 2048 merged
    rows cut by a two-key co-rank, both runs' slices merged in shared
    memory, each pair combined with its twin, the pairs alive ranked and
    placed by decoupled look-back straight into the capacity; a tile whose
    first merged group is EMPTY_KEY returns at once. The outputs, `needed`
    and the clipped count are views of one allocation."""
    if not ms.k1.is_cuda:
        return ms_merge_plain(ms, u1, u2, ud)
    k1, k2, cnt, needed, count = binding.ms_merge(
        ms.k1.contiguous(), ms.k2.contiguous(), ms.cnt.contiguous(),
        u1.contiguous(), u2.contiguous(), ud.to(torch.int64).contiguous())
    LAUNCHES["ms_merge"] += 1
    return _multiset()(k1, k2, count, cnt), needed


# ---------------------------------------------------------------------------
# ms_find
# ---------------------------------------------------------------------------


def ms_find_plain(ms, q1: torch.Tensor, q2: torch.Tensor):
    """The reference's unrolled composite binary search (see `ms_find`)."""
    empty = _empty()
    c = ms.k1.shape[0]
    lo = torch.zeros(q1.shape, dtype=torch.int64, device=q1.device)
    hi = torch.full(q1.shape, c, dtype=torch.int64, device=q1.device)
    for _ in range(max(1, (c - 1).bit_length() + 1)):
        mid = (lo + hi) // 2
        mid_c = torch.clamp(mid, max=c - 1)
        m1, m2 = ms.k1[mid_c], ms.k2[mid_c]
        less = (m1 < q1) | ((m1 == q1) & (m2 < q2))
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    lo_c = torch.clamp(lo, max=c - 1)
    found = (ms.k1[lo_c] == q1) & (ms.k2[lo_c] == q2) & (q1 != empty)
    return found, torch.where(found, ms.cnt[lo_c], 0)


def ms_find(ms, q1: torch.Tensor, q2: torch.Tensor):
    """Multiplicity of each (q1, q2) pair in the multiset: (found bool,
    count int64 — 0 when absent). Needs a capacity >= 1.

    The reference unrolls bit_length(C - 1) + 1 halving steps over all C
    slots; that many steps always reach the composite lower bound (or
    C - 1 after the clip), so the kernel runs a plain lower bound per
    query, in any query order: an EMPTY query is answered unsearched
    (its q2 unread), a thread takes four queries, and a block descends
    a 2047-pair sample of the multiset staged in shared memory in heap
    order before the last bit_length(ceil(C / 2047) - 1) steps in device
    memory."""
    if not ms.k1.is_cuda:
        return ms_find_plain(ms, q1, q2)
    found, cnt = binding.ms_find(ms.k1.contiguous(), ms.k2.contiguous(),
                                 ms.cnt.contiguous(), q1.contiguous(),
                                 q2.contiguous())
    LAUNCHES["ms_find"] += 1
    return found, cnt
