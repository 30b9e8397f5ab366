"""The key-skew telemetry cores: hand-written CUDA kernels, each beside its
plain PyTorch version.

| core          | replaces (risingwave_tpu/)                                   |
|---------------|--------------------------------------------------------------|
| `vnode_hist`, `vnode_hists` | `device/skew_stats.py` `vnode_occupancy` :69 and `vnode_traffic` :84, over `core/vnode.py` `crc32_u64_jnp` :246 / `compute_vnodes_jnp` :261 (a [16, n] one-hot sum) |
| `topk_packed` | `device/skew_stats.py` `epoch_topk` :102 (after the sort) and `weighted_topk` :129 (pack + lax.top_k) |

As in the package's `__init__`: each dispatch function sends CUDA tensors
to its kernel (`csrc/skew_runs.cu`, bound by `binding.py`) and CPU
tensors to the `*_plain` version, with no switch and no fallback, and
every launch adds one to `LAUNCHES[name]`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import LAUNCHES, binding


def _sk():
    from ..device import skew_stats
    return skew_stats


def _empty() -> int:
    from ..device.sorted_state import EMPTY_KEY
    return EMPTY_KEY


# (keys, live or None, weights or None, output row)
Segment = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor],
                int]


# ---------------------------------------------------------------------------
# vnode_hist
# ---------------------------------------------------------------------------


def vnode_hist_plain(keys: torch.Tensor, live: Optional[torch.Tensor],
                     weights: Optional[torch.Tensor], empty_key: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted 16-bucket vnode histogram (see `vnode_hist`): the CRC by
    int64 emulation, then one scatter_add_."""
    from ..core.vnode import VNODE_COUNT, compute_vnodes_dev
    nb = _sk().SK_BUCKETS
    if out is None:
        out = torch.zeros(nb, dtype=torch.int64, device=keys.device)
    if live is None:
        live = keys != empty_key
    bucket = compute_vnodes_dev(keys).to(torch.int64) * nb // VNODE_COUNT
    w = torch.ones_like(keys) if weights is None else weights.to(torch.int64)
    return out.scatter_add_(0, bucket, torch.where(live, w, 0))


def vnode_hists_plain(segments: Sequence[Segment], rows: int,
                      empty_key: int) -> torch.Tensor:
    """Several weighted vnode histograms (see `vnode_hists`): one
    `vnode_hist_plain` per segment into its row."""
    out = torch.zeros((rows, _sk().SK_BUCKETS), dtype=torch.int64,
                      device=segments[0][0].device)
    for keys, live, weights, row in segments:
        vnode_hist_plain(keys, live, weights, empty_key, out[row])
    return out


def vnode_hists(segments: Sequence[Segment], rows: int,
                empty_key: Optional[int] = None) -> torch.Tensor:
    """A keyed node's histograms in one call: int64 [rows, 16], row r the
    sum over the segments `(keys, live, weights, row)` with that row of
    each live row's weight (1 without `weights`) in the bucket
    vnode(key) * 16 // 256; a row is live where `live` is true or, with
    `live` None, where its key is not `empty_key` (a padded key table).
    Segments that share a row add into it (a join's two sides). At most
    4 segments and 4 rows.

    CUDA: one launch (`vnode_hist`'s kernel), the segments passed by
    value; no zero fill: the rows are written by the last block to
    finish. Integer adds: the result does not depend on their order."""
    if empty_key is None:
        empty_key = _empty()
    if not segments[0][0].is_cuda:
        return vnode_hists_plain(segments, rows, empty_key)
    out = binding.vnode_hists(
        [(k.contiguous(), None if lv is None else lv.contiguous(),
          None if w is None else w.to(torch.int64).contiguous(), r)
         for k, lv, w, r in segments], rows, int(empty_key))
    LAUNCHES["vnode_hist"] += 1
    return out


def vnode_hist(keys: torch.Tensor, live: Optional[torch.Tensor] = None,
               weights: Optional[torch.Tensor] = None,
               empty_key: Optional[int] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add each live row's weight (1 without `weights`) to the bucket
    vnode(key) * 16 // 256 of `out` (int64 [16], zeros when absent) and
    return it. Without `live`, a row is live when its key is not
    `empty_key` (the occupancy of a padded key table). The one-segment
    form of `vnode_hists`.

    CUDA: a bucket is four parities of the key (bits 4..7 of its CRC,
    affine in the key's bits; no table), counted per thread in shared
    memory without atomics, one atomic per bucket and block, the row
    written (or added into `out`) by the last block."""
    if empty_key is None:
        empty_key = _empty()
    if not keys.is_cuda:
        return vnode_hist_plain(keys, live, weights, empty_key, out)
    seg = [(keys.contiguous(), None if live is None else live.contiguous(),
            None if weights is None else weights.to(torch.int64).contiguous(),
            0)]
    if out is None:
        res = binding.vnode_hists(seg, 1, int(empty_key))[0]
    else:
        res = out
        binding.vnode_hists(seg, 1, int(empty_key), out=out.view(1, -1))
    LAUNCHES["vnode_hist"] += 1
    return res


# ---------------------------------------------------------------------------
# topk_packed
# ---------------------------------------------------------------------------


def _pack(keys: torch.Tensor, counts: torch.Tensor, empty_key: int
          ) -> torch.Tensor:
    sk = _sk()
    return torch.where((counts > 0) & (keys != empty_key),
                       (torch.clamp(counts, max=sk.SK_COUNT_MAX)
                        << sk.SK_SHIFT) | (keys & sk.SK_KEY_MASK), 0)


def topk_packed_plain(keys: torch.Tensor, counts: Optional[torch.Tensor],
                      empty_key: int) -> torch.Tensor:
    """Top-4 packed (count, key) values (see `topk_packed`): pack, then
    torch.topk, padded with 0."""
    if counts is None:
        # runs mode: `keys` sorted; one (key, run length) row per run
        keys, counts = torch.unique_consecutive(keys, return_counts=True)
    k = _sk().SK_TOPK
    packed = _pack(keys, counts.to(torch.int64), empty_key)
    top = torch.topk(packed, min(k, packed.shape[0])).values
    pad = torch.zeros(k - top.shape[0], dtype=torch.int64,
                      device=keys.device)
    return torch.cat([top, pad])


def topk_packed(keys: torch.Tensor, counts: Optional[torch.Tensor],
                empty_key: Optional[int] = None) -> torch.Tensor:
    """The 4 largest `(min(count, 2^22 - 1) << 40) | (key & (2^40 - 1))`
    values, descending, padded with 0 (as lax.top_k over a packed vector
    that holds 0s): int64 [4].

    Weighted mode (`counts` given): one packed value per row whose count
    is > 0 and key is not `empty_key`. Runs mode (`counts` None): `keys`
    is sorted, and each run of equal non-empty keys packs with its
    length. Equal packed values keep their multiplicity.

    CUDA: one launch, one allocation (the output). Each thread keeps its
    own top 4 in registers; a shuffle butterfly merges the warp's lists,
    one warp the block's, and the last block to finish merges the blocks'
    lists from a persistent per-device buffer (`binding.topk_state`).
    Weighted rows are read by 16-byte loads; in runs mode each thread
    owns 8 sorted keys and finds its runs' lengths from the next head in
    its rows, its warp or its block, and only a tile's last run is
    searched past the tile's edge in device memory (a warp's gallop)."""
    if empty_key is None:
        empty_key = _empty()
    if not keys.is_cuda:
        return topk_packed_plain(keys, counts, empty_key)
    out = binding.topk_packed(
        keys.contiguous(),
        None if counts is None else counts.to(torch.int64).contiguous(),
        int(empty_key))
    LAUNCHES["topk_packed"] += 1
    return out
