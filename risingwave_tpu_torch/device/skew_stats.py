"""Key-skew and flow telemetry riding the fused stats vector (PyTorch port
of `risingwave_tpu/device/skew_stats.py`).

Keyed nodes (AggNode, JoinNode) armed by `enable_skew` / `enable_flow`
add three signals to their stats every epoch, with no extra sync:

* **vnode occupancy** (`skv*`, MAX across epochs): the live key table's
  keys per bucket `vnode(key) * SK_BUCKETS // VNODE_COUNT`, the CRC32
  vnode map a mesh exchange routes by;
* **heavy hitters** (`skh*`, MAX across epochs): the epoch's top
  SK_TOPK (count, key) pairs of the input delta, packed as `(count <<
  SK_SHIFT) | (key & SK_KEY_MASK)` so one int64 max keeps the pair
  together;
* **vnode traffic** (`tv*`, SUM across epochs): the epoch's routed input
  rows per bucket.

The device functions return int64 tensors ([SK_BUCKETS] or [SK_TOPK])
and run the `vnode_hist` / `topk_packed` kernels on the card (their
plain versions on the CPU); `node_hists` gives a node both histograms
in one launch. The host helpers read the folded stats for
`FusedJob.skew_report`, and the mesh policy's math (`shard_loads`,
`shard_skew_ratio`, `balanced_bounds`) turns an occupancy histogram into
per-shard loads and rebalanced vnode-block bounds for
`FusedJob._maybe_retune`.
"""
from __future__ import annotations

from collections import deque
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.vnode import VNODE_COUNT

# histogram buckets over the vnode space (16 of 16 vnodes each)
SK_BUCKETS = 16
# heavy-hitter rank slots per keyed node
SK_TOPK = 4
# packed layout: count in the high bits, truncated key in the low bits
SK_KEY_BITS = 40
SK_SHIFT = SK_KEY_BITS
SK_KEY_MASK = (1 << SK_KEY_BITS) - 1
# counts clamp to 22 bits so count << 40 stays clear of the int64 sign
SK_COUNT_MAX = (1 << 22) - 1

SKEW_STAT_NAMES: Tuple[str, ...] = tuple(
    [f"skv{i}" for i in range(SK_BUCKETS)]
    + [f"skh{i}" for i in range(SK_TOPK)])
TRAFFIC_STAT_NAMES: Tuple[str, ...] = tuple(
    f"tv{i}" for i in range(SK_BUCKETS))


def vnode_occupancy(keys: torch.Tensor, empty_key: int) -> torch.Tensor:
    """Live keys per bucket of a padded (EMPTY_KEY-filled) key table."""
    from ..kernels import vnode_hist
    return vnode_hist(keys, None, None, empty_key)


def vnode_traffic(keys: torch.Tensor, live: torch.Tensor,
                  weights: torch.Tensor = None) -> torch.Tensor:
    """Routed rows per bucket of one epoch's input delta; `weights` (the
    pre-combined agg path) carries each combined row's raw-row count so
    the totals equal the uncombined run's."""
    from ..kernels import vnode_hist
    return vnode_hist(keys, live, weights)


def node_hists(tables, keys=None, live=None, weights=None,
               empty_key: int = None):
    """One keyed node's histograms in one `vnode_hists` call: the
    occupancy of its padded key `tables` (added into one histogram) when
    any are given, and the traffic of the epoch's input `keys` (routed
    where `live`, weighted by `weights`) when given -> (occupancy or
    None, traffic or None)."""
    from ..kernels import vnode_hists
    segs = [(t, None, None, 0) for t in tables]
    if keys is not None:
        segs.append((keys, live, weights, 1 if tables else 0))
    h = vnode_hists(segs, (1 if tables else 0) + (keys is not None),
                    empty_key)
    return (h[0] if tables else None, h[-1] if keys is not None else None)


def epoch_topk(keys: torch.Tensor, live: torch.Tensor,
               empty_key: int) -> torch.Tensor:
    """Top-SK_TOPK packed (count, key) of one epoch's input delta: the live
    keys sorted (`sort_cols`), each run of equal keys counted."""
    from ..kernels import sort_cols, topk_packed
    (sk,), _ = sort_cols([torch.where(live, keys, empty_key)], [])
    return topk_packed(sk, None, empty_key)


def weighted_topk(keys: torch.Tensor, counts: torch.Tensor,
                  empty_key: int) -> torch.Tensor:
    """Top-SK_TOPK packed (count, key) from already-combined (key, count)
    rows; rows with key == empty_key or count <= 0 drop out."""
    from ..kernels import topk_packed
    return topk_packed(keys, counts, empty_key)


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


def unpack_hot(packed: int) -> Tuple[int, int]:
    """One heavy-hitter slot -> (key40, count)."""
    packed = int(packed)
    return packed & SK_KEY_MASK, packed >> SK_SHIFT


def hot_key_set(stats) -> Tuple[int, ...]:
    """The heavy-hitter keys (40-bit masked) of one node's folded stats."""
    out = set()
    for i in range(SK_TOPK):
        packed = stats.get(f"skh{i}", 0)
        if packed:
            key, cnt = unpack_hot(packed)
            if cnt > 0:
                out.add(int(key))
    return tuple(sorted(out))


# ---------------------------------------------------------------------------
# the mesh policy's math: occupancy histogram -> shard loads -> new bounds
# ---------------------------------------------------------------------------


def shard_loads(bucket_counts, bounds, vnode_count: int = VNODE_COUNT
                ) -> List[float]:
    """Per-shard load implied by the SK_BUCKETS-bucket occupancy
    histogram under vnode-block `bounds` (n_shards + 1 of them, from 0 to
    vnode_count). A bucket that straddles a block boundary splits in
    proportion to the overlap (keys are taken as uniform within a
    bucket). Each shard's terms add in bucket order, as the reference's
    loop adds them, so the floats are the reference's bit for bit."""
    counts = np.asarray([float(c) for c in bucket_counts], np.float64)
    nb = len(counts)
    if nb == 0 or len(bounds) < 2:
        return [0.0] * max(0, len(bounds) - 1)
    per_bucket = vnode_count / float(nb)
    blo = np.arange(nb, dtype=np.float64) * per_bucket
    bhi = np.arange(1, nb + 1, dtype=np.float64) * per_bucket
    b = np.asarray([float(v) for v in bounds], np.float64)
    ov = np.minimum(b[1:, None], bhi[None, :]) \
        - np.maximum(b[:-1, None], blo[None, :])
    terms = np.where(ov > 0, counts[None, :] * ov / per_bucket, 0.0)
    # a running sum is the sequential sum (np.sum would pair the terms)
    return [float(x) for x in np.cumsum(terms, axis=1)[:, -1]]


def shard_skew_ratio(bucket_counts, bounds,
                     vnode_count: int = VNODE_COUNT) -> float:
    """max / mean of the per-shard loads under `bounds`: the straggler
    predictor the rebalancer thresholds on (`skew_ratio` is the raw key
    skew, whatever the bounds)."""
    loads = shard_loads(bucket_counts, bounds, vnode_count)
    total = sum(loads)
    if total <= 0:
        return 0.0
    return max(loads) / (total / len(loads))


def balanced_bounds(bucket_counts, n_shards: int,
                    vnode_count: int = VNODE_COUNT) -> Tuple[int, ...]:
    """Contiguous vnode-block bounds that even out the observed bucket
    loads, at bucket granularity: the smallest max-block load that n
    contiguous blocks can reach (a binary search over the answer with a
    greedy check, optimal for contiguous partitions), then each bound
    placed where the running load would pass it. Blocks may be empty
    (equal consecutive bounds) when one bucket dominates: the hot bucket
    gets a shard to itself."""
    counts = np.asarray([int(c) for c in bucket_counts], np.int64)
    nb = len(counts)
    per_bucket = vnode_count // max(1, nb)
    if int(counts.sum()) <= 0 or n_shards <= 1:
        from ..parallel.mesh import vnode_block_bounds
        return tuple(int(v) for v in vnode_block_bounds(n_shards,
                                                        vnode_count))

    def cuts(cap: int, limit: Optional[int] = None) -> List[int]:
        """Bucket indices where a new block starts under a max load of
        `cap` (at most `limit` blocks)."""
        out, acc = [], 0
        for b, c in enumerate(counts.tolist()):
            if acc + c > cap and (limit is None or len(out) + 1 < limit):
                out.append(b)
                acc = 0
            acc += c
        return out

    lo, hi = int(counts.max()), int(counts.sum())
    while lo < hi:
        mid = (lo + hi) // 2
        if len(cuts(mid)) + 1 <= n_shards:
            hi = mid
        else:
            lo = mid + 1
    bounds = [0] + [b * per_bucket for b in cuts(lo, n_shards)]
    bounds += [vnode_count] * (n_shards + 1 - len(bounds))
    return tuple(int(v) for v in bounds)


_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(counts) -> str:
    """Unicode sparkline of a histogram."""
    hi = max([c for c in counts] + [1])
    return "".join(_SPARK[min(len(_SPARK) - 1,
                              int(c * len(_SPARK) / hi)) if c else 0]
                   for c in counts)


def skew_ratio(bucket_counts) -> float:
    """max / mean of a histogram: 1.0 is even, 0.0 when it is empty."""
    total = sum(bucket_counts)
    if total <= 0:
        return 0.0
    mean = total / float(len(bucket_counts))
    return max(bucket_counts) / mean


def traffic_divergence(traffic, occupancy) -> float:
    """Half the L1 distance between the normalized traffic and occupancy
    histograms, in [0, 1] (0: rows go where state lives)."""
    tt, to = sum(traffic), sum(occupancy)
    if tt <= 0 or to <= 0:
        return 0.0
    return 0.5 * sum(abs(t / tt - o / to)
                     for t, o in zip(traffic, occupancy))


class TrafficEwma:
    """Per-node EWMA over per-checkpoint traffic deltas: `burst_ratio`
    compares the latest window with the sustained rate."""

    def __init__(self, alpha: float = 0.3, ring: int = 16):
        self.alpha = float(alpha)
        self.ewma: List[float] = [0.0] * SK_BUCKETS
        self.ring: Any = deque(maxlen=ring)   # recent window deltas
        self._last_total: List[int] = [0] * SK_BUCKETS

    def update(self, cumulative) -> List[int]:
        """Feed the cumulative per-bucket totals; returns the window's
        delta."""
        cur = [int(c) for c in cumulative]
        delta = [max(0, c - p) for c, p in zip(cur, self._last_total)]
        self._last_total = cur
        a = self.alpha
        self.ewma = [a * d + (1.0 - a) * e
                     for d, e in zip(delta, self.ewma)]
        self.ring.append(delta)
        return delta

    def burst_ratio(self) -> float:
        """max over buckets of (latest window) / (EWMA)."""
        if not self.ring:
            return 0.0
        latest = self.ring[-1]
        worst = 0.0
        for d, e in zip(latest, self.ewma):
            if d > 0:
                worst = max(worst, d / e if e > 0 else float(d))
        return worst
