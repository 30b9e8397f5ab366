"""Predictive capacity sizing for device state.

Fixed-capacity device state (sorted runs, join sides, pair buffers) grows
by restoring a snapshot and replaying at a larger size — on the fused path
one growth costs a checkpoint-window replay plus a per-node re-trace, so
discovering cardinality one pow2 doubling at a time is the dominant cost
of capacity-bound runs (the r05 q5/q7/q8 bench: 2,553 events/s against
q4's 671k, all of it growth-replay churn). The fix is the same lesson
PanJoin draws for adaptive stream-join partitioning and "Global Hash
Tables Strike Back!" for parallel GROUP BY sizing: right-size up front
from an observed rate instead of reacting one overflow at a time.

`project` extrapolates an observed entries-per-event rate over the
source's event horizon (`max_events`); callers clamp the result against
an HBM budget (`DeviceConfig.hbm_budget_mb`) and never below the observed
need — the budget trims headroom, not correctness.
"""
from __future__ import annotations

from typing import Optional

# Multiplicative headroom on the extrapolated rate. Keep it SMALL: the
# pow2 bucket already rounds up (2x worst-case headroom), and group/pair
# counts are usually sublinear in events (they saturate) so the linear
# projection itself over-shoots. A large factor pushes dead-linear rates
# (bids-per-event) one whole bucket past their true need, and every
# subsequent epoch pays the sort over the padded state; an under-shoot
# merely costs one more (bounded) replay.
HEADROOM = 1.05
# Unbounded sources have no horizon to extrapolate over: grow two pow2
# steps past the observed need (4x) so each replay buys several doublings.
UNBOUNDED_STEP = 4
# Per-epoch-bounded slots (join pair buffers, agg `touched` compaction
# bounds) reset every epoch: their need does NOT scale with total events,
# so the linear horizon extrapolation wildly over-shoots them on window
# queries. They get flat multiplicative headroom instead — the pow2
# bucket on top makes the effective margin 2-4x.
EPOCH_HEADROOM = 2.0


def tier_waters() -> tuple:
    """(high, low) occupancy-fraction water marks for the state tier
    (device/tiering.py). Demotion ARMS when a node's live count crosses
    high * capacity and drains cold keys down to low * capacity — the
    gap is what keeps the capacity predictor from ever needing to grow
    past the HBM budget, because `needed` stays strictly below the
    current bucket between demotion ticks. Env-overridable per run."""
    import os
    high = float(os.environ.get("RW_TIER_HIGH_WATER", "0.85"))
    low = float(os.environ.get("RW_TIER_LOW_WATER", "0.60"))
    high = min(max(high, 0.05), 0.99)
    low = min(max(low, 0.01), high)
    return high, low


def bucket(n: int, lo: int = 256) -> int:
    """Smallest pow2 >= n, floored at lo (pow2 buckets bound the number of
    distinct traced shapes per node)."""
    return max(lo, 1 << (max(1, int(n)) - 1).bit_length())


def ladder(current: int, predicted: int, rungs: int = 4) -> list:
    """The pow2 capacity rungs between `current` (exclusive) and
    `bucket(predicted)` (inclusive) — the shapes worth AOT-compiling
    ahead of growth. At most `rungs` values, keeping the FIRST step
    (where a mis-predicted growth lands) and the TOP of the ladder
    (where predictive growth jumps); middle rungs are the first to go,
    since cascade-free growth rarely visits them."""
    hi = bucket(max(int(predicted), 1), lo=1)
    out = []
    c = bucket(max(int(current), 1), lo=1)
    while c < hi:
        c <<= 1
        out.append(c)
    if rungs > 0 and len(out) > rungs:
        out = out[:1] + out[-(rungs - 1):] if rungs > 1 else out[-1:]
    return out


def project_epoch(need: int, headroom: float = EPOCH_HEADROOM) -> int:
    """Projection for a per-epoch-bounded slot: flat headroom over the
    observed per-epoch high-water, never horizon-scaled. 0 when nothing
    was observed."""
    if need <= 0:
        return 0
    return int(need * headroom)


def project(need: int, events_seen: int, horizon: Optional[int],
            headroom: float = HEADROOM) -> int:
    """Raw (un-bucketed) slot projection for a state that holds `need`
    entries after `events_seen` events, extrapolated to `horizon` events.

    Returns 0 when nothing was observed; never less than `need`. Once the
    horizon is reached (sync at drain — the bench shape), the observed
    need IS the final need: size exactly, no headroom — over-shoot costs
    every subsequent epoch its sort over the padded state.
    """
    if need <= 0:
        return 0
    if horizon and events_seen:
        if horizon > events_seen:
            return max(need,
                       int(need * horizon / events_seen * headroom) + 64)
        return need
    return need * UNBOUNDED_STEP


def exchange_cap(epoch_events: int, n_shards: int, lo: int = 256) -> int:
    """Initial per-(source, dest) send-bucket capacity of the bucket
    exchange (`device/shard_exec.py`): a shard holds 1/n of the
    epoch's rows and, under uniform key hashing, sends 1/n of those to
    each destination — so the expected bucket fill is events/n^2. 2x
    headroom plus the pow2 bucket covers moderate skew; a genuinely hot
    destination overflows the "exch" stat once and the normal
    grow+replay path resizes it (per-epoch-bounded, flat headroom). The
    floor keeps degenerate cadences from thrashing growth."""
    per_dest = max(1, epoch_events // max(1, n_shards * n_shards))
    return bucket(2 * per_dest, lo=lo)


def node_hbm_bytes(node) -> int:
    """Allocated HBM bytes of one node's declared capacity slots (the
    declarative interface: cap_current x cap_bytes). 0 for stateless
    nodes."""
    cur = node.cap_current()
    if not cur:
        return 0
    bpe = node.cap_bytes()
    return sum(c * bpe.get(s, 0) for s, c in cur.items())


def hbm_footprint(nodes) -> int:
    """Total allocated HBM bytes across a program's nodes — the numerator
    of the rw_hbm_budget_utilization gauge (denominator: hbm_budget_mb)."""
    return sum(node_hbm_bytes(n) for n in nodes)


def predict_capacity(need: int, current: int, events_seen: int = 0,
                     horizon: Optional[int] = None, lo: int = 256) -> int:
    """Bucketed growth target for one standalone state (the per-operator
    wrappers, which grow-and-retry inside one epoch instead of replaying):
    at least the observed need, at least the current capacity, sized ahead
    by the rate projection so one grow skips the intermediate buckets."""
    if need <= current:
        return current
    return bucket(max(need, project(need, events_seen, horizon)), lo=current)
