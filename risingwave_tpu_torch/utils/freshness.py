"""Source->MV freshness: end-to-end staleness per materialized view (the
port's own copy of the JAX package's `utils/freshness.py`; it observes
`mv_freshness_seconds` in the port's `utils/metrics.REGISTRY`).

Answers the question none of the existing surfaces could: "how long
after an event exists does this MV reflect it, durably?" Every commit of
an MV records (epoch, ingest_ts, commit_ts):

* ingest_ts — when the OLDEST event of the committed window came into
  existence: a host source's first-chunk poll wall of the epoch
  (stamped onto the barrier it seals — `Barrier.note_ingest`, with the
  barrier-injection time of the previous barrier as the conservative
  fallback when no source stamped), or a fused job's first epoch
  dispatch since the last checkpoint (device datagen: dispatch IS
  ingest).
* commit_ts — when the commit completed on the coordinator (for remote
  fragments this is after cross-worker barrier alignment, so the whole
  dispatch -> worker -> merge -> materialize path is inside the
  measure; for fused jobs it is after the verified device sync + state
  table commit).

freshness = commit_ts - ingest_ts feeds the `mv_freshness_seconds`
histogram (per-MV label) and a ring per MV; the `rw_mv_freshness`
system table reports the LIVE view — last commit's numbers plus
`staleness_s` recomputed at SELECT time (now - last committed
ingest_ts: how far behind the MV is right now, which keeps growing
while nothing commits) and p50/p99 over the ring.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# barrier cadences are tens of ms; checkpoints with growth replays reach
# tens of seconds — wider buckets than the default latency ladder
FRESHNESS_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                     5.0, 10.0, 30.0, 60.0, 300.0)
RING = 512


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class FreshnessTracker:
    """Per-MV commit ring + the mv_freshness_seconds histogram. Commits
    arrive from the barrier loop AND fused-job checkpoints (same
    thread today, but supervisor respawns can re-enter) — mutations are
    locked; reads snapshot under the lock."""

    def __init__(self):
        self._rings: Dict[str, deque] = {}
        self._lock = threading.Lock()
        # mv -> (served_epoch, ingest_ts of that epoch's commit): set
        # when a staleness-bounded SELECT was SERVED from a cache
        # snapshot OLDER than the last commit — the staleness the reader
        # actually experienced, which `rows()` must report instead of
        # the head-of-ring number (cleared the next time a serve is
        # up to date)
        self._served: Dict[str, Tuple[int, float]] = {}

    def commit(self, mv: str, epoch: int, ingest_ts: float,
               commit_ts: Optional[float] = None) -> float:
        commit_ts = commit_ts if commit_ts is not None else time.time()
        fresh = max(0.0, commit_ts - ingest_ts)
        with self._lock:
            ring = self._rings.get(mv)
            if ring is None:
                ring = self._rings[mv] = deque(maxlen=RING)
            ring.append((epoch, ingest_ts, commit_ts, fresh))
        from .metrics import REGISTRY
        REGISTRY.histogram(
            "mv_freshness_seconds",
            "source ingest to durable MV commit, end to end",
            labels=("mv",), buckets=FRESHNESS_BUCKETS).labels(mv).observe(
                fresh)
        return fresh

    def note_served(self, mv: str, served_epoch: int,
                    committed_epoch: int,
                    as_of_ts: Optional[float]) -> None:
        """A SELECT was answered from the serving cache at
        `served_epoch` while the job stood at `committed_epoch` (both
        in the CALLER's epoch unit — they are only compared to each
        other). When the serve lagged, anchor the MV's reported
        staleness on the ingest stamp of the last commit at or before
        `as_of_ts` (the snapshot's fill wall clock: the data reflects
        nothing later) — `rows()` would otherwise claim head-of-ring
        freshness for data the cache served several epochs stale."""
        with self._lock:
            ring = self._rings.get(mv)
            if not ring:
                return
            if served_epoch >= committed_epoch or as_of_ts is None:
                self._served.pop(mv, None)     # up-to-date serve
                return
            anchor = ring[0][1]   # older than the ring remembers: floor
            for _ep, ing, commit, _fresh in ring:
                if commit > as_of_ts:
                    break
                anchor = ing
            self._served[mv] = (int(served_epoch), anchor)

    def forget(self, mv: str) -> None:
        with self._lock:
            self._rings.pop(mv, None)
            self._served.pop(mv, None)

    def history(self, mv: str) -> List[Tuple]:
        """(epoch, ingest_ts, commit_ts, freshness_s) commits, oldest
        first — the monotonicity surface the respawn tests assert on."""
        with self._lock:
            return list(self._rings.get(mv, ()))

    def rows(self, now: Optional[float] = None) -> List[Tuple]:
        """rw_mv_freshness rows, one per MV: (mv, epoch, ingest_ts,
        commit_ts, freshness_s, staleness_s, p50_s, p99_s, commits).
        `staleness_s` is recomputed at read time against the LAST
        committed ingest stamp — an MV nothing commits into reads as
        ever-staler, exactly what an operator needs to see. When the
        last SELECT was served from a cache epoch that LAGGED the last
        commit (`note_served`), the staleness anchors on the served
        epoch's ingest instead: the number reports what readers get,
        not what the store holds."""
        now = now if now is not None else time.time()
        with self._lock:
            snap = {mv: list(ring) for mv, ring in self._rings.items()}
            served = dict(self._served)
        out: List[Tuple] = []
        for mv in sorted(snap):
            ring = snap[mv]
            epoch, ingest, commit, fresh = ring[-1]
            anchor = ingest
            if mv in served:
                anchor = min(anchor, served[mv][1])
            fr = sorted(r[3] for r in ring)
            out.append((mv, epoch, ingest, commit, fresh,
                        max(0.0, now - anchor),
                        _quantile(fr, 0.50), _quantile(fr, 0.99),
                        len(ring)))
        return out

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-MV p50/p99/last/commits — the bench detail block."""
        with self._lock:
            snap = {mv: list(ring) for mv, ring in self._rings.items()}
        out: Dict[str, Dict[str, Any]] = {}
        for mv, ring in sorted(snap.items()):
            fr = sorted(r[3] for r in ring)
            out[mv] = {"commits": len(ring),
                       "p50_s": round(_quantile(fr, 0.50), 6),
                       "p99_s": round(_quantile(fr, 0.99), 6),
                       "last_s": round(ring[-1][3], 6)}
        return out
