"""Epoch-versioned MV read cache: the serving tier's host-side half (the
port's own copy of the JAX package's `serving/read_cache.py`).

Every SELECT against a fused MV ultimately costs one synchronised device
pull (`FusedJob.mv_rows_now`: the MV state copied to the host and
formatted; under a mesh, the shards' sorted runs merged). Between two
checkpoint commits that pull returns the SAME rows — the MV only
changes at barrier commits — so the coordinator caches one
`(epoch, rows)` snapshot per MV and serves every reader in that commit
window from host memory:

* **Versioning** — a snapshot is stamped with the committed epoch the
  pull reflected (the fill returns it beside the rows: the JAX
  package's `FusedJob.mv_rows_versioned`, or a job's `committed` with
  its `mv_rows_now()` where the barrier loop and the readers share a
  thread). A commit does not eagerly refill anything;
  it merely advances `committed_epoch`, which makes stale snapshots
  unservable. The FIRST read after a commit repopulates — so a restart
  or in-place recovery simply starts cold and heals on first contact.

* **Staleness bound** — a snapshot serves iff
  `cache_epoch >= committed_epoch - staleness` (the
  `rw_serving_staleness_epochs` knob; 0 = always-fresh, the cache still
  coalesces all readers within one commit window).

* **Request coalescing** — concurrent cache-miss readers of one MV
  block on a per-MV condition while a single filler runs the device
  pull; they wake into a cache hit. One device pull per (MV, epoch)
  regardless of reader count — the acceptance invariant, asserted by
  counting the fills.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class _Entry:
    __slots__ = ("epoch", "rows", "filling", "hits", "misses",
                 "coalesced", "fills", "fill_ts")

    def __init__(self) -> None:
        self.epoch = -1
        self.rows: Optional[List[Tuple]] = None
        self.filling = False
        self.hits = 0
        self.misses = 0
        self.coalesced = 0
        self.fills = 0
        # wall clock of the last fill: a snapshot reflects commits up
        # to this moment — the served-staleness anchor rw_mv_freshness
        # reports for cache-lagged reads
        self.fill_ts: Optional[float] = None


class MVReadCache:
    """Per-MV `(epoch, rows)` snapshots with single-flight fills."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._conds: Dict[str, threading.Condition] = {}

    def _slot(self, name: str) -> Tuple[_Entry, threading.Condition]:
        with self._lock:
            ent = self._entries.get(name)
            if ent is None:
                ent = self._entries[name] = _Entry()
                self._conds[name] = threading.Condition()
            return ent, self._conds[name]

    def peek(self, name: str, committed_epoch: int,
             staleness: int = 0) -> Optional[List[Tuple]]:
        """Servable snapshot or None — no fill, no blocking, no stats."""
        with self._lock:
            ent = self._entries.get(name)
        if ent is None or ent.rows is None:
            return None
        return ent.rows if ent.epoch >= committed_epoch - staleness \
            else None

    def get(self, name: str, committed_epoch: int, staleness: int,
            fill: Callable[[], Tuple[int, List[Tuple]]]
            ) -> Tuple[int, List[Tuple]]:
        """Serve `name` as of (at least) `committed_epoch - staleness`,
        filling through `fill` (-> (epoch, rows)) on miss. Concurrent missers
        coalesce onto one fill."""
        ent, cond = self._slot(name)
        waited = False
        with cond:
            while True:
                if ent.rows is not None \
                        and ent.epoch >= committed_epoch - staleness:
                    ent.hits += 1
                    if waited:
                        ent.coalesced += 1
                    return ent.epoch, ent.rows
                if ent.filling:
                    waited = True
                    cond.wait()
                    continue
                ent.filling = True
                ent.misses += 1
                break
        try:
            epoch, rows = fill()
            with cond:
                if epoch >= ent.epoch:
                    ent.epoch, ent.rows = int(epoch), rows
                    ent.fill_ts = time.time()
                ent.fills += 1
            return int(epoch), rows
        finally:
            with cond:
                ent.filling = False
                cond.notify_all()

    def invalidate(self, name: Optional[str] = None) -> None:
        """Forget one MV's snapshot (DROP) or everything (recovery /
        rebalance: the cache rebuilds cold, first read repopulates).
        Never called on commit — staleness does that job lazily."""
        with self._lock:
            if name is None:
                self._entries.clear()
                self._conds.clear()
            else:
                self._entries.pop(name, None)
                self._conds.pop(name, None)

    def fill_time(self, name: str) -> Optional[float]:
        """Wall clock of `name`'s last snapshot fill (None when cold)."""
        with self._lock:
            ent = self._entries.get(name)
        return ent.fill_ts if ent is not None else None

    def stats(self) -> Dict[str, int]:
        with self._lock:
            ents = list(self._entries.values())
        return {"hits": sum(e.hits for e in ents),
                "misses": sum(e.misses for e in ents),
                "coalesced": sum(e.coalesced for e in ents),
                "fills": sum(e.fills for e in ents)}

    def report(self) -> List[Tuple[str, int, int, int, int, int, int]]:
        """Per-MV rows for the `rw_serving_cache` system table /
        `risectl serving`: (mv, cache_epoch, cached_rows, hits, misses,
        coalesced, fills)."""
        with self._lock:
            items = sorted(self._entries.items())
        return [(name, e.epoch, len(e.rows) if e.rows is not None else 0,
                 e.hits, e.misses, e.coalesced, e.fills)
                for name, e in items]
