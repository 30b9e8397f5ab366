"""Process-placed fragment runtime — in the port so far only its durable
poison-pill quarantine store, `DeadLetterQueue` (the port's own copy of
that class of the JAX package's `runtime/remote_fragments.py`), over the
port's `state/state_table.StateTable`, and the `RemoteWorkerDied`
exception that `sql/database.py`'s worker liveness check raises.

The rest of the reference module — worker OS processes over the
credit-flow exchange, their supervision, respawn and wedge reaping, the
heartbeat frames of the metrics plane — is ROADMAP queue 1 item 8.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

from ..core import dtypes as T



class RemoteWorkerDied(RuntimeError):
    """A worker process of a remote fragment set died unsupervised (no
    such set can be planned in the port until item 8)."""


class DeadLetterQueue:
    """Durable poison-pill quarantine store — the rows behind the
    `rw_dead_letter` system table and `risectl dlq`.

    One row per sidelined input record:
        (id, job, slot, side, epoch, fingerprint, sign, row_repr,
         payload, status, ts)
    `payload` is the value-encoded row (exact requeue); `row_repr` is a
    human-readable audit copy; `status` walks quarantined -> requeued
    (or the row is purged). The table rides the normal state-store
    commit protocol, so quarantines are durable at the next checkpoint
    and survive coordinator restarts."""

    DTYPES = (T.INT64, T.VARCHAR, T.INT64, T.INT64, T.INT64, T.VARCHAR,
              T.INT64, T.VARCHAR, T.BYTEA, T.VARCHAR, T.FLOAT64)
    PK = (0,)

    def __init__(self, table):
        self.table = table
        self._next_id = 1 + max(
            [int(r[0]) for r in table.iter_all()], default=-1)

    def quarantine(self, job: str, slot: int, entries,
                   fingerprint: str, commit_epoch: int) -> int:
        """`entries`: (side, epoch, sign, row, payload) per sidelined
        record; returns the count written."""
        n = 0
        for side, epoch, sign, row, payload in entries:
            self.table.insert((self._next_id, job, slot, side, epoch,
                               fingerprint, sign, repr(tuple(row)),
                               payload, "quarantined", time.time()))
            self._next_id += 1
            n += 1
        if n:
            self.table.commit(commit_epoch)
        return n

    def entries(self, job: Optional[str] = None,
                status: Optional[str] = None) -> List[Tuple]:
        return sorted(tuple(r) for r in self.table.iter_all()
                      if (job is None or r[1] == job)
                      and (status is None or r[9] == status))

    def mark(self, ids, status: Optional[str], commit_epoch: int) -> int:
        """Flip entries to `status` (None = purge them outright)."""
        by_id = {int(r[0]): tuple(r) for r in self.table.iter_all()}
        n = 0
        for i in ids:
            r = by_id.get(int(i))
            if r is None:
                continue
            self.table.delete(r)
            if status is not None:
                self.table.insert(r[:9] + (status, r[10]))
            n += 1
        if n:
            self.table.commit(commit_epoch)
        return n
