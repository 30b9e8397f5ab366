"""State store backends.

Re-design of the reference's `StateStore` trait stack
(`src/storage/src/store.rs:259,335,364`): an ordered epoch-versioned KV per
table. Three backends, selected like `store_impl.rs:60-76`:

* `MemoryStateStore` — ordered in-memory tables (tests + hot working set);
* `SpillStateStore` (state/hummock.py) — LSM-lite: memtable + sorted-run
  files on the local "object store" with checkpoint manifests;
* device mirrors (device/sorted_state.py) — device-resident projections
  of hot operator state, rebuilt from the host store on recovery.

The port holds `MemoryStateStore`; `SpillStateStore` is still to port.

Keys are raw bytes (vnode prefix + memcomparable pk); values are decoded row
tuples on the hot path (value-encoding happens only at checkpoint, unlike the
reference which encodes on every write — host dict + lazy encode is the
faster layout here since the exact path lives in Python/numpy, not Rust).
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple


class KeyedTable:
    """One table: dict + lazily-rebuilt sorted key view.

    Writes are O(1) dict ops; the sorted view rebuilds once per scan after
    changes (ordered scans are rare next to writes — an epoch can upsert
    10^5 keys, and per-write `insort` would make the batch quadratic)."""

    __slots__ = ("data", "_sorted", "_dirty")

    def __init__(self):
        self.data: Dict[bytes, Tuple] = {}
        self._sorted: List[bytes] = []
        self._dirty = False

    def put(self, key: bytes, value: Tuple) -> None:
        if key not in self.data:
            self._dirty = True
        self.data[key] = value

    def delete(self, key: bytes) -> None:
        if self.data.pop(key, None) is not None:
            self._dirty = True

    def get(self, key: bytes) -> Optional[Tuple]:
        return self.data.get(key)

    def _keys(self) -> List[bytes]:
        if self._dirty:
            self._sorted = sorted(self.data.keys())
            self._dirty = False
        return self._sorted

    def iter_range(self, start: Optional[bytes], end: Optional[bytes]
                   ) -> Iterator[Tuple[bytes, Tuple]]:
        keys = self._keys()
        lo = bisect.bisect_left(keys, start) if start is not None else 0
        hi = bisect.bisect_left(keys, end) if end is not None else len(keys)
        for i in range(lo, hi):
            k = keys[i]
            v = self.data.get(k)
            if v is not None:
                yield k, v

    def __len__(self) -> int:
        return len(self.data)


class StateStore:
    """Backend interface (`StateStoreRead::{get,iter}` + ingest/commit)."""

    def get(self, table_id: int, key: bytes) -> Optional[Tuple]:
        raise NotImplementedError

    def iter_range(self, table_id: int, start: Optional[bytes],
                   end: Optional[bytes]) -> Iterator[Tuple[bytes, Tuple]]:
        raise NotImplementedError

    def ingest_batch(self, table_id: int,
                     batch: Sequence[Tuple[bytes, Optional[Tuple]]],
                     epoch: int) -> None:
        """Apply (key, row|None=delete) mutations for `epoch`."""
        raise NotImplementedError

    def commit_epoch(self, epoch: int) -> None:
        """Seal `epoch` durably (checkpoint barrier)."""
        raise NotImplementedError

    def table_len(self, table_id: int) -> int:
        raise NotImplementedError


class MemoryStateStore(StateStore):
    """In-memory backend (`src/storage/src/memory.rs` analog)."""

    def __init__(self):
        self.tables: Dict[int, KeyedTable] = {}
        self.committed_epoch: int = 0

    def _table(self, table_id: int) -> KeyedTable:
        t = self.tables.get(table_id)
        if t is None:
            t = self.tables[table_id] = KeyedTable()
        return t

    def get(self, table_id: int, key: bytes) -> Optional[Tuple]:
        return self._table(table_id).get(key)

    def iter_range(self, table_id: int, start: Optional[bytes],
                   end: Optional[bytes]) -> Iterator[Tuple[bytes, Tuple]]:
        return self._table(table_id).iter_range(start, end)

    def ingest_batch(self, table_id, batch, epoch):
        t = self._table(table_id)
        for key, row in batch:
            if row is None:
                t.delete(key)
            else:
                t.put(key, row)

    def commit_epoch(self, epoch):
        self.committed_epoch = max(self.committed_epoch, epoch)

    def table_len(self, table_id: int) -> int:
        return len(self._table(table_id))
