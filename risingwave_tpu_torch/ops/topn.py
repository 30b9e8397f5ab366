"""TopN executors (plain + grouped) — the port's own copy of the JAX
package's `ops/topn.py`.

Reference: `src/stream/src/executor/top_n/` (`top_n_plain.rs`, `group_top_n.rs`,
`top_n_cache.rs`): maintain the ordered state per (group), emit window deltas
when rows enter/leave [offset, offset+limit).

Incremental emission: an insert/delete at sorted position p shifts the window
boundary only — at most one row enters and one leaves, found in O(log n) via
bisect on the memcomparable sort key (the same key encoding the state table
uses, so in-memory order == durable order).
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.chunk import Op, StreamChunk, StreamChunkBuilder
from ..core.encoding import encode_key, encode_row
from ..core.schema import Schema
from ..state.state_table import StateTable
from .executor import Executor, UnaryExecutor
from .message import Barrier, Message


class _OrderedMultiset:
    """Sorted (sort_key_bytes, row) list with bisect ops."""

    __slots__ = ("items",)

    def __init__(self):
        self.items: List[Tuple[bytes, Tuple]] = []

    def insert(self, key: bytes, row: Tuple) -> int:
        pos = bisect.bisect_left(self.items, (key, row))
        self.items.insert(pos, (key, row))
        return pos

    def remove(self, key: bytes, row: Tuple) -> Optional[int]:
        pos = bisect.bisect_left(self.items, (key, row))
        if pos < len(self.items) and self.items[pos] == (key, row):
            del self.items[pos]
            return pos
        return None

    def __len__(self):
        return len(self.items)

    def at(self, i: int) -> Optional[Tuple[bytes, Tuple]]:
        return self.items[i] if 0 <= i < len(self.items) else None


class TopNExecutor(UnaryExecutor):
    """ORDER BY ... OFFSET o LIMIT l over the whole stream (`top_n_plain.rs`)."""

    def __init__(self, input: Executor, order_by: Sequence[Tuple[int, bool]],
                 limit: int, offset: int = 0,
                 state_table: Optional[StateTable] = None,
                 group_key: Sequence[int] = ()):
        super().__init__(input, input.schema,
                         "GroupTopN" if group_key else "TopN")
        self.order_by = list(order_by)
        self.limit = limit
        self.offset = offset
        self.group_key = list(group_key)
        self.groups: Dict[Tuple, _OrderedMultiset] = {}
        self.state_table = state_table
        self._recovered = state_table is None

    def _sort_key(self, row: Tuple) -> bytes:
        cols = [row[i] for i, _ in self.order_by]
        dts = [self.schema.dtypes[i] for i, _ in self.order_by]
        desc = [d for _, d in self.order_by]
        # full-row value encoding as a stable tiebreak
        return encode_key(cols, dts, desc) + encode_row(row, self.schema.dtypes)

    def _recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        for row in self.state_table.iter_all():
            g = tuple(row[i] for i in self.group_key)
            self.groups.setdefault(g, _OrderedMultiset()).insert(
                self._sort_key(row), tuple(row))

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        self._recover()
        out = StreamChunkBuilder(self.schema.dtypes)
        lo, hi = self.offset, self.offset + self.limit
        for op, row in chunk.compact().op_rows():
            g = tuple(row[i] for i in self.group_key)
            ms = self.groups.get(g)
            if ms is None:
                ms = self.groups[g] = _OrderedMultiset()
            key = self._sort_key(row)
            if op.is_insert:
                pos = ms.insert(key, row)
                if self.state_table is not None:
                    self.state_table.insert(row)
                if pos < hi:
                    # element shifted to index hi (old hi-1) exits the window
                    exiting = ms.at(hi)
                    if exiting is not None:
                        out.append_row(Op.DELETE, exiting[1])
                    # p < lo: old element at lo-1 shifted into the window
                    # start; lo <= p < hi: the new row itself enters
                    entering = ms.at(lo) if pos < lo else (key, row)
                    if entering is not None:
                        out.append_row(Op.INSERT, entering[1])
            else:
                pos = ms.remove(key, row)
                if pos is None:
                    continue  # unknown row; ignore (consistency wrapper logs)
                if self.state_table is not None:
                    self.state_table.delete(row)
                if pos < hi:
                    if pos < lo:
                        # row above window removed: old [lo] (now at lo-1)
                        # falls out of the window
                        exiting = ms.at(lo - 1)
                        if exiting is not None:
                            out.append_row(Op.DELETE, exiting[1])
                    else:
                        out.append_row(Op.DELETE, row)
                    # old [hi] (now at hi-1) shifts into the window
                    entering = ms.at(hi - 1)
                    if entering is not None and len(ms) >= hi:
                        out.append_row(Op.INSERT, entering[1])
        yield from out.drain()

    def on_barrier(self, barrier: Barrier) -> Iterator[Message]:
        if self.state_table is not None:
            self.state_table.commit(barrier.epoch.curr)
        return iter(())


class AppendOnlyDedupExecutor(UnaryExecutor):
    """Drop duplicate keys in an append-only stream (`dedup/append_only_dedup.rs`)."""

    def __init__(self, input: Executor, key_indices: Sequence[int],
                 state_table: Optional[StateTable] = None):
        super().__init__(input, input.schema, "AppendOnlyDedup")
        self.append_only = input.append_only
        self.key_indices = list(key_indices)
        self.seen: set = set()
        self.state_table = state_table
        self._recovered = state_table is None

    def _recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        for row in self.state_table.iter_all():
            self.seen.add(tuple(row[i] for i in self.key_indices))

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        self._recover()
        import numpy as np
        chunk = chunk.compact()
        keep = np.zeros(chunk.capacity, dtype=bool)
        for i in range(chunk.capacity):
            k = tuple(chunk.columns[j].get(i) for j in self.key_indices)
            if k not in self.seen:
                self.seen.add(k)
                keep[i] = True
                if self.state_table is not None:
                    self.state_table.insert(chunk.row_at(i))
        if keep.any():
            yield chunk.with_visibility(keep)

    def on_barrier(self, barrier: Barrier) -> Iterator[Message]:
        if self.state_table is not None:
            self.state_table.commit(barrier.epoch.curr)
        return iter(())
