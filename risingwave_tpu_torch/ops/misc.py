"""Misc stream executors: Changelog, Now, DynamicFilter, watermark Sort
(the port's own copy of the JAX package's `ops/misc.py`).

Reference executors (`src/stream/src/executor/{changelog.rs, now.rs,
dynamic_filter.rs, sort.rs}`) that round out the NodeBody inventory:

* `ChangelogExecutor` — turns a retractable change stream into an
  append-only stream with an explicit `op` column (the CDC-export shape;
  uniqueness of output rows comes from the planner-appended stream key,
  the same contract every append-only stream here carries).
* `NowExecutor` — a one-column source that holds the current barrier
  timestamp, emitting an update pair per (checkpoint) barrier; feeds
  temporal filters.
* `DynamicFilterExecutor` — filter whose RHS is a dynamic scalar from a
  second (single-row) stream: rows cross in/out of the output when the
  bound moves (`WHERE v > (SELECT max(x) FROM m)`).
* `SortExecutor` — watermark-driven reorder: buffer until the event-time
  watermark passes, emit in order below it (EOWC building block).
"""
from __future__ import annotations

import operator
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core import dtypes as T
from ..core.chunk import Column, Op, StreamChunk, StreamChunkBuilder
from ..core.schema import Field, Schema
from ..state.state_table import StateTable
from .executor import Executor, UnaryExecutor
from .message import Barrier, Message, Watermark


class ChangelogExecutor(UnaryExecutor):
    """Retractable stream -> append-only changelog (`changelog.rs`):
    every input row becomes an INSERT carrying its original op code.

    With `with_row_id`, the schema additionally declares the hidden
    `_changelog_row_id` column the reference exposes; a downstream
    RowIdGenExecutor mints it (chunks leave here without it)."""

    def __init__(self, input: Executor, op_name: str = "op",
                 with_row_id: bool = False):
        fields = list(input.schema.fields) + [Field(op_name, T.INT32)]
        if with_row_id:
            fields.append(Field("_changelog_row_id", T.SERIAL))
        super().__init__(input, Schema(fields), "Changelog")
        self.append_only = True

    # Internal Op order is INSERT=0, DELETE=1, UPDATE_DELETE=2,
    # UPDATE_INSERT=3; the exported CDC contract (`stream_chunk.rs:84`
    # Op::to_i16) is Insert=1, Delete=2, UpdateInsert=3, UpdateDelete=4.
    _OP_EXPORT = np.array([1, 2, 4, 3], dtype=np.int32)

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        chunk = chunk.compact()
        cols = list(chunk.columns)
        cols.append(Column(T.INT32, self._OP_EXPORT[chunk.ops]))
        yield StreamChunk(np.zeros(chunk.capacity, dtype=np.int8), cols)


class NowExecutor(Executor):
    """One-row source holding the barrier timestamp (`now.rs`): emits
    INSERT at the first barrier, then U-/U+ pairs as time advances.
    Epochs encode wall-time; the value is the barrier's epoch time."""

    def __init__(self, barrier_source: Executor,
                 state_table: Optional[StateTable] = None):
        super().__init__(Schema.of(("now", T.TIMESTAMP)), "Now")
        self.barrier_source = barrier_source
        self.state_table = state_table
        self._last: Optional[int] = None
        self._recovered = state_table is None

    def _recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        for row in self.state_table.iter_all():
            self._last = row[0]

    def execute(self) -> Iterator[Message]:
        from ..core.epoch import physical_time_ms
        for msg in self.barrier_source.execute():
            if isinstance(msg, Barrier):
                self._recover()
                nowv = physical_time_ms(msg.epoch.curr) * 1000
                # Guard the WHOLE update on strict advance: if the barrier
                # timestamp ever regressed, writing state while emitting
                # nothing would make durable state diverge from what
                # downstream saw (silent backwards jump after recovery).
                if self._last is None or nowv > self._last:
                    if self._last is None:
                        yield StreamChunk.from_rows(
                            self.schema.dtypes, [(Op.INSERT, (nowv,))])
                    else:
                        yield StreamChunk.from_rows(
                            self.schema.dtypes,
                            [(Op.UPDATE_DELETE, (self._last,)),
                             (Op.UPDATE_INSERT, (nowv,))])
                    if self.state_table is not None:
                        if self._last is not None:
                            self.state_table.delete((self._last,))
                        self.state_table.insert((nowv,))
                        self.state_table.commit(msg.epoch.curr)
                    self._last = nowv
                yield Watermark(0, T.TIMESTAMP, self._last)
                yield msg.with_trace(self.name)
            elif isinstance(msg, StreamChunk):
                pass                       # barriers only
            else:
                yield msg


_CMP = {">": operator.gt, ">=": operator.ge,
        "<": operator.lt, "<=": operator.le, "=": operator.eq}


class DynamicFilterExecutor(Executor):
    """`left.col <cmp> right_scalar` where the scalar is a 1-row stream
    (`dynamic_filter.rs`): when the bound moves, previously-passing rows
    retract and newly-passing rows emit from the left state."""

    def __init__(self, left: Executor, right: Executor, key_col: int,
                 cmp: str, state_table: Optional[StateTable] = None):
        super().__init__(left.schema, f"DynamicFilter[{cmp}]")
        self.left_exec, self.right_exec = left, right
        self.key_col = key_col
        self.cmp = _CMP[cmp]
        self.state_table = state_table
        self._bound: Optional[Any] = None
        self._rows: Dict[Tuple, int] = {}     # row -> multiplicity
        self._recovered = state_table is None

    def _recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        for row in self.state_table.iter_all():
            r, n = tuple(row[:-1]), row[-1]
            self._rows[r] = self._rows.get(r, 0) + n

    def _passes(self, row: Tuple) -> bool:
        v = row[self.key_col]
        return (v is not None and self._bound is not None
                and self.cmp(v, self._bound))

    def execute(self) -> Iterator[Message]:
        liter = self.left_exec.execute()
        riter = self.right_exec.execute()
        out = StreamChunkBuilder(self.schema.dtypes)
        while True:
            new_bound = self._bound
            # drain right to its barrier, applying ops in order: a DELETE
            # with no re-insert means the scalar became NULL (empty
            # subquery) and the comparison passes nothing
            for msg in riter:
                if isinstance(msg, Barrier):
                    break
                if isinstance(msg, StreamChunk):
                    for op, r in msg.compact().op_rows():
                        if op.is_insert:
                            new_bound = r[0]
                        elif r[0] == new_bound:
                            new_bound = None
            got_left_barrier = False
            for msg in liter:
                if isinstance(msg, Barrier):
                    self._recover()
                    # bound move: diff the stored rows' pass sets
                    if new_bound != self._bound:
                        old = self._bound
                        for row, n in self._rows.items():
                            v = row[self.key_col]
                            if v is None or n <= 0:
                                continue
                            was = old is not None and self.cmp(v, old)
                            now = new_bound is not None \
                                and self.cmp(v, new_bound)
                            if was == now:
                                continue
                            for _ in range(n):
                                out.append_row(
                                    Op.INSERT if now else Op.DELETE, row)
                        self._bound = new_bound
                    for chunk in out.drain():
                        yield chunk
                    if self.state_table is not None:
                        self.state_table.commit(msg.epoch.curr)
                    yield msg.with_trace(self.name)
                    got_left_barrier = True
                    break
                if isinstance(msg, StreamChunk):
                    self._recover()
                    for op, row in msg.compact().op_rows():
                        n0 = self._rows.get(row, 0)
                        n1 = n0 + op.sign
                        if n1 <= 0:
                            self._rows.pop(row, None)   # no dead entries
                        else:
                            self._rows[row] = n1
                        if self.state_table is not None:
                            if n1 <= 0:
                                self.state_table.delete(row + (n0,))
                            else:
                                self.state_table.insert(row + (n1,))
                        if self._passes(row):
                            out.append_row(
                                Op.INSERT if op.is_insert else Op.DELETE,
                                row)
                    for chunk in out.drain():
                        yield chunk
                elif isinstance(msg, Watermark):
                    yield msg
            if not got_left_barrier:
                return


class SortExecutor(UnaryExecutor):
    """Event-time reorder (`sort.rs`): buffer append-only rows, release
    them in sort order once the watermark passes their event time."""

    def __init__(self, input: Executor, time_col: int,
                 state_table: Optional[StateTable] = None):
        super().__init__(input, input.schema, "Sort")
        self.append_only = input.append_only
        self.time_col = time_col
        self.state_table = state_table
        self._buf: List[Tuple] = []
        self._wm: Optional[Any] = None
        self._recovered = state_table is None

    def _recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        self._buf.extend(self.state_table.iter_all())

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        self._recover()
        for op, row in chunk.compact().op_rows():
            assert op.is_insert, "SortExecutor requires append-only input"
            self._buf.append(row)
            if self.state_table is not None:
                self.state_table.insert(row)
        return iter(())

    def on_watermark(self, wm: Watermark) -> Iterator[Message]:
        if wm.col_idx != self.time_col:
            yield wm              # other columns' watermarks pass through
            return
        self._recover()
        self._wm = wm.value
        ready = sorted((r for r in self._buf
                        if r[self.time_col] is not None
                        and r[self.time_col] <= wm.value),
                       key=lambda r: r[self.time_col])
        if ready:
            self._buf = [r for r in self._buf
                         if r[self.time_col] is None
                         or r[self.time_col] > wm.value]
            for r in ready:
                if self.state_table is not None:
                    self.state_table.delete(r)
            yield StreamChunk.from_rows(
                self.schema.dtypes, [(Op.INSERT, r) for r in ready])
        yield wm

    def on_barrier(self, barrier: Barrier) -> Iterator[Message]:
        if self.state_table is not None:
            self.state_table.commit(barrier.epoch.curr)
        return iter(())
