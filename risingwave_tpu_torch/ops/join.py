"""Streaming hash join (the port's own copy of the JAX package's
`ops/join.py`).

Reference: `src/stream/src/executor/hash_join.rs` (3.5k LoC north-star op):
two-input barrier-aligned loop (`:575-686`), per-side `JoinHashMap` over
row + degree state (`join/hash_join.rs:181`), eq-join per chunk with outer
null-row retraction driven by match degrees.

Degree bookkeeping (the part that makes outer joins incremental): every stored
row carries the count of current matches on the other side. A right insert
that takes a left row's degree 0→1 retracts the left row's null-padded output;
a delete that takes it 1→0 re-emits it (`join/hash_join.rs` degree table).

The host dict path is exact for all types; the device probe path for int keys
lives in `device/join_step.py` (`ops/device_join.py`).
"""
from __future__ import annotations

import enum
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.chunk import Op, StreamChunk, StreamChunkBuilder
from ..core.schema import Field, Schema
from ..core import dtypes as T
from ..expr.expression import Expr
from ..state.state_table import StateTable
from .executor import Executor
from .message import Barrier, Message, Watermark


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT_OUTER = "left_outer"
    RIGHT_OUTER = "right_outer"
    FULL_OUTER = "full_outer"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    RIGHT_SEMI = "right_semi"
    RIGHT_ANTI = "right_anti"


class JoinEntry:
    """One stored input row + its current match degree."""
    __slots__ = ("row", "degree")

    def __init__(self, row: Tuple, degree: int = 0):
        self.row = row
        self.degree = degree


class JoinSide:
    """One side's state: key -> {pk: JoinEntry}
    (`JoinHashMap`, `src/stream/src/executor/join/hash_join.rs:181`).

    Contract (same as the reference): input rows are unique per pk (the
    upstream stream key) — the planner guarantees a stream key on every
    stream, inserting RowIdGen when the source has none."""

    def __init__(self, key_indices: Sequence[int], pk_indices: Sequence[int],
                 schema: Schema, state_table: Optional[StateTable] = None):
        self.key_indices = list(key_indices)
        self.pk_indices = list(pk_indices)
        self.schema = schema
        self.table: Dict[Tuple, Dict[Tuple, JoinEntry]] = {}
        self.state_table = state_table
        self._recovered = state_table is None

    def recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        n = len(self.schema)
        for srow in self.state_table.iter_all():
            row, degree = srow[:n], srow[n]
            key = tuple(row[i] for i in self.key_indices)
            pk = tuple(row[i] for i in self.pk_indices)
            self.table.setdefault(key, {})[pk] = JoinEntry(tuple(row), degree)

    def key_of(self, row: Sequence[Any]) -> Tuple:
        return tuple(row[i] for i in self.key_indices)

    def pk_of(self, row: Sequence[Any]) -> Tuple:
        return tuple(row[i] for i in self.pk_indices)

    def matches(self, key: Tuple) -> List[JoinEntry]:
        d = self.table.get(key)
        return list(d.values()) if d else []

    def insert(self, row: Tuple, degree: int) -> JoinEntry:
        e = JoinEntry(row, degree)
        self.table.setdefault(self.key_of(row), {})[self.pk_of(row)] = e
        return e

    def remove(self, row: Tuple) -> Optional[JoinEntry]:
        key = self.key_of(row)
        d = self.table.get(key)
        if not d:
            return None
        e = d.pop(self.pk_of(row), None)
        if not d:
            del self.table[key]
        return e

    def persist(self, epoch: int) -> None:
        """Rewrite dirty state at barrier. Incremental write-set tracking:
        entries touched since last barrier are re-upserted."""
        if self.state_table is None:
            return
        # write-through happens in the executor via _mark_dirty
        self.state_table.commit(epoch)

    def upsert_state(self, e: JoinEntry) -> None:
        if self.state_table is not None:
            self.state_table.insert(e.row + (e.degree,))

    def delete_state(self, e: JoinEntry) -> None:
        if self.state_table is not None:
            self.state_table.delete(e.row + (e.degree,))


def _null_row(n: int) -> Tuple:
    return tuple([None] * n)


class HashJoinExecutor(Executor):
    def __init__(self, left: Executor, right: Executor,
                 left_keys: Sequence[int], right_keys: Sequence[int],
                 join_type: JoinType = JoinType.INNER,
                 condition: Optional[Expr] = None,
                 left_pk: Optional[Sequence[int]] = None,
                 right_pk: Optional[Sequence[int]] = None,
                 left_state: Optional[StateTable] = None,
                 right_state: Optional[StateTable] = None,
                 max_chunk_size: int = 1024):
        if join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            schema = left.schema
        elif join_type in (JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
            schema = right.schema
        else:
            schema = left.schema.concat(right.schema)
        super().__init__(schema, f"HashJoin[{join_type.value}]")
        # inner/semi joins of append-only inputs only ever insert; outer
        # joins retract their NULL-padded rows, anti joins retract on probe
        self.append_only = (left.append_only and right.append_only
                            and join_type in (JoinType.INNER,
                                              JoinType.LEFT_SEMI,
                                              JoinType.RIGHT_SEMI))
        self.left_exec, self.right_exec = left, right
        self.join_type = join_type
        self.condition = condition
        lpk = list(left_pk) if left_pk is not None else list(range(len(left.schema)))
        rpk = list(right_pk) if right_pk is not None else list(range(len(right.schema)))
        self.sides = {
            "l": JoinSide(left_keys, lpk, left.schema, left_state),
            "r": JoinSide(right_keys, rpk, right.schema, right_state),
        }
        self.max_chunk_size = max_chunk_size
        # watermark min-alignment on equi-key pairs (hash_join.rs derives
        # output watermarks ONLY for key columns: state rows below both
        # sides' key watermark can never match again — non-key watermarks
        # don't survive a join because old state rows resurface in output).
        self._wm: Dict[str, Dict[int, Any]] = {"l": {}, "r": {}}
        self._emitted_wm: Dict[int, Any] = {}
        self._clean_wm: Dict[int, Any] = {}   # key_pos -> aligned watermark

    # ---- condition eval, vectorized over all candidates of one input row ----
    def _filter_matches(self, side: str, row: Tuple,
                        cands: List[JoinEntry]) -> List[JoinEntry]:
        if self.condition is None or not cands:
            return cands
        from ..core.chunk import DataChunk
        if side == "l":
            rows = [row + e.row for e in cands]
        else:
            rows = [e.row + row for e in cands]
        ch = DataChunk.from_rows(
            self.left_exec.schema.dtypes + self.right_exec.schema.dtypes, rows)
        c = self.condition.eval(ch)
        return [e for e, ok, valid in zip(cands, c.values, c.validity)
                if valid and ok]

    def _joined(self, side: str, this_row: Tuple, other_row: Tuple) -> Tuple:
        return (this_row + other_row) if side == "l" else (other_row + this_row)

    def _process_row(self, side: str, op: Op, row: Tuple,
                     out: StreamChunkBuilder) -> None:
        """Apply one input row from `side`, appending output rows to `out`.
        Degree algebra per `join/hash_join.rs`: matches' degrees move with
        this row; 0↔1 transitions drive outer null-row and semi/anti flips."""
        jt = self.join_type
        me = self.sides[side]
        other = self.sides["r" if side == "l" else "l"]
        key = me.key_of(row)
        # SQL NULL semantics: a NULL key equals nothing, including another
        # NULL — such rows match nothing and are not stored (the reference
        # null-checks key columns in hash_join.rs before probing)
        has_null_key = any(v is None for v in key)
        matches = [] if has_null_key else \
            self._filter_matches(side, row, other.matches(key))
        null_other = _null_row(len(other.schema))
        null_me = _null_row(len(me.schema))
        is_insert = op.is_insert
        d = 1 if is_insert else -1

        # update state + degrees first
        if has_null_key:
            pass
        elif is_insert:
            me.upsert_state(me.insert(row, len(matches)))
        else:
            e = me.remove(row)
            if e is not None:
                me.delete_state(e)
        for m in matches:
            m.degree += d
            other.upsert_state(m)

        # emission, per join type
        outer_types = (JoinType.INNER, JoinType.LEFT_OUTER,
                       JoinType.RIGHT_OUTER, JoinType.FULL_OUTER)
        if jt in outer_types:
            this_outer = jt == JoinType.FULL_OUTER or \
                (jt == JoinType.LEFT_OUTER and side == "l") or \
                (jt == JoinType.RIGHT_OUTER and side == "r")
            other_outer = jt == JoinType.FULL_OUTER or \
                (jt == JoinType.LEFT_OUTER and side == "r") or \
                (jt == JoinType.RIGHT_OUTER and side == "l")
            if this_outer and not matches:
                out.append_row(Op.INSERT if is_insert else Op.DELETE,
                               self._joined(side, row, null_other))
            for m in matches:
                if other_outer and is_insert and m.degree == 1:
                    # other row gains its first match: null row -> joined row
                    out.append_update(self._joined(side, null_me, m.row),
                                      self._joined(side, row, m.row))
                elif other_outer and not is_insert and m.degree == 0:
                    # other row loses its last match: joined row -> null row
                    out.append_update(self._joined(side, row, m.row),
                                      self._joined(side, null_me, m.row))
                else:
                    out.append_row(Op.INSERT if is_insert else Op.DELETE,
                                   self._joined(side, row, m.row))
            return

        is_anti = jt in (JoinType.LEFT_ANTI, JoinType.RIGHT_ANTI)
        output_side = "l" if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI) else "r"
        if side == output_side:
            # arrival on the output side: emit iff (has match) != anti
            if (len(matches) > 0) != is_anti:
                out.append_row(Op.INSERT if is_insert else Op.DELETE, row)
        else:
            # arrival on the probe side flips output rows on 0<->1 transitions
            for m in matches:
                if is_insert and m.degree == 1:
                    out.append_row(Op.DELETE if is_anti else Op.INSERT, m.row)
                elif not is_insert and m.degree == 0:
                    out.append_row(Op.INSERT if is_anti else Op.DELETE, m.row)

    def _process_chunk(self, side: str, chunk: StreamChunk
                       ) -> Iterator[StreamChunk]:
        out = StreamChunkBuilder(self.schema.dtypes, self.max_chunk_size)
        for op, row in chunk.compact().op_rows():
            # updates decay to delete+insert; RW preserves pairs when the key
            # is unchanged — semantically equivalent downstream
            self._process_row(side, op, row, out)
        yield from out.drain()

    def execute(self) -> Iterator[Message]:
        for s in self.sides.values():
            s.recover()
        liter = self.left_exec.execute()
        riter = self.right_exec.execute()
        alive = True
        while alive:
            barrier = None
            for side, it in (("l", liter), ("r", riter)):
                while True:
                    try:
                        msg = next(it)
                    except StopIteration:
                        alive = False
                        break
                    if isinstance(msg, Barrier):
                        barrier = msg
                        break
                    if isinstance(msg, StreamChunk):
                        if msg.cardinality:
                            yield from self._process_chunk(side, msg)
                    elif isinstance(msg, Watermark):
                        yield from self._on_watermark(side, msg)
            if barrier is None:
                return
            self._clean_state()
            for s in self.sides.values():
                if s.state_table is not None:
                    s.state_table.commit(barrier.epoch.curr)
            yield barrier.with_trace(self.name)
            if barrier.is_stop():
                return

    def _on_watermark(self, side: str, wm: Watermark) -> Iterator[Message]:
        me = self.sides[side]
        if wm.col_idx not in me.key_indices:
            return
        kp = me.key_indices.index(wm.col_idx)
        self._wm[side][kp] = wm.value
        other = "r" if side == "l" else "l"
        ov = self._wm[other].get(kp)
        if ov is None:
            return
        low = min(wm.value, ov)
        prev = self._emitted_wm.get(kp)
        if prev is not None and low <= prev:
            return
        self._emitted_wm[kp] = low
        self._clean_wm[kp] = low
        nl = len(self.left_exec.schema)
        lcol = self.sides["l"].key_indices[kp]
        rcol = self.sides["r"].key_indices[kp]
        if self.join_type in (JoinType.INNER, JoinType.LEFT_OUTER,
                              JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
            yield Watermark(lcol, wm.dtype, low)
            yield Watermark(nl + rcol, wm.dtype, low)
        elif self.join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            yield Watermark(lcol, wm.dtype, low)
        else:
            yield Watermark(rcol, wm.dtype, low)

    def _clean_state(self) -> None:
        """Drop state rows below the aligned key watermark — they can never
        match a future row on either side (`state_table.rs:1002` analog)."""
        if not self._clean_wm:
            return
        for kp, wv in self._clean_wm.items():
            for s in self.sides.values():
                dead = [k for k in s.table
                        if k[kp] is not None and k[kp] < wv]
                for k in dead:
                    for e in s.table.pop(k).values():
                        s.delete_state(e)
        self._clean_wm.clear()
