"""Streaming ASOF join (the port's own copy of the JAX package's
`ops/asof_join.py`).

Reference: `src/stream/src/executor/asof_join.rs` (AsOfJoinExecutor):
`a ASOF [LEFT] JOIN b ON a.k = b.k AND a.t <cmp> b.t` — per left row, at
most ONE right row joins: the one with the same key whose inequality
column is *closest* to the left's while satisfying the comparison
(`AsOfInequalityType` + the BTreeMap lower/upper_bound probe,
asof_join.rs:625). Streaming semantics: when a better right row arrives
(or the current match is deleted), the previously emitted pair retracts
and the new best pair emits.

Best-match rule (asof_join.rs:625-645):
    l <  r  -> smallest right > l          l >  r -> largest right < l
    l <= r  -> smallest right >= l         l >= r -> largest right <= l
Ties on the inequality value break deterministically by right pk (the
reference iterates its (ineq, pk)-ordered BTreeMap the same way).

Re-design vs the reference: instead of the cache/degree machinery, each
side keeps key -> {pk: row} plus a per-left-row record of the CURRENTLY
EMITTED output row; a right-side change marks its key dirty and the
executor re-derives best matches for that key's left rows at chunk
granularity, emitting only the diff. Exactness over incrementality — the
per-key scan is the simple host path (the device path batches at barrier
granularity anyway).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.chunk import Op, StreamChunk, StreamChunkBuilder
from ..core.schema import Schema
from ..state.state_table import StateTable
from .executor import Executor
from .message import Barrier, Message, Watermark

_OPS = ("<", "<=", ">", ">=")


def _null_row(n: int) -> Tuple:
    return tuple(None for _ in range(n))


class _Side:
    """key -> {pk: row}; rows also mirrored to the state table."""

    def __init__(self, key_idx: Sequence[int], pk_idx: Sequence[int],
                 state_table: Optional[StateTable]):
        self.key_idx = list(key_idx)
        self.pk_idx = list(pk_idx)
        self.state_table = state_table
        self.data: Dict[Tuple, Dict[Tuple, Tuple]] = {}

    def key_of(self, row: Tuple) -> Tuple:
        return tuple(row[i] for i in self.key_idx)

    def pk_of(self, row: Tuple) -> Tuple:
        return tuple(row[i] for i in self.pk_idx)

    def insert(self, row: Tuple) -> None:
        self.data.setdefault(self.key_of(row), {})[self.pk_of(row)] = row
        if self.state_table is not None:
            self.state_table.insert(row)

    def delete(self, row: Tuple) -> None:
        key = self.key_of(row)
        group = self.data.get(key)
        if group is not None:
            group.pop(self.pk_of(row), None)
            if not group:
                del self.data[key]
        if self.state_table is not None:
            self.state_table.delete(row)

    def recover(self) -> None:
        if self.state_table is None:
            return
        for row in self.state_table.iter_all():
            row = tuple(row)
            self.data.setdefault(self.key_of(row), {})[self.pk_of(row)] = row


class AsOfJoinExecutor(Executor):
    def __init__(self, left: Executor, right: Executor,
                 left_keys: Sequence[int], right_keys: Sequence[int],
                 left_ineq: int, right_ineq: int, ineq_op: str,
                 left_outer: bool = False,
                 left_pk: Optional[Sequence[int]] = None,
                 right_pk: Optional[Sequence[int]] = None,
                 left_state: Optional[StateTable] = None,
                 right_state: Optional[StateTable] = None):
        assert ineq_op in _OPS, ineq_op
        schema = left.schema.concat(right.schema)
        super().__init__(schema,
                         f"AsOfJoin[{'left' if left_outer else 'inner'}]")
        self.append_only = False          # better matches displace old ones
        self.left_exec, self.right_exec = left, right
        self.ineq_op = ineq_op
        self.left_ineq, self.right_ineq = left_ineq, right_ineq
        self.left_outer = left_outer
        lpk = list(left_pk) if left_pk is not None \
            else list(range(len(left.schema)))
        rpk = list(right_pk) if right_pk is not None \
            else list(range(len(right.schema)))
        self.lside = _Side(left_keys, lpk, left_state)
        self.rside = _Side(right_keys, rpk, right_state)
        self._n_r = len(right.schema)
        # left pk -> currently emitted output row (None = nothing emitted)
        self._emitted: Dict[Tuple, Optional[Tuple]] = {}
        # equi-key watermark alignment, as in hash_join.rs
        self._wm: Dict[str, Dict[int, Any]] = {"l": {}, "r": {}}
        self._emitted_wm: Dict[int, Any] = {}

    # ---- best-match ------------------------------------------------------
    def _best(self, lrow: Tuple) -> Optional[Tuple]:
        v = lrow[self.left_ineq]
        if v is None:
            return None
        key = self.lside.key_of(lrow)
        if any(k is None for k in key):
            return None
        group = self.rside.data.get(key)
        if not group:
            return None
        op = self.ineq_op
        best_item = None
        for pk, row in group.items():
            rv = row[self.right_ineq]
            if rv is None:
                continue
            ok = ((op == "<" and v < rv) or (op == "<=" and v <= rv)
                  or (op == ">" and v > rv) or (op == ">=" and v >= rv))
            if not ok:
                continue
            item = (rv, pk)
            if best_item is None:
                best_item = (item, row)
            elif op in ("<", "<="):          # closest above: smallest
                if item < best_item[0]:
                    best_item = (item, row)
            else:                            # closest below: largest
                if item > best_item[0]:
                    best_item = (item, row)
        return best_item[1] if best_item else None

    def _out_row(self, lrow: Tuple) -> Optional[Tuple]:
        m = self._best(lrow)
        if m is not None:
            return lrow + m
        if self.left_outer:
            return lrow + _null_row(self._n_r)
        return None

    # ---- diff emission ---------------------------------------------------
    def _retarget(self, lpk: Tuple, new_out: Optional[Tuple],
                  out: StreamChunkBuilder) -> None:
        old = self._emitted.get(lpk)
        if old == new_out:
            return
        if old is not None and new_out is not None:
            out.append_row(Op.UPDATE_DELETE, old)
            out.append_row(Op.UPDATE_INSERT, new_out)
        elif old is not None:
            out.append_row(Op.DELETE, old)
        elif new_out is not None:
            out.append_row(Op.INSERT, new_out)
        if new_out is None:
            self._emitted.pop(lpk, None)
        else:
            self._emitted[lpk] = new_out

    def _process_chunk(self, side: str, chunk: StreamChunk
                       ) -> Iterator[Message]:
        out = StreamChunkBuilder(self.schema.dtypes, 1024)
        if side == "l":
            for op, row in chunk.compact().op_rows():
                row = tuple(row)
                lpk = self.lside.pk_of(row)
                if op.is_insert:
                    self.lside.insert(row)
                    self._retarget(lpk, self._out_row(row), out)
                else:
                    self.lside.delete(row)
                    self._retarget(lpk, None, out)
        else:
            dirty: Dict[Tuple, None] = {}
            for op, row in chunk.compact().op_rows():
                row = tuple(row)
                if op.is_insert:
                    self.rside.insert(row)
                else:
                    self.rside.delete(row)
                key = self.rside.key_of(row)
                if not any(k is None for k in key):
                    dirty[key] = None
            for key in dirty:
                for lpk, lrow in self.lside.data.get(key, {}).items():
                    self._retarget(lpk, self._out_row(lrow), out)
        yield from out.drain()

    # ---- watermarks: min-align equi-key columns (hash_join.rs rule) ------
    def _on_watermark(self, side: str, wm: Watermark) -> Iterator[Message]:
        me = self.lside if side == "l" else self.rside
        if wm.col_idx not in me.key_idx:
            return
        kp = me.key_idx.index(wm.col_idx)
        self._wm[side][kp] = wm.value
        ov = self._wm["r" if side == "l" else "l"].get(kp)
        if ov is None:
            return
        low = min(wm.value, ov)
        prev = self._emitted_wm.get(kp)
        if prev is not None and low <= prev:
            return
        self._emitted_wm[kp] = low
        nl = len(self.left_exec.schema)
        yield Watermark(self.lside.key_idx[kp], wm.dtype, low)
        yield Watermark(nl + self.rside.key_idx[kp], wm.dtype, low)

    # ---- barrier-aligned two-input loop ----------------------------------
    def execute(self) -> Iterator[Message]:
        self.lside.recover()
        self.rside.recover()
        # rebuild the emitted map from recovered state (no emission)
        for group in self.lside.data.values():
            for lpk, lrow in group.items():
                o = self._out_row(lrow)
                if o is not None:
                    self._emitted[lpk] = o
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
            for s in (self.lside, self.rside):
                if s.state_table is not None:
                    s.state_table.commit(barrier.epoch.curr)
            yield barrier.with_trace(self.name)
            if barrier.is_stop():
                return
