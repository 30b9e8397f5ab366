"""Temporal join: stream JOIN table FOR SYSTEM_TIME AS OF PROCTIME() (the
port's own copy of the JAX package's `ops/temporal_join.py`).

Reference: `src/stream/src/executor/temporal_join.rs:44`. The left side is
an (append-only) stream; the right side is a *version table* — its change
stream maintains an index, but versions are looked up, never joined
symmetrically: a left row matches the right side's CURRENT rows at
processing time, the output is append-only, and later right-side changes
never retract rows already emitted (the defining difference from a regular
streaming join, which would).

Barrier protocol: two-input alignment like HashJoin, with the right
(version) side drained first inside each epoch so lookups see the freshest
committed version — proc-time semantics make any intra-epoch interleaving
legal; this one is deterministic for tests.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.chunk import Op, StreamChunk, StreamChunkBuilder
from ..core.schema import Schema
from ..expr.expression import Expr
from ..state.state_table import StateTable
from .executor import Executor
from .message import Barrier, Message, Watermark


class TemporalJoinExecutor(Executor):
    def __init__(self, left: Executor, right: Executor,
                 left_keys: Sequence[int], right_keys: Sequence[int],
                 outer: bool = False,
                 condition: Optional[Expr] = None,
                 right_pk: Optional[Sequence[int]] = None,
                 right_state: Optional[StateTable] = None,
                 max_chunk_size: int = 1024):
        schema = left.schema.concat(right.schema)
        super().__init__(schema,
                         f"TemporalJoin[{'left' if outer else 'inner'}]")
        # output rows are never retracted, whatever the right side does
        self.append_only = left.append_only
        self.left_exec, self.right_exec = left, right
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.outer = outer
        self.condition = condition
        self.right_pk = list(right_pk) if right_pk is not None \
            else list(range(len(right.schema)))
        self.right_state = right_state
        self._recovered = right_state is None
        # version index: join key -> {pk: row}
        self.index: Dict[Tuple, Dict[Tuple, Tuple]] = {}
        self.max_chunk_size = max_chunk_size

    # ---- version side ----------------------------------------------------
    def _recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        for row in self.right_state.iter_all():
            row = tuple(row)
            key = tuple(row[i] for i in self.right_keys)
            pk = tuple(row[i] for i in self.right_pk)
            self.index.setdefault(key, {})[pk] = row

    def _apply_version(self, chunk: StreamChunk) -> None:
        for op, row in chunk.compact().op_rows():
            key = tuple(row[i] for i in self.right_keys)
            pk = tuple(row[i] for i in self.right_pk)
            if op.is_insert:
                self.index.setdefault(key, {})[pk] = row
                if self.right_state is not None:
                    self.right_state.insert(row)
            else:
                d = self.index.get(key)
                if d is not None:
                    d.pop(pk, None)
                    if not d:
                        del self.index[key]
                if self.right_state is not None:
                    self.right_state.delete(row)

    # ---- stream side -----------------------------------------------------
    def _lookup(self, row: Tuple) -> List[Tuple]:
        key = tuple(row[i] for i in self.left_keys)
        if any(v is None for v in key):
            return []
        cands = list(self.index.get(key, {}).values())
        if self.condition is None or not cands:
            return cands
        from ..core.chunk import DataChunk
        rows = [row + c for c in cands]
        ch = DataChunk.from_rows(self.schema.dtypes, rows)
        col = self.condition.eval(ch)
        return [c for c, ok, valid in zip(cands, col.values, col.validity)
                if valid and ok]

    def _process_left(self, chunk: StreamChunk) -> Iterator[StreamChunk]:
        out = StreamChunkBuilder(self.schema.dtypes, self.max_chunk_size)
        nulls = tuple([None] * len(self.right_exec.schema))
        for op, row in chunk.compact().op_rows():
            if not op.is_insert:
                raise ValueError(
                    "temporal join requires an append-only left input "
                    "(temporal_join.rs append-only precondition)")
            matches = self._lookup(row)
            if matches:
                for m in matches:
                    out.append_row(Op.INSERT, row + m)
            elif self.outer:
                out.append_row(Op.INSERT, row + nulls)
        yield from out.drain()

    # ---- the aligned loop ------------------------------------------------
    def execute(self) -> Iterator[Message]:
        self._recover()
        liter = self.left_exec.execute()
        riter = self.right_exec.execute()
        alive = True
        while alive:
            barrier = None
            # version side first: lookups inside this epoch see its writes
            for side, it in (("r", riter), ("l", liter)):
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
                        if not msg.cardinality:
                            continue
                        if side == "r":
                            self._apply_version(msg)
                        else:
                            yield from self._process_left(msg)
                    elif isinstance(msg, Watermark) and side == "l":
                        yield msg        # left watermark cols keep indices
            if barrier is None:
                return
            if self.right_state is not None:
                self.right_state.commit(barrier.epoch.curr)
            yield barrier.with_trace(self.name)
            if barrier.is_stop():
                return
