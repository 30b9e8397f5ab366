"""Stateless executors: Project, Filter, Union, Values, RowIdGen, Expand
(the port's own copy of the JAX package's `ops/simple.py`).

Reference: `src/stream/src/executor/{project.rs,filter.rs,union.rs,values.rs,
row_id_gen.rs,expand.rs}`. These are the vmap-analog layer: per-chunk
vectorized transforms with no cross-chunk state.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..core.chunk import Column, Op, StreamChunk
from ..core.schema import Field, Schema
from ..core import dtypes as T
from ..expr.expression import Expr, InputRef
from .executor import Executor, UnaryExecutor
from .message import Barrier, Message, Watermark


class ProjectExecutor(UnaryExecutor):
    """Evaluate expressions over each chunk (`project.rs`)."""

    def __init__(self, input: Executor, exprs: Sequence[Expr],
                 names: Optional[Sequence[str]] = None):
        names = names or [f"expr#{i}" for i in range(len(exprs))]
        schema = Schema([Field(n, e.return_type) for n, e in zip(names, exprs)])
        super().__init__(input, schema)
        self.append_only = input.append_only
        self.exprs = list(exprs)

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        chunk = chunk.compact()
        data = chunk.data_chunk()
        cols = [e.eval(data) for e in self.exprs]
        yield StreamChunk(chunk.ops, cols)

    def on_watermark(self, wm: Watermark) -> Iterator[Message]:
        # pass through only if some output expr is a direct ref of the col
        for out_idx, e in enumerate(self.exprs):
            if isinstance(e, InputRef) and e.index == wm.col_idx:
                yield Watermark(out_idx, wm.dtype, wm.value)
                return


class FilterExecutor(UnaryExecutor):
    """Predicate filter with U-/U+ pair fixing (`filter.rs`): when a predicate
    flips across an update pair, the pair degrades to a single DELETE or
    INSERT so downstream state stays consistent."""

    def __init__(self, input: Executor, predicate: Expr):
        super().__init__(input, input.schema)
        self.append_only = input.append_only
        self.predicate = predicate

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        chunk = chunk.compact()
        pred = self.predicate.eval(chunk.data_chunk())
        passes = pred.values.astype(np.bool_) & pred.validity
        ops = chunk.ops.copy()
        vis = passes.copy()
        i = 0
        n = chunk.capacity
        while i < n:
            if ops[i] == Op.UPDATE_DELETE and i + 1 < n and ops[i + 1] == Op.UPDATE_INSERT:
                old_p, new_p = passes[i], passes[i + 1]
                if old_p and not new_p:
                    ops[i] = Op.DELETE
                    vis[i], vis[i + 1] = True, False
                elif not old_p and new_p:
                    ops[i + 1] = Op.INSERT
                    vis[i], vis[i + 1] = False, True
                i += 2
            else:
                i += 1
        if vis.any():
            yield StreamChunk(ops, chunk.columns, vis)


class UnionExecutor(Executor):
    """Merge N inputs with barrier alignment (`union.rs` + the alignment that
    `MergeExecutor` (merge.rs:235) performs): chunks interleave freely between
    barriers; a barrier is forwarded only once ALL inputs yielded it."""

    def __init__(self, inputs: Sequence[Executor]):
        super().__init__(inputs[0].schema, "Union")
        self.append_only = all(i.append_only for i in inputs)
        self.inputs = list(inputs)
        # per-column min-tracking across inputs (`union.rs`
        # BufferedWatermarks): the union's watermark for a column is the
        # MIN of every live input's latest watermark; it is emitted only
        # once all live inputs have reported and only when it advances
        self._in_wms: List[Dict[int, Any]] = [{} for _ in inputs]
        self._out_wms: Dict[int, Any] = {}
        self._wm_dtypes: Dict[int, Any] = {}

    def _check_col(self, col: int, dtype,
                   alive: Sequence[bool]) -> Iterator[Message]:
        reporters = [w for a, w in zip(alive, self._in_wms)
                     if a and col in w]
        n_alive = sum(1 for a in alive if a)
        if not reporters or len(reporters) < n_alive:
            return
        lo = min(w[col] for w in reporters)
        if self._out_wms.get(col) is None or lo > self._out_wms[col]:
            self._out_wms[col] = lo
            yield Watermark(col, dtype, lo)

    def _on_watermark(self, idx: int, wm: Watermark,
                      alive: Sequence[bool]) -> Iterator[Message]:
        self._in_wms[idx][wm.col_idx] = wm.value
        self._wm_dtypes[wm.col_idx] = wm.dtype
        yield from self._check_col(wm.col_idx, wm.dtype, alive)

    def _on_input_done(self, alive: Sequence[bool]) -> Iterator[Message]:
        """A finished input stops constraining the min — watermarks held
        waiting for it must be re-evaluated and released (the reference
        re-checks on buffer removal, `union.rs`/BufferedWatermarks)."""
        for col, dtype in self._wm_dtypes.items():
            yield from self._check_col(col, dtype, alive)

    def execute(self) -> Iterator[Message]:
        iters = [inp.execute() for inp in self.inputs]
        alive = [True] * len(iters)
        while any(alive):
            barrier: Optional[Barrier] = None
            # drain each input up to its barrier
            for idx, it in enumerate(iters):
                if not alive[idx]:
                    continue
                while True:
                    try:
                        msg = next(it)
                    except StopIteration:
                        alive[idx] = False
                        yield from self._on_input_done(alive)
                        break
                    if isinstance(msg, Barrier):
                        barrier = msg
                        break
                    if isinstance(msg, Watermark):
                        yield from self._on_watermark(idx, msg, alive)
                        continue
                    yield msg
            if barrier is not None:
                yield barrier.with_trace(self.name)
            else:
                return


class ValuesExecutor(Executor):
    """Emit a fixed set of rows once, then pass barriers (`values.rs`)."""

    def __init__(self, schema: Schema, rows: Sequence[Sequence],
                 barrier_source: "Executor"):
        super().__init__(schema, "Values")
        self.append_only = True
        self.rows = list(rows)
        self.barrier_source = barrier_source

    def execute(self) -> Iterator[Message]:
        emitted = False
        for msg in self.barrier_source.execute():
            if not emitted and isinstance(msg, Barrier):
                yield msg
                if self.rows:
                    from ..core.chunk import StreamChunk as SC
                    yield SC.from_rows(self.schema.dtypes,
                                       [(Op.INSERT, r) for r in self.rows])
                emitted = True
            else:
                yield msg


class RowIdGenExecutor(UnaryExecutor):
    """Fill a serial row-id column (`row_id_gen.rs`): ids embed the vnode so
    generation is conflict-free across parallel shards."""

    # Bit budget (63 bits total, like the reference's row-id layout
    # timestamp|vnode|sequence): 41-bit millis since _ID_EPOCH | 10-bit
    # shard | 12-bit per-ms sequence. Millis are anchored to a custom epoch
    # (like the reference's row-id generator) so the 41-bit field lasts
    # ~69 years from 2024 instead of overflowing into the sign bit in 2039.
    # Restart-disjointness holds because a restarted process re-reads the
    # clock; minting >4096 ids/ms advances the logical millis ahead of wall
    # clock (same caveat as the reference).
    _SEQ_BITS = 12
    _SHARD_BITS = 10
    _ID_EPOCH_MS = 1_704_067_200_000   # 2024-01-01T00:00:00Z

    def __init__(self, input: Executor, row_id_index: int, shard: int = 0):
        super().__init__(input, input.schema)
        self.append_only = input.append_only
        self.row_id_index = row_id_index
        # logical counter = millis * 2^12 + seq; monotonic, clock-anchored
        self._counter = self._now_ms() << self._SEQ_BITS
        if not 0 <= shard < (1 << self._SHARD_BITS):
            raise ValueError(f"shard {shard} exceeds {self._SHARD_BITS} bits")
        self.shard = shard

    @classmethod
    def _now_ms(cls) -> int:
        import time
        return int(time.time() * 1000) - cls._ID_EPOCH_MS

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        chunk = chunk.compact()
        n = chunk.capacity
        # re-anchor to the wall clock whenever it has moved past the counter
        self._counter = max(self._counter,
                            self._now_ms() << self._SEQ_BITS)
        counters = np.arange(self._counter, self._counter + n, dtype=np.int64)
        ms, seq = counters >> self._SEQ_BITS, counters & ((1 << self._SEQ_BITS) - 1)
        ids = ((ms << (self._SHARD_BITS + self._SEQ_BITS))
               | (self.shard << self._SEQ_BITS) | seq)
        self._counter += n
        cols = list(chunk.columns)
        if self.row_id_index >= len(cols):
            # connector chunks don't carry the row-id column; append it
            cols.append(Column(T.SERIAL, ids))
        else:
            old = cols[self.row_id_index]
            if old.validity.any():
                # rows that already carry an id (DML deletes/updates resolved
                # against the table) keep it; only NULL ids are minted
                ids = np.where(old.validity,
                               old.values.astype(np.int64, copy=False), ids)
            cols[self.row_id_index] = Column(T.SERIAL, ids)
        yield StreamChunk(chunk.ops, cols)


class ExpandExecutor(UnaryExecutor):
    """Row → multiple subset rows with a flag column (`expand.rs`), used for
    grouping sets / distinct agg rewrites."""

    def __init__(self, input: Executor, subsets: Sequence[Sequence[int]]):
        in_schema = input.schema
        fields = [Field(f.name, f.dtype) for f in in_schema.fields]
        fields.append(Field("flag", T.INT64))
        super().__init__(input, Schema(fields), "Expand")
        self.append_only = input.append_only
        self.subsets = [list(s) for s in subsets]

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        chunk = chunk.compact()
        n = chunk.capacity
        for flag, subset in enumerate(self.subsets):
            cols = []
            for i, c in enumerate(chunk.columns):
                if i in subset:
                    cols.append(c)
                else:
                    vals = (np.empty(n, dtype=object)
                            if c.dtype.np_dtype == np.dtype(object)
                            else np.zeros(n, dtype=c.dtype.np_dtype))
                    if c.dtype.np_dtype == np.dtype(object):
                        vals[:] = None
                    cols.append(Column(c.dtype, vals, np.zeros(n, dtype=np.bool_)))
            cols.append(Column(T.INT64, np.full(n, flag, dtype=np.int64)))
            yield StreamChunk(chunk.ops, cols)
