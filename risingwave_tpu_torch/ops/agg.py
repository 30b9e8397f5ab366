"""Aggregation executors: HashAgg, SimpleAgg, StatelessSimpleAgg (the
port's own copy of the JAX package's `ops/agg.py`).

Reference: `src/stream/src/executor/aggregate/{hash_agg.rs,simple_agg.rs,
stateless_simple_agg.rs,agg_group.rs,distinct.rs}`. Chunk application updates
in-memory group states; at each barrier the executor emits a change chunk
(insert / retract / update pairs) for groups whose outputs changed
(`hash_agg.rs:331,411`), then commits state.

The first implicit aggregate is always row_count (`agg_group.rs` does the
same): count(*) decides group liveness — a group whose row count reaches 0
emits a DELETE and drops its state.

The device path for the int-keyed sum/count/min/max subset lives in
`device/agg_step.py` (`ops/device_agg.py`; sharded:
`parallel/sharded_agg.py`); this host implementation is the exact path
and the fallback for decimals and other host-only types.
"""
from __future__ import annotations

import heapq
import pickle
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.chunk import Column, Op, StreamChunk, StreamChunkBuilder
from ..core.schema import Field, Schema
from ..core import dtypes as T
from ..expr.agg import AggCall, AggState, DistinctDedup, create_agg_state
from ..expr.expression import Expr
from ..state.state_table import StateTable
from .executor import Executor, UnaryExecutor
from .message import Barrier, Message, Watermark

_NOT_NULL = object()  # count(*) sentinel value


class AggGroup:
    """Per-group state: row_count + one AggState per call
    (`agg_group.rs` analog)."""

    __slots__ = ("states", "dedups", "prev_output", "row_count")

    def __init__(self, calls: Sequence[AggCall]):
        self.states: List[AggState] = [create_agg_state(c) for c in calls]
        self.dedups: List[Optional[DistinctDedup]] = [
            DistinctDedup() if c.distinct else None for c in calls]
        self.prev_output: Optional[Tuple] = None  # None = never emitted
        self.row_count = 0

    def apply(self, sign: int, values: Sequence[Any]) -> None:
        self.row_count += sign
        for i, st in enumerate(self.states):
            v = values[i]
            if v is _NOT_NULL:
                st.apply(sign, v)
                continue
            if v is None:
                continue  # strict aggregates skip NULL inputs
            d = self.dedups[i]
            if d is not None:
                fs = d.apply(sign, v)
                if fs != 0:
                    st.apply(fs, v)
            else:
                st.apply(sign, v)

    def output(self) -> Tuple:
        return tuple(st.output() for st in self.states)


def _eval_agg_inputs(calls: Sequence[AggCall], chunk: StreamChunk
                     ) -> List[Optional[np.ndarray]]:
    """Evaluate each call's arg expression + filter over the chunk once
    (vectorized); returns per-call value arrays with None for filtered/NULL."""
    data = chunk.data_chunk()
    n = chunk.capacity
    out = []
    for c in calls:
        if c.arg is None:
            vals = np.empty(n, dtype=object)
            vals[:] = _NOT_NULL
        else:
            col = c.arg.eval(data)
            vals = np.empty(n, dtype=object)
            for i in range(n):
                vals[i] = col.get(i)
        if c.filter is not None:
            f = c.filter.eval(data)
            keep = f.values.astype(np.bool_) & f.validity
            for i in range(n):
                if not keep[i]:
                    vals[i] = None
        out.append(vals)
    return out


class HashAggExecutor(UnaryExecutor):
    """Group-by aggregation (`hash_agg.rs`)."""

    def __init__(self, input: Executor, group_key_indices: Sequence[int],
                 calls: Sequence[AggCall],
                 state_table: Optional[StateTable] = None,
                 emit_on_window_close: bool = False,
                 window_col_in_group: Optional[int] = None):
        in_schema = input.schema
        fields = [in_schema.fields[i] for i in group_key_indices]
        fields += [Field(f"agg#{i}", c.return_type) for i, c in enumerate(calls)]
        super().__init__(input, Schema(fields), "HashAgg")
        self.group_key_indices = list(group_key_indices)
        self.calls = list(calls)
        self.groups: Dict[Tuple, AggGroup] = {}
        self.dirty: Dict[Tuple, AggGroup] = {}
        self.state_table = state_table
        self._recovered = state_table is None
        # EOWC: buffer change emission until the watermark passes the window
        # column (`hash_agg.rs:420-429` SortBuffer semantics).
        self.emit_on_window_close = emit_on_window_close
        if emit_on_window_close:
            assert window_col_in_group is not None, \
                "EOWC requires window_col_in_group (the window column's " \
                "position within the group key)"
        self.window_col_in_group = window_col_in_group
        self.window_watermark: Optional[Any] = None
        self._emitted_windows_upto: Optional[Any] = None
        self._wm_dtype: Optional[Any] = None
        # min-heap of (window_value, seq, group_key): closed windows pop in
        # order without scanning all live groups (SortBuffer analog)
        self._window_heap: List[Tuple[Any, int, Tuple]] = []
        self._heap_seq = 0
        # watermark-driven state cleaning (`state_table.rs:1002` analog):
        # a watermark on a group-key column proves groups below it can
        # never change again — their state is dropped at the next barrier
        # (the MV keeps the rows; no retraction is emitted)
        self._clean_wm: Optional[Tuple[int, Any]] = None   # (group_pos, val)

    # ---- state persistence (pickled AggGroup per group key) ----
    def _recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        for row in self.state_table.iter_all():
            key = tuple(row[: len(self.group_key_indices)])
            g: AggGroup = pickle.loads(row[-1])
            self.groups[key] = g
            wc = self.window_col_in_group
            if self.emit_on_window_close and key[wc] is not None:
                heapq.heappush(self._window_heap,
                               (key[wc], self._heap_seq, key))
                self._heap_seq += 1

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        self._recover()
        chunk = chunk.compact()
        agg_vals = _eval_agg_inputs(self.calls, chunk)
        signs = chunk.signs()
        n = chunk.capacity
        gki = self.group_key_indices
        wc = self.window_col_in_group
        for i in range(n):
            key = tuple(chunk.columns[j].get(i) for j in gki)
            if self.emit_on_window_close:
                # late-data guard: rows for already-emitted windows are
                # dropped — emitted EOWC output is final
                if (self._emitted_windows_upto is not None
                        and key[wc] is not None
                        and key[wc] < self._emitted_windows_upto):
                    continue
            g = self.groups.get(key)
            if g is None:
                g = self.groups[key] = AggGroup(self.calls)
                if self.emit_on_window_close and key[wc] is not None:
                    heapq.heappush(self._window_heap,
                                   (key[wc], self._heap_seq, key))
                    self._heap_seq += 1
            g.apply(int(signs[i]), [v[i] for v in agg_vals])
            self.dirty[key] = g
        return iter(())

    def _emit_group(self, out: StreamChunkBuilder, key: Tuple, g: AggGroup
                    ) -> None:
        new_out = g.output()
        if g.row_count == 0:
            if g.prev_output is not None:
                out.append_row(Op.DELETE, key + g.prev_output)
            del self.groups[key]
            if self.state_table is not None:
                self.state_table.delete(key + (pickle.dumps(g),))
            return
        if g.prev_output is None:
            out.append_row(Op.INSERT, key + new_out)
        elif g.prev_output != new_out:
            out.append_update(key + g.prev_output, key + new_out)
        g.prev_output = new_out
        if self.state_table is not None:
            self.state_table.insert(key + (pickle.dumps(g),))

    def on_barrier(self, barrier: Barrier) -> Iterator[Message]:
        self._recover()
        out = StreamChunkBuilder(self.schema.dtypes)
        wm_out: Optional[Watermark] = None
        if self.emit_on_window_close:
            self._emit_eowc(out)
            # persist still-open windows so recovery does not lose them
            if self.state_table is not None:
                for key, g in self.dirty.items():
                    self.state_table.insert(key + (pickle.dumps(g),))
            self.dirty.clear()
            # the watermark is released only AFTER the rows it closes
            # (`hash_agg.rs` SortBuffer contract: output respects watermarks)
            if (self.window_watermark is not None
                    and self.window_watermark != self._emitted_windows_upto):
                self._emitted_windows_upto = self.window_watermark
                wm_out = Watermark(self.window_col_in_group, self._wm_dtype,
                                   self.window_watermark)
        else:
            for key, g in self.dirty.items():
                self._emit_group(out, key, g)
            self.dirty.clear()
            self._clean_state()
        for chunk in out.drain():
            yield chunk
        if wm_out is not None:
            yield wm_out
        if self.state_table is not None:
            self.state_table.commit(barrier.epoch.curr)

    def _clean_state(self) -> None:
        if self._clean_wm is None:
            return
        gi, wv = self._clean_wm
        self._clean_wm = None
        dead = [k for k in self.groups
                if k[gi] is not None and k[gi] < wv]
        for k in dead:
            g = self.groups.pop(k)
            if self.state_table is not None:
                self.state_table.delete(k + (pickle.dumps(g),))

    def _emit_eowc(self, out: StreamChunkBuilder) -> None:
        """Emit only groups whose window column is closed by the watermark;
        emitted groups are final (append-only output). Closed windows pop
        from the heap in window order — O(closed log n), not O(live)."""
        if self.window_watermark is None:
            return
        wm = self.window_watermark
        # a watermark promises no future rows with value < wm, so exactly
        # the windows strictly below it are closed (watermark_filter.rs
        # keeps `ts >= watermark`)
        while self._window_heap and self._window_heap[0][0] < wm:
            _, _, key = heapq.heappop(self._window_heap)
            g = self.groups.pop(key, None)
            if g is None:
                continue  # already closed (recovery rebuilt the heap)
            self.dirty.pop(key, None)
            if g.row_count > 0 and g.prev_output is None:
                out.append_row(Op.INSERT, key + g.output())
            if self.state_table is not None:
                self.state_table.delete(key + (pickle.dumps(g),))

    def on_watermark(self, wm: Watermark) -> Iterator[Message]:
        if (self.emit_on_window_close and self.window_col_in_group is not None
                and self.group_key_indices[self.window_col_in_group] == wm.col_idx):
            # buffer: released at the barrier after closed windows are emitted
            self.window_watermark = wm.value
            self._wm_dtype = wm.dtype
        elif wm.col_idx in self.group_key_indices:
            gi = self.group_key_indices.index(wm.col_idx)
            self._clean_wm = (gi, wm.value)
            yield Watermark(gi, wm.dtype, wm.value)


class SimpleAggExecutor(UnaryExecutor):
    """Global aggregation — exactly one group, always emits a row (even for
    zero input rows, matching SQL `SELECT count(*) FROM t` = 0)
    (`simple_agg.rs`)."""

    def __init__(self, input: Executor, calls: Sequence[AggCall],
                 state_table: Optional[StateTable] = None):
        fields = [Field(f"agg#{i}", c.return_type) for i, c in enumerate(calls)]
        super().__init__(input, Schema(fields), "SimpleAgg")
        self.calls = list(calls)
        self.group = AggGroup(self.calls)
        self.state_table = state_table
        self._recovered = state_table is None
        self.dirty = True  # first barrier emits the initial row

    def _recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        for row in self.state_table.iter_all():
            self.group = pickle.loads(row[-1])

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        self._recover()
        chunk = chunk.compact()
        agg_vals = _eval_agg_inputs(self.calls, chunk)
        signs = chunk.signs()
        for i in range(chunk.capacity):
            self.group.apply(int(signs[i]), [v[i] for v in agg_vals])
        self.dirty = True
        return iter(())

    def on_barrier(self, barrier: Barrier) -> Iterator[Message]:
        self._recover()
        if self.dirty:
            new_out = self.group.output()
            # SQL semantics for the empty group: count()=0, sum()=NULL
            if self.group.prev_output is None:
                yield StreamChunk.from_rows(self.schema.dtypes,
                                            [(Op.INSERT, new_out)])
            elif new_out != self.group.prev_output:
                b = StreamChunkBuilder(self.schema.dtypes)
                b.append_update(self.group.prev_output, new_out)
                yield b.take()
            self.group.prev_output = new_out
            self.dirty = False
            if self.state_table is not None:
                self.state_table.insert((0, pickle.dumps(self.group)))
        if self.state_table is not None:
            self.state_table.commit(barrier.epoch.curr)


class StatelessPartialAggExecutor(UnaryExecutor):
    """Grouped per-chunk partial aggregation with NO cross-epoch state —
    the pre-shuffle stage of 2-phase aggregation (`stateless_simple_agg.rs`
    generalized with a group key, as the reference's batch/stream 2-phase
    agg rewrite plans it). Partials accumulate across the EPOCH and flush
    one INSERT row per touched group at the barrier: (group cols...,
    partial outputs...) — epoch granularity is what makes the reduction
    effective (per-chunk partials barely compress keys that cluster over
    time, like nexmark auction ids). Downstream merges with sum0/min/max.
    Statelessness ACROSS barriers is the recovery story for remote
    placement: a killed worker loses only uncommitted-epoch partials,
    which the barrier protocol discards anyway."""

    def __init__(self, input: Executor, group_indices: Sequence[int],
                 calls: Sequence[AggCall]):
        if not input.append_only:
            raise ValueError("stateless partial aggregation requires an "
                             "append-only input")
        gfields = [input.schema.fields[i] for i in group_indices]
        fields = gfields + [Field(f"agg#{i}", c.return_type)
                            for i, c in enumerate(calls)]
        super().__init__(input, Schema(fields), "StatelessPartialAgg")
        self.append_only = True
        self.group_key_indices = list(group_indices)
        self.calls = list(calls)
        self._groups: dict = {}

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        chunk = chunk.compact()
        agg_vals = _eval_agg_inputs(self.calls, chunk)
        signs = chunk.signs()
        rows = chunk.data_chunk().rows()
        for i, row in enumerate(rows):
            if signs[i] < 0:
                raise ValueError("retraction reached a stateless partial "
                                 "aggregation (append-only violated)")
            key = tuple(row[j] for j in self.group_key_indices)
            g = self._groups.get(key)
            if g is None:
                g = self._groups[key] = AggGroup(self.calls)
            g.apply(1, [v[i] for v in agg_vals])
        return iter(())

    def on_barrier(self, barrier: Barrier) -> Iterator[Message]:
        if self._groups:
            yield StreamChunk.from_rows(
                self.schema.dtypes,
                [(Op.INSERT, key + g.output())
                 for key, g in self._groups.items()])
            self._groups = {}


class StatelessSimpleAggExecutor(UnaryExecutor):
    """Per-chunk partial aggregation emitted immediately — the pre-shuffle
    local agg (`stateless_simple_agg.rs`). Output rows are partial states
    (e.g. partial sums + counts) to be merged downstream."""

    def __init__(self, input: Executor, calls: Sequence[AggCall]):
        fields = [Field(f"agg#{i}", c.return_type) for i, c in enumerate(calls)]
        super().__init__(input, Schema(fields), "StatelessSimpleAgg")
        self.calls = list(calls)

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        chunk = chunk.compact()
        g = AggGroup(self.calls)
        agg_vals = _eval_agg_inputs(self.calls, chunk)
        signs = chunk.signs()
        for i in range(chunk.capacity):
            g.apply(int(signs[i]), [v[i] for v in agg_vals])
        if g.row_count != 0 or any(s.output() is not None for s in g.states):
            yield StreamChunk.from_rows(self.schema.dtypes,
                                        [(Op.INSERT, g.output())])
