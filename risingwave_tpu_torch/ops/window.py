"""Window executors: HopWindow (table function) and OverWindow (window
functions) — the port's own copy of the JAX package's `ops/window.py`.

Reference: `src/stream/src/executor/hop_window.rs` and
`src/stream/src/executor/over_window/general.rs` (+ `over_partition.rs`,
`frame_finder.rs`). HopWindow expands each row into size/hop overlapping
windows — vectorized here with numpy repeat instead of per-row loops.
OverWindow recomputes affected partitions against ordered state and emits
output diffs; correct (if not maximally incremental) for all frame shapes —
the per-partition delta optimization mirrors what `over_partition.rs` caches
and is a later device-path concern.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.chunk import Column, Op, StreamChunk, StreamChunkBuilder
from ..core.dtypes import Interval
from ..core.encoding import SortKey
from ..core.schema import Field, Schema
from ..core import dtypes as T
from ..expr.agg import AggCall, create_agg_state
from ..expr.expression import Expr
from ..state.state_table import StateTable
from .executor import Executor, UnaryExecutor
from .message import Barrier, Message, Watermark


class HopWindowExecutor(UnaryExecutor):
    """TUMBLE is the hop==size special case. Appends window_start/window_end
    columns; each input row appears in size/hop output windows."""

    def __init__(self, input: Executor, time_col: int, hop: Interval,
                 size: Interval):
        in_schema = input.schema
        fields = list(in_schema.fields) + [
            Field("window_start", T.TIMESTAMP), Field("window_end", T.TIMESTAMP)]
        super().__init__(input, Schema(fields), "HopWindow")
        self.append_only = input.append_only
        self.time_col = time_col
        self.hop_usecs = hop.total_usecs_approx()
        self.size_usecs = size.total_usecs_approx()
        assert self.hop_usecs > 0 and self.size_usecs % self.hop_usecs == 0, \
            "window size must be a multiple of hop"
        self.n_windows = self.size_usecs // self.hop_usecs

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        chunk = chunk.compact()
        n = chunk.capacity
        ts = chunk.columns[self.time_col].values.astype(np.int64)
        # latest hop-aligned start <= ts
        first_start = (ts // self.hop_usecs) * self.hop_usecs
        reps = self.n_windows
        idx = np.repeat(np.arange(n), reps)
        k = np.tile(np.arange(reps, dtype=np.int64), n)
        starts = first_start[idx] - k * self.hop_usecs
        ends = starts + self.size_usecs
        ops = chunk.ops[idx]
        cols = [c.take(idx) for c in chunk.columns]
        cols.append(Column(T.TIMESTAMP, starts))
        cols.append(Column(T.TIMESTAMP, ends))
        valid = chunk.columns[self.time_col].validity[idx]
        yield StreamChunk(ops, cols, valid)

    def on_watermark(self, wm: Watermark) -> Iterator[Message]:
        if wm.col_idx == self.time_col:
            # a closed input timestamp closes windows starting <= wm - (size-hop)
            ws = ((wm.value // self.hop_usecs) * self.hop_usecs
                  - (self.size_usecs - self.hop_usecs))
            yield Watermark(len(self.schema) - 2, T.TIMESTAMP, ws)
        else:
            yield wm


class WindowFuncCall:
    """One OVER() call: kind in {row_number, rank, dense_rank, lag, lead,
    sum, count, min, max, avg, first_value, last_value}.

    frame: (start, end) offsets relative to the current row — None =
    unbounded, 0 = current row. In ROWS mode offsets are positions
    (`frame: (-2, 0)` = 2 PRECEDING..CURRENT ROW); in RANGE mode they are
    ORDER-BY-value deltas (`src/expr/core/src/window_function/` RowsFrame
    / RangeFrame)."""

    def __init__(self, kind: str, arg: Optional[Expr] = None, offset: int = 1,
                 return_type: Optional[T.DataType] = None,
                 frame: Tuple[Optional[int], Optional[int]] = (None, 0),
                 frame_mode: str = "rows"):
        self.kind = kind
        self.arg = arg
        self.offset = offset
        self.frame = frame
        self.frame_mode = frame_mode
        if return_type is not None:
            self.return_type = return_type
        elif kind in ("row_number", "rank", "dense_rank", "count"):
            self.return_type = T.INT64
        elif arg is not None:
            self.return_type = AggCall(kind, arg).return_type if kind in (
                "sum", "avg", "min", "max") else arg.return_type
        else:
            self.return_type = T.INT64


class _Partition:
    """One partition's ordered rows + cached outputs + per-call prefix
    states (the analog of `over_partition.rs`'s range cache)."""
    __slots__ = ("keys", "rows", "outs", "vals", "ovals")

    def __init__(self, n_calls: int):
        self.keys: List[bytes] = []     # sort keys, aligned with rows
        self.rows: List[Tuple] = []
        self.outs: List[Tuple] = []     # cached window outputs per row
        self.vals: List[List[Any]] = [[] for _ in range(n_calls)]
        self.ovals: List[Any] = []      # first ORDER BY column's values

    def nn(self) -> int:
        """Live non-null prefix length of ovals (NULLs sort last)."""
        n = len(self.ovals)
        while n > 0 and self.ovals[n - 1] is None:
            n -= 1
        return n


class OverWindowExecutor(UnaryExecutor):
    """Window functions over partitions (`over_window/general.rs` +
    `over_partition.rs` + `frame_finder.rs`).

    Incremental maintenance: rows live in a per-partition ordered cache;
    a chunk's changes mark the minimum affected sorted position, each
    call widens it by its frame's lookback (`frame_finder.rs` computes
    the same affected ranges), and only [start, n) is recomputed and
    diffed. Appends at the tail of the order — the streaming common case
    — therefore touch O(delta) rows regardless of partition size (the
    `over_window_recomputed_rows` metric asserts this in tests).
    Aggregate frames slide retractable states across the region instead
    of rebuilding per row; RANGE frames use value-space two-pointer
    bounds over the ordered cache."""

    def __init__(self, input: Executor, partition_by: Sequence[int],
                 order_by: Sequence[Tuple[int, bool]],
                 calls: Sequence[WindowFuncCall],
                 state_table: Optional[StateTable] = None):
        in_schema = input.schema
        fields = list(in_schema.fields) + [
            Field(f"w#{i}", c.return_type) for i, c in enumerate(calls)]
        super().__init__(input, Schema(fields), "OverWindow")
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.calls = list(calls)
        self.in_dtypes = in_schema.dtypes
        self.partitions: Dict[Tuple, _Partition] = {}
        self.state_table = state_table
        self._recovered = state_table is None
        for c in self.calls:
            if c.frame_mode == "range" and (
                    len(self.order_by) != 1 or self.order_by[0][1]):
                raise ValueError("RANGE frames require exactly one "
                                 "ascending ORDER BY column")

    def _recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        by_p: Dict[Tuple, List[Tuple]] = {}
        for row in self.state_table.iter_all():
            p = tuple(row[i] for i in self.partition_by)
            by_p.setdefault(p, []).append(tuple(row))
        oc0 = self.order_by[0][0] if self.order_by else None
        for p, rows in by_p.items():
            part = self.partitions.setdefault(p, _Partition(len(self.calls)))
            rows.sort(key=self._order_key)
            part.rows = rows
            part.keys = [self._order_key(r) for r in rows]
            part.vals = self._eval_args(rows)
            if oc0 is not None:
                part.ovals = [r[oc0] for r in rows]
            part.outs = self._compute(part, 0)

    def _order_key(self, row: Tuple):
        cols = [row[i] for i, _ in self.order_by]
        dts = [self.in_dtypes[i] for i, _ in self.order_by]
        desc = [d for _, d in self.order_by]
        return SortKey(cols, dts, desc).enc + repr(row).encode()

    # ---- vectorized argument evaluation -----------------------------------
    def _eval_args(self, rows: List[Tuple]) -> List[List[Any]]:
        """Per-call argument values for `rows`, one DataChunk eval per
        call (not per row)."""
        if not rows:
            return [[] for _ in self.calls]
        from ..core.chunk import DataChunk
        ch = None
        out = []
        for call in self.calls:
            if call.arg is None:
                out.append([1] * len(rows))
                continue
            if ch is None:
                ch = DataChunk.from_rows(self.in_dtypes, rows)
            c = call.arg.eval(ch)
            out.append([c.get(i) for i in range(len(rows))])
        return out

    # ---- affected-range computation (frame_finder.rs analog) --------------
    def _start_of(self, part: _Partition, min_pos: int,
                  min_val: Any, null_change: bool = False) -> int:
        """First sorted position whose output can change, given the
        minimum changed position (positions >= min_pos shifted/changed)
        and the minimum changed ORDER VALUE (for value-space frames —
        a deleted row's value no longer sits at any position)."""
        start = min_pos
        for call in self.calls:
            k = call.kind
            if k in ("row_number", "rank", "dense_rank", "lag"):
                continue                        # look backward only
            if k == "lead":
                start = min(start, max(0, min_pos - call.offset))
                continue
            lo, hi = call.frame
            if hi is None:
                return 0                        # trailing-unbounded frame
            if call.frame_mode == "rows":
                if hi > 0:
                    start = min(start, max(0, min_pos - hi))
            else:                               # range: value-space bound
                if null_change:
                    # a change in the NULL peer group affects every NULL
                    # row's frame — widen to the group start
                    start = min(start, part.nn())
                if min_val is None:
                    continue
                import bisect
                start = min(start, bisect.bisect_left(
                    part.ovals, min_val - hi, 0, part.nn()))
        return max(0, start)

    # ---- region recompute --------------------------------------------------
    def _compute(self, part: _Partition, start: int) -> List[Tuple]:
        """Window outputs for part.rows[start:], using cached outputs
        before `start` to seed prefix-dependent calls."""
        rows, vals_all = part.rows, part.vals
        n = len(rows)
        region = range(start, n)
        outs: List[List[Any]] = [[] for _ in region]
        order_keys = None
        if any(c.kind in ("rank", "dense_rank") for c in self.calls):
            # only the region (plus its predecessor, for the seed compare)
            # is materialized — O(delta), not O(partition)
            order_keys = {i: tuple(rows[i][j] for j, _ in self.order_by)
                          for i in range(max(0, start - 1), n)}
        for ci, call in enumerate(self.calls):
            k = call.kind
            vals = vals_all[ci]
            col = [None] * (n - start)
            if k == "row_number":
                for i in region:
                    col[i - start] = i + 1
            elif k in ("rank", "dense_rank"):
                if start == 0:
                    rank = 0
                else:
                    rank = part.outs[start - 1][ci]
                for i in region:
                    if i == 0:
                        rank = 1
                    elif order_keys[i] != order_keys[i - 1]:
                        rank = i + 1 if k == "rank" else rank + 1
                    col[i - start] = rank
            elif k in ("lag", "lead"):
                delta = -call.offset if k == "lag" else call.offset
                for i in region:
                    j = i + delta
                    col[i - start] = vals[j] if 0 <= j < n else None
            elif k == "last_value" and call.frame == (None, 0) \
                    and call.frame_mode == "rows":
                for i in region:
                    col[i - start] = vals[i]
            elif k == "first_value" and call.frame == (None, 0) \
                    and call.frame_mode == "rows":
                # PG: first_value does NOT skip NULLs — it is the frame's
                # first row's value, NULL included (constant per
                # partition for the default frame)
                fv = part.outs[start - 1][ci] if start > 0 \
                    else (vals[0] if n > 0 else None)
                for i in region:
                    col[i - start] = fv
            elif call.frame == (None, 0) and call.frame_mode == "rows" \
                    and k in ("sum", "count", "min", "max"):
                # prefix state seeded from the cached output at start-1
                # (these outputs ARE their prefix states; extension is
                # insert-only, so no retraction machinery is needed)
                st = create_agg_state(AggCall(k, call.arg))
                if start > 0:
                    seed = part.outs[start - 1][ci]
                    if seed is not None:
                        st.apply(1, seed)
                        if k == "count":
                            st.n = seed
                for i in region:
                    if vals[i] is not None:
                        st.apply(1, vals[i])
                    col[i - start] = st.output()
            elif k in ("sum", "count", "min", "max", "avg",
                       "first_value", "last_value"):
                col = self._sliding_frame(call, vals, part, start, n)
            else:
                raise ValueError(f"unknown window function {k}")
            for i in region:
                outs[i - start].append(col[i - start])
        return [tuple(o) for o in outs]

    def _sliding_frame(self, call: WindowFuncCall, vals: List[Any],
                       part: _Partition, start: int, n: int) -> List[Any]:
        """Aggregate over a moving frame: one retractable state slides
        across the region (O(region + frame) applies, not O(region x
        frame) rebuilds)."""
        lo_off, hi_off = call.frame
        if call.kind in ("first_value", "last_value"):
            return self._edge_value_frame(call, vals, part, start, n)
        st = create_agg_state(AggCall(call.kind, call.arg))
        col = [None] * (n - start)
        if call.frame_mode == "rows":
            cur_lo = 0 if lo_off is None else max(0, start + lo_off)
            cur_hi = cur_lo - 1          # empty window
            for i in range(start, n):
                lo = 0 if lo_off is None else max(0, i + lo_off)
                hi = n - 1 if hi_off is None else min(n - 1, i + hi_off)
                if lo > cur_lo + 64 or lo < cur_lo:   # re-seed on jumps
                    st = create_agg_state(AggCall(call.kind, call.arg))
                    cur_lo, cur_hi = lo, lo - 1
                while cur_hi < hi:
                    cur_hi += 1
                    if vals[cur_hi] is not None:
                        st.apply(1, vals[cur_hi])
                while cur_lo < lo:
                    if vals[cur_lo] is not None:
                        st.apply(-1, vals[cur_lo])
                    cur_lo += 1
                col[i - start] = st.output()
        else:
            # RANGE: frame of row i = rows with order value in
            # [v_i + lo, v_i + hi] (two-pointer over the ascending order).
            # NULL order values sort last and form their own peer group
            # (PG: the frame of a NULL row is the NULL group).
            ovals = part.ovals
            nn = part.nn()
            cur_lo = start
            cur_hi = start - 1
            import bisect
            for i in range(start, n):
                v = ovals[i]
                if v is None:
                    lo, hi = nn, n - 1
                else:
                    lo = 0 if lo_off is None else bisect.bisect_left(
                        ovals, v + lo_off, 0, nn)
                    hi = n - 1 if hi_off is None else bisect.bisect_right(
                        ovals, v + hi_off, 0, nn) - 1
                if lo < cur_lo or lo > cur_hi + 64:
                    st = create_agg_state(AggCall(call.kind, call.arg))
                    cur_lo, cur_hi = lo, lo - 1
                while cur_hi < hi:
                    cur_hi += 1
                    if vals[cur_hi] is not None:
                        st.apply(1, vals[cur_hi])
                while cur_lo < lo:
                    if vals[cur_lo] is not None:
                        st.apply(-1, vals[cur_lo])
                    cur_lo += 1
                col[i - start] = st.output()
        return col

    def _edge_value_frame(self, call: WindowFuncCall, vals: List[Any],
                          part: _Partition, start: int, n: int
                          ) -> List[Any]:
        """first_value / last_value over an explicit frame: PG semantics
        take the frame's edge row's value WITHOUT skipping NULLs (unlike
        aggregates); empty frame -> NULL."""
        import bisect
        lo_off, hi_off = call.frame
        first = call.kind == "first_value"
        col = [None] * (n - start)
        if call.frame_mode == "rows":
            for i in range(start, n):
                lo = 0 if lo_off is None else max(0, i + lo_off)
                hi = n - 1 if hi_off is None else min(n - 1, i + hi_off)
                if lo <= hi:
                    col[i - start] = vals[lo if first else hi]
        else:
            ovals = part.ovals
            nn = part.nn()
            for i in range(start, n):
                v = ovals[i]
                if v is None:
                    lo, hi = nn, n - 1
                else:
                    lo = 0 if lo_off is None else bisect.bisect_left(
                        ovals, v + lo_off, 0, nn)
                    hi = n - 1 if hi_off is None else bisect.bisect_right(
                        ovals, v + hi_off, 0, nn) - 1
                if lo <= hi:
                    col[i - start] = vals[lo if first else hi]
        return col

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        import bisect
        from ..utils.metrics import REGISTRY
        self._recover()
        touched: Dict[Tuple, int] = {}       # partition -> min changed pos
        chval: Dict[Tuple, Any] = {}         # partition -> min changed value
        chnull: Dict[Tuple, bool] = {}       # partitions with NULL-order changes
        removed: Dict[Tuple, List[Tuple[Tuple, Tuple]]] = {}
        added: Dict[Tuple, int] = {}
        oc0 = self.order_by[0][0] if self.order_by else None
        for op, row in chunk.compact().op_rows():
            p = tuple(row[i] for i in self.partition_by)
            part = self.partitions.setdefault(p, _Partition(len(self.calls)))
            key = self._order_key(row)
            if oc0 is not None:
                if row[oc0] is None:
                    chnull[p] = True
                else:
                    prev = chval.get(p)
                    chval[p] = row[oc0] if prev is None \
                        else min(prev, row[oc0])
            if op.is_insert:
                pos = bisect.bisect_right(part.keys, key)
                part.keys.insert(pos, key)
                part.rows.insert(pos, row)
                part.outs.insert(pos, None)       # placeholder
                for v in part.vals:
                    v.insert(pos, None)
                if oc0 is not None:
                    part.ovals.insert(pos, row[oc0])
                added[p] = added.get(p, 0) + 1
                if self.state_table is not None:
                    self.state_table.insert(row)
            else:
                pos = bisect.bisect_left(part.keys, key)
                if pos < len(part.keys) and part.keys[pos] == key:
                    removed.setdefault(p, []).append(
                        (row, part.outs[pos]))
                    part.keys.pop(pos)
                    part.rows.pop(pos)
                    part.outs.pop(pos)
                    for v in part.vals:
                        v.pop(pos)
                    if oc0 is not None:
                        part.ovals.pop(pos)
                if self.state_table is not None:
                    self.state_table.delete(row)
            touched[p] = min(touched.get(p, pos), pos)
        out = StreamChunkBuilder(self.schema.dtypes)
        recomputed = 0
        for p, min_pos in touched.items():
            part = self.partitions[p]
            n = len(part.rows)
            start = self._start_of(part, min_pos, chval.get(p),
                                   chnull.get(p, False))
            # refresh cached arg values for the region (inserted rows
            # hold placeholders); one vectorized eval per call
            region_vals = self._eval_args(part.rows[start:])
            for ci in range(len(self.calls)):
                part.vals[ci][start:] = region_vals[ci]
            old_outs = part.outs[start:]
            new_outs = self._compute(part, start)
            recomputed += n - start
            part.outs[start:] = new_outs
            # diff the region; removed rows emit deletes with their
            # cached outputs
            old_by_row: Dict[Tuple, List[Tuple]] = {}
            for r, o in zip(part.rows[start:], old_outs):
                if o is not None:
                    old_by_row.setdefault(r, []).append(o)
            deletes: List[Tuple] = [r + o for r, o in removed.get(p, [])
                                    if o is not None]
            updates: List[Tuple[Tuple, Tuple]] = []
            inserts: List[Tuple] = []
            for r, o in zip(part.rows[start:], new_outs):
                olds = old_by_row.get(r)
                if olds:
                    old_o = olds.pop(0)
                    if old_o != o:
                        updates.append((r + old_o, r + o))
                else:
                    inserts.append(r + o)
            for r, olds in old_by_row.items():
                deletes.extend(r + o for o in olds)
            for row_out in deletes:
                out.append_row(Op.DELETE, row_out)
            for old_row, new_row in updates:
                out.append_update(old_row, new_row)
            for row_out in inserts:
                out.append_row(Op.INSERT, row_out)
            if not part.rows:
                del self.partitions[p]
        REGISTRY.counter(
            "over_window_recomputed_rows",
            "rows recomputed by OverWindow per chunk").inc(recomputed)
        yield from out.drain()

    def on_barrier(self, barrier: Barrier) -> Iterator[Message]:
        if self.state_table is not None:
            self.state_table.commit(barrier.epoch.curr)
        return iter(())
