"""Batch executors: pull-based chunk pipelines over a pinned snapshot (the
port's own copy of the JAX package's `batch/executor.py`).

Re-design of the reference's batch executor framework
(`src/batch/src/executor/mod.rs:47` `Executor` trait — schema + a chunk
stream). Where the stream engine maintains state across barriers, a batch
executor runs a finite chunk stream to completion; operators are
vectorized over `DataChunk`s (expressions evaluate columnar via
`expr/expression.py`) and aggregation reuses the exact `AggState`
machinery so batch and stream results agree bit-for-bit.

Snapshot pinning: the scan's chunks are materialized from the committed
state at plan time (the runtime flushes the in-flight barrier first), the
`batch_table/mod.rs:892` snapshot-read analog for a single-process store.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.chunk import Column, DataChunk
from ..core.schema import Field, Schema
from ..expr.agg import AggCall, create_agg_state


class BatchExecutor:
    """Base: `execute()` yields DataChunks; finite."""

    def __init__(self, schema: Schema, name: str = ""):
        self.schema = schema
        self.name = name or type(self).__name__

    def execute(self) -> Iterator[DataChunk]:
        raise NotImplementedError

    def rows(self) -> List[Tuple]:
        out: List[Tuple] = []
        for ch in self.execute():
            out.extend(ch.rows())
        return out


class SeqScan(BatchExecutor):
    """Scan a materialized snapshot (`row_seq_scan.rs` analog)."""

    def __init__(self, schema: Schema, chunks: Sequence[DataChunk],
                 name: str = "SeqScan"):
        super().__init__(schema, name)
        self.chunks = list(chunks)

    def execute(self) -> Iterator[DataChunk]:
        yield from self.chunks


class StatelessWrap(BatchExecutor):
    """Run a STATELESS stream operator's vectorized `on_chunk` over the
    batch stream (project/filter/hop-window/expand are identical in both
    engines — the reference shares `expr/` the same way)."""

    def __init__(self, input: BatchExecutor, op: Any):
        super().__init__(op.schema, f"Batch({op.name})")
        self.input = input
        self.op = op

    def execute(self) -> Iterator[DataChunk]:
        from ..core.chunk import StreamChunk
        for ch in self.input.execute():
            ch = ch.compact()
            sc = StreamChunk(np.zeros(ch.capacity, dtype=np.int8),
                             ch.columns)
            for out in self.op.on_chunk(sc):
                if isinstance(out, StreamChunk):
                    yield out.data_chunk()


class BatchHashAgg(BatchExecutor):
    """Vectorized grouping + exact AggState accumulation
    (`hash_agg.rs` analog)."""

    def __init__(self, input: BatchExecutor,
                 group_key_indices: Sequence[int],
                 calls: Sequence[AggCall]):
        fields = [input.schema.fields[i] for i in group_key_indices]
        fields += [Field(f"agg#{i}", c.return_type)
                   for i, c in enumerate(calls)]
        super().__init__(Schema(fields), "BatchHashAgg")
        self.input = input
        self.group_key_indices = list(group_key_indices)
        self.calls = list(calls)

    def execute(self) -> Iterator[DataChunk]:
        from ..expr.agg import DistinctDedup
        groups: Dict[Tuple, Tuple[List[Any], List[Any]]] = {}
        for ch in self.input.execute():
            ch = ch.compact()
            if ch.capacity == 0:
                continue
            keys = list(zip(*(ch.columns[i].to_list()
                              for i in self.group_key_indices))) \
                if self.group_key_indices else [()] * ch.capacity
            # evaluate each call's argument column once per chunk
            arg_cols = [c.arg.eval(ch) if c.arg is not None else None
                        for c in self.calls]
            filt_cols = [c.filter.eval(ch) if c.filter is not None else None
                         for c in self.calls]
            for i, k in enumerate(keys):
                g = groups.get(k)
                if g is None:
                    g = groups[k] = (
                        [create_agg_state(c) for c in self.calls],
                        [DistinctDedup() if c.distinct else None
                         for c in self.calls])
                st, dedups = g
                for ci, (call, ac) in enumerate(zip(self.calls, arg_cols)):
                    fc = filt_cols[ci]
                    if fc is not None and not (fc.validity[i]
                                               and fc.values[i]):
                        continue
                    if ac is None:                 # count(*)
                        st[ci].apply(1, 1)
                        continue
                    v = ac.get(i)
                    if v is None:                  # NULLs don't aggregate
                        continue
                    d = dedups[ci]
                    if d is not None and d.apply(1, v) == 0:
                        continue                   # duplicate DISTINCT value
                    st[ci].apply(1, v)
        rows = [k + tuple(st.output() for st in sts)
                for k, (sts, _d) in groups.items()]
        if rows:
            yield DataChunk.from_rows(self.schema.dtypes, rows)


class BatchSimpleAgg(BatchHashAgg):
    """Global aggregation: exactly one output row, even on empty input
    (`sort_agg.rs`/simple agg semantics)."""

    def __init__(self, input: BatchExecutor, calls: Sequence[AggCall]):
        super().__init__(input, [], calls)
        self.name = "BatchSimpleAgg"

    def execute(self) -> Iterator[DataChunk]:
        got = list(super().execute())
        if got:
            yield from got
        else:
            sts = [create_agg_state(c) for c in self.calls]
            yield DataChunk.from_rows(
                self.schema.dtypes, [tuple(s.output() for s in sts)])


class BatchHashJoin(BatchExecutor):
    """Build-probe equi join with optional residual condition
    (`hash_join.rs` analog; build = right side)."""

    def __init__(self, left: BatchExecutor, right: BatchExecutor,
                 left_keys: Sequence[int], right_keys: Sequence[int],
                 join_type: str = "inner", condition: Any = None,
                 chunk_size: int = 4096):
        from ..ops.join import JoinType
        jt = join_type.value if isinstance(join_type, JoinType) else join_type
        if jt in ("left_semi", "left_anti"):
            schema = left.schema
        else:
            schema = left.schema.concat(right.schema)
        super().__init__(schema, f"BatchHashJoin[{jt}]")
        self.left, self.right = left, right
        self.lk, self.rk = list(left_keys), list(right_keys)
        self.join_type = jt
        self.condition = condition
        self.chunk_size = chunk_size

    def _passes(self, rows: List[Tuple]) -> List[bool]:
        if self.condition is None or not rows:
            return [True] * len(rows)
        probe_schema = self.left.schema.concat(self.right.schema)
        ch = DataChunk.from_rows(probe_schema.dtypes, rows)
        c = self.condition.eval(ch)
        return [bool(ok) and bool(v)
                for v, ok in zip(c.values, c.validity)]

    def execute(self) -> Iterator[DataChunk]:
        build: Dict[Tuple, List[Tuple]] = defaultdict(list)
        for ch in self.right.execute():
            for row in ch.rows():
                k = tuple(row[i] for i in self.rk)
                if any(v is None for v in k):
                    continue
                build[k].append(row)
        matched_right: set = set()
        out: List[Tuple] = []
        jt = self.join_type

        def flush():
            nonlocal out
            if out:
                yield DataChunk.from_rows(self.schema.dtypes, out)
                out = []

        nr = len(self.right.schema)
        for ch in self.left.execute():
            for lrow in ch.rows():
                k = tuple(lrow[i] for i in self.lk)
                cands = build.get(k, []) if not any(v is None for v in k) \
                    else []
                pairs = [lrow + r for r in cands]
                ok = self._passes(pairs)
                hits = [r for r, o in zip(cands, ok) if o]
                if jt == "left_semi":
                    if hits:
                        out.append(lrow)
                elif jt == "left_anti":
                    if not hits:
                        out.append(lrow)
                else:
                    for r in hits:
                        out.append(lrow + r)
                        if jt in ("right_outer", "full_outer"):
                            matched_right.add(id(r))
                    if not hits and jt in ("left_outer", "full_outer"):
                        out.append(lrow + (None,) * nr)
                if len(out) >= self.chunk_size:
                    yield from flush()
        if jt in ("right_outer", "full_outer"):
            nl = len(self.left.schema)
            for rows_ in build.values():
                for r in rows_:
                    if id(r) not in matched_right:
                        out.append((None,) * nl + r)
        yield from flush()


class BatchUnion(BatchExecutor):
    def __init__(self, inputs: Sequence[BatchExecutor]):
        super().__init__(inputs[0].schema, "BatchUnion")
        self.inputs = list(inputs)

    def execute(self) -> Iterator[DataChunk]:
        for i in self.inputs:
            yield from i.execute()
