"""Set-returning functions: ProjectSet + table-function scan (the port's
own copy of the JAX package's `ops/project_set.py`).

Reference: `src/stream/src/executor/project/project_set.rs` (ProjectSet:
each input row expands through a mix of scalar expressions and table
functions, PG-style zipped to the longest function with NULL padding,
plus a `projected_row_id` ordinal that keeps the expanded rows' stream
identity) and `src/expr/core/src/table_function/mod.rs:174` /
`src/expr/impl/src/table_function/generate_series.rs` for the function
semantics (series bounds are INCLUSIVE, zero step is an error).

Supported functions: generate_series over ints and timestamps (+INTERVAL
step), unnest over ARRAY[...] literals of scalar expressions (array-typed
columns are not in the type system yet).
"""
from __future__ import annotations

from typing import Any, Iterator, List, Optional, Sequence, Tuple

from ..core.chunk import Op, StreamChunk, StreamChunkBuilder
from ..core.dtypes import Interval, TypeKind
from ..core.schema import Field, Schema
from ..core import dtypes as T
from ..expr.expression import Expr
from .executor import Executor, UnaryExecutor
from .message import Barrier, Message, Watermark

TABLE_FUNCTIONS = ("generate_series", "unnest")


class BoundTableFunction:
    """One table-function call with bound argument expressions.

    `unnest` carries the ARRAY literal's element expressions directly
    (each evaluated per input row); `generate_series` evaluates
    (start, stop[, step]) per row and yields the inclusive series.
    """

    def __init__(self, name: str, args: Sequence[Expr],
                 return_type: Any):
        self.name = name
        self.args = list(args)
        self.return_type = return_type

    def expand(self, data_chunk) -> List[List[Any]]:
        """Per input row (by position), the list of produced values."""
        cols = [a.eval(data_chunk) for a in self.args]
        n = data_chunk.capacity
        vals = [[c.get(i) for c in cols] for i in range(n)]
        if self.name == "unnest":
            return vals                       # element exprs ARE the rows
        out: List[List[Any]] = []
        for row in vals:
            out.append(_series(row, self.return_type))
        return out


def _series(args: List[Any], rt) -> List[Any]:
    if any(a is None for a in args):
        return []                             # PG: NULL bound -> no rows
    start, stop = args[0], args[1]
    step = args[2] if len(args) > 2 else 1
    if isinstance(step, Interval):
        if step.months:
            raise ValueError("generate_series month-interval steps are "
                             "not supported")
        step = step.days * 86_400_000_000 + step.usecs
    if step == 0:
        raise ValueError("step size cannot equal zero")
    out = []
    v = start
    if step > 0:
        while v <= stop:
            out.append(v)
            v += step
    else:
        while v >= stop:
            out.append(v)
            v += step
    return out


def series_return_type(arg_types: Sequence[Any]):
    """Result element type of generate_series, PG-style."""
    if arg_types[0].kind in (TypeKind.TIMESTAMP, TypeKind.DATE):
        return T.TIMESTAMP
    return T.INT64


class TableFunctionScanExecutor(Executor):
    """FROM-clause table function over constant arguments: emits the whole
    row set once (like Values), then passes barriers. The hidden trailing
    `_row_id` ordinal is the stream key (expansions may repeat values)."""

    def __init__(self, tf: BoundTableFunction, name: str,
                 barrier_source: Executor):
        schema = Schema([Field(name, tf.return_type),
                         Field("_row_id", T.INT64)])
        super().__init__(schema, f"TableFunctionScan[{tf.name}]")
        self.append_only = True
        self.tf = tf
        self.barrier_source = barrier_source

    def execute(self) -> Iterator[Message]:
        from ..core.chunk import DataChunk
        emitted = False
        for msg in self.barrier_source.execute():
            if not emitted and isinstance(msg, Barrier):
                yield msg
                one = DataChunk.from_rows([T.INT64], [(0,)])  # 1-row driver
                (vals,) = self.tf.expand(one)
                if vals:
                    yield StreamChunk.from_rows(
                        self.schema.dtypes,
                        [(Op.INSERT, (v, i)) for i, v in enumerate(vals)])
                emitted = True
            else:
                yield msg


class ProjectSetExecutor(UnaryExecutor):
    """SELECT-list expansion (`project_set.rs`): items are ('s', expr) or
    ('tf', BoundTableFunction). Output = item columns + carried hidden
    columns (`carry`, input column indices — the upstream stream key) +
    `projected_row_id`.

    PG zip semantics: per input row, every table function runs; the row
    expands to max(lengths) output rows; shorter functions NULL-pad;
    scalars repeat. A row whose functions all return empty produces
    nothing. Updates decay to DELETE+INSERT (expansion lengths may
    differ across the pair)."""

    def __init__(self, input: Executor,
                 items: Sequence[Tuple[str, Any]],
                 names: Sequence[str],
                 carry: Sequence[int] = ()):
        fields = []
        for (kind, item), nm in zip(items, names):
            rt = item.return_type
            fields.append(Field(nm, rt))
        for ci in carry:
            fields.append(Field(f"_carry{ci}", input.schema.fields[ci].dtype))
        fields.append(Field("_projected_row_id", T.INT64))
        super().__init__(input, Schema(fields))
        self.append_only = input.append_only
        self.items = list(items)
        self.carry = list(carry)

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        chunk = chunk.compact()
        data = chunk.data_chunk()
        n = chunk.capacity
        per_item: List[Any] = []
        for kind, item in self.items:
            if kind == "s":
                col = item.eval(data)
                per_item.append([col.get(i) for i in range(n)])
            else:
                per_item.append(item.expand(data))
        carried = [[data.columns[ci].get(i) for ci in self.carry]
                   for i in range(n)]
        out = StreamChunkBuilder(self.schema.dtypes, 1024)
        for i in range(n):
            op = Op(int(chunk.ops[i]))
            if op == Op.UPDATE_DELETE:
                op = Op.DELETE
            elif op == Op.UPDATE_INSERT:
                op = Op.INSERT
            lens = [len(v[i]) for (k, _), v in zip(self.items, per_item)
                    if k == "tf"]
            m = max(lens) if lens else 1
            for j in range(m):
                row = []
                for (kind, _), vals in zip(self.items, per_item):
                    if kind == "s":
                        row.append(vals[i])
                    else:
                        row.append(vals[i][j] if j < len(vals[i]) else None)
                row.extend(carried[i])
                row.append(j)
                out.append_row(op, tuple(row))
        yield from out.drain()

    def on_watermark(self, wm: Watermark) -> Iterator[Message]:
        from ..expr.expression import InputRef
        for out_idx, (kind, item) in enumerate(self.items):
            if kind == "s" and isinstance(item, InputRef) \
                    and item.index == wm.col_idx:
                yield Watermark(out_idx, wm.dtype, wm.value)
                return
        # not selected — the watermark column may still ride a hidden
        # carry column (the planner points downstream at that index)
        if wm.col_idx in self.carry:
            out_idx = len(self.items) + self.carry.index(wm.col_idx)
            yield Watermark(out_idx, wm.dtype, wm.value)
