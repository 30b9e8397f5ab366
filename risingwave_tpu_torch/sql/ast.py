"""SQL AST nodes (the `src/sqlparser/src/ast/` analog, minimal; the port's
own copy of the JAX package's `sql/ast.py`)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class ExprNode:
    pass


@dataclass
class Lit(ExprNode):
    value: Any                 # python value; None = NULL
    type_hint: Optional[str] = None   # 'interval', etc.


@dataclass
class Col(ExprNode):
    name: str
    table: Optional[str] = None


@dataclass
class Star(ExprNode):
    table: Optional[str] = None


@dataclass
class BinOp(ExprNode):
    op: str                    # '+', '-', '=', 'and', ...
    left: ExprNode
    right: ExprNode


@dataclass
class UnaryOp(ExprNode):
    op: str                    # 'not', '-'
    operand: ExprNode


@dataclass
class FuncCall(ExprNode):
    name: str
    args: List[ExprNode]
    distinct: bool = False
    over: Optional["WindowSpec"] = None
    filter: Optional[ExprNode] = None   # FILTER (WHERE ...) on aggregates
    # WITHIN GROUP (ORDER BY e) — ordered-set aggregates
    # (approx_percentile); the direct args stay in `args`
    within_group: Optional[ExprNode] = None


@dataclass
class Param(ExprNode):
    """$n placeholder in a prepared statement (1-based). Replaced with a
    Lit at Bind time (`pg_extended.rs` bound-statement analog); binding
    one directly is an error."""
    index: int


def max_param(node: Any) -> int:
    """Highest $n index anywhere in a statement tree (0 = none)."""
    import dataclasses
    best = 0
    stack = [node]
    while stack:
        x = stack.pop()
        if isinstance(x, Param):
            best = max(best, x.index)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name)
                         for f in dataclasses.fields(x))
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return best


def bind_params(node: Any, lits: "List[Lit]") -> Any:
    """Deep-substitute every Param with its bound literal — the
    plan-once half of Parse/Bind: the statement tree parsed at Parse is
    reused for every Bind/Execute, no re-lex/re-parse."""
    import dataclasses

    def sub(x):
        if isinstance(x, Param):
            if x.index - 1 >= len(lits):
                raise ValueError(f"no value for placeholder ${x.index}")
            return lits[x.index - 1]
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            kw = {}
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                nv = sub(v)
                if nv is not v:
                    kw[f.name] = nv
            return dataclasses.replace(x, **kw) if kw else x
        if isinstance(x, list):
            out = [sub(v) for v in x]
            return out if any(a is not b for a, b in zip(out, x)) else x
        if isinstance(x, tuple):
            out = tuple(sub(v) for v in x)
            return out if any(a is not b for a, b in zip(out, x)) else x
        return x

    return sub(node)


@dataclass
class ArrayLit(ExprNode):
    """ARRAY[e1, e2, ...] — consumed by UNNEST (no array columns yet)."""
    items: List[ExprNode]


@dataclass
class WindowSpec:
    partition_by: List[ExprNode]
    order_by: List[Tuple[ExprNode, bool]]   # (expr, desc)
    # (mode, start, end): mode 'rows'|'range'; bounds are
    # ('unbounded',) | ('current',) | ('preceding', expr) |
    # ('following', expr); None = no explicit frame (default)
    frame: Optional[Tuple] = None


@dataclass
class CaseExpr(ExprNode):
    operand: Optional[ExprNode]
    branches: List[Tuple[ExprNode, ExprNode]]
    else_expr: Optional[ExprNode]


@dataclass
class CastExpr(ExprNode):
    operand: ExprNode
    type_name: str


@dataclass
class ExtractExpr(ExprNode):
    field: str
    operand: ExprNode


@dataclass
class IsNullExpr(ExprNode):
    operand: ExprNode
    negated: bool


@dataclass
class InList(ExprNode):
    operand: ExprNode
    items: List[ExprNode]
    negated: bool


@dataclass
class Between(ExprNode):
    operand: ExprNode
    low: ExprNode
    high: ExprNode
    negated: bool


@dataclass
class SubqueryExpr(ExprNode):
    query: "Select"


@dataclass
class InSubquery(ExprNode):
    """operand [NOT] IN (SELECT ...) — plans as a semi/anti join."""
    operand: ExprNode
    query: "Select"
    negated: bool


@dataclass
class Index(ExprNode):
    """expr[i] — array subscript (regexp_match group access)."""
    operand: ExprNode
    index: int


# ---------------------------------------------------------------------------
# FROM clause
# ---------------------------------------------------------------------------


class TableRef:
    alias: Optional[str]


@dataclass
class NamedTable(TableRef):
    name: str
    alias: Optional[str] = None


@dataclass
class WindowTable(TableRef):
    """TUMBLE(t, time_col, size) / HOP(t, time_col, hop, size)."""
    kind: str                  # 'tumble' | 'hop'
    inner: TableRef
    time_col: str
    args: List[ExprNode]       # intervals
    alias: Optional[str] = None


@dataclass
class SubqueryTable(TableRef):
    query: "Select"
    alias: Optional[str] = None


@dataclass
class Join(TableRef):
    left: TableRef
    right: TableRef
    kind: str                  # 'inner' | 'left' | 'right' | 'full' | 'cross'
    on: Optional[ExprNode]
    alias: Optional[str] = None


@dataclass
class ChangelogTable(TableRef):
    """WITH name AS changelog FROM obj (`ast/query.rs` CteInner::ChangeLog):
    the upstream's retractable change stream as an append-only relation with
    a `changelog_op` column."""
    inner: str
    alias: Optional[str] = None


@dataclass
class TableFunctionTable(TableRef):
    """FROM-clause table function: generate_series(...) / unnest(ARRAY[...])
    (`src/expr/core/src/table_function/mod.rs:174`)."""
    name: str                  # 'generate_series' | 'unnest'
    args: List[ExprNode]
    alias: Optional[str] = None


@dataclass
class TemporalTable(TableRef):
    """t FOR SYSTEM_TIME AS OF PROCTIME() — the version side of a temporal
    join (`src/stream/src/executor/temporal_join.rs:44`)."""
    inner: "NamedTable"
    alias: Optional[str] = None


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------


@dataclass
class SelectItem:
    expr: ExprNode
    alias: Optional[str] = None


@dataclass
class Select:
    items: List[SelectItem]
    from_: Optional[TableRef]
    where: Optional[ExprNode] = None
    group_by: List[ExprNode] = field(default_factory=list)
    having: Optional[ExprNode] = None
    order_by: List[Tuple[ExprNode, bool]] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False


@dataclass
class SetOp:
    """UNION [ALL] (`ast/query.rs` SetExpr::SetOperation). `left`/`right`
    are Select or nested SetOp. ORDER BY/LIMIT written after the last
    branch belong to the whole set operation (hoisted by the parser)."""
    op: str                    # 'union'
    all: bool
    left: Any
    right: Any
    order_by: List[Tuple[ExprNode, bool]] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None


Query = Any                    # Select | SetOp


@dataclass
class ColumnDef:
    name: str
    type_name: str
    primary_key: bool = False
    watermark_delay: Optional[ExprNode] = None   # WATERMARK FOR c AS c - d


@dataclass
class CreateTable:
    name: str
    columns: List[ColumnDef]
    primary_key: List[str]
    with_options: dict
    append_only: bool = False
    is_source: bool = False
    watermark: Optional[Tuple[str, ExprNode]] = None


@dataclass
class CreateMaterializedView:
    name: str
    query: Select


@dataclass
class CreateFunction:
    """CREATE FUNCTION name(argtypes) RETURNS t LANGUAGE python AS $$..$$
    (the reference's embedded-Python UDF, `src/expr/impl/src/udf/python.rs`)."""
    name: str
    arg_types: List[str]
    return_type: str
    language: str
    body: str
    or_replace: bool = False


@dataclass
class CreateSink:
    name: str
    from_name: Optional[str]
    query: Optional[Select]
    with_options: dict


@dataclass
class CreateIndex:
    name: str
    table: str
    columns: List[str]


@dataclass
class DropObject:
    kind: str                  # 'table' | 'source' | 'materialized view' ...
    name: str
    if_exists: bool = False
    cascade: bool = False


@dataclass
class Insert:
    table: str
    columns: List[str]
    rows: List[List[ExprNode]]
    query: Optional[Select] = None


@dataclass
class Delete:
    table: str
    where: Optional[ExprNode]


@dataclass
class Update:
    table: str
    assignments: List[Tuple[str, ExprNode]]
    where: Optional[ExprNode]


@dataclass
class Flush:
    pass


@dataclass
class ShowObjects:
    kind: str


@dataclass
class Explain:
    stmt: Any


@dataclass
class ExplainAnalyze:
    """EXPLAIN ANALYZE <mv>: the live per-operator tree of a RUNNING
    streaming job (eps, amplification, occupancy, phase shares, skew) —
    unlike EXPLAIN, which renders the plan a statement WOULD run."""
    target: str


@dataclass
class AlterParallelism:
    """ALTER MATERIALIZED VIEW <name> SET PARALLELISM <n>."""
    name: str
    parallelism: int


@dataclass
class SetVar:
    """SET <name> = <value> (session) / ALTER SYSTEM SET (cluster)."""
    name: str
    value: Any
    system: bool = False


@dataclass
class ShowVar:
    """SHOW <name> | SHOW ALL | SHOW PARAMETERS."""
    name: Optional[str]   # None = ALL
