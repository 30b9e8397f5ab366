"""Binder + planner: Select AST -> executor tree (the port's own copy of
the JAX package's `sql/planner.py`).

Collapses the reference's binder -> logical plan -> optimizer -> stream plan
pipeline (`src/frontend/src/{binder,planner,optimizer}/`) into one direct
lowering: each SELECT shape maps onto the executor set the same way the
reference's optimized stream plans do (Project/Filter/HashAgg/HashJoin/
HopWindow/OverWindow/TopN/Materialize). The 100+ rewrite rules exist to
normalize hand-written SQL into those shapes; here the planner emits them
directly and leaves micro-optimization to the CUDA kernels on the device
path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core import dtypes as T
from ..core.dtypes import DataType, Interval, TypeKind, parse_interval
from ..core.schema import Field, Schema
from ..expr import (AGG_KINDS, AggCall, Case, Coalesce, Expr, InputRef,
                    Literal, build_func, cast)
from ..expr.expression import IsNull
from ..ops import (FilterExecutor, HashAggExecutor, HashJoinExecutor,
                   HopWindowExecutor, JoinType, OverWindowExecutor,
                   ProjectExecutor, SimpleAggExecutor, TopNExecutor,
                   WindowFuncCall)
from ..ops.executor import Executor
from . import ast as A

_TYPE_MAP = {
    "int": T.INT32, "integer": T.INT32, "int4": T.INT32,
    "smallint": T.INT16, "int2": T.INT16,
    "bigint": T.INT64, "int8": T.INT64, "serial": T.INT64,
    "real": T.FLOAT32, "float4": T.FLOAT32,
    "double": T.FLOAT64, "float8": T.FLOAT64, "float": T.FLOAT64,
    "numeric": T.DECIMAL, "decimal": T.DECIMAL,
    "boolean": T.BOOLEAN, "bool": T.BOOLEAN,
    "varchar": T.VARCHAR, "text": T.VARCHAR, "string": T.VARCHAR,
    "date": T.DATE, "time": T.TIME, "timestamp": T.TIMESTAMP,
    "timestamptz": T.TIMESTAMPTZ, "interval": T.INTERVAL, "bytea": T.BYTEA,
}


def type_from_name(name: str) -> DataType:
    dt = _TYPE_MAP.get(name.lower())
    if dt is None:
        raise ValueError(f"unknown type {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Namespace: the column scope a plan node exposes
# ---------------------------------------------------------------------------


@dataclass
class ColumnEntry:
    table: Optional[str]
    name: str
    dtype: DataType


@dataclass
class Namespace:
    cols: List[ColumnEntry]
    # indices forming the stream key: the minimal column set that makes rows
    # unique in the change stream (StreamMaterialize pk derivation analog,
    # `src/frontend/src/optimizer/plan_node/stream_materialize.rs`). The MV
    # pk must cover it or duplicate rows collapse.
    stream_key: List[int] = field(default_factory=list)
    n_visible: Optional[int] = None    # hidden stream-key cols sit past this
    watermark_idx: Optional[int] = None   # column carrying the watermark

    def resolve(self, name: str, table: Optional[str] = None) -> int:
        hits = [i for i, c in enumerate(self.cols)
                if c.name == name and (table is None or c.table == table)]
        if not hits:
            raise ValueError(f"column {table + '.' if table else ''}{name} "
                             f"does not exist")
        if len(hits) > 1:
            raise ValueError(f"column reference {name!r} is ambiguous")
        return hits[0]

    def schema(self) -> Schema:
        return Schema([Field(c.name, c.dtype) for c in self.cols])

    @staticmethod
    def of_schema(schema: Schema, table: Optional[str],
                  stream_key: Optional[Sequence[int]] = None) -> "Namespace":
        return Namespace([ColumnEntry(table, f.name, f.dtype)
                          for f in schema.fields],
                         list(stream_key or []))

    def concat(self, other: "Namespace") -> "Namespace":
        off = len(self.cols)
        return Namespace(self.cols + other.cols,
                         self.stream_key + [i + off
                                            for i in other.stream_key])


# ---------------------------------------------------------------------------
# Expression binding
# ---------------------------------------------------------------------------

_BINOP_FUNC = {
    "+": "add", "-": "subtract", "*": "multiply", "/": "divide",
    "%": "modulus", "=": "equal", "<>": "not_equal", "!=": "not_equal",
    "<": "less_than", "<=": "less_than_or_equal", ">": "greater_than",
    ">=": "greater_than_or_equal", "and": "and", "or": "or",
}


def _lit(value: Any, hint: Optional[str]) -> Literal:
    if hint == "interval":
        return Literal(parse_interval(value), T.INTERVAL)
    if value is None:
        return Literal(None, T.VARCHAR)
    if isinstance(value, bool):
        return Literal(value, T.BOOLEAN)
    if isinstance(value, int):
        return Literal(value, T.INT32 if -2**31 <= value < 2**31 else T.INT64)
    if isinstance(value, float):
        return Literal(value, T.FLOAT64)
    if isinstance(value, str):
        return Literal(value, T.VARCHAR)
    raise ValueError(f"cannot type literal {value!r}")


class Binder:
    def __init__(self, ns: Namespace):
        self.ns = ns

    def bind(self, node: A.ExprNode) -> Expr:
        if isinstance(node, A.Param):
            raise ValueError(f"there is no parameter ${node.index} "
                             "(unbound prepared-statement placeholder)")
        if isinstance(node, A.Lit):
            return _lit(node.value, node.type_hint)
        if isinstance(node, A.Col):
            i = self.ns.resolve(node.name, node.table)
            return InputRef(i, self.ns.cols[i].dtype)
        if isinstance(node, A.BinOp):
            return build_func(_BINOP_FUNC[node.op],
                              [self.bind(node.left), self.bind(node.right)])
        if isinstance(node, A.UnaryOp):
            if node.op == "not":
                return build_func("not", [self.bind(node.operand)])
            return build_func("neg", [self.bind(node.operand)])
        if isinstance(node, A.FuncCall):
            if node.name in ("count", "sum", "min", "max", "avg") \
                    and node.over is None:
                raise ValueError(f"aggregate {node.name} in scalar context")
            if node.filter is not None:
                raise ValueError("FILTER is only supported on aggregate "
                                 "function calls")
            if node.name == "concat_op":
                return build_func("concat_op", [self.bind(a)
                                                for a in node.args])
            return build_func(node.name, [self.bind(a) for a in node.args])
        if isinstance(node, A.CaseExpr):
            branches = []
            for cond, res in node.branches:
                if node.operand is not None:
                    cond = A.BinOp("=", node.operand, cond)
                branches.append((self.bind(cond), self.bind(res)))
            els = self.bind(node.else_expr) if node.else_expr else None
            ret = branches[0][1].return_type
            return Case(branches, els, ret)
        if isinstance(node, A.CastExpr):
            return cast(self.bind(node.operand),
                        type_from_name(node.type_name))
        if isinstance(node, A.ExtractExpr):
            return build_func("extract",
                              [Literal(node.field.upper(), T.VARCHAR),
                               self.bind(node.operand)])
        if isinstance(node, A.IsNullExpr):
            return IsNull(self.bind(node.operand), negated=node.negated)
        if isinstance(node, A.Between):
            lo = A.BinOp(">=", node.operand, node.low)
            hi = A.BinOp("<=", node.operand, node.high)
            e = A.BinOp("and", lo, hi)
            if node.negated:
                e = A.UnaryOp("not", e)
            return self.bind(e)
        if isinstance(node, A.InList):
            e: Optional[A.ExprNode] = None
            for item in node.items:
                eq = A.BinOp("=", node.operand, item)
                e = eq if e is None else A.BinOp("or", e, eq)
            if node.negated:
                e = A.UnaryOp("not", e)
            return self.bind(e)
        if isinstance(node, A.Index):
            inner = node.operand
            if isinstance(inner, A.FuncCall) and inner.name == "regexp_match":
                args = [self.bind(a) for a in inner.args]
                args.append(Literal(node.index, T.INT32))
                return build_func("regexp_match_idx", args)
            raise ValueError("subscript is only supported on "
                             "regexp_match(...)")
        if isinstance(node, A.InSubquery):
            raise ValueError("IN (SELECT ...) is only supported as a "
                             "top-level WHERE condition")
        if isinstance(node, A.SubqueryExpr):
            raise ValueError("scalar subqueries are only supported on one "
                             "side of a WHERE/HAVING comparison")
        raise ValueError(f"cannot bind {node!r}")


# ---------------------------------------------------------------------------
# Aggregate extraction
# ---------------------------------------------------------------------------


def _find_aggs(node: A.ExprNode, out: List[A.FuncCall]) -> None:
    if isinstance(node, A.FuncCall) and node.over is None and \
            node.name in AGG_KINDS:
        out.append(node)
        return
    for child in _children(node):
        _find_aggs(child, out)


def _children(node: A.ExprNode) -> List[A.ExprNode]:
    if isinstance(node, A.BinOp):
        return [node.left, node.right]
    if isinstance(node, A.UnaryOp):
        return [node.operand]
    if isinstance(node, A.FuncCall):
        return list(node.args)
    if isinstance(node, A.CaseExpr):
        out = list(node.branches and
                   [x for b in node.branches for x in b] or [])
        if node.operand:
            out.append(node.operand)
        if node.else_expr:
            out.append(node.else_expr)
        return out
    if isinstance(node, (A.CastExpr, A.ExtractExpr, A.IsNullExpr)):
        return [node.operand]
    if isinstance(node, A.Between):
        return [node.operand, node.low, node.high]
    if isinstance(node, A.InList):
        return [node.operand] + node.items
    if isinstance(node, (A.Index, A.InSubquery)):
        return [node.operand]
    return []


def _contains_agg(node: A.ExprNode) -> bool:
    found: List[A.FuncCall] = []
    _find_aggs(node, found)
    return bool(found)


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

_JOIN_KIND = {"inner": JoinType.INNER, "left": JoinType.LEFT_OUTER,
              "right": JoinType.RIGHT_OUTER, "full": JoinType.FULL_OUTER}


class Planner:
    """Plans one Select into an executor tree.

    `subscribe(name) -> (Executor, Schema, pk)` is supplied by the runtime
    (Database): streaming change feed + backfill for MV plans, snapshot
    source for batch queries — the planner is mode-agnostic, exactly the
    to-stream / to-batch split of the reference's plan_node lowering.
    """

    def __init__(self, subscribe: Callable[[str], Tuple[Executor, Schema]],
                 make_state: Optional[Callable[[Sequence[DataType],
                                                Sequence[int]], Any]] = None,
                 device=None, barrier_source=None, watermark_of=None,
                 state_table_of=None, torch_device=None):
        self.subscribe = subscribe
        # name -> StateTable | None: the object's arrangement, for
        # lookup/delta joins (ops/lookup_join.py)
        self.state_table_of = state_table_of
        # SET streaming_enable_delta_join (stamped by Database per CREATE)
        self.delta_join = False
        # state-table factory: (dtypes, pk) -> StateTable | None. Called in
        # a DETERMINISTIC order per statement so table ids line up when the
        # DDL log replays on recovery.
        self.make_state = make_state or (lambda dtypes, pk: None)
        # DeviceConfig | None — the SQL->device dispatch seam (the reference's
        # from_proto/mod.rs:151-197 analog): eligible HashAgg fragments
        # lower onto DeviceHashAggExecutor. Must be stable across restarts
        # of the same data directory (state-table layouts differ).
        self.device = device
        # the torch device the device executors' state lives on (the
        # port's own argument; None = `cuda:0`, raising with no GPU)
        self.torch_device = torch_device
        # () -> Executor yielding only barriers; required to plan NOW()
        # (the `now.rs` barrier-receiver registration)
        self.barrier_source = barrier_source
        # name -> watermark column index | None (EOWC Sort planning)
        self.watermark_of = watermark_of or (lambda name: None)
        # host-path fragment parallelism (SET streaming_parallelism): >1
        # plans HashAgg as Dispatch -> k agg fragments -> Merge
        self.parallelism = 1

    def _make_hash_agg(self, input: Executor, group_indices: List[int],
                       calls: List[AggCall], gdtypes: List[DataType],
                       eowc: bool = False, wc: Optional[int] = None,
                       carry_cols: Optional[List[int]] = None
                       ) -> Executor:
        """Device-vs-host HashAgg dispatch. State-table allocation order is
        deterministic PER DISPATCH POLICY (host: one pickled-state table;
        device: payload table + one table per min/max input column), and the
        policy is recorded in the data directory and validated on reopen
        (Database._check_device_marker) — so DDL-log replay always re-runs
        under the policy that shaped the tables."""
        from ..ops.device_agg import (DeviceHashAggExecutor,
                                      device_agg_eligible,
                                      device_minput_count,
                                      device_payload_dtypes)
        # bottom-up append-only property (generic/agg.rs `input.append_only`):
        # derived from the executor tree, so it is deterministic for a given
        # DDL + dispatch policy and replays identically on recovery
        ao = bool(input.append_only)
        if self.device is not None and not eowc \
                and device_agg_eligible(calls, self.device.minmax, ao):
            st = self.make_state(gdtypes + device_payload_dtypes(calls, ao),
                                 list(range(len(group_indices))))
            # one (group..., encoded value, count) table per retractable
            # min/max call — pk covers group + value
            mts = [self.make_state(gdtypes + [T.INT64, T.INT64],
                                   list(range(len(group_indices) + 1)))
                   for _ in range(device_minput_count(calls, ao))]
            return DeviceHashAggExecutor(input, group_indices, calls,
                                         state_table=st, minput_tables=mts,
                                         mesh=self.device.mesh,
                                         capacity=self.device.capacity,
                                         append_only=ao,
                                         device=self.torch_device)
        if self.parallelism > 1 and group_indices and not eowc \
                and getattr(self, "placement", "local") == "process":
            # worker OS processes over the credit-flow exchange — real CPU
            # parallelism (stream_manager.rs:610 actor placement analog).
            # 2-phase: stateless partial agg in workers, stateful final agg
            # here (its state table makes recovery identical to the local
            # path; workers respawn with nothing to restore). Plans the
            # 2-phase rewrite can't express fall through to local topology.
            from ..runtime.remote_fragments import (RemoteFragmentSet,
                                                    serializable_agg)
            if serializable_agg(input, calls):
                # prune to the columns the fragment reads before anything
                # crosses the wire (exchange bytes + encode CPU are the
                # coordinator's budget)
                used = list(dict.fromkeys(
                    list(group_indices)
                    + [c.arg.index for c in calls if c.arg is not None]))
                prune = ProjectExecutor(
                    input, [InputRef(i, input.schema.fields[i].dtype)
                            for i in used],
                    [input.schema.fields[i].name for i in used])
                prune.append_only = input.append_only
                remap = {old: new for new, old in enumerate(used)}
                pruned_calls = [
                    AggCall(c.kind,
                            InputRef(remap[c.arg.index],
                                     c.arg.return_type)
                            if c.arg is not None else None)
                    for c in calls]
                rfs = RemoteFragmentSet(
                    prune, [remap[i] for i in group_indices], pruned_calls,
                    self.parallelism,
                    supervise=getattr(self, "supervise", False))
                merge = rfs.merge_executor()
                ng = len(group_indices)
                st = self.make_state(gdtypes + [T.BYTEA], list(range(ng)))
                return HashAggExecutor(merge, list(range(ng)),
                                       rfs.final_calls(), state_table=st)
            from ..runtime.remote_fragments import (make_remote_agg,
                                                    remotable_calls)
            if carry_cols and remotable_calls(calls):
                # retractable/owned-group placement: workers keep the
                # FULL stateful agg for their hash-owned groups; the
                # coordinator shadows the live input rows and re-seeds
                # respawned workers — agg state is a pure function of
                # the live input multiset. Shadow pk = the carried
                # stream-key columns (the unique row identity).
                dts = input.schema.dtypes
                shadow = self.make_state(dts, list(carry_cols))
                rfs = make_remote_agg(input, group_indices, calls,
                                      self.parallelism, shadow,
                                      supervise=getattr(self, "supervise",
                                                        False))
                return rfs.merge_executor()
        if self.parallelism > 1 and group_indices and not eowc:
            # Dispatch -> k parallel agg fragments -> Merge: the reference's
            # hash-exchange topology (`dispatch.rs:777` HashDataDispatcher,
            # `merge.rs:235` alignment) run inside one process. Group keys
            # hash to disjoint vnode blocks, so each fragment owns its
            # groups and the merged change stream equals the 1-fragment one.
            from ..ops import (Channel, ChannelSource, DispatchExecutor,
                               MergeExecutor)
            from ..ops.exchange import FragmentPump
            k = self.parallelism
            in_ch = [Channel(capacity=4096) for _ in range(k)]
            disp = DispatchExecutor(input, in_ch, kind="hash",
                                    key_indices=list(group_indices))
            out_ch = [Channel(capacity=4096) for _ in range(k)]
            pumps = []
            schema = None
            for i in range(k):
                st = self.make_state(gdtypes + [T.BYTEA],
                                     list(range(len(group_indices))))
                frag = HashAggExecutor(
                    ChannelSource(in_ch[i], input.schema, disp),
                    group_indices, calls, state_table=st)
                schema = frag.schema
                pumps.append(FragmentPump(frag, out_ch[i]))
            return MergeExecutor(out_ch, schema, pumps=pumps)
        st = self.make_state(gdtypes + [T.BYTEA],
                             list(range(len(group_indices))))
        return HashAggExecutor(input, group_indices, calls, state_table=st,
                               emit_on_window_close=eowc,
                               window_col_in_group=wc)

    # ---- FROM -----------------------------------------------------------
    def _plan_table(self, ref: A.TableRef) -> Tuple[Executor, Namespace]:
        if isinstance(ref, A.NamedTable):
            execu, schema, pk = self.subscribe(ref.name)
            ns = Namespace.of_schema(schema, ref.alias or ref.name, pk)
            ns.watermark_idx = self.watermark_of(ref.name)
            return execu, ns
        if isinstance(ref, A.SubqueryTable):
            execu, ns = self.plan_query(ref.query)
            alias = ref.alias
            return execu, Namespace(
                [ColumnEntry(alias, c.name, c.dtype) for c in ns.cols],
                list(ns.stream_key))
        if isinstance(ref, A.ChangelogTable):
            return self._plan_changelog(ref)
        if isinstance(ref, A.WindowTable):
            execu, ns = self._plan_table(ref.inner)
            ti = ns.resolve(ref.time_col)
            b = Binder(ns)
            ivals = [b.bind(a) for a in ref.args]
            assert all(isinstance(e, Literal) for e in ivals), \
                "window sizes must be INTERVAL literals"
            if ref.kind == "tumble":
                size = ivals[0].value
                hop = size
            else:
                hop, size = ivals[0].value, ivals[1].value
            execu = HopWindowExecutor(execu, ti, hop, size)
            alias = ref.alias
            cols = [ColumnEntry(alias or c.table, c.name, c.dtype)
                    for c in ns.cols]
            cols += [ColumnEntry(alias, "window_start", T.TIMESTAMP),
                     ColumnEntry(alias, "window_end", T.TIMESTAMP)]
            # each input row appears once per window: key = input key + win
            sk = list(ns.stream_key) + [len(cols) - 2]
            out = Namespace(cols, sk)
            out.watermark_idx = ns.watermark_idx
            return execu, out
        if isinstance(ref, A.TableFunctionTable):
            return self._plan_table_function(ref)
        if isinstance(ref, A.TemporalTable):
            raise ValueError("FOR SYSTEM_TIME AS OF PROCTIME() is only "
                             "valid as the right side of a join")
        if isinstance(ref, A.Join):
            return self._plan_join(ref)
        raise ValueError(f"cannot plan table ref {ref!r}")

    def _plan_table_function(self, ref: A.TableFunctionTable
                             ) -> Tuple[Executor, Namespace]:
        """FROM generate_series(...) / UNNEST(ARRAY[...]) — a bounded scan
        (`table_function/mod.rs:174`; batch `generate_series.rs`)."""
        from ..ops import TableFunctionScanExecutor
        if self.barrier_source is None:
            raise ValueError("table functions need a streaming context")
        tf = self._bind_table_function(ref.name, ref.args,
                                       Binder(Namespace([], [])))
        # PG: the alias of a single-column SRF names the COLUMN too
        # (SELECT g FROM generate_series(1,3) AS g)
        col = ref.alias or ref.name
        execu = TableFunctionScanExecutor(tf, col, self.barrier_source())
        cols = [ColumnEntry(col, col, tf.return_type),
                ColumnEntry(col, "_row_id", T.INT64)]
        return execu, Namespace(cols, [1], 1)

    def _bind_table_function(self, name: str, args: List[A.ExprNode],
                             b: "Binder"):
        from ..ops import BoundTableFunction
        from ..ops.project_set import series_return_type
        if name == "unnest":
            if len(args) != 1 or not isinstance(args[0], A.ArrayLit):
                raise ValueError("UNNEST supports ARRAY[...] literals only "
                                 "(array-typed columns are not supported)")
            elems = [b.bind(x) for x in args[0].items]
            if not elems:
                raise ValueError("UNNEST of an empty array")
            return BoundTableFunction("unnest", elems,
                                      elems[0].return_type)
        if not 2 <= len(args) <= 3:
            raise ValueError("generate_series(start, stop[, step])")
        bound = [b.bind(x) for x in args]
        rt = series_return_type([e.return_type for e in bound])
        if rt.kind == TypeKind.TIMESTAMP:
            # DATE bounds are day counts while the series runs in
            # TIMESTAMP microseconds — cast them up front, as the
            # reference does (`generate_series.rs` casts args to the
            # common timestamp type before evaluation). PG requires an
            # interval step for the timestamp form: without one, the
            # default step of 1 would mean one row per MICROSECOND.
            if len(bound) < 3:
                raise ValueError("generate_series over timestamps/dates "
                                 "requires an interval step")
            from ..expr.functions import cast as _cast
            bound = [_cast(e, T.TIMESTAMP)
                     if e.return_type.kind == TypeKind.DATE else e
                     for e in bound]
        return BoundTableFunction("generate_series", bound, rt)

    def _plan_changelog(self, ref: A.ChangelogTable
                        ) -> Tuple[Executor, Namespace]:
        """WITH x AS changelog FROM t (`changelog.rs` + the frontend's
        CteInner::ChangeLog lowering): upstream change stream ->
        append-only rows + `changelog_op` + hidden `_changelog_row_id`."""
        from ..ops import ChangelogExecutor, RowIdGenExecutor
        execu, schema, _pk = self.subscribe(ref.inner)
        chg = ChangelogExecutor(execu, op_name="changelog_op",
                                with_row_id=True)
        rid = len(chg.schema.fields) - 1
        execu = RowIdGenExecutor(chg, row_id_index=rid)
        alias = ref.alias or ref.inner
        cols = [ColumnEntry(alias, f.name, f.dtype)
                for f in chg.schema.fields]
        return execu, Namespace(cols, [rid])

    def _plan_join(self, ref: A.Join) -> Tuple[Executor, Namespace]:
        if isinstance(ref.right, A.TemporalTable):
            return self._plan_temporal_join(ref)
        if isinstance(ref.left, A.TemporalTable):
            raise ValueError("the version table (FOR SYSTEM_TIME) must be "
                             "the right side of a temporal join")
        lexec, lns = self._plan_table(ref.left)
        rexec, rns = self._plan_table(ref.right)
        ns = lns.concat(rns)
        conjuncts = _split_and(ref.on)
        if ref.kind in ("asof_inner", "asof_left"):
            return self._plan_asof_join(ref, lexec, lns, rexec, rns, ns,
                                        conjuncts)
        if ref.kind == "cross":
            # comma-join: steal equi conjuncts from the WHERE clause (the
            # reference's cross-join elimination / predicate-pushdown-into-
            # join rewrite, `optimizer/rule/` translate_apply + push rules);
            # `FROM a, b WHERE a.k = b.k` plans as an inner hash join
            stolen = []
            for c in list(self._pending_where):
                if _equi_pair(c, ns, len(lns.cols)) is not None:
                    stolen.append(c)
                    self._pending_where.remove(c)
            if not stolen:
                raise ValueError("cross join without equi-condition is not "
                                 "supported in streaming plans")
            conjuncts = stolen
            ref = A.Join(ref.left, ref.right, "inner", None)
        # split ON into equi-conjuncts and residual condition
        lkeys: List[int] = []
        rkeys: List[int] = []
        residual: List[A.ExprNode] = []
        nl = len(lns.cols)
        for c in conjuncts:
            pair = _equi_pair(c, ns, nl)
            if pair is not None:
                lkeys.append(pair[0])
                rkeys.append(pair[1] - nl)
            else:
                residual.append(c)
        if not lkeys:
            raise ValueError("join requires at least one equi-condition")
        cond = None
        if residual:
            node = residual[0]
            for r in residual[1:]:
                node = A.BinOp("and", node, r)
            cond = Binder(ns).bind(node)
        if self.delta_join and ref.kind == "inner" \
                and self.state_table_of is not None \
                and isinstance(ref.left, A.NamedTable) \
                and isinstance(ref.right, A.NamedTable):
            lookup = self._try_lookup_join(ref, lexec, rexec, lkeys, rkeys,
                                           cond)
            if lookup is not None:
                return lookup, ns
        ldtypes = [c.dtype for c in lns.cols]
        rdtypes = [c.dtype for c in rns.cols]
        # both dispatch paths share one state-table layout (row + degree,
        # pk = whole row), so the device policy doesn't reshape join state
        left_state = self.make_state(ldtypes + [T.INT64],
                                     list(range(len(ldtypes))))
        right_state = self.make_state(rdtypes + [T.INT64],
                                      list(range(len(rdtypes))))
        if self.device is not None and ref.kind == "inner":
            from ..ops.device_join import DeviceHashJoinExecutor
            execu: Executor = DeviceHashJoinExecutor(
                lexec, rexec, lkeys, rkeys, condition=cond,
                left_state=left_state, right_state=right_state,
                mesh=self.device.mesh, capacity=self.device.capacity,
                device=self.torch_device)
        elif self.parallelism > 1 \
                and getattr(self, "placement", "local") == "process" \
                and cond is None \
                and ref.kind in ("inner", "left", "right", "full"):
            # hash-partitioned join across worker OS processes: workers
            # own their key space and keep the full join state; the
            # coordinator shadows both sides and re-seeds respawned
            # workers (runtime/remote_fragments.py RemoteStatefulSet)
            from ..runtime.remote_fragments import make_remote_join
            rfs = make_remote_join(lexec, rexec, lkeys, rkeys,
                                   _JOIN_KIND[ref.kind],
                                   self.parallelism,
                                   left_state, right_state,
                                   supervise=getattr(self, "supervise",
                                                     False))
            return rfs.merge_executor(), ns
        else:
            execu = HashJoinExecutor(
                lexec, rexec, lkeys, rkeys, _JOIN_KIND[ref.kind],
                condition=cond,
                left_state=left_state, right_state=right_state)
        return execu, ns

    def _try_lookup_join(self, ref: A.Join, lexec, rexec, lkeys, rkeys,
                         cond) -> Optional[Executor]:
        """Arrangement-sharing lookup/delta join when both sides' join
        keys are pk prefixes of their state tables (the reference's
        delta-join rule requires exactly this index property,
        `stream_delta_join.rs`); None -> fall back to hash join."""
        from ..ops.lookup_join import LookupJoinExecutor
        lt = self.state_table_of(ref.left.name, lkeys)
        rt = self.state_table_of(ref.right.name, rkeys)
        if lt is None or rt is None:
            return None                 # keys not indexed -> hash join
        return LookupJoinExecutor(lexec, rexec, lkeys, rkeys, lt, rt,
                                  condition=cond)

    def _plan_asof_join(self, ref: A.Join, lexec, lns, rexec, rns, ns,
                        conjuncts) -> Tuple[Executor, Namespace]:
        """ASOF [LEFT] JOIN: equi keys + exactly ONE inequality conjunct
        (`stream_asof_join.rs` / `asof_join.rs` AsOfDesc)."""
        from ..ops.asof_join import AsOfJoinExecutor
        nl = len(lns.cols)
        lkeys: List[int] = []
        rkeys: List[int] = []
        ineq: Optional[Tuple[int, int, str]] = None   # (l, r, op as l-op-r)
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
        for c in conjuncts:
            pair = _equi_pair(c, ns, nl)
            if pair is not None:
                lkeys.append(pair[0])
                rkeys.append(pair[1] - nl)
                continue
            if isinstance(c, A.BinOp) and c.op in flip \
                    and isinstance(c.left, A.Col) \
                    and isinstance(c.right, A.Col):
                li = ns.resolve(c.left.name, c.left.table)
                ri = ns.resolve(c.right.name, c.right.table)
                op = c.op
                if ri < nl <= li:
                    li, ri, op = ri, li, flip[op]
                if li < nl <= ri:
                    if ineq is not None:
                        raise ValueError("ASOF JOIN requires exactly one "
                                         "inequality condition")
                    ineq = (li, ri - nl, op)
                    continue
            raise ValueError("unsupported ASOF JOIN condition (equi "
                             "conjuncts + one column inequality only)")
        if not lkeys:
            raise ValueError("ASOF JOIN requires at least one "
                             "equi-condition")
        if ineq is None:
            raise ValueError("ASOF JOIN requires an inequality condition")
        ldtypes = [c.dtype for c in lns.cols]
        rdtypes = [c.dtype for c in rns.cols]
        left_state = self.make_state(ldtypes, list(range(len(ldtypes))))
        right_state = self.make_state(rdtypes, list(range(len(rdtypes))))
        execu = AsOfJoinExecutor(
            lexec, rexec, lkeys, rkeys, ineq[0], ineq[1], ineq[2],
            left_outer=ref.kind == "asof_left",
            left_pk=lns.stream_key, right_pk=rns.stream_key,
            left_state=left_state, right_state=right_state)
        # exactly (left: =1 | inner: <=1) output row per left row: the
        # LEFT stream key alone identifies output rows
        out_ns = Namespace(ns.cols, list(lns.stream_key), None)
        return execu, out_ns

    def _plan_temporal_join(self, ref: A.Join) -> Tuple[Executor, Namespace]:
        """stream JOIN t FOR SYSTEM_TIME AS OF PROCTIME() ON ...
        (`temporal_join.rs:44`): right side is a version index that is
        looked up, not joined — output is append-only."""
        from ..ops import TemporalJoinExecutor
        if ref.kind not in ("inner", "left"):
            raise ValueError("temporal joins support INNER and LEFT only")
        tref: A.TemporalTable = ref.right
        lexec, lns = self._plan_table(ref.left)
        rexec, rschema, rpk = self.subscribe(tref.inner.name)
        alias = tref.alias or tref.inner.name
        rns = Namespace.of_schema(rschema, alias, rpk)
        ns = lns.concat(rns)
        lkeys: List[int] = []
        rkeys: List[int] = []
        residual: List[A.ExprNode] = []
        nl = len(lns.cols)
        for c in _split_and(ref.on):
            pair = _equi_pair(c, ns, nl)
            if pair is not None:
                lkeys.append(pair[0])
                rkeys.append(pair[1] - nl)
            else:
                residual.append(c)
        if not lkeys:
            raise ValueError("temporal join requires an equi-condition on "
                             "the version table")
        cond = None
        if residual:
            node = residual[0]
            for r in residual[1:]:
                node = A.BinOp("and", node, r)
            cond = Binder(ns).bind(node)
        rdtypes = [f.dtype for f in rschema.fields]
        right_state = self.make_state(rdtypes, list(rpk or
                                                    range(len(rdtypes))))
        execu = TemporalJoinExecutor(
            lexec, rexec, lkeys, rkeys, outer=ref.kind == "left",
            condition=cond, right_pk=rpk, right_state=right_state)
        # output identity comes from the left stream alone: right-side
        # changes never retract emitted rows, so left stream key + right pk
        # make output rows unique
        out = Namespace(ns.cols, list(lns.stream_key)
                        + [nl + i for i in (rpk or [])])
        out.watermark_idx = lns.watermark_idx
        return execu, out

    # ---- SELECT ---------------------------------------------------------
    def plan_query(self, q: A.Query) -> Tuple[Executor, Namespace]:
        if isinstance(q, A.SetOp):
            return self._plan_setop(q)
        return self.plan_select(q)

    def _plan_setop(self, q: A.SetOp) -> Tuple[Executor, Namespace]:
        """UNION [ALL] -> UnionExecutor (`union.rs`). Branch rows stay
        distinguishable via a hidden `_branch` discriminator appended to
        the stream key (the reference StreamUnion's hidden source column);
        UNION distinct dedups with a group-only HashAgg over the visible
        columns, like the reference's UNION -> Union + Agg rewrite."""
        from ..ops import UnionExecutor
        if getattr(q, "emit_on_window_close", False):
            raise ValueError("EMIT ON WINDOW CLOSE is not supported on "
                             "UNION queries")
        branches: List[Tuple[Executor, Namespace]] = []
        for part in (q.left, q.right):
            if isinstance(part, A.Select) and part.from_ is None:
                branches.append(self._plan_values(part))
            else:
                branches.append(self.plan_query(part))
        l_ns = branches[0][1]
        lv = l_ns.n_visible if l_ns.n_visible is not None else len(l_ns.cols)
        for _, ns in branches[1:]:
            v = ns.n_visible if ns.n_visible is not None else len(ns.cols)
            if v != lv:
                raise ValueError("each UNION query must have the same "
                                 "number of columns")
            for i in range(lv):
                if ns.cols[i].dtype != l_ns.cols[i].dtype:
                    raise ValueError(
                        f"UNION types {l_ns.cols[i].dtype} and "
                        f"{ns.cols[i].dtype} cannot be matched (column "
                        f"{l_ns.cols[i].name!r})")
        if not q.all:
            # visible columns only; the dedup agg restores set semantics
            parts = []
            for execu, ns in branches:
                exprs = [InputRef(i, ns.cols[i].dtype) for i in range(lv)]
                parts.append(ProjectExecutor(
                    execu, exprs, [c.name for c in ns.cols[:lv]]))
            union: Executor = UnionExecutor(parts)
            dts = [c.dtype for c in l_ns.cols[:lv]]
            union = self._make_hash_agg(union, list(range(lv)), [], dts)
            out = Namespace([ColumnEntry(None, c.name, c.dtype)
                             for c in l_ns.cols[:lv]], list(range(lv)), lv)
            return self._setop_limit(q, union, out)
        # UNION ALL: carry each branch's stream key + a branch literal; the
        # key layouts must agree or output rows lose identity. Append-only
        # branches whose key layout differs get a minted row-id identity
        # (retraction-free, so fresh ids are safe).
        sk_dtypes = [[ns.cols[i].dtype for i in ns.stream_key]
                     for _, ns in branches]
        if any(d != sk_dtypes[0] for d in sk_dtypes[1:]):
            from ..ops import RowIdGenExecutor
            target = next((d for (e, _), d in zip(branches, sk_dtypes)
                           if not e.append_only), [T.INT64])
            for bi, ((execu, ns), skd) in enumerate(zip(list(branches),
                                                        sk_dtypes)):
                if skd == target or not execu.append_only:
                    continue
                if len(target) != 1 or target[0] not in (T.INT64, T.SERIAL):
                    break
                idx = len(ns.cols)
                execu = RowIdGenExecutor(execu, row_id_index=idx)
                ns = Namespace(ns.cols + [ColumnEntry(None, "_uid",
                                                      target[0])],
                               [idx], ns.n_visible)
                branches[bi] = (execu, ns)
                sk_dtypes[bi] = target
        if any(d != sk_dtypes[0] for d in sk_dtypes[1:]):
            raise ValueError("UNION ALL branches derive incompatible "
                             "stream keys; add DISTINCT or align the "
                             "branch row identities")
        parts = []
        for bi, (execu, ns) in enumerate(branches):
            exprs = [InputRef(i, ns.cols[i].dtype) for i in range(lv)]
            names = [c.name for c in ns.cols[:lv]]
            for ki, si in enumerate(ns.stream_key):
                exprs.append(InputRef(si, ns.cols[si].dtype))
                names.append(f"_sk{ki}")
            exprs.append(Literal(bi, T.INT32))
            names.append("_branch")
            parts.append(ProjectExecutor(execu, exprs, names))
        union = UnionExecutor(parts)
        cols = [ColumnEntry(None, c.name, c.dtype) for c in l_ns.cols[:lv]]
        nsk = len(sk_dtypes[0])
        cols += [ColumnEntry(None, f"_sk{k}", d)
                 for k, d in enumerate(sk_dtypes[0])]
        cols.append(ColumnEntry(None, "_branch", T.INT32))
        out = Namespace(cols, list(range(lv, lv + nsk + 1)), lv)
        return self._setop_limit(q, union, out)

    def _setop_limit(self, q: A.SetOp, execu: Executor, ns: Namespace
                     ) -> Tuple[Executor, Namespace]:
        if getattr(q, "limit", None) is None:
            return execu, ns
        order = [(ns.resolve(_order_name(e, ns)), d)
                 for e, d in q.order_by] if q.order_by else []
        st = self.make_state([c.dtype for c in ns.cols],
                             list(range(len(ns.cols))))
        return TopNExecutor(execu, order, q.limit, q.offset or 0,
                            state_table=st), ns

    def _plan_values(self, q: A.Select) -> Tuple[Executor, Namespace]:
        """Constant SELECT (no FROM) inside a set operation -> a one-shot
        Values source (`values.rs`)."""
        if self.barrier_source is None:
            raise ValueError("SELECT without FROM is a batch-only statement")
        from ..core.schema import Field, Schema
        from ..ops import ValuesExecutor
        row, fields = [], []
        for it in q.items:
            dt = const_expr_type(it.expr)
            row.append(eval_const(it.expr, dt))
            fields.append(Field(it.alias or _default_name(it.expr), dt))
        schema = Schema(fields)
        execu = ValuesExecutor(schema, [tuple(row)], self.barrier_source())
        ns = Namespace([ColumnEntry(None, f.name, f.dtype) for f in fields],
                       [], len(fields))
        return execu, ns

    def plan_select(self, q: A.Select) -> Tuple[Executor, Namespace]:
        # logical rewrites (sql/optimizer.py) run once per tree; subquery
        # recursion below sees already-optimized nodes
        if not hasattr(q, "applied_rules"):
            from .optimizer import optimize
            stats = None
            if self.state_table_of is not None:
                def stats(name, _sto=self.state_table_of):
                    st = _sto(name)
                    return len(st) if st is not None else None
            optimize(q, stats=stats)
        if q.from_ is None:
            raise ValueError("SELECT without FROM is a batch-only statement")
        # WHERE conjuncts are visible to FROM planning so comma-joins can
        # steal their equi conditions (cross-join elimination)
        outer_pw = getattr(self, "_pending_where", [])
        self._pending_where = _split_and(q.where)
        execu, ns = self._plan_table(q.from_)
        conjs = self._pending_where
        self._pending_where = outer_pw

        if conjs:
            plain: List[A.ExprNode] = []
            for conj in conjs:
                if _contains_now(conj):
                    execu = self._plan_now_filter(execu, ns, conj)
                elif isinstance(conj, A.InSubquery):
                    execu = self._plan_in_subquery(execu, ns, conj)
                elif _subquery_cmp(conj) is not None:
                    execu = self._plan_subquery_filter(execu, ns, conj)
                else:
                    plain.append(conj)
            if plain:
                node = plain[0]
                for c in plain[1:]:
                    node = A.BinOp("and", node, c)
                execu = FilterExecutor(execu, Binder(ns).bind(node))

        # expand stars (hidden system/stream-key columns stay hidden,
        # like PG's ctid)
        items: List[A.SelectItem] = []
        for it in q.items:
            if isinstance(it.expr, A.Star):
                for i, c in enumerate(ns.cols):
                    if c.name.startswith("_"):
                        continue
                    if it.expr.table is None or c.table == it.expr.table:
                        items.append(A.SelectItem(A.Col(c.name, c.table),
                                                  c.name))
            else:
                items.append(it)

        has_aggs = bool(q.group_by) or any(_contains_agg(i.expr)
                                           for i in items) or \
            (q.having is not None and _contains_agg(q.having))

        if has_aggs:
            execu, ns, items = self._plan_agg(execu, ns, q, items)
        if q.having is not None and not has_aggs:
            execu = FilterExecutor(execu, Binder(ns).bind(q.having))

        # over-window functions
        if any(isinstance(i.expr, A.FuncCall) and i.expr.over is not None
               for i in items):
            execu, ns, items = self._plan_over_window(execu, ns, items)

        # set-returning functions in the SELECT list -> ProjectSet
        # (`project_set.rs`); it subsumes the final projection
        from ..ops.project_set import TABLE_FUNCTIONS
        if any(isinstance(i.expr, A.FuncCall)
               and i.expr.name.lower() in TABLE_FUNCTIONS
               and i.expr.over is None for i in items):
            if getattr(q, "emit_on_window_close", False):
                raise ValueError("EMIT ON WINDOW CLOSE with set-returning "
                                 "functions is not supported")
            execu, ns = self._plan_project_set(execu, ns, items)
            if q.distinct:
                raise ValueError("SELECT DISTINCT with set-returning "
                                 "functions is not supported")
            if q.limit is not None:
                order = [(ns.resolve(_order_name(e, ns)), d)
                         for e, d in q.order_by] if q.order_by else []
                st = self.make_state([c.dtype for c in ns.cols],
                                     list(range(len(ns.cols))))
                execu = TopNExecutor(execu, order, q.limit, q.offset or 0,
                                     state_table=st)
            return execu, ns

        # final projection; upstream stream-key columns ride along hidden
        # unless already selected, so the MV pk can preserve multiplicity
        # (StreamMaterialize pk derivation analog)
        b = Binder(ns)
        exprs = [b.bind(i.expr) for i in items]
        names = [i.alias or _default_name(i.expr) for i in items]
        n_visible = len(items)
        ns_watermark_idx = ns.watermark_idx
        out_sk: List[int] = []
        if q.distinct:
            out_sk = list(range(n_visible))   # output is set-like
        else:
            for ki, sk_idx in enumerate(ns.stream_key):
                pos = next((j for j, e in enumerate(exprs)
                            if isinstance(e, InputRef) and e.index == sk_idx),
                           None)
                if pos is None:
                    pos = len(exprs)
                    exprs.append(InputRef(sk_idx, ns.cols[sk_idx].dtype))
                    names.append(f"_sk{ki}")
                out_sk.append(pos)
        execu = ProjectExecutor(execu, exprs, names)
        ns = Namespace([ColumnEntry(None, n, e.return_type)
                        for n, e in zip(names, exprs)],
                       out_sk, n_visible)

        if q.distinct:
            if execu.append_only:
                # insert-only input: dedup needs no counts, only a seen-set
                # (`dedup/append_only_dedup.rs`)
                from ..ops import AppendOnlyDedupExecutor
                dts = [c.dtype for c in ns.cols]
                st = self.make_state(dts, list(range(len(dts))))
                execu = AppendOnlyDedupExecutor(
                    execu, list(range(len(ns.cols))), state_table=st)
            else:
                execu = self._make_hash_agg(execu,
                                            list(range(len(ns.cols))), [],
                                            [c.dtype for c in ns.cols])
            # schema unchanged: group keys only

        if getattr(q, "emit_on_window_close", False) and not has_aggs:
            # EOWC without aggregation: emit rows in event-time order once
            # the watermark passes (`sort.rs`); requires the watermark
            # column in the output
            tc = next((j for j, e in enumerate(exprs)
                       if isinstance(e, InputRef)
                       and e.index == ns_watermark_idx), None) \
                if ns_watermark_idx is not None else None
            if tc is None:
                raise ValueError(
                    "EMIT ON WINDOW CLOSE requires a watermarked time "
                    "column in the select list")
            from ..ops import SortExecutor
            st = self.make_state([c.dtype for c in ns.cols],
                                 list(ns.stream_key))
            execu = SortExecutor(execu, tc, state_table=st)

        if q.limit is not None:
            order = [(ns.resolve(_order_name(e, ns)), d)
                     for e, d in q.order_by] if q.order_by else []
            st = self.make_state([c.dtype for c in ns.cols],
                                 list(range(len(ns.cols))))
            execu = TopNExecutor(execu, order, q.limit, q.offset or 0,
                                 state_table=st)
        return execu, ns

    def _plan_project_set(self, execu: Executor, ns: Namespace,
                          items: List[A.SelectItem]
                          ) -> Tuple[Executor, Namespace]:
        """Lower the select list to ProjectSet items: scalar expressions
        plus bound table functions, with the upstream stream key carried
        hidden and `projected_row_id` completing the output identity."""
        from ..ops import ProjectSetExecutor
        from ..ops.project_set import TABLE_FUNCTIONS
        b = Binder(ns)
        ps_items: List[Tuple[str, Any]] = []
        names: List[str] = []
        for it in items:
            e = it.expr
            if isinstance(e, A.FuncCall) \
                    and e.name.lower() in TABLE_FUNCTIONS and e.over is None:
                tf = self._bind_table_function(e.name.lower(), e.args, b)
                ps_items.append(("tf", tf))
                names.append(it.alias or e.name.lower())
            else:
                be = b.bind(e)
                ps_items.append(("s", be))
                names.append(it.alias or _default_name(e))
        n_visible = len(ps_items)
        carry = list(ns.stream_key)
        execu = ProjectSetExecutor(execu, ps_items, names, carry=carry)
        cols = [ColumnEntry(None, f.name, f.dtype)
                for f in execu.schema.fields]
        sk = list(range(n_visible, len(cols)))
        # the upstream watermark column survives either as a selected
        # scalar InputRef or via the hidden carry columns — map it through
        # so downstream EOWC/watermark operators keep advancing
        wm_out = None
        if ns.watermark_idx is not None:
            wm_out = next((j for j, (k, it) in enumerate(ps_items)
                           if k == "s" and isinstance(it, InputRef)
                           and it.index == ns.watermark_idx), None)
            if wm_out is None and ns.watermark_idx in carry:
                wm_out = n_visible + carry.index(ns.watermark_idx)
        return execu, Namespace(cols, sk, n_visible, watermark_idx=wm_out)

    def _plan_now_filter(self, execu: Executor, ns: Namespace,
                         conj: A.ExprNode) -> Executor:
        """`col <cmp> f(now())` -> Now + DynamicFilter (`now.rs`,
        `dynamic_filter.rs`): the bound is a one-row stream advancing with
        the barrier clock; rows enter/leave the output as it moves."""
        from ..ops import DynamicFilterExecutor, NowExecutor
        if self.barrier_source is None:
            raise ValueError("NOW() requires a streaming context")
        if not (isinstance(conj, A.BinOp) and conj.op in (">", ">=", "<",
                                                          "<=")):
            raise ValueError("NOW() is only supported in temporal filter "
                             "comparisons (col > NOW() - interval)")
        flip = {">": "<", ">=": "<=", "<": ">", "<=": ">="}
        lhs, rhs, cmp = conj.left, conj.right, conj.op
        if _contains_now(lhs):
            lhs, rhs, cmp = rhs, lhs, flip[cmp]
        if not isinstance(lhs, A.Col) or _contains_now(lhs):
            raise ValueError("the non-NOW() side of a temporal filter must "
                             "be a plain column")
        key_col = ns.resolve(lhs.name, lhs.table)
        now_st = self.make_state([T.TIMESTAMP], [0])
        now_src = NowExecutor(self.barrier_source(), state_table=now_st)
        now_ns = Namespace([ColumnEntry(None, "now", T.TIMESTAMP)], [0])
        bound = Binder(now_ns).bind(_rewrite_now(rhs))
        rhs_exec = ProjectExecutor(now_src, [bound], ["bound"])
        dts = [c.dtype for c in ns.cols]
        df_st = self.make_state(dts + [T.INT64], list(range(len(dts))))
        return DynamicFilterExecutor(execu, rhs_exec, key_col, cmp,
                                     state_table=df_st)

    def _plan_in_subquery(self, execu: Executor, ns: Namespace,
                          conj: A.InSubquery) -> Executor:
        """col [NOT] IN (SELECT ...) -> left semi/anti hash join (the
        reference's subquery unnesting into StreamHashJoin, `hash_join.rs`
        LeftSemi/LeftAnti arms). NOTE: NULLs in the subquery follow join
        semantics, not PG's three-valued NOT IN (no NULL-producing
        subqueries in the supported workloads)."""
        if not isinstance(conj.operand, A.Col):
            raise ValueError("IN (SELECT ...) requires a plain column on "
                             "the left")
        li = ns.resolve(conj.operand.name, conj.operand.table)
        sub_exec, sub_ns = self.plan_query(conj.query)
        nvis = sub_ns.n_visible if sub_ns.n_visible is not None \
            else len(sub_ns.cols)
        if nvis != 1:
            raise ValueError("IN subquery must select exactly one column")
        ldtypes = [c.dtype for c in ns.cols]
        rdtypes = [c.dtype for c in sub_ns.cols]
        left_state = self.make_state(ldtypes + [T.INT64],
                                     list(range(len(ldtypes))))
        right_state = self.make_state(rdtypes + [T.INT64],
                                      list(range(len(rdtypes))))
        jt = JoinType.LEFT_ANTI if conj.negated else JoinType.LEFT_SEMI
        return HashJoinExecutor(execu, sub_exec, [li], [0], jt,
                                left_state=left_state,
                                right_state=right_state)

    def _plan_subquery_filter(self, execu: Executor, ns: Namespace,
                              conj: A.ExprNode) -> Executor:
        """col CMP (SELECT scalar) -> DynamicFilter with the one-row
        subquery stream as the moving bound (`dynamic_filter.rs`; the
        reference unnests uncorrelated scalar subqueries the same way)."""
        lhs, rhs, cmp = _subquery_cmp(conj)
        if not isinstance(lhs, A.Col):
            raise ValueError("the non-subquery side of the comparison must "
                             "be a plain column")
        key_col = ns.resolve(lhs.name, lhs.table)
        sub_exec, sub_ns = self.plan_query(rhs.query)
        nvis = sub_ns.n_visible if sub_ns.n_visible is not None \
            else len(sub_ns.cols)
        if nvis != 1:
            raise ValueError("scalar subquery must select exactly one "
                             "column")
        sub_exec = ProjectExecutor(
            sub_exec, [InputRef(0, sub_ns.cols[0].dtype)], ["bound"])
        dts = [c.dtype for c in ns.cols]
        df_st = self.make_state(dts + [T.INT64], list(range(len(dts))))
        from ..ops import DynamicFilterExecutor
        return DynamicFilterExecutor(execu, sub_exec, key_col, cmp,
                                     state_table=df_st)

    def _plan_agg(self, execu: Executor, ns: Namespace, q: A.Select,
                  items: List[A.SelectItem]
                  ) -> Tuple[Executor, Namespace, List[A.SelectItem]]:
        b = Binder(ns)
        group_exprs = [b.bind(g) for g in q.group_by]

        aggs: List[A.FuncCall] = []
        for it in items:
            _find_aggs(it.expr, aggs)
        if q.having is not None:
            _find_aggs(q.having, aggs)

        # pre-projection: group keys then agg args
        pre_exprs: List[Expr] = list(group_exprs)
        pre_names = [f"g{i}" for i in range(len(group_exprs))]
        calls: List[AggCall] = []
        for i, a in enumerate(aggs):
            direct: Tuple = ()
            if a.name == "approx_percentile":
                # ordered-set: approx_percentile(q[, rel_err]) WITHIN
                # GROUP (ORDER BY v) — direct args must be literals
                # (`binder/expr/function/aggregate.rs:183`)
                if a.within_group is None or not 1 <= len(a.args) <= 2:
                    raise ValueError(
                        "approx_percentile(quantile[, relative_error]) "
                        "WITHIN GROUP (ORDER BY col)")
                dvals = []
                for x in a.args:
                    lit = b.bind(x)
                    if not isinstance(lit, Literal) or lit.value is None:
                        raise ValueError("approx_percentile direct "
                                         "arguments must be constants")
                    dvals.append(float(lit.value))
                direct = tuple(dvals)
                a = A.FuncCall(a.name, [a.within_group], a.distinct,
                               a.over, a.filter)
            if a.args:
                arg = b.bind(a.args[0])
                idx = len(pre_exprs)
                pre_exprs.append(arg)
                pre_names.append(f"a{i}")
                call_arg = InputRef(idx, arg.return_type)
            else:
                call_arg = None
            filt_ref = None
            if a.filter is not None:
                fe = b.bind(a.filter)
                fi = len(pre_exprs)
                pre_exprs.append(fe)
                pre_names.append(f"f{i}")
                filt_ref = InputRef(fi, T.BOOLEAN)
            calls.append(AggCall(a.name, call_arg, distinct=a.distinct,
                                 filter=filt_ref, direct_args=direct))
        if not pre_exprs:
            # count(*)-only: chunks must keep their cardinality, and a
            # zero-column chunk cannot (`DataChunk` derives capacity from
            # its columns) — project a constant
            pre_exprs = [Literal(1, T.INT32)]
            pre_names = ["_one"]
        # under process placement, carry the upstream stream key through
        # the pre-agg projection: remote stateful agg fragments need a
        # unique row identity for the coordinator's input shadow
        carry_cols: Optional[List[int]] = None
        if getattr(self, "placement", "local") == "process" \
                and self.parallelism > 1 and group_exprs \
                and not getattr(q, "emit_on_window_close", False) \
                and ns.stream_key:
            carry_cols = []
            for sk in ns.stream_key:
                carry_cols.append(len(pre_exprs))
                pre_exprs.append(InputRef(sk, ns.cols[sk].dtype))
                pre_names.append(f"_rk{sk}")
        proj = ProjectExecutor(execu, pre_exprs, pre_names)
        eowc = getattr(q, "emit_on_window_close", False)
        wc = None
        if eowc:
            wc = _find_window_col(q.group_by)
        if group_exprs:
            gdtypes = [e.return_type for e in group_exprs]
            agg: Executor = self._make_hash_agg(
                proj, list(range(len(group_exprs))), calls, gdtypes,
                eowc=eowc, wc=wc, carry_cols=carry_cols)
        else:
            st = self.make_state([T.INT64, T.BYTEA], [0])
            agg = SimpleAggExecutor(proj, calls, state_table=st)

        # post-agg namespace: group cols (resolvable by original AST) + aggs
        post_cols = []
        for i, g in enumerate(q.group_by):
            name = _default_name(g)
            post_cols.append(ColumnEntry(_table_of(g), name,
                                         group_exprs[i].return_type))
        for i, (a, c) in enumerate(zip(aggs, calls)):
            post_cols.append(ColumnEntry(None, f"agg#{i}", c.return_type))
        # the group key IS the stream key after aggregation (empty for the
        # single-row SimpleAgg output)
        post_ns = Namespace(post_cols, list(range(len(group_exprs))))

        # rewrite items/having: replace agg calls with agg#i refs, group
        # exprs with their post-agg columns
        def rewrite(node: A.ExprNode) -> A.ExprNode:
            for i, g in enumerate(q.group_by):
                if node == g:
                    c = post_cols[i]
                    return A.Col(c.name, c.table)
            if isinstance(node, A.FuncCall) and node.over is None and \
                    node.name in AGG_KINDS:
                idx = next(i for i, a in enumerate(aggs) if a is node)
                return A.Col(f"agg#{idx}")
            clone = _clone_with(node, rewrite)
            return clone

        new_items = [A.SelectItem(rewrite(i.expr), i.alias) for i in items]
        out: Executor = agg
        if q.having is not None:
            plain: List[A.ExprNode] = []
            for conj in _split_and(q.having):
                conj = rewrite(conj)
                if _subquery_cmp(conj) is not None:
                    out = self._plan_subquery_filter(out, post_ns, conj)
                else:
                    plain.append(conj)
            if plain:
                node = plain[0]
                for c in plain[1:]:
                    node = A.BinOp("and", node, c)
                out = FilterExecutor(out, Binder(post_ns).bind(node))
        return out, post_ns, new_items

    def _frame_offset(self, bound: Tuple, b: "Binder", is_start: bool,
                      order_kind=None) -> Optional[int]:
        """Frame bound -> signed offset (None = unbounded, 0 = current).
        PRECEDING is negative, FOLLOWING positive. Interval offsets scale
        to the ORDER BY column's unit: microseconds for TIMESTAMP, days
        for DATE (whose runtime values are day counts)."""
        if bound[0] == "unbounded":
            # PG: frame start cannot be UNBOUNDED FOLLOWING, frame end
            # cannot be UNBOUNDED PRECEDING
            if is_start and bound[1] == "following":
                raise ValueError("frame start cannot be UNBOUNDED "
                                 "FOLLOWING")
            if not is_start and bound[1] == "preceding":
                raise ValueError("frame end cannot be UNBOUNDED PRECEDING")
            return None
        if bound[0] == "current":
            return 0
        e = b.bind(bound[1])
        if not isinstance(e, Literal) or e.value is None:
            raise ValueError("frame offsets must be constants")
        v = e.value
        if isinstance(v, Interval):
            if v.months:
                raise ValueError("month intervals are not valid frame "
                                 "offsets")
            if order_kind == TypeKind.DATE:
                if v.usecs:
                    raise ValueError("sub-day interval frame offsets are "
                                     "not valid over a DATE order column")
                v = v.days
            else:
                v = v.days * 86_400_000_000 + v.usecs
        if order_kind is None or isinstance(v, int):
            # ROWS offsets are row counts — integers only (PG errors on
            # fractional ROWS offsets rather than truncating)
            if float(v) != int(v):
                raise ValueError("ROWS frame offsets must be integers")
            v = int(v)
        else:
            v = float(v) if not isinstance(v, (int, float)) else v
        return -v if bound[0] == "preceding" else v

    def _plan_over_window(self, execu: Executor, ns: Namespace,
                          items: List[A.SelectItem]):
        specs = [i for i in items
                 if isinstance(i.expr, A.FuncCall) and i.expr.over is not None]
        first = specs[0].expr.over
        for s in specs[1:]:
            o = s.expr.over
            # frames are per-CALL (the executor computes each call's
            # frame independently); only partition/order must agree
            if o.partition_by != first.partition_by \
                    or o.order_by != first.order_by:
                raise ValueError("multiple distinct OVER() "
                                 "partition/order specs unsupported")
        b = Binder(ns)
        partition = [_as_input_ref(b.bind(p)) for p in first.partition_by]
        order = [(_as_input_ref(b.bind(e)), d) for e, d in first.order_by]
        def bind_frame(spec):
            """Per-CALL frame: each OVER() clause carries its own."""
            frame, mode = (None, 0), "rows"
            if spec.frame is not None:
                mode = spec.frame[0]
                ok = None
                if mode == "range" and order:
                    ok = ns.cols[order[0][0]].dtype.kind
                    has_offset = any(
                        bd[0] in ("preceding", "following")
                        for bd in (spec.frame[1], spec.frame[2]))
                    if has_offset and ok not in (
                            TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
                            TypeKind.FLOAT32, TypeKind.FLOAT64,
                            TypeKind.DECIMAL, TypeKind.TIMESTAMP,
                            TypeKind.TIMESTAMPTZ, TypeKind.DATE,
                            TypeKind.TIME):
                        # PG rejects offset RANGE frames over non-
                        # orderable-by-offset columns at plan time
                        raise ValueError(
                            "RANGE with offset requires a numeric or "
                            "datetime ORDER BY column")
                frame = (self._frame_offset(spec.frame[1], b, True, ok),
                         self._frame_offset(spec.frame[2], b, False, ok))
                if frame[0] is not None and frame[1] is not None \
                        and frame[0] > frame[1]:
                    raise ValueError("frame start cannot be past frame "
                                     "end")
            return frame, mode
        calls = []
        for s in specs:
            f: A.FuncCall = s.expr
            if f.filter is not None:
                raise ValueError("FILTER on window functions is not "
                                 "supported")
            arg = b.bind(f.args[0]) if f.args else None
            if f.name in ("sum", "count", "min", "max", "avg",
                          "first_value", "last_value"):
                frame, mode = bind_frame(f.over)
                calls.append(WindowFuncCall(f.name, arg, frame=frame,
                                            frame_mode=mode))
            else:
                # rank family / lag / lead ignore the frame clause (PG)
                offset = 1
                if f.name in ("lag", "lead") and len(f.args) > 2:
                    raise ValueError(
                        f"{f.name} default-value argument (3-arg form) "
                        "is not supported")
                if f.name in ("lag", "lead") and len(f.args) > 1:
                    # the offset argument must be a plan-time constant
                    # (PG allows expressions; this runtime's incremental
                    # affected-range computation needs a fixed offset)
                    try:
                        off = eval_const(f.args[1], T.INT64)
                    except Exception:
                        raise ValueError(
                            f"{f.name} offset must be a constant "
                            "integer") from None
                    if off is None or int(off) < 0:
                        raise ValueError(
                            f"{f.name} offset must be a non-negative "
                            f"constant, got {off!r}")
                    offset = int(off)
                calls.append(WindowFuncCall(f.name, arg, offset=offset))
        st = self.make_state([c.dtype for c in ns.cols],
                             list(range(len(ns.cols))))
        execu = OverWindowExecutor(execu, partition, order, calls,
                                   state_table=st)
        cols = list(ns.cols)
        new_items = []
        wi = 0
        for it in items:
            if isinstance(it.expr, A.FuncCall) and it.expr.over is not None:
                name = f"w#{wi}"
                cols.append(ColumnEntry(None, name, calls[wi].return_type))
                new_items.append(A.SelectItem(A.Col(name), it.alias))
                wi += 1
            else:
                new_items.append(it)
        return execu, Namespace(cols, list(ns.stream_key)), new_items


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def eval_const(e: A.ExprNode, dtype: Optional[DataType] = None):
    """Evaluate a constant expression (no column refs) to a Python value."""
    from ..core.chunk import Op, StreamChunk
    b = Binder(Namespace([]))
    expr = b.bind(e)
    chunk = StreamChunk.from_rows([T.INT64], [(Op.INSERT, (0,))])
    col = expr.eval(chunk)
    v = col.get(0)
    if dtype is not None and v is not None:
        from ..expr import cast as _cast
        lit = Literal(v, expr.return_type)
        v = _cast(lit, dtype).eval(chunk).get(0)
    return v


def const_expr_type(e: A.ExprNode) -> DataType:
    return Binder(Namespace([])).bind(e).return_type


def _subquery_cmp(node: A.ExprNode):
    """(lhs, SubqueryExpr, cmp) when `node` is a comparison with a scalar
    subquery on exactly one side (cmp flipped if it's the left)."""
    if not (isinstance(node, A.BinOp)
            and node.op in (">", ">=", "<", "<=", "=")):
        return None
    flip = {">": "<", ">=": "<=", "<": ">", "<=": ">=", "=": "="}
    if isinstance(node.right, A.SubqueryExpr) \
            and not isinstance(node.left, A.SubqueryExpr):
        return (node.left, node.right, node.op)
    if isinstance(node.left, A.SubqueryExpr) \
            and not isinstance(node.right, A.SubqueryExpr):
        return (node.right, node.left, flip[node.op])
    return None


def _contains_now(node: A.ExprNode) -> bool:
    if isinstance(node, A.FuncCall) and node.name == "now" and not node.args:
        return True
    return any(_contains_now(c) for c in _children(node))


def _rewrite_now(node: A.ExprNode) -> A.ExprNode:
    """now() -> the Now stream's single column."""
    if isinstance(node, A.FuncCall) and node.name == "now" and not node.args:
        return A.Col("now")
    return _clone_with(node, _rewrite_now)


def _split_and(node: Optional[A.ExprNode]) -> List[A.ExprNode]:
    if node is None:
        return []
    if isinstance(node, A.BinOp) and node.op == "and":
        return _split_and(node.left) + _split_and(node.right)
    return [node]


def _equi_pair(node: A.ExprNode, ns: Namespace, nl: int
               ) -> Optional[Tuple[int, int]]:
    if not (isinstance(node, A.BinOp) and node.op == "="):
        return None
    if not (isinstance(node.left, A.Col) and isinstance(node.right, A.Col)):
        return None
    try:
        li = ns.resolve(node.left.name, node.left.table)
        ri = ns.resolve(node.right.name, node.right.table)
    except ValueError:
        return None
    if li < nl <= ri:
        return (li, ri)
    if ri < nl <= li:
        return (ri, li)
    return None


def _as_input_ref(e: Expr) -> int:
    if not isinstance(e, InputRef):
        raise ValueError("PARTITION BY / ORDER BY must be plain columns")
    return e.index


def _order_name(e: A.ExprNode, ns: Namespace) -> str:
    if isinstance(e, A.Col):
        return e.name
    raise ValueError("ORDER BY in MV must reference output columns")


def _default_name(e: A.ExprNode) -> str:
    if isinstance(e, A.Col):
        return e.name
    if isinstance(e, A.FuncCall):
        return e.name
    if isinstance(e, A.ExtractExpr):
        return "extract"
    if isinstance(e, A.CaseExpr):
        return "case"
    if isinstance(e, A.CastExpr):
        return _default_name(e.operand)
    return "?column?"


def _table_of(e: A.ExprNode) -> Optional[str]:
    return e.table if isinstance(e, A.Col) else None


def _find_window_col(group_by: List[A.ExprNode]) -> Optional[int]:
    for i, g in enumerate(group_by):
        if isinstance(g, A.Col) and g.name in ("window_start", "window_end"):
            return i
    raise ValueError("EMIT ON WINDOW CLOSE requires window_start/window_end "
                     "in GROUP BY")


def _clone_with(node: A.ExprNode, f) -> A.ExprNode:
    if isinstance(node, A.BinOp):
        return A.BinOp(node.op, f(node.left), f(node.right))
    if isinstance(node, A.UnaryOp):
        return A.UnaryOp(node.op, f(node.operand))
    if isinstance(node, A.FuncCall):
        return A.FuncCall(node.name, [f(a) for a in node.args],
                          node.distinct, node.over, node.filter,
                          within_group=node.within_group)
    if isinstance(node, A.CaseExpr):
        return A.CaseExpr(f(node.operand) if node.operand else None,
                          [(f(c), f(r)) for c, r in node.branches],
                          f(node.else_expr) if node.else_expr else None)
    if isinstance(node, A.CastExpr):
        return A.CastExpr(f(node.operand), node.type_name)
    if isinstance(node, A.ExtractExpr):
        return A.ExtractExpr(node.field, f(node.operand))
    if isinstance(node, A.IsNullExpr):
        return A.IsNullExpr(f(node.operand), node.negated)
    if isinstance(node, A.Between):
        return A.Between(f(node.operand), f(node.low), f(node.high),
                         node.negated)
    if isinstance(node, A.InList):
        return A.InList(f(node.operand), [f(i) for i in node.items],
                        node.negated)
    if isinstance(node, A.Index):
        return A.Index(f(node.operand), node.index)
    if isinstance(node, A.InSubquery):
        return A.InSubquery(f(node.operand), node.query, node.negated)
    return node
