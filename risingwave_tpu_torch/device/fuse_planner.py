"""Fuse planner: recognize an eligible executor tree and lower it to a
FusedProgram (`device/fused.py`); the port's own copy of
`risingwave_tpu/device/fuse_planner.py`.

This is the dispatch seam one level up from `ops/device_agg.py`: instead
of swapping ONE executor onto the device, an entire MV fragment —
source (nexmark) -> project/filter/hop -> agg/join -> materialize —
becomes one epoch program over device-resident state. Recognition is
conservative: anything outside the proven shape (nullable flows,
expressions without a device half, unpackable keys, outer joins,
DISTINCT / filtered aggregates) returns None and the per-operator path
runs unchanged.

Static analysis carried per stream column: SQL dtype, surrogate decoder
(strings ride as injective int64 surrogates; only projection / group-by /
equi-join use is allowed), and (lo, hi, stride) integer range — the proof
obligations for lossless key packing, re-verified on device at runtime.

Besides `try_fuse`, the steps it runs after the walk are helpers of their
own, which hand-built jobs call too:

* `arm_telemetry`: the key-skew and flow telemetry and the state-tiering
  recency arm on every keyed node, in that order (the stat layout);
* `arm_exchange`: under a mesh, every node whose shard spec names
  exchange inputs gets its `[n, exch]` send bucket, sized from the epoch
  cadence (`capacity.exchange_cap`), with `_exchange_row_width` for the
  budget math;
* the host-ingest wiring: `to_ingest` (every source becomes an
  `IngestNode`), `prune_ingest_columns` (only the columns some node reads
  ship), `host_ingest` (the job's `HostIngest`) and `tier_plans` (one
  `TierPlan` per keyed node, with promotion recipes where its key lineage
  reaches the ingest);
* `_TsShift`: `ts +/- INTERVAL const`, which the planner rewrites from
  `ts_*_interval` calls because the host registers those without a
  device half (Nexmark q7's `date_time BETWEEN window_end - INTERVAL '10'
  SECOND AND window_end`); it lowers to an add of a constant in the
  `expr_eval` kernel.

The reference's ahead-of-time compile service has no counterpart: the
port's kernels are built once per process, and nothing is traced per
node shape.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import dtypes as T
from ..core.dtypes import DataType, TypeKind
from ..expr.expression import Expr, FunctionCall, InputRef, Literal, lower_as

NUM = ("num",)
TS = ("ts",)
_HORIZON = 1 << 33          # event horizon assumed for unbounded sources
# fused epoch cadence = source events_per_poll * EPOCH_POLLS (the
# SourceExecutor poll budget per barrier); module-level so tests can pin
# a cadence that does NOT divide the shard count (tail-padding coverage)
EPOCH_POLLS = 64


class FuseReject(Exception):
    """Plan shape outside the fused subset — fall back silently."""


@dataclass
class Meta:
    """Walker-side static description of one node's output delta."""
    idx: int                              # node index in the program
    dtypes: List[DataType]
    decoders: List[Tuple]
    ranges: List[Optional[Tuple[int, int, int]]]
    rows_bound: int
    append_only: bool
    agg: Any = None                       # set when this delta IS an agg's
    is_pair: bool = False                 # carries (pk, pk2) pair identity


def _devify(e: Expr) -> Expr:
    """Rewrite for device evaluability (constant interval arithmetic);
    raises FuseReject when the expression has no device path."""
    if isinstance(e, FunctionCall) and e.name.startswith("ts_") \
            and e.name.endswith("_interval"):
        iv = e.args[1]
        if isinstance(iv, Literal) and getattr(iv.value, "months", 1) == 0:
            us = iv.value.days * 86_400_000_000 + iv.value.usecs
            return _TsShift(_devify(e.args[0]),
                            us if "add" in e.name else -us)
        raise FuseReject(f"non-constant interval in {e.name}")
    if isinstance(e, FunctionCall):
        e = FunctionCall(e.name, [_devify(a) for a in e.args],
                         e.return_type, e.sig)
    if isinstance(e, InputRef):
        # verbatim column refs are always device-safe here: variable-width
        # columns ride as int64 surrogates, and _surrogate_safe forbids
        # computing over them
        return e
    if not e.supports_device():
        raise FuseReject(f"no device path for {e!r}")
    return e


def _surrogate_safe(e: Expr, decoders: Sequence[Tuple]) -> None:
    """Surrogate columns may only be projected verbatim (or used as keys,
    which the caller handles) — any computation on them would act on pool
    indices, not strings."""
    if isinstance(e, InputRef):
        return                      # verbatim projection is fine
    stack = list(e.children() if hasattr(e, "children") else [])
    while stack:
        c = stack.pop()
        if isinstance(c, InputRef) and decoders[c.index] not in (NUM, TS):
            raise FuseReject("computation over a string surrogate column")
        stack.extend(c.children() if hasattr(c, "children") else [])


def _range_of(e: Expr, ranges) -> Optional[Tuple[int, int, int]]:
    """Interval analysis for packing proofs. None = unbounded/unknown."""
    if isinstance(e, InputRef):
        return ranges[e.index]
    if isinstance(e, Literal):
        if isinstance(e.value, (int, np.integer)) \
                and not isinstance(e.value, bool):
            v = int(e.value)
            return (v, v, max(1, abs(v)))
        return None
    if isinstance(e, _TsShift):
        r = _range_of(e.arg, ranges)
        if r is None:
            return None
        return (r[0] + e.delta, r[1] + e.delta,
                math.gcd(r[2], abs(e.delta)) or 1)
    if isinstance(e, FunctionCall) and e.name in ("add", "subtract") \
            and len(e.args) == 2:
        a = _range_of(e.args[0], ranges)
        b = _range_of(e.args[1], ranges)
        if a is None or b is None:
            return None
        if e.name == "add":
            lo, hi = a[0] + b[0], a[1] + b[1]
        else:
            lo, hi = a[0] - b[1], a[1] - b[0]
        return (lo, hi, math.gcd(a[2], b[2]) or 1)
    if isinstance(e, FunctionCall) and e.return_type.kind == TypeKind.BOOLEAN:
        return (0, 1, 1)
    return None


def _env_bool(name: str, default: bool) -> bool:
    """RW_* operational overrides of the DeviceConfig knobs (the same
    variable names as the reference's: RW_SKEW_STATS, RW_FLOW_STATS,
    RW_AGG_PRECOMBINE, RW_STATE_TIERING, RW_HOST_INGEST, RW_HOT_KEY_REP,
    RW_VNODE_REBALANCE): force on or off without code changes."""
    import os as _os
    v = _os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "off")


def arm_telemetry(nodes: Sequence, skew: bool = True, flow: bool = True,
                  tier: bool = True) -> None:
    """Arm skew (occupancy + heavy hitters) and flow (traffic) telemetry
    and the tiering recency column on every keyed node, before the
    FusedProgram is built: the slots extend the stat layout in that
    order, skew's, flow's, then tiering's. Un-keyed nodes ignore it."""
    for node in nodes:
        if skew:
            node.enable_skew()
        if flow:
            node.enable_flow()
        if tier:
            node.enable_tiering()


def arm_exchange(nodes: Sequence, mesh, epoch_events: int) -> None:
    """Arm the exchange stage of every node whose shard spec names
    exchange inputs (aggs route on the group key, joins on both join
    keys): its per-(source, destination) bucket starts at
    `exchange_cap(epoch_events, n)`, and an overflow rides the "exch" stat
    into grow + replay. After `arm_telemetry` (the "exch" slot stays last
    in the stat layout) and before the FusedProgram is built."""
    from ..parallel.mesh import data_shards
    from .capacity import exchange_cap
    n = data_shards(mesh)
    cap0 = exchange_cap(epoch_events, n)
    for node in nodes:
        if node.shard_spec().exchanges:
            node.enable_exchange(cap0,
                                 slot_bytes=8 * n * _exchange_row_width(node))


def _exchange_row_width(node) -> int:
    """Arrays one exchanged row buffers (`shard_exec._exchange_local`: the
    declared ref columns — or every input column when undeclared — plus
    sign, plus pk when carried), worst case across the node's exchange
    stages. Budget math only."""
    from .fused import AggNode, JoinNode
    widths = []
    for ex in node.shard_spec().exchanges:
        if ex.ref_idx is not None:
            w = len(ex.ref_idx)
        elif isinstance(node, JoinNode):
            # a join side's input delta carries exactly its val columns
            w = (len(node.l_val_dtypes), len(node.r_val_dtypes))[ex.input]
        elif isinstance(node, AggNode) and node.combined:
            # pre-combined delta: packed key + raw-row count + one partial
            # delta per payload column
            w = 2 + len(node.spec.kinds)
        else:
            w = 3
        widths.append(w + 1 + (1 if ex.carry_pk else 0))
    return max(widths, default=4)


def to_ingest(nodes: List) -> List[int]:
    """Replace every SourceNode of a (pre-chain) node list by the
    IngestNode of the same table and columns: the host-fed job. All of a
    job's sources share one event clock, so one host-fed source makes
    them all host-fed. Returns the ingest node indices."""
    from .fused import IngestNode, SourceNode
    out = []
    for i, n in enumerate(nodes):
        if isinstance(n, SourceNode):
            nodes[i] = IngestNode(n.table, n.gencfg, n.col_names,
                                  n.rowid_pos, n.max_events, n.dtypes,
                                  device=n.device)
        if isinstance(nodes[i], IngestNode):
            out.append(i)
    return out


def _expr_col_refs(e: Expr) -> set:
    """Every InputRef index an expression tree reads."""
    out = set()
    stack = [e]
    while stack:
        c = stack.pop()
        if isinstance(c, InputRef):
            out.add(c.index)
        stack.extend(c.children() if hasattr(c, "children") else [])
    return out


def prune_ingest_columns(nodes: Sequence) -> None:
    """Feed-column liveness: only the IngestNode columns some downstream
    node can read ship to the card (`IngestNode.set_live`). Conservative:
    a consumer it cannot reason about (a join, a pair MV) keeps the whole
    schema live. Runs on the pre-chain node list, before the program is
    built."""
    from .fused import (AggNode, FilterNode, HopNode, IngestNode, MapNode,
                        PrecombineNode)
    consumers: Dict[int, List[int]] = {i: [] for i in range(len(nodes))}
    for j, nd in enumerate(nodes):
        for i in nd.inputs:
            consumers[i].append(j)
    memo: Dict[int, Optional[set]] = {}

    def need(i: int, arity: int) -> Optional[set]:
        """Live output-column set of node i (None = all)."""
        if i in memo:
            return memo[i]
        memo[i] = None
        out: set = set()
        for j in consumers[i]:
            c = nodes[j]
            if isinstance(c, MapNode):
                r: Optional[set] = set()
                for e in c.exprs:
                    r |= _expr_col_refs(e)
            elif isinstance(c, FilterNode):
                down = need(j, arity)
                r = None if down is None \
                    else _expr_col_refs(c.pred) | down
            elif isinstance(c, HopNode):
                down = need(j, arity + 2)
                r = None if down is None \
                    else {c.time_col} | {x for x in down if x < arity}
            elif isinstance(c, (AggNode, PrecombineNode)):
                r = set(c.group_idx)
                for call in c.calls:
                    if call.arg is not None:
                        r.add(call.arg)
            else:
                r = None
            if r is None:
                memo[i] = None
                return None
            out |= r
        memo[i] = out
        return out

    for idx, node in enumerate(nodes):
        if isinstance(node, IngestNode):
            live = need(idx, len(node.col_names))
            if live is not None:
                node.set_live(live)


def host_ingest(program, max_events: Optional[int],
                names: Optional[Dict[int, str]] = None):
    """The job's HostIngest: one multiplexed event clock over the
    program's IngestNodes (in node order), feeds keyed by post-chain
    node index (per shard under the program's mesh); None when the
    program has none. `names` gives a node's
    source its catalog name (default: its table's)."""
    from .fused import IngestNode
    from .ingest import HostIngest, NexmarkIngestSource
    names = names or {}
    srcs = [(i, NexmarkIngestSource(names.get(i, n.table), n.table,
                                    n.gencfg, n.col_names, n.rowid_pos,
                                    n.max_events, live=n.live))
            for i, n in enumerate(program.nodes) if isinstance(n, IngestNode)]
    if not srcs:
        return None
    return HostIngest(srcs, program.epoch_events, max_events=max_events,
                      device=program.device, mesh=program.mesh)


def tier_plans(program, ingest) -> tuple:
    """Demotion plans: one per keyed node of the (chained) program. A node
    gets promotion recipes only where its key columns trace back through
    InputRef-only Maps and Filters to an ingest source's shipped columns:
    raw, non-multiset aggs, and joins whose two sides both trace. Others
    keep recency stats and never demote, which is always safe. `mv_idx`
    is an agg's lockstep terminal MVKeyedNode."""
    from .fused import AggNode, JoinNode, MVKeyedNode
    from .tiering import TierPlan, derive_recipe
    source_ords = {idx: k for k, (idx, _s) in enumerate(ingest.sources)} \
        if ingest is not None else {}
    mv_of = {n.inputs[0]: j for j, n in enumerate(program.nodes)
             if isinstance(n, MVKeyedNode)}
    plans = []
    for j, node in enumerate(program.nodes):
        if isinstance(node, AggNode):
            recipes = ()
            if not node.spec.minputs and not node.combined:
                r = derive_recipe(program.nodes, node.inputs[0],
                                  node.group_idx, node.pack.fields,
                                  source_ords)
                if r is not None:
                    recipes = (r,)
            plans.append(TierPlan(j, "agg", recipes, mv_of.get(j)))
        elif isinstance(node, JoinNode):
            rl = derive_recipe(program.nodes, node.inputs[0], node.l_keys,
                               node.pack.fields, source_ords)
            rr = derive_recipe(program.nodes, node.inputs[1], node.r_keys,
                               node.pack.fields, source_ords)
            # promotion must see every window key that can touch either
            # side: a one-sided lineage cannot, so such a join demotes
            # nothing
            recipes = (rl, rr) if rl is not None and rr is not None else ()
            plans.append(TierPlan(j, "join", recipes))
    return tuple(plans)


class _TsShift(Expr):
    """ts +/- a constant number of microseconds, evaluated on device
    (int64, wrapping). It lowers to an int64 literal and an add, so a time
    bound runs inside the `expr_eval` kernel."""

    def __init__(self, arg: Expr, delta_usecs: int):
        self.arg = arg
        self.delta = int(delta_usecs)
        self.return_type = T.TIMESTAMP

    def children(self):
        return [self.arg]

    def supports_device(self) -> bool:
        return self.arg.supports_device()

    def eval_device(self, cols):
        v, ok = self.arg.eval_device(cols)
        return v + self.delta, ok

    def lower(self, b):
        from ..kernels import expr_eval as X
        lower_as(b, self.arg, X.T_I64)
        b.lit(self.delta, X.T_I64)
        return b.op(X.OP_ADD, X.T_I64, 2, X.T_I64)

    def __repr__(self):
        return f"ts_shift({self.arg!r}, {self.delta})"


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------


class _Fuser:
    """Executor tree -> node list (pre-chain indices), with a `Meta` per
    node output. Nodes are built on `device`."""

    def __init__(self, device_cfg, device, epoch_events_cap: Optional[int]
                 = None):
        self.nodes: List = []
        self.device = device
        self.capacity = getattr(device_cfg, "capacity", 1 << 14) or (1 << 14)
        self.epoch_events: Optional[int] = epoch_events_cap
        self._source_cache: Dict[Tuple, Meta] = {}
        self.max_events: Optional[int] = None
        # local pre-combine (skew defense 1): duplicate-key agg input
        # rows combine to one partial row per key before the state merge
        # (and the exchange). Armed per agg when exactly combinable.
        self.precombine = _env_bool(
            "RW_AGG_PRECOMBINE",
            getattr(device_cfg, "agg_precombine", True))
        # host-ingest mode (device/ingest.py): sources become IngestNodes
        # fed from staged host buffers instead of device-generated events.
        # DeviceConfig.host_ingest (RW_HOST_INGEST) arms it for every
        # source; one source opts in with WITH (nexmark.ingest='host'),
        # and then the job's other sources follow (`try_fuse`)
        self.host_ingest = _env_bool(
            "RW_HOST_INGEST", getattr(device_cfg, "host_ingest", False))
        # every source desc by (pre-chain) node index
        self.source_descs: Dict[int, "_NexmarkDesc"] = {}

    def add(self, node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    # ---- leaf: source chain --------------------------------------------
    def _source(self, execu) -> Meta:
        from ..connectors.nexmark import NexmarkReader
        from ..ops import (MaterializeExecutor, RowIdGenExecutor,
                           SourceExecutor)
        from ..ops.executor import SharedStreamPort
        from ..sql.database import _Backfill
        from .fused import SourceNode
        desc = getattr(execu, "virtual_source", None)
        e = execu
        while desc is None:
            if isinstance(e, _Backfill):
                if e.snapshot is not None and e.snapshot.capacity:
                    raise FuseReject("source already has history (backfill "
                                     "snapshot) — fused jobs start at 0")
                e = e.port
            elif isinstance(e, SharedStreamPort):
                e = e.shared.upstream
            elif isinstance(e, (MaterializeExecutor, RowIdGenExecutor)):
                e = e.input
            elif isinstance(e, SourceExecutor):
                if not isinstance(e.reader, NexmarkReader):
                    raise FuseReject(f"unfusable reader "
                                     f"{type(e.reader).__name__}")
                if e.reader.next_event:
                    raise FuseReject("source already advanced")
                nm = e.name
                if nm.startswith("Source(") and nm.endswith(")"):
                    nm = nm[len("Source("):-1]
                desc = _NexmarkDesc.from_reader(e.reader, e.schema, nm)
            else:
                raise FuseReject(f"unfusable source chain node "
                                 f"{type(e).__name__}")
        key = desc.cache_key
        if key in self._source_cache:
            return self._source_cache[key]
        if self.max_events is None:
            self.max_events = desc.max_events
        elif desc.max_events != self.max_events:
            raise FuseReject("sources disagree on max_events")
        ee = desc.events_per_poll * EPOCH_POLLS
        if self.epoch_events is None:
            self.epoch_events = ee
        elif self.epoch_events != ee:
            raise FuseReject("sources disagree on epoch cadence")
        # every source starts as a SourceNode; `try_fuse` turns them all
        # into IngestNodes (`to_ingest`) when any of them is host-fed —
        # the same column metadata, so every packing proof is the same
        node = SourceNode(desc.table, desc.gencfg, desc.col_names,
                          desc.rowid_pos, desc.max_events, desc.dtypes,
                          device=self.device)
        idx = self.add(node)
        self.source_descs[idx] = desc
        meta = Meta(idx, list(node.dtypes), list(node.decoders),
                    list(node.ranges),
                    rows_bound=desc.max_events or _HORIZON,
                    append_only=True)
        self._source_cache[key] = meta
        return meta

    @property
    def wants_ingest(self) -> bool:
        return self.host_ingest or any(d.ingest == "host"
                                       for d in self.source_descs.values())

    # ---- recursive build ------------------------------------------------
    def build(self, execu, need_pk: bool) -> Meta:
        from ..ops import (FilterExecutor, HashAggExecutor, HashJoinExecutor,
                           HopWindowExecutor, JoinType, ProjectExecutor)
        from ..ops.device_agg import DeviceHashAggExecutor
        from ..ops.device_join import DeviceHashJoinExecutor
        from .fused import FilterNode, HopNode

        if isinstance(execu, ProjectExecutor):
            m = self.build(execu.input, need_pk)
            return self._map(m, execu.exprs)
        if isinstance(execu, FilterExecutor):
            m = self.build(execu.input, need_pk)
            pred = _devify(execu.predicate)
            _surrogate_safe(pred, m.decoders)
            idx = self.add(FilterNode(m.idx, pred, device=self.device))
            return replace(m, idx=idx, agg=None)
        if isinstance(execu, HopWindowExecutor):
            m = self.build(execu.input, need_pk)
            if m.agg is not None or m.is_pair:
                raise FuseReject("hop over non-source stream")
            node = HopNode(m.idx, execu.time_col, execu.hop_usecs,
                           execu.size_usecs, device=self.device)
            idx = self.add(node)
            tr = m.ranges[execu.time_col]
            if tr is None:
                raise FuseReject("hop over unbounded time column")
            ws = ((tr[0] // execu.hop_usecs - node.n) * execu.hop_usecs,
                  tr[1], execu.hop_usecs)
            we = (ws[0] + execu.size_usecs, tr[1] + execu.size_usecs,
                  execu.hop_usecs)
            return Meta(idx, m.dtypes + [T.TIMESTAMP, T.TIMESTAMP],
                        m.decoders + [TS, TS], m.ranges + [ws, we],
                        rows_bound=m.rows_bound * node.n,
                        append_only=m.append_only)
        if isinstance(execu, (DeviceHashAggExecutor, HashAggExecutor)):
            return self._agg(execu, need_pk)
        if isinstance(execu, (DeviceHashJoinExecutor, HashJoinExecutor)):
            if isinstance(execu, HashJoinExecutor) \
                    and execu.join_type != JoinType.INNER:
                raise FuseReject("non-inner join")
            return self._join(execu)
        # source chains (backfill/port/virtual) end the recursion
        return self._source(execu)

    def _map(self, m: Meta, exprs: Sequence[Expr]) -> Meta:
        from .fused import MapNode
        dexprs, dts, decs, rngs = [], [], [], []
        for e in exprs:
            de = _devify(e)
            _surrogate_safe(de, m.decoders)
            dexprs.append(de)
            dts.append(e.return_type)
            if isinstance(de, InputRef):
                decs.append(m.decoders[de.index])
            elif e.return_type.kind in (TypeKind.TIMESTAMP, TypeKind.DATE):
                decs.append(TS)
            else:
                decs.append(NUM)
            rngs.append(_range_of(de, m.ranges))
        idx = self.add(MapNode(m.idx, dexprs, device=self.device))
        return Meta(idx, dts, decs, rngs, m.rows_bound, m.append_only,
                    is_pair=m.is_pair)

    def _agg(self, execu, need_pk: bool) -> Meta:
        from .agg_step import DeviceAggSpec
        from .fused import AggCall, AggNode, PackPlan, PrecombineNode
        m = self.build(execu.input, need_pk=False)
        gidx = list(execu.group_key_indices)
        calls = list(execu.calls)
        arg_dtypes, arg_ids = [], []
        out_dt, out_dec, out_rng = [], [], []
        for i in gidx:
            out_dt.append(m.dtypes[i])
            out_dec.append(m.decoders[i])
            out_rng.append(m.ranges[i])
        for ci, c in enumerate(calls):
            if c.distinct or c.filter is not None:
                raise FuseReject("DISTINCT / FILTER aggregate")
            k = "count_star" if c.kind == "count" and c.arg is None \
                else c.kind
            if k not in ("count_star", "count", "sum", "min", "max"):
                raise FuseReject(f"aggregate {c.kind} not fused")
            if c.arg is not None:
                if not isinstance(c.arg, InputRef):
                    raise FuseReject("non-column aggregate argument")
                if m.decoders[c.arg.index] not in (NUM, TS):
                    raise FuseReject("aggregate over string surrogate")
                dd = c.arg.return_type.device_dtype
                if dd is None:
                    raise FuseReject("aggregate arg has no device dtype")
                if k in ("min", "max") and not m.append_only \
                        and np.issubdtype(np.dtype(dd), np.floating):
                    # retractable min/max multisets hold order-encoded
                    # int64; the fused path doesn't order-encode floats
                    raise FuseReject("retractable float min/max not fused")
                arg_dtypes.append(np.dtype(dd))
                arg_ids.append(("ref", c.arg.index))
            else:
                arg_dtypes.append(np.dtype(np.int64))
                arg_ids.append(("call", ci))
            out_dt.append(c.return_type)
            if k in ("count_star", "count"):
                out_dec.append(NUM)
                out_rng.append((0, m.rows_bound, 1))
            elif k == "sum":
                out_dec.append(NUM)
                out_rng.append(None)
            else:                    # min / max: value from the arg column
                out_dec.append(m.decoders[c.arg.index])
                out_rng.append(m.ranges[c.arg.index])
        pack = PackPlan.plan([m.ranges[i] for i in gidx])
        if pack is None:
            raise FuseReject("group key not losslessly packable")
        spec = DeviceAggSpec.build(
            ["count_star" if c.kind == "count" and c.arg is None else c.kind
             for c in calls],
            arg_dtypes, append_only=m.append_only, arg_ids=arg_ids)
        pk_pack = None
        if need_pk:
            pk_pack = PackPlan.plan(out_rng)
            if pk_pack is None:
                raise FuseReject("agg change-row identity not packable")
        ncalls = [AggCall(c.kind, None if c.arg is None else c.arg.index)
                  for c in calls]
        in_idx = m.idx
        if self.precombine and self._combinable(spec):
            # skew defense 1 (local pre-combine): a stateless combine
            # stage collapses the epoch's duplicate-key rows to one
            # partial-aggregate row per key BEFORE the agg (and, under a
            # mesh, before the exchange)
            in_idx = self.add(PrecombineNode(m.idx, gidx, ncalls, pack,
                                             spec, device=self.device))
        node = AggNode(in_idx, gidx, ncalls, pack, spec, self.capacity,
                       pk_pack, device=self.device)
        if in_idx != m.idx:
            node.enable_precombine()
        idx = self.add(node)
        return Meta(idx, out_dt, out_dec, out_rng,
                    rows_bound=2 * m.rows_bound, append_only=False,
                    agg=node)

    @staticmethod
    def _combinable(spec) -> bool:
        """Exact pre-combine eligibility: the per-key deltas must combine
        by associative, order-independent reductions — which rules out
        retractable min/max multisets (multiset entries key by (group,
        value), not group) and float SUM columns (float addition is not
        associative bit-for-bit)."""
        from .sorted_state import ReduceKind
        if spec.minputs:
            return False
        return not any(k == ReduceKind.SUM and dt.is_floating_point
                       for k, dt in zip(spec.kinds, spec.dtypes))

    def _join(self, execu) -> Meta:
        from ..ops.device_join import DeviceHashJoinExecutor
        from .fused import JoinNode, PackPlan
        if isinstance(execu, DeviceHashJoinExecutor):
            lkeys, rkeys = execu.key_idx["a"], execu.key_idx["b"]
        else:
            lkeys, rkeys = execu.left_keys, execu.right_keys
        lex, rex = execu.left_exec, execu.right_exec
        cond = execu.condition
        lm = self.build(lex, need_pk=True)
        rm = self.build(rex, need_pk=True)
        merged = []
        for li, ri in zip(lkeys, rkeys):
            a, b = lm.ranges[li], rm.ranges[ri]
            if a is None or b is None:
                raise FuseReject("join key not packable")
            if (lm.decoders[li] in (NUM, TS)) != (rm.decoders[ri]
                                                  in (NUM, TS)):
                raise FuseReject("join between surrogate and plain column")
            merged.append((min(a[0], b[0]), max(a[1], b[1]),
                           math.gcd(a[2], b[2]) or 1))
        pack = PackPlan.plan(merged)
        if pack is None:
            raise FuseReject("join key not losslessly packable")
        out_dt = lm.dtypes + rm.dtypes
        out_dec = lm.decoders + rm.decoders
        out_rng = lm.ranges + rm.ranges
        dcond = None
        if cond is not None:
            dcond = _devify(cond)
            _surrogate_safe(dcond, out_dec)
        node = JoinNode(lm.idx, rm.idx, lkeys, rkeys, pack, dcond,
                        self.capacity, 4 * self.capacity,
                        _side_dtypes(lm.dtypes), _side_dtypes(rm.dtypes),
                        device=self.device)
        idx = self.add(node)
        rb = min(lm.rows_bound * rm.rows_bound, _HORIZON)
        return Meta(idx, out_dt, out_dec, out_rng, rows_bound=rb,
                    append_only=lm.append_only and rm.append_only,
                    is_pair=True)


@dataclass(frozen=True)
class _NexmarkDesc:
    table: str
    gencfg: Any
    col_names: Tuple[str, ...]
    dtypes: Tuple[DataType, ...]
    rowid_pos: Optional[int]
    max_events: Optional[int]
    events_per_poll: int
    cache_key: Tuple
    # catalog source name (admission-bucket / provenance key) and the
    # per-source ingest opt-in (WITH (nexmark.ingest='host'))
    src_name: str = ""
    ingest: str = ""

    @staticmethod
    def from_reader(reader, schema, src_name: str = "") -> "_NexmarkDesc":
        from .nexmark_gen import GenCfg
        names = [f.name for f in schema.fields]
        rowid = names.index("_row_id") if "_row_id" in names else None
        return _NexmarkDesc(
            reader.table, GenCfg.from_config(reader.gen.cfg), tuple(names),
            tuple(f.dtype for f in schema.fields), rowid,
            reader.max_events, reader.events_per_poll,
            (reader.table, id(reader.gen)), src_name,
            getattr(reader, "ingest_mode", "") or "")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def try_fuse(execu, ns, device_cfg, name: str, mv_state_table=None,
             make_state=None, cap_registry=None, device=None):
    """Lower a planned MV executor tree to a FusedJob on `device` (None:
    `cuda:0`), or None. A mesh job lays its shards over
    `parallel.mesh.device_set(device)` — every visible card from a CUDA
    device, or the sequence given — and runs shard 0 on its first device;
    a single-device job runs on that first device.

    `execu` is the tree Database._create_mv would hand to Materialize;
    `ns` its namespace (schema + stream key + visibility).
    `cap_registry` maps plan-shape hash -> {node shape key -> caps}
    (FusedJob.shape_hints of previous incarnations): the program's nodes
    presize from it BEFORE state allocation, so a re-created MV with the
    same plan — under ANY name — never re-climbs the capacity growth
    ladder. Hints match on structural shape keys, never program indices,
    so a different plan can never inherit them.

    Under a mesh (`DeviceConfig.mesh_shards > 1`) the job runs the
    reference's checkpoint-time skew policy: vnode rebalancing
    (`vnode_rebalance`, past `rebalance_threshold`) and hot-key
    replication of joins (`hot_key_rep`, at `hot_key_frac` of an epoch);
    both read the skew telemetry, so both need `skew_stats` on.
    """
    from ..ops import HashAggExecutor, ProjectExecutor
    from ..ops.device_agg import DeviceHashAggExecutor
    from ..parallel.mesh import data_shards, device_set
    from .fused import (FusedJob, FusedProgram, JoinNode, MVKeyedNode,
                        MVPairNode, MVPull, node_shape_key, plan_shape_hash)
    if device_cfg is None or getattr(device_cfg, "mesh", None) is not None:
        return None        # a per-operator mesh plans the sharded ops
    devices = device_set(device)
    device = devices[0]
    try:
        f = _Fuser(device_cfg, device)
        if not isinstance(execu, ProjectExecutor):
            raise FuseReject(f"unexpected terminal {type(execu).__name__}")
        inner = execu.input
        if isinstance(inner, (DeviceHashAggExecutor, HashAggExecutor)):
            # keyed MV straight off the agg change set
            m = f.build(inner, need_pk=False)
            agg = m.agg
            out_map, dts, decs = [], [], []
            ng = len(agg.group_idx)
            for e in execu.exprs:
                if not isinstance(e, InputRef):
                    raise FuseReject("computed column over aggregation "
                                     "output")
                out_map.append(("g", e.index) if e.index < ng
                               else ("c", e.index - ng))
                dts.append(e.return_type)
                decs.append(m.decoders[e.index])
            mv_idx = f.add(MVKeyedNode(m.idx, agg, agg.capacity,
                                       device=device))
            pull = MVPull("keyed", mv_idx, dts, decs, agg=agg,
                          out_map=out_map)
        else:
            m = f.build(inner, need_pk=False)
            if not m.is_pair:
                raise FuseReject("terminal stream has no pair identity "
                                 "(plain stateless MVs stay on host)")
            m = f._map(m, execu.exprs)
            mv_idx = f.add(MVPairNode(m.idx, _side_dtypes(m.dtypes),
                                      f.capacity, device=device))
            pull = MVPull("pair", mv_idx, m.dtypes, m.decoders)
    except FuseReject:
        return None
    ee = f.epoch_events or 8192 * 64
    # operational kill switches / force-ons without code changes (tier-1
    # pins them off for its time budget; the dedicated tests force them)
    skew_on = _env_bool("RW_SKEW_STATS",
                        getattr(device_cfg, "skew_stats", True))
    flow_on = _env_bool("RW_FLOW_STATS",
                        getattr(device_cfg, "flow_stats", True))
    tier_on = _env_bool("RW_STATE_TIERING",
                        getattr(device_cfg, "state_tiering", True))
    # skew, then flow, then tiering — before the exchange (its "exch" stat
    # stays last) and before the plan hash (the arms shape the steps)
    arm_telemetry(f.nodes, skew=skew_on, flow=flow_on, tier=tier_on)
    mesh = _fused_mesh(device_cfg, ee, devices)
    hot_on = _env_bool("RW_HOT_KEY_REP",
                       getattr(device_cfg, "hot_key_rep", True))
    rebalance = _env_bool("RW_VNODE_REBALANCE",
                          getattr(device_cfg, "vnode_rebalance", True))
    if mesh is not None:
        arm_exchange(f.nodes, mesh, ee)
        if skew_on and hot_on:
            # skew defense 2 (hot-key replication): joins become
            # candidates for the checkpoint-time hot-key policy; the
            # heavy-hitter counters are its evidence, so it needs skew
            # telemetry. The exchange routes normally until a policy
            # lands hot keys.
            for node in f.nodes:
                if isinstance(node, JoinNode):
                    node.hotrep = True
    ingest_names: Dict[int, str] = {}
    if f.wants_ingest:
        # one host-fed source makes the whole job host-fed: all sources
        # share one event clock, and a mixed job would re-emit the rows
        # of a window that admission shrank
        to_ingest(f.nodes)
        prune_ingest_columns(f.nodes)
        ingest_names = {i: d.src_name or d.table
                        for i, d in f.source_descs.items()}
    program = FusedProgram(f.nodes, ee, device=device, mesh=mesh)
    ingest = None
    if ingest_names:
        ingest = host_ingest(program, f.max_events, names={
            program.remap.get(i, i): nm for i, nm in ingest_names.items()})
    plans = tier_plans(program, ingest) if tier_on else ()
    ph = plan_shape_hash(program.nodes, program.epoch_events,
                         data_shards(mesh) if mesh is not None else 1)
    hints = (cap_registry or {}).get(ph) or {}
    if hints:
        # structural shape keys must match exactly: a hint from another
        # plan never presizes this one
        for node in program.nodes:
            caps = hints.get(node_shape_key(node))
            if caps:
                node.preset_caps(dict(caps))
    job_table = make_state([T.INT64, T.INT64], [0]) if make_state \
        else None
    return FusedJob(name, program, pull, f.max_events, device=device,
                    mv_state_table=mv_state_table,
                    job_state_table=job_table,
                    mv_schema_len=len(ns.cols),
                    persist_every=getattr(device_cfg, "mv_persist_every", 1),
                    predictive=getattr(device_cfg, "predictive_growth", True),
                    hbm_budget_mb=getattr(device_cfg, "hbm_budget_mb", 4096),
                    profile=getattr(device_cfg, "profile", True),
                    plan_hash=ph, ingest=ingest, state_tiering=tier_on,
                    tier_plans=plans, rebalance=rebalance and skew_on,
                    rebalance_threshold=getattr(device_cfg,
                                                "rebalance_threshold", 2.0),
                    hot_key_rep=hot_on and skew_on,
                    hot_key_frac=getattr(device_cfg, "hot_key_frac", 0.125))


def _fused_mesh(device_cfg, epoch_events: int, devices):
    """The in-process mesh (`parallel/mesh.py`) a fused program shards
    over, dealt over `devices` (a `device_set`), or None for the
    single-device path.
    `DeviceConfig.mesh_shards` opts in, `replicas` (or
    `RW_MESH_REPLICAS`) adds serving-replica columns. A mesh that cannot
    be made degrades as in the reference: the serving replicas go first,
    then the mesh."""
    import os
    n = max(1, int(getattr(device_cfg, "mesh_shards", 1) or 1))
    if n <= 1:
        return None
    r = os.environ.get("RW_MESH_REPLICAS")
    r = int(r) if r else max(1, int(getattr(device_cfg, "replicas", 1) or 1))
    from ..parallel.mesh import make_mesh
    try:
        return make_mesh(n, devices=devices, replicas=r)
    except (ValueError, RuntimeError):
        if r > 1:
            try:
                return make_mesh(n, devices=devices)
            except (ValueError, RuntimeError):
                return None
        return None


def _side_dtypes(dts: Sequence[DataType]) -> List[torch.dtype]:
    """Device dtypes of a join side's / pair MV's columns: float64 for
    floating columns, int64 for everything else."""
    return [torch.float64 if d.np_dtype is not None
            and np.issubdtype(d.np_dtype, np.floating) else torch.int64
            for d in dts]
