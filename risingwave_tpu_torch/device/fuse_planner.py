"""What the fuse planner adds to a node graph (the port's own copy of part
of `risingwave_tpu/device/fuse_planner.py`):

* `_TsShift`: `ts +/- INTERVAL const`, which the planner rewrites from
  `ts_*_interval` calls because the host registers those without a
  device half (Nexmark q7's `date_time BETWEEN window_end - INTERVAL '10'
  SECOND AND window_end`); it lowers to an add of a constant in the
  `expr_eval` kernel;
* `arm_telemetry`: the key-skew and flow telemetry and the state-tiering
  recency arm the planner arms on every keyed node, all on by default as
  in the reference's `DeviceConfig`;
* `arm_exchange` (reference :587-600): under a mesh, every node whose
  shard spec names exchange inputs gets its `[n, exch]` send bucket,
  sized from the epoch cadence (`capacity.exchange_cap`), with
  `_exchange_row_width` (:846) for the budget math;
* the host-ingest wiring (reference :617-690): `to_ingest` (every source
  becomes an `IngestNode`), `prune_ingest_columns` (only the columns some
  node reads ship), `host_ingest` (the job's `HostIngest`) and
  `tier_plans` (one `TierPlan` per keyed node, with promotion recipes
  where its key lineage reaches the ingest).

The planner itself — SQL plan to fused node graph — is still to be
ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..core import dtypes as T
from ..expr.expression import Expr, InputRef, lower_as


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


def host_ingest(program, max_events: Optional[int]):
    """The job's HostIngest: one multiplexed event clock over the
    program's IngestNodes (in node order), feeds keyed by post-chain
    node index; None when the program has none."""
    from .fused import IngestNode
    from .ingest import HostIngest, NexmarkIngestSource
    srcs = [(i, NexmarkIngestSource(n.table, n.table, n.gencfg, n.col_names,
                                    n.rowid_pos, n.max_events, live=n.live))
            for i, n in enumerate(program.nodes) if isinstance(n, IngestNode)]
    if not srcs:
        return None
    return HostIngest(srcs, program.epoch_events, max_events=max_events,
                      device=program.device)


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
