"""Fused fragment runtime on PyTorch: a whole MV dataflow as one epoch
program (the single-device subset of `risingwave_tpu/device/fused.py`
that Nexmark q3a, q4, q5, q7 and q8 run, with the key-skew and flow
telemetry of its keyed nodes).

Node graphs built from Source, Hop, Map, Filter, Precombine, Agg (with
retractable min/max multisets), Join, MVKeyed and MVPair nodes run every
epoch as eager tensor ops over device-resident state; the host barrier
loop only dispatches. It synchronizes exclusively at checkpoints
and MV pulls: each node's `apply` returns its stat scalars as device
tensors, the program stacks them into one vector, and the job folds that
vector across the epochs of a checkpoint window (sum for row counters,
max for capacity needs and violation flags). No node reads a value back
to the host, so an epoch never waits on the device.

Exactness: group keys are lossless bit-packings chosen by static interval
analysis and verified on device — a value outside its proven range
raises at the next sync. Capacity overflow restores the last checkpoint
snapshot, grows every node predictively, and deterministically replays
the window (the sources are pure functions of the event id).
"""
from __future__ import annotations

from dataclasses import dataclass
from decimal import Decimal
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dtypes import DataType, TypeKind
from . import resolve_device
from .capacity import bucket as _bucket


@dataclass
class Delta:
    """A batch of signed rows on device. `cols` is positional (aligned with
    the producing operator's schema); `pk` / `pk2` carry row identity for
    joins and pair MVs. All columns are non-null by construction."""
    cols: List[Any]
    sign: Any
    mask: Any
    pk: Optional[Any] = None
    pk2: Optional[Any] = None


NUM = ("num",)

# Device-memory budget that caps a predictive grow (the reference's
# `DeviceConfig.hbm_budget_mb` default).
HBM_BUDGET_MB = 4096


def _nrows(mask: torch.Tensor) -> torch.Tensor:
    """Device row count of a boolean mask (one stats-vector scalar)."""
    return torch.sum(mask, dtype=torch.int64)


# ---------------------------------------------------------------------------
# lossless key packing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PackField:
    offset: int
    stride: int
    bits: int


@dataclass(frozen=True)
class PackPlan:
    """key = sum_i ((col_i - offset_i) // stride_i) << shift_i, proven
    lossless by interval analysis and re-verified on device (`check`)."""
    fields: Tuple[PackField, ...]

    @staticmethod
    def plan(ranges: Sequence[Optional[Tuple[int, int, int]]]
             ) -> Optional["PackPlan"]:
        fields = []
        total = 0
        for r in ranges:
            if r is None:
                return None
            lo, hi, stride = r
            stride = max(1, stride)
            span = max(0, hi - lo) // stride
            bits = max(1, int(span).bit_length())
            fields.append(PackField(lo, stride, bits))
            total += bits
        if total > 62:        # keys must stay clear of EMPTY_KEY (2^63-1)
            return None
        return PackPlan(tuple(fields))

    def pack(self, cols: Sequence[torch.Tensor]) -> torch.Tensor:
        key = torch.zeros_like(cols[0])
        shift = 0
        for c, f in zip(cols, self.fields):
            v = torch.div(c - f.offset, f.stride, rounding_mode="floor") \
                if f.stride > 1 else c - f.offset
            key = key + (v.to(torch.int64) << shift)
            shift += f.bits
        return key

    def unpack(self, key: torch.Tensor) -> List[torch.Tensor]:
        out = []
        shift = 0
        for f in self.fields:
            v = (key >> shift) & ((1 << f.bits) - 1)
            out.append((v * f.stride + f.offset).to(torch.int64))
            shift += f.bits
        return out

    def check(self, cols: Sequence[torch.Tensor],
              mask: torch.Tensor) -> torch.Tensor:
        """int64 violation flag (0 = all rows within their proven ranges)."""
        bad = torch.zeros((), dtype=torch.int64, device=mask.device)
        for c, f in zip(cols, self.fields):
            r = c - f.offset
            v = torch.div(r, f.stride, rounding_mode="floor") \
                if f.stride > 1 else r
            row_bad = (r < 0) | (v >= (1 << f.bits))
            if f.stride > 1:
                row_bad |= torch.remainder(r, f.stride) != 0
            bad = bad | torch.where(mask & row_bad, 1, 0).max()
        return bad


# ---------------------------------------------------------------------------
# stage nodes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AggCall:
    """One aggregate call of an agg node: its SQL kind and the input
    column it reads (None for count(*))."""
    kind: str
    arg: Optional[int] = None


class Node:
    """Static stage config. `inputs` are node indices; state is one slot
    per node (None when stateless). `takes_event_lo`: this node's `extra`
    is the epoch's first event id."""
    inputs: Tuple[int, ...] = ()
    stat_names: Tuple[str, ...] = ()
    # subset of stat_names that accumulate across epochs by SUM (row-flow
    # counters); everything else accumulates by MAX (capacity needs,
    # violation flags)
    stat_sums: Tuple[str, ...] = ()
    takes_event_lo: bool = False
    # key-skew / flow telemetry (device/skew_stats.py): keyed nodes (agg,
    # join) add the occupancy + heavy-hitter (skew) and traffic (flow)
    # slots to their stats when armed. False everywhere else.
    keyed: bool = False
    skew: bool = False
    flow: bool = False

    def init_state(self):
        return None

    def enable_skew(self) -> None:
        """Arm skew telemetry (before the program is built: the slots
        extend the stat layout; they combine by MAX). No-op for un-keyed
        nodes."""
        from .skew_stats import SKEW_STAT_NAMES
        if self.keyed and not self.skew:
            self.skew = True
            self.stat_names = tuple(self.stat_names) + SKEW_STAT_NAMES

    def enable_flow(self) -> None:
        """Arm flow telemetry (before the program is built). The traffic
        slots are row-flow counters: SUM across epochs. No-op for
        un-keyed nodes."""
        from .skew_stats import TRAFFIC_STAT_NAMES
        if self.keyed and not self.flow:
            self.flow = True
            self.stat_names = tuple(self.stat_names) + TRAFFIC_STAT_NAMES
            self.stat_sums = tuple(self.stat_sums) + TRAFFIC_STAT_NAMES

    # ---- capacity lifecycle (FusedJob.sync drives these) ----------------
    # A node names its capacity slots and reports per-slot observed needs
    # from its pulled stats; the JOB owns the growth policy and hands back
    # bucketed targets.
    def cap_current(self) -> Dict[str, int]:
        """slot name -> current capacity (empty = stateless node)."""
        return {}

    def cap_needs(self, stats: Dict[str, int]) -> Dict[str, int]:
        """slot name -> observed slots needed (the overflow check)."""
        return {}

    def cap_needs_cum(self, stats: Dict[str, int]) -> Dict[str, int]:
        """Cumulative component of the need (grows with total events):
        the part the predictor may extrapolate over the event horizon."""
        return self.cap_needs(stats)

    def cap_needs_epoch(self, stats: Dict[str, int]) -> Dict[str, int]:
        """Per-epoch-bounded component (agg `touched`): flat headroom."""
        return {}

    def cap_bytes(self) -> Dict[str, int]:
        """slot name -> approximate device bytes per slot (budget math)."""
        return {}

    def preset_caps(self, caps: Dict[str, int]) -> None:
        """Adopt capacities BEFORE init_state."""

    def cap_resize(self, state, caps: Dict[str, int]):
        """Pad live state to the given (>= current) capacities and adopt
        them; slots absent from `caps` keep their size."""
        return state

    def adopt_state(self, state) -> None:
        """Take the capacities of a state built elsewhere (carry-across)."""

    def apply(self, state, ins: List[Optional[Delta]], extra,
              epoch_events: int):
        """-> (state', out Delta | None, [stat scalars], aux | None).
        `extra` is this node's cross-node input (SourceNode: event_lo;
        MVKeyedNode: its agg's change set)."""
        raise NotImplementedError


class SourceNode(Node):
    """On-device exact Nexmark events for this epoch's id range."""

    takes_event_lo = True
    stat_names = ("rows_out",)
    stat_sums = ("rows_out",)

    def __init__(self, table: str, gencfg, col_names: Sequence[str],
                 rowid_pos: Optional[int], max_events: Optional[int],
                 schema_dtypes: Sequence[DataType], device=None):
        from .nexmark_gen import SURROGATE, column_bounds
        self.device = resolve_device(device)
        self.table = table
        self.gencfg = gencfg
        self.col_names = list(col_names)
        self.rowid_pos = rowid_pos
        self.max_events = max_events
        self.dtypes = list(schema_dtypes)
        self.decoders = []
        self.ranges: List[Optional[Tuple[int, int, int]]] = []
        for i, nm in enumerate(self.col_names):
            if i == rowid_pos:
                self.decoders.append(NUM)
                self.ranges.append((0, max_events or (1 << 40), 1))
                continue
            self.decoders.append(SURROGATE[table][nm])
            lo, hi = column_bounds(gencfg, table, nm, max_events)
            stride = gencfg.inter_event_gap_usecs \
                if SURROGATE[table][nm] == ("ts",) and nm == "date_time" else 1
            self.ranges.append((lo, hi, stride))

    def apply(self, state, ins, extra, epoch_events):
        from .nexmark_gen import gen_table, table_mask
        # `extra` is a host int: arange takes it as a kernel argument, so
        # the epoch's ids need no host-to-device copy
        ids = torch.arange(extra, extra + epoch_events, dtype=torch.int64,
                           device=self.device)
        mask = table_mask(self.table, ids)
        if self.max_events is not None:
            mask = mask & (ids < self.max_events)
        all_cols = gen_table(self.gencfg, self.table, ids)
        cols = [ids if i == self.rowid_pos else all_cols[nm]
                for i, nm in enumerate(self.col_names)]
        d = Delta(cols, torch.ones(ids.shape, dtype=torch.int32,
                                   device=self.device), mask, pk=ids)
        return state, d, [_nrows(mask)], None


class MapNode(Node):
    """Project: device-evaluable expressions over the input delta."""

    stat_names = ("rows_in", "rows_out")
    stat_sums = ("rows_in", "rows_out")

    def __init__(self, input: int, exprs: Sequence[Any], device=None):
        self.device = resolve_device(device)
        self.inputs = (input,)
        self.exprs = list(exprs)

    def apply(self, state, ins, extra, epoch_events):
        d = ins[0]
        cols = [e.eval_device(d.cols)[0] for e in self.exprs]
        out = Delta(cols, d.sign, d.mask, pk=d.pk, pk2=d.pk2)
        n = _nrows(d.mask)
        return state, out, [n, n], None


class FilterNode(Node):
    """Drop rows whose predicate is not TRUE (FALSE or NULL) by masking
    them out."""

    stat_names = ("rows_in", "rows_out")
    stat_sums = ("rows_in", "rows_out")

    def __init__(self, input: int, pred: Any, device=None):
        self.device = resolve_device(device)
        self.inputs = (input,)
        self.pred = pred

    def apply(self, state, ins, extra, epoch_events):
        d = ins[0]
        ok, valid = self.pred.eval_device(d.cols)
        out = Delta(d.cols, d.sign, d.mask & ok & valid, pk=d.pk, pk2=d.pk2)
        return state, out, [_nrows(d.mask), _nrows(out.mask)], None


class HopNode(Node):
    """Row -> size/hop windowed copies, appending window_start/window_end
    (HOP, or TUMBLE when hop == size). Row identity extends with the
    window ordinal so each copy stays unique. The expansion is the
    `hop_expand` kernel."""

    stat_names = ("rows_in", "rows_out")
    stat_sums = ("rows_in", "rows_out")

    def __init__(self, input: int, time_col: int, hop_usecs: int,
                 size_usecs: int, device=None):
        if hop_usecs <= 0 or size_usecs % hop_usecs != 0:
            raise ValueError("HOP size must be a positive multiple of hop")
        self.device = resolve_device(device)
        self.inputs = (input,)
        self.time_col = time_col
        self.hop = hop_usecs
        self.size = size_usecs
        self.n = size_usecs // hop_usecs

    def apply(self, state, ins, extra, epoch_events):
        from ..kernels import hop_expand
        d = ins[0]
        cols, pk, sign, mask = hop_expand(d.cols, self.time_col, self.hop,
                                          self.size, d.pk, d.sign, d.mask)
        out = Delta(cols, sign, mask, pk=pk)
        return state, out, [_nrows(d.mask), _nrows(out.mask)], None


class ChainNode(Node):
    """A maximal run of stateless single-consumer nodes (Source/Map/Filter)
    run as one program step."""

    def __init__(self, chain: List[Node], inputs: Tuple[int, ...]):
        self.chain = list(chain)
        self.inputs = tuple(inputs)
        self.device = chain[0].device
        self.takes_event_lo = bool(getattr(chain[0], "takes_event_lo",
                                           False))
        # source-rooted chains have no input delta to count
        self.stat_names = ("rows_in", "rows_out") if inputs \
            else ("rows_out",)
        self.stat_sums = self.stat_names

    def apply(self, state, ins, extra, epoch_events):
        out = None
        for i, n in enumerate(self.chain):
            node_ins = ins if i == 0 else [out]
            _, out, _, _ = n.apply(None, node_ins,
                                   extra if i == 0 else None, epoch_events)
        stats = [_nrows(out.mask)]
        if self.inputs:
            stats = [_nrows(ins[0].mask)] + stats
        return None, out, stats, None


_CHAINABLE = (SourceNode, MapNode, FilterNode)


def _chain_nodes(nodes: List[Node]) -> Tuple[List[Node], Dict[int, int]]:
    """Greedily absorb stateless single-consumer runs into ChainNodes.
    Returns (new_nodes, remap old->new index). Only the LAST member of a
    chain may have external consumers (enforced by the single-consumer
    rule), so remapping its index covers every reference."""
    consumers: Dict[int, List[int]] = {i: [] for i in range(len(nodes))}
    for i, n in enumerate(nodes):
        for j in n.inputs:
            consumers[j].append(i)
    absorbed = set()
    new_nodes: List[Node] = []
    remap: Dict[int, int] = {}
    for i, n in enumerate(nodes):
        if i in absorbed:
            continue
        if isinstance(n, _CHAINABLE):
            chain = [n]
            cur = i
            while len(consumers[cur]) == 1:
                nxt = consumers[cur][0]
                if isinstance(nodes[nxt], _CHAINABLE) \
                        and nodes[nxt].inputs == (cur,):
                    chain.append(nodes[nxt])
                    absorbed.add(nxt)
                    cur = nxt
                else:
                    break
            ins = tuple(remap[j] for j in n.inputs)
            if len(chain) > 1:
                new = ChainNode(chain, ins)
            else:
                n.inputs = ins
                new = n
            new_nodes.append(new)
            remap[cur] = len(new_nodes) - 1
            remap[i] = len(new_nodes) - 1
        else:
            if not isinstance(n, ChainNode):   # idempotent re-wrap guard
                n.inputs = tuple(remap[j] for j in n.inputs)
            new_nodes.append(n)
            remap[i] = len(new_nodes) - 1
    return new_nodes, remap


def _agg_inputs(calls: Sequence[AggCall], cols, keys):
    """(values, valid) per call: count(*) reads zeros; others their arg."""
    ones = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    return tuple((torch.zeros_like(keys) if c.arg is None else cols[c.arg],
                  ones) for c in calls)


class PrecombineNode(Node):
    """Local pre-combine stage ahead of an AggNode: the epoch's raw input
    rows collapse to one partial-aggregate row per unique group key
    BEFORE the agg's state merge. Output delta layout: cols = [packed
    group key, raw-row count, *per-column partial deltas (spec.kinds
    layout)], live rows compacted to a prefix. Stateless. Only for
    exactly-combinable aggs: no multisets, no float SUM columns."""

    stat_names = ("rows_in", "rows_out", "packbad")
    stat_sums = ("rows_in", "rows_out")

    def __init__(self, input: int, group_idx: Sequence[int],
                 calls: Sequence[AggCall], pack: PackPlan, spec,
                 device=None):
        self.device = resolve_device(device)
        self.inputs = (input,)
        self.group_idx = list(group_idx)
        self.calls = list(calls)
        self.pack = pack
        self.spec = spec

    def apply(self, state, ins, extra, epoch_events):
        from .agg_step import precombine_core
        from .sorted_state import EMPTY_KEY
        d = ins[0]
        live = d.mask & (d.sign != 0)
        gcols = [d.cols[i] for i in self.group_idx]
        packbad = self.pack.check(gcols, live)
        keys = self.pack.pack(gcols)
        ukeys, ucnt, udeltas = precombine_core(
            self.spec, keys, d.sign, d.mask,
            _agg_inputs(self.calls, d.cols, keys))
        out_live = ukeys != EMPTY_KEY
        out = Delta([ukeys, ucnt] + list(udeltas),
                    torch.where(out_live, 1, 0).to(torch.int32), out_live)
        return state, out, [_nrows(live), _nrows(out_live), packbad], None


class AggNode(Node):
    """epoch_core_full behind a packed group key; emits the change stream
    as a signed delta (old rows retract, new rows insert; unchanged groups
    suppressed). Change-set internals go out as aux for a terminal keyed
    MV. With `combined` armed (enable_precombine), the input is a
    PrecombineNode's partial-aggregate delta instead of raw rows.
    Retractable min/max calls keep one sorted multiset per input column
    (`spec.minputs`), each a capacity slot `ms{i}` of its own."""

    keyed = True

    def __init__(self, input: int, group_idx: Sequence[int],
                 calls: Sequence[AggCall], pack: PackPlan, spec,
                 capacity: int, pk_pack: Optional[PackPlan], device=None):
        self.device = resolve_device(device)
        self.inputs = (input,)
        self.group_idx = list(group_idx)
        self.calls = list(calls)
        self.pack = pack
        self.spec = spec
        self.capacity = capacity
        # per-minput multiset capacities (tracked on the node so presizing
        # can set them before init_state builds the tensors)
        self.ms_caps = [capacity] * len(spec.minputs)
        # row identity of emitted change rows = pack(group, outputs); None
        # when no pair consumer reads this stream
        self.pk_pack = pk_pack
        # False when only a terminal MVKeyedNode consumes this agg (via
        # the aux change set): the signed delta stream is then never
        # built. Set by FusedProgram's consumer analysis.
        self.emit_out = True
        # True after enable_precombine: the input delta is a
        # PrecombineNode's partial-aggregate layout
        self.combined = False
        self.stat_names = tuple(["needed", "touched"]
                                + [f"ms{i}" for i in range(len(spec.minputs))]
                                + ["packbad", "rows_in", "rows_out"])
        self.stat_sums = ("rows_in", "rows_out")

    def enable_precombine(self) -> None:
        """Arm the pre-combined input mode (before the program is built).
        The spec must be exactly combinable (no multisets, no float SUM
        columns)."""
        from .sorted_state import ReduceKind
        if self.spec.minputs:
            raise ValueError("pre-combine over multiset state")
        if any(k == ReduceKind.SUM and dt.is_floating_point
               for k, dt in zip(self.spec.kinds, self.spec.dtypes)):
            raise ValueError("pre-combine over a float SUM column")
        self.combined = True

    def init_state(self):
        from .agg_step import DeviceAggState
        from .minput import ms_make
        return DeviceAggState(
            self.spec.make_state(self.capacity, self.device),
            tuple(ms_make(c, self.device) for c in self.ms_caps))

    def cap_current(self):
        caps = {"main": self.capacity}
        for i, c in enumerate(self.ms_caps):
            caps[f"ms{i}"] = c
        return caps

    def cap_needs(self, stats):
        # `touched` guards the change-set compaction bound (2 * capacity):
        # an epoch touching more unique groups than capacity must grow and
        # replay even if enough groups died for the merge itself to fit
        needs = {"main": max(stats["needed"], stats.get("touched", 0))}
        for i in range(len(self.ms_caps)):
            needs[f"ms{i}"] = stats[f"ms{i}"]
        return needs

    def cap_needs_cum(self, stats):
        # live groups and multiset entries accumulate across epochs
        needs = {"main": stats["needed"]}
        for i in range(len(self.ms_caps)):
            needs[f"ms{i}"] = stats[f"ms{i}"]
        return needs

    def cap_needs_epoch(self, stats):
        return {"main": stats.get("touched", 0)}

    def cap_bytes(self):
        from .minput import MS_SLOT_BYTES
        caps = {"main": 8 * (1 + len(self.spec.dtypes))}
        for i in range(len(self.ms_caps)):
            caps[f"ms{i}"] = MS_SLOT_BYTES
        return caps

    def preset_caps(self, caps):
        self.capacity = max(self.capacity, caps.get("main", 0))
        for i in range(len(self.ms_caps)):
            self.ms_caps[i] = max(self.ms_caps[i], caps.get(f"ms{i}", 0))

    def cap_resize(self, state, caps):
        from .agg_step import DeviceAggState
        from .minput import ms_grow
        from .sorted_state import grow_state
        main = state.main
        if caps.get("main", 0) > main.capacity:
            self.capacity = caps["main"]
            main = grow_state(main, self.capacity, self.spec.kinds)
        ms = list(state.minputs)
        for i in range(len(ms)):
            c = caps.get(f"ms{i}", 0)
            if c > ms[i].capacity:
                self.ms_caps[i] = c
                ms[i] = ms_grow(ms[i], c)
        return DeviceAggState(main, tuple(ms))

    def adopt_state(self, state) -> None:
        self.capacity = state.main.capacity
        self.ms_caps = [m.capacity for m in state.minputs]

    def _call_outputs(self, ch, which: str):
        """Per-call (array, null) at the touched keys, old or new. A
        retractable min/max reads its multiset's extreme, NULL where the
        group has no value there."""
        outs, nulls = [], []
        for ci, dc in enumerate(self.spec.calls):
            if dc.minput is not None:
                sub = ch[f"minput{dc.minput}"]
                v = sub[f"{which}_max"] if self.calls[ci].kind == "max" \
                    else sub[f"{which}_min"]
                outs.append(v)
                nulls.append(~sub[f"{which}_found"])
            else:
                outs.append(ch[f"{which}_out"][ci])
                nulls.append(ch[f"{which}_null"][ci])
        return outs, nulls

    def apply(self, state, ins, extra, epoch_events):
        from .agg_step import DeviceAggState, epoch_core_combined, \
            local_epoch_step
        from .skew_stats import (epoch_topk, vnode_occupancy, vnode_traffic,
                                 weighted_topk)
        from .sorted_state import EMPTY_KEY
        d = ins[0]
        stats_tail: List[torch.Tensor] = []
        sk: List[torch.Tensor] = []
        if self.combined:
            # pre-combined input ([key, raw-row count, *partial deltas]):
            # re-combine and merge — the key is pre-packed and its bounds
            # pre-checked upstream
            keys = d.cols[0]
            cnt = d.cols[1]
            dvals = list(d.cols[2:2 + len(self.spec.kinds)])
            live = d.mask & (d.sign != 0)
            new_main, needed, ch = epoch_core_combined(
                self.spec, state.main, keys, cnt, dvals, live)
            new_state = DeviceAggState(new_main, ())
            packbad = torch.zeros((), dtype=torch.int64, device=self.device)
            rows_in = ch["rows_in"].to(torch.int64)
            if self.skew:
                # heavy hitters from the exact combined per-key counts
                sk += list(vnode_occupancy(new_main.keys, EMPTY_KEY)) \
                    + list(weighted_topk(ch["keys"], ch["in_counts"],
                                         EMPTY_KEY))
            if self.flow:
                # each combined row weighs its raw-row count: the totals
                # equal the uncombined run's
                sk += list(vnode_traffic(keys, live, weights=cnt.abs()))
        else:
            gcols = [d.cols[i] for i in self.group_idx]
            packbad = self.pack.check(gcols, d.mask & (d.sign != 0))
            keys = self.pack.pack(gcols)
            new_state, (needed, ms_needed), ch = local_epoch_step(
                self.spec, state, keys, d.sign, d.mask,
                _agg_inputs(self.calls, d.cols, keys))
            live = d.mask & (d.sign != 0)
            rows_in = _nrows(live)
            stats_tail = [m.to(torch.int64) for m in ms_needed]
            if self.skew:
                sk += list(vnode_occupancy(new_state.main.keys, EMPTY_KEY)) \
                    + list(epoch_topk(keys, live, EMPTY_KEY))
            if self.flow:
                sk += list(vnode_traffic(keys, live))
        head = [needed.to(torch.int64),
                ch["count"].to(torch.int64)] + stats_tail
        if not self.emit_out:
            # terminal agg: only the MV apply reads the change set; no
            # delta stream. rows_out counts the upserts + deletes.
            aux = {"keys": ch["keys"], "old_found": ch["old_found"],
                   "new_found": ch["new_found"], "new_out": ch["new_out"],
                   "new_null": ch["new_null"]}
            for mi in range(len(self.spec.minputs)):
                sub = ch[f"minput{mi}"]
                aux[f"minput{mi}"] = {k: sub[k] for k in
                                     ("new_found", "new_min", "new_max")}
            rows_out = _nrows(ch["old_found"] | ch["new_found"])
            return (new_state, None, head + [packbad, rows_in, rows_out] + sk,
                    aux)
        # ---- change stream: old rows (-1) then new rows (+1) ------------
        old_found, new_found = ch["old_found"], ch["new_found"]
        old_outs, _ = self._call_outputs(ch, "old")
        new_outs, _ = self._call_outputs(ch, "new")
        changed = ~(old_found & new_found)
        for ov, nv in zip(old_outs, new_outs):
            changed = changed | (ov != nv)
        ug = self.pack.unpack(ch["keys"])
        cols = [torch.cat([g, g]) for g in ug]
        for ov, nv in zip(old_outs, new_outs):
            c = torch.cat([ov, nv])
            cols.append(c if c.dtype.is_floating_point
                        else c.to(torch.int64))
        n = ch["keys"].shape[0]
        ones = torch.ones(n, dtype=torch.int32, device=self.device)
        sign = torch.cat([-ones, ones])
        mask = torch.cat([old_found & changed, new_found & changed])
        # Bound the emitted change set by 2 * capacity: an epoch cannot
        # touch more groups than the state holds without growing (the
        # `touched` stat triggers grow+replay before truncation could
        # ever drop a live row).
        bound = 2 * min(n, self.capacity)
        if bound < 2 * n:
            from .sorted_state import compact_rows
            out_rows = compact_rows(mask, [], cols + [sign], bound,
                                    [0] * len(cols) + [0])
            cols, sign = list(out_rows[:-1]), out_rows[-1]
            mask = sign != 0
        pk = None
        if self.pk_pack is not None:
            pk = self.pk_pack.pack(cols)
            packbad = packbad | self.pk_pack.check(cols, mask)
        out = Delta(cols, sign, mask, pk=pk)
        return (new_state, out, head + [packbad, rows_in, _nrows(mask)] + sk,
                ch)


class MVKeyedNode(Node):
    """Terminal MV over an agg change set: upsert-by-group-key table
    (`device/materialize.py`), zero host traffic until a pull."""

    def __init__(self, input: int, agg_node: AggNode, capacity: int,
                 device=None):
        self.device = resolve_device(device)
        self.inputs = (input,)
        self.agg = agg_node
        self.capacity = capacity
        self.stat_names = ("needed", "rows_in")
        self.stat_sums = ("rows_in",)

    def init_state(self):
        from .materialize import make_mv_state
        dts = [c.acc_dtype for c in self.agg.spec.calls]
        return make_mv_state(self.capacity, dts, self.device)

    def cap_current(self):
        return {"main": self.capacity}

    def cap_needs(self, stats):
        return {"main": stats["needed"]}

    def cap_bytes(self):
        # key + liveness + (value, null) per call
        return {"main": 8 * (2 + 2 * len(self.agg.spec.calls))}

    def preset_caps(self, caps):
        self.capacity = max(self.capacity, caps.get("main", 0))

    def cap_resize(self, state, caps):
        from .materialize import mv_kinds
        from .sorted_state import grow_state
        if caps.get("main", 0) > state.capacity:
            self.capacity = caps["main"]
            return grow_state(state, self.capacity,
                              mv_kinds(len(self.agg.spec.calls)))
        return state

    def adopt_state(self, state) -> None:
        self.capacity = state.capacity

    def apply(self, state, ins, extra, epoch_events):
        from .materialize import mv_apply_changes
        ch = extra
        upsert = ch["new_found"]
        delete = ch["old_found"] & ~ch["new_found"]
        outs, nulls = self.agg._call_outputs(ch, "new")
        state, needed = mv_apply_changes(
            state, ch["keys"], upsert, delete,
            [o.to(state.vals[1 + 2 * i].dtype) for i, o in enumerate(outs)],
            nulls)
        return state, None, [needed.to(torch.int64),
                             _nrows(upsert | delete)], None


class JoinNode(Node):
    """Inner equi-join: `join_step.local_join_step` (join_core plus the
    cross-delta pair netting) behind a packed join key, with an optional
    non-equi condition over the pair columns. Output pair identity =
    (left pk, right pk); output columns = left columns then right."""

    keyed = True

    def __init__(self, left: int, right: int, l_keys: Sequence[int],
                 r_keys: Sequence[int], pack: PackPlan, cond: Optional[Any],
                 capacity: int, pair_capacity: int,
                 l_val_dtypes: Sequence[torch.dtype],
                 r_val_dtypes: Sequence[torch.dtype], device=None):
        self.device = resolve_device(device)
        self.inputs = (left, right)
        self.l_keys = list(l_keys)
        self.r_keys = list(r_keys)
        self.pack = pack
        self.cond = cond
        self.cap_a = self.cap_b = self.capacity = capacity
        self.m = pair_capacity
        self.l_val_dtypes = list(l_val_dtypes)
        self.r_val_dtypes = list(r_val_dtypes)
        self.stat_names = ("need_a", "need_b", "need_pairs", "packbad",
                           "rows_in", "rows_out")
        self.stat_sums = ("rows_in", "rows_out")

    def init_state(self):
        from .join_step import make_side
        return (make_side(self.cap_a, self.l_val_dtypes, self.device),
                make_side(self.cap_b, self.r_val_dtypes, self.device))

    def cap_current(self):
        return {"a": self.cap_a, "b": self.cap_b, "pairs": self.m}

    def cap_needs(self, stats):
        return {"a": stats["need_a"], "b": stats["need_b"],
                "pairs": stats["need_pairs"]}

    def cap_needs_cum(self, stats):
        # build sides accumulate rows; the pair buffer does not
        return {"a": stats["need_a"], "b": stats["need_b"]}

    def cap_needs_epoch(self, stats):
        # the probe-output pair buffer is re-filled from scratch every
        # epoch: per-epoch-bounded, never horizon-extrapolated
        return {"pairs": stats["need_pairs"]}

    def cap_bytes(self):
        # pair buffer: two probe outputs carry both sides' payloads + ids
        pair = 16 * (3 + len(self.l_val_dtypes) + len(self.r_val_dtypes))
        return {"a": 8 * (2 + len(self.l_val_dtypes)),
                "b": 8 * (2 + len(self.r_val_dtypes)),
                "pairs": pair}

    def preset_caps(self, caps):
        self.cap_a = max(self.cap_a, caps.get("a", 0))
        self.cap_b = max(self.cap_b, caps.get("b", 0))
        self.m = max(self.m, caps.get("pairs", 0))
        self.capacity = max(self.cap_a, self.cap_b)

    def cap_resize(self, state, caps):
        from .join_step import grow_side
        a, b = state
        if caps.get("a", 0) > a.jk.shape[0]:
            self.cap_a = caps["a"]
            a = grow_side(a, self.cap_a)
        if caps.get("b", 0) > b.jk.shape[0]:
            self.cap_b = caps["b"]
            b = grow_side(b, self.cap_b)
        self.capacity = max(self.cap_a, self.cap_b)
        if caps.get("pairs", 0) > self.m:
            self.m = caps["pairs"]
        return (a, b)

    def adopt_state(self, state) -> None:
        self.cap_a = state[0].jk.shape[0]
        self.cap_b = state[1].jk.shape[0]
        self.capacity = max(self.cap_a, self.cap_b)

    def apply(self, state, ins, extra, epoch_events):
        from .join_step import local_join_step
        packbad = torch.zeros((), dtype=torch.int64, device=self.device)
        sides = []
        for d, keys in zip(ins, (self.l_keys, self.r_keys)):
            kcols = [d.cols[i] for i in keys]
            packbad = packbad | self.pack.check(kcols,
                                                d.mask & (d.sign != 0))
            vals = tuple(c if c.dtype.is_floating_point
                         else c.to(torch.int64) for c in d.cols)
            sides += [self.pack.pack(kcols), d.pk, d.sign, d.mask, vals]
        a, b = state
        new_a, new_b, njk, npk, nsign, nvals, needed = local_join_step(
            a, b, *sides, self.m)
        omask = nsign != 0
        ocols = list(nvals)
        if self.cond is not None:
            ok, valid = self.cond.eval_device(ocols)
            omask = omask & ok & valid
        out = Delta(ocols, nsign, omask, pk=njk, pk2=npk)
        live = [d.mask & (d.sign != 0) for d in ins]
        rows_in = _nrows(live[0]) + _nrows(live[1])
        stats = [needed["a"].to(torch.int64), needed["b"].to(torch.int64),
                 needed["pairs"].to(torch.int64), packbad, rows_in,
                 _nrows(omask)]
        if self.skew or self.flow:
            from .skew_stats import epoch_topk, vnode_traffic
            from .sorted_state import EMPTY_KEY
            cat_keys = torch.cat([sides[0], sides[5]])
            cat_live = torch.cat(live)
        if self.skew:
            # occupancy over both build sides (one key space, added
            # bucket by bucket) + the epoch's hot join keys of both deltas
            from ..kernels import vnode_hist
            occ = vnode_hist(new_b.jk, None, None, EMPTY_KEY,
                             out=vnode_hist(new_a.jk, None, None, EMPTY_KEY))
            stats += list(occ) + list(epoch_topk(cat_keys, cat_live,
                                                 EMPTY_KEY))
        if self.flow:
            stats += list(vnode_traffic(cat_keys, cat_live))
        return (new_a, new_b), out, stats, None


class MVPairNode(Node):
    """Terminal MV over a join's pair stream: a sorted multimap keyed by
    (left pk, right pk) holding the output columns (merge_side upsert)."""

    def __init__(self, input: int, val_dtypes: Sequence[torch.dtype],
                 capacity: int, device=None):
        self.device = resolve_device(device)
        self.inputs = (input,)
        self.val_dtypes = list(val_dtypes)
        self.capacity = capacity
        self.stat_names = ("needed", "rows_in")
        self.stat_sums = ("rows_in",)

    def init_state(self):
        from .join_step import make_side
        return make_side(self.capacity, self.val_dtypes, self.device)

    def cap_current(self):
        return {"main": self.capacity}

    def cap_needs(self, stats):
        return {"main": stats["needed"]}

    def cap_bytes(self):
        return {"main": 8 * (2 + len(self.val_dtypes))}

    def preset_caps(self, caps):
        self.capacity = max(self.capacity, caps.get("main", 0))

    def cap_resize(self, state, caps):
        from .join_step import grow_side
        if caps.get("main", 0) > state.jk.shape[0]:
            self.capacity = caps["main"]
            return grow_side(state, self.capacity)
        return state

    def adopt_state(self, state) -> None:
        self.capacity = state.jk.shape[0]

    def apply(self, state, ins, extra, epoch_events):
        from .join_step import merge_side
        d = ins[0]
        # masked pairs merge as no-ops (sign 0) and keep their place, so
        # the delta stays in the join's (left pk, right pk) order
        sign = torch.where(d.mask, d.sign, 0)
        vals = tuple(c if c.dtype.is_floating_point else c.to(torch.int64)
                     for c in d.cols)
        state, needed = merge_side(state, d.pk, d.pk2, sign, vals)
        return state, None, [needed.to(torch.int64),
                             _nrows(sign != 0)], None


@dataclass
class MVPull:
    """How the host materializes the terminal MV state into SQL rows."""
    kind: str                      # "keyed" | "pair"
    node_idx: int
    dtypes: List[DataType]
    decoders: List[Tuple]
    # keyed only: final column <- ("g", group_pos) | ("c", call_pos)
    agg: Optional[AggNode] = None
    out_map: Optional[List[Tuple[str, int]]] = None


class FusedProgram:
    """The chained node graph plus its stats-vector layout."""

    def __init__(self, nodes: List[Node], epoch_events: int, device=None):
        self.device = resolve_device(device)
        for n in nodes:
            if n.device != self.device:
                raise ValueError(f"{type(n).__name__} is on {n.device}, "
                                 f"the program on {self.device}")
        self.nodes, self.remap = _chain_nodes(nodes)
        self.epoch_events = epoch_events
        # an agg whose only consumers are terminal MV appliers never needs
        # its change-delta stream (they read the aux change set instead)
        delta_consumed: Dict[int, bool] = {}
        for n in self.nodes:
            for j in n.inputs:
                if not isinstance(n, MVKeyedNode):   # MVKeyed reads aux only
                    delta_consumed[j] = True
        for i, n in enumerate(self.nodes):
            if isinstance(n, AggNode) and not delta_consumed.get(i):
                n.emit_out = False
        self.stat_layout: List[Tuple[int, str]] = []
        for i, n in enumerate(self.nodes):
            for s in n.stat_names:
                self.stat_layout.append((i, s))
        # which stats slots accumulate by SUM (row-flow counters) vs MAX
        self.sum_mask = np.array(
            [name in self.nodes[ni].stat_sums
             for ni, name in self.stat_layout] or [False])
        self._sum_mask = torch.from_numpy(self.sum_mask).to(self.device)

    def init_states(self):
        return tuple(n.init_state() for n in self.nodes)

    def epoch(self, states, event_lo: int):
        """One epoch: every node's step in order, eagerly; only device
        tensors flow between nodes. A node's inputs are the output deltas
        of the nodes it names (one, or a join's left and right). Returns
        (states', stats vector)."""
        outs: List[Optional[Delta]] = []
        auxes: List[Any] = []
        new_states = list(states)
        stats: List[torch.Tensor] = []
        for i, node in enumerate(self.nodes):
            ins = [outs[j] for j in node.inputs]
            if node.takes_event_lo:
                extra = event_lo
            elif isinstance(node, MVKeyedNode):
                extra = auxes[node.inputs[0]]
            else:
                extra = None
            st, out, s, aux = node.apply(states[i], ins, extra,
                                         self.epoch_events)
            new_states[i] = st
            outs.append(out)
            auxes.append(aux)
            stats.extend(s)
        vec = torch.stack(stats) if stats \
            else torch.zeros((1,), dtype=torch.int64, device=self.device)
        return tuple(new_states), vec

    def step(self, states, event_lo: int, stats_acc: torch.Tensor):
        """(states, event_lo, stats_acc) -> (states', folded stats): sum
        slots add, capacity/flag slots keep the high-water."""
        new_states, vec = self.epoch(states, event_lo)
        acc = torch.where(self._sum_mask, stats_acc + vec,
                          torch.maximum(stats_acc, vec))
        return new_states, acc

    def node_stats(self, i: int, vec: np.ndarray) -> Dict[str, int]:
        return {name: int(vec[k]) for k, (ni, name)
                in enumerate(self.stat_layout) if ni == i}


# ---------------------------------------------------------------------------
# FusedJob: the host-side barrier loop
# ---------------------------------------------------------------------------


class FusedJob:
    """Owns the device state of one fused MV fragment.

    Barrier protocol: `on_barrier` DISPATCHES one epoch (no device sync);
    checkpoint barriers sync, verify the accumulated stats (pack bounds,
    capacity overflow) and advance the restore snapshot. Capacity
    overflow restores the last snapshot, grows, and deterministically
    replays — barrier-boundary exactness is never compromised by the
    asynchronous window.

    Overflow replays are PREDICTIVE and cascade-free: one overflow
    re-sizes every node from its observed entries-per-event rate
    extrapolated over `max_events` (clamped by the device-memory
    budget), so the replay does not immediately overflow a downstream
    node.
    """

    def __init__(self, name: str, program: FusedProgram, pull: MVPull,
                 max_events: Optional[int], device=None):
        self.device = resolve_device(device)
        if program.device != self.device:
            raise ValueError(f"program is on {program.device}, the job "
                             f"on {self.device}")
        if pull.kind not in ("keyed", "pair"):
            raise ValueError(f"unknown MV pull kind {pull.kind!r}")
        self.name = name
        self.program = program
        # node indices predate the chain transform — remap through it
        pull.node_idx = program.remap.get(pull.node_idx, pull.node_idx)
        self.pull = pull
        self.max_events = max_events
        self.growth_replays = 0
        self.counter = 0
        self.committed = 0
        self.states = program.init_states()
        self.snapshot = (self.states, 0)
        self._zero_stats = torch.zeros(
            (max(1, len(program.stat_layout)),), dtype=torch.int64,
            device=self.device)
        self.stats_acc = self._zero_stats
        # the last pulled stats vector (sync) and the job-lifetime totals
        # of the committed windows (sum slots add, max slots high-water):
        # what skew_report reads
        self._last_stats = np.zeros(len(self._zero_stats), np.int64)
        self._stat_totals = np.zeros(len(self._zero_stats), np.int64)
        # per flow-armed node: an EWMA over the checkpoint windows'
        # traffic, fed at every checkpoint
        self._traffic_ewma: Dict[int, Any] = {}

    # ---- barrier protocol ----------------------------------------------
    @property
    def drained(self) -> bool:
        return self.max_events is not None \
            and self.counter >= self.max_events

    def on_barrier(self, barrier) -> None:
        """Dispatch this barrier's epoch; at a checkpoint barrier, sync and
        commit. `barrier` needs `is_checkpoint` and `epoch.curr`."""
        if not self.drained:
            self._dispatch_epoch()
        if barrier.is_checkpoint:
            self._checkpoint(barrier.epoch.curr)

    def _dispatch_epoch(self) -> None:
        """Dispatch ONE epoch (asynchronously: nothing here reads the
        device)."""
        self.states, self.stats_acc = self.program.step(
            self.states, self.counter, self.stats_acc)
        self.counter += self.program.epoch_events

    def _dispatch_range(self, lo: int, hi: int) -> None:
        """Replay epochs [lo, hi) as pure device dispatch."""
        e = self.program.epoch_events
        c = lo
        while c < hi:
            self.states, self.stats_acc = self.program.step(
                self.states, c, self.stats_acc)
            c += e

    def _predict_caps(self, needs: Dict[int, Dict[str, int]],
                      needs_cum: Dict[int, Dict[str, int]],
                      needs_epoch: Dict[int, Dict[str, int]]
                      ) -> Dict[int, Dict[str, int]]:
        """Bucketed capacity targets for EVERY node (cascade-free): each
        slot's cumulative component is extrapolated over max_events, its
        per-epoch component gets flat headroom, and everything is scaled
        down toward the observed need when the summed projection exceeds
        the memory budget (never below need or current)."""
        from .capacity import project, project_epoch
        events = max(1, self.counter)
        plans = []           # [node, slot, need, current, bytes/slot, proj]
        for i, node in enumerate(self.program.nodes):
            cur = node.cap_current()
            if not cur:
                continue
            bpe = node.cap_bytes()
            nd = needs.get(i) or {}
            ndc = needs_cum.get(i) or {}
            nde = needs_epoch.get(i) or {}
            for s, c in cur.items():
                n = nd.get(s, 0)
                p = max(c, n, project(ndc.get(s, 0), events, self.max_events),
                        project_epoch(nde.get(s, 0)))
                plans.append([i, s, n, c, bpe.get(s, 16), p])
        budget = HBM_BUDGET_MB << 20
        total = sum(_bucket(p[5]) * p[4] for p in plans)
        if total > budget:
            scale = budget / total
            for p in plans:
                p[5] = max(p[2], p[3], int(p[5] * scale))
        out = {}
        for i, s, n, c, _, p in plans:
            out.setdefault(i, {})[s] = _bucket(max(n, p), lo=c)
        return out

    def sync(self) -> None:
        """Block; verify stats; grow + replay from the snapshot when any
        state overflowed its capacity."""
        while True:
            vec = self.stats_acc.cpu().numpy()
            self._last_stats = vec
            for k, (ni, nm) in enumerate(self.program.stat_layout):
                if nm == "packbad" and vec[k] != 0:
                    raise RuntimeError(
                        f"fused job {self.name}: packed-key bounds violated "
                        f"at node {ni} ({type(self.program.nodes[ni]).__name__}"
                        ") — a column left its statically proven range.")
            needs, needs_cum, needs_epoch = {}, {}, {}
            for i, node in enumerate(self.program.nodes):
                st = self.program.node_stats(i, vec)
                needs[i] = node.cap_needs(st)
                needs_cum[i] = node.cap_needs_cum(st)
                needs_epoch[i] = node.cap_needs_epoch(st)
            overflow = any(
                needs[i].get(s, 0) > c
                for i, node in enumerate(self.program.nodes)
                for s, c in node.cap_current().items())
            if not overflow:
                return
            targets = self._predict_caps(needs, needs_cum, needs_epoch)
            snap_states, snap_counter = self.snapshot
            new_states = []
            for i, node in enumerate(self.program.nodes):
                cur = node.cap_current()
                want = targets.get(i) or {}
                grown = {s: want[s] for s in want if want[s] > cur.get(s, 0)}
                if grown:
                    new_states.append(node.cap_resize(snap_states[i],
                                                      grown))
                else:
                    new_states.append(snap_states[i])
            self.growth_replays += 1
            target = self.counter
            self.states = tuple(new_states)
            self.snapshot = (self.states, snap_counter)
            self.counter = snap_counter
            self.stats_acc = self._zero_stats
            self._dispatch_range(snap_counter, target)
            self.counter = target

    def _checkpoint(self, epoch: int) -> None:
        """Sync, fold the window's stats into the job totals, advance the
        restore snapshot, and feed the traffic EWMAs."""
        self.sync()
        # after the sync's replays: the vector covers the committed window
        # once
        self._accum_totals(self._last_stats)
        self.snapshot = (self.states, self.counter)
        self.stats_acc = self._zero_stats
        self.committed = self.counter
        self._update_traffic_ewma()

    def load_states(self, states, counter: int) -> None:
        """Install states built elsewhere (`state_io.states_from_numpy`)
        as the committed snapshot at event `counter`."""
        for node, st in zip(self.program.nodes, states):
            node.adopt_state(st)
        self.states = tuple(states)
        self.snapshot = (self.states, counter)
        self.counter = self.committed = counter
        self.stats_acc = self._zero_stats

    # ---- telemetry surfaces --------------------------------------------
    def _accum_totals(self, vec: np.ndarray) -> None:
        sm = self.program.sum_mask
        self._stat_totals = np.where(sm, self._stat_totals + vec,
                                     np.maximum(self._stat_totals, vec))

    def _update_traffic_ewma(self) -> None:
        """Feed each flow-armed node's EWMA the cumulative tv* totals (it
        differences consecutive checkpoints itself)."""
        from .skew_stats import SK_BUCKETS, TrafficEwma
        for i, node in enumerate(self.program.nodes):
            if not node.flow:
                continue
            st = self.program.node_stats(i, self._stat_totals)
            ew = self._traffic_ewma.setdefault(i, TrafficEwma())
            ew.update([st.get(f"tv{b}", 0) for b in range(SK_BUCKETS)])

    def skew_report(self) -> List[Tuple]:
        """Rows (node, type, metric, ordinal, key, value, share) for the
        skew- and flow-armed nodes, from the committed totals (no device
        traffic): 'vnode_occ' per bucket (high-water live keys, share of
        the total), 'skew_ratio', 'hot_key' per rank (the 40-bit key and
        its per-epoch row count); then 'vnode_traffic' per bucket (routed
        rows), 'traffic_skew', 'traffic_div' and 'traffic_burst'."""
        from .skew_stats import (SK_BUCKETS, SK_TOPK, skew_ratio,
                                 traffic_divergence, unpack_hot)
        out: List[Tuple] = []
        for i, node in enumerate(self.program.nodes):
            if not (node.skew or node.flow):
                continue
            st = self.program.node_stats(i, self._stat_totals)
            tname = type(node).__name__
            occ = [st.get(f"skv{b}", 0) for b in range(SK_BUCKETS)]
            if node.skew:
                total = sum(occ)
                for b, c in enumerate(occ):
                    out.append((i, tname, "vnode_occ", b, None, c,
                                c / total if total else 0.0))
                out.append((i, tname, "skew_ratio", 0, None, int(total),
                            skew_ratio(occ)))
                for r in range(SK_TOPK):
                    key, count = unpack_hot(st.get(f"skh{r}", 0))
                    if count > 0:
                        out.append((i, tname, "hot_key", r, key, count,
                                    None))
            if node.flow:
                tv = [st.get(f"tv{b}", 0) for b in range(SK_BUCKETS)]
                ttot = sum(tv)
                for b, c in enumerate(tv):
                    out.append((i, tname, "vnode_traffic", b, None, c,
                                c / ttot if ttot else 0.0))
                out.append((i, tname, "traffic_skew", 0, None, int(ttot),
                            skew_ratio(tv)))
                if node.skew:
                    out.append((i, tname, "traffic_div", 0, None,
                                int(ttot), traffic_divergence(tv, occ)))
                ew = self._traffic_ewma.get(i)
                if ew is not None:
                    out.append((i, tname, "traffic_burst", 0, None,
                                int(ttot), ew.burst_ratio()))
        return out

    def node_skew_ratio(self, i: int) -> Optional[float]:
        """Occupancy skew ratio of node i, or None when it is not
        skew-armed."""
        from .skew_stats import SK_BUCKETS, skew_ratio
        if not self.program.nodes[i].skew:
            return None
        st = self.program.node_stats(i, self._stat_totals)
        return skew_ratio([st.get(f"skv{b}", 0) for b in range(SK_BUCKETS)])

    # ---- MV materialization --------------------------------------------
    def _pull_rows(self) -> List[Tuple]:
        st = self.states[self.pull.node_idx]
        if self.pull.kind == "pair":
            # the pair multimap's live prefix, in (left pk, right pk) order
            n = int(st.count)
            out_cols = [_format_col(dt, dec, v[:n].cpu().numpy(), None)
                        for dt, dec, v in zip(self.pull.dtypes,
                                              self.pull.decoders, st.vals)]
            return list(zip(*out_cols)) if out_cols else [()] * n
        from .materialize import mv_rows
        dts = [c.acc_dtype for c in self.pull.agg.spec.calls]
        keys, cols, nulls = mv_rows(st, dts)
        gcols_np = _np_unpack(self.pull.agg.pack, keys)
        out_cols = []
        for pos, (kind, j) in enumerate(self.pull.out_map):
            src = gcols_np[j] if kind == "g" else cols[j]
            null = None if kind == "g" else nulls[j]
            out_cols.append(_format_col(
                self.pull.dtypes[pos], self.pull.decoders[pos],
                np.asarray(src), null))
        return [tuple(c[i] for c in out_cols) for i in range(len(keys))]

    def mv_rows_now(self) -> List[Tuple]:
        """Query serving: sync and pull the CURRENT MV rows, in key order."""
        self.sync()
        return self._pull_rows()


def _np_unpack(pack: PackPlan, keys: np.ndarray) -> List[np.ndarray]:
    out = []
    shift = 0
    for f in pack.fields:
        v = (keys >> shift) & ((1 << f.bits) - 1)
        out.append(v * f.stride + f.offset)
        shift += f.bits
    return out


def _format_col(dtype: DataType, decoder: Tuple, vals: np.ndarray,
                nulls: Optional[np.ndarray]) -> List[Any]:
    """Device int64/f64 column -> host Python values matching the host
    executors' state-table representation exactly."""
    from .nexmark_gen import decode_column
    if decoder not in (("num",), ("ts",)):
        dec = decode_column(decoder, vals.astype(np.int64))
        out = list(dec)
    elif dtype.kind == TypeKind.DECIMAL:
        out = [Decimal(int(v)) for v in vals]
    elif dtype.kind in (TypeKind.FLOAT32, TypeKind.FLOAT64):
        out = [float(v) for v in vals]
    elif dtype.kind == TypeKind.BOOLEAN:
        out = [bool(v) for v in vals]
    else:
        out = [int(v) for v in vals]
    if nulls is not None:
        out = [None if nulls[i] else out[i] for i in range(len(out))]
    return out
