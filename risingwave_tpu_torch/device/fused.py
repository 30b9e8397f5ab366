"""Fused fragment runtime on PyTorch: a whole MV dataflow as one epoch
program (the single-device subset of `risingwave_tpu/device/fused.py`
that Nexmark q3a, q4, q5, q7 and q8 run, with the key-skew, flow and
state-tiering arms of its keyed nodes, fed by device datagen or by host
ingest).

Node graphs built from Source, Ingest, Hop, Map, Filter, Precombine, Agg
(with retractable min/max multisets), Join, MVKeyed and MVPair nodes run
every epoch as eager tensor ops over device-resident state; the host
barrier loop only dispatches. It synchronizes exclusively at checkpoints
and MV pulls (and, with state tiering, at a promotion's merge): each node's `apply` returns its stat scalars as device
tensors, the program stacks them into one vector, and the job folds that
vector across the epochs of a checkpoint window (sum for row counters,
max for capacity needs and violation flags). No node reads a value back
to the host, so an epoch never waits on the device.

Exactness: group keys are lossless bit-packings chosen by static interval
analysis and verified on device — a value outside its proven range
raises at the next sync. Capacity overflow restores the last checkpoint
snapshot, grows every node predictively, and deterministically replays
the window (the sources are pure functions of the event id; a host-fed
job replays its retained ingest windows). The same determinism is the
recovery: a device fault rebuilds the state and replays the committed
history and the crash window in place, and a restart replays the job to
its committed counter.

State tiering (`device/tiering.py`): every keyed node stamps a
last-touched epoch per row; under memory pressure the job demotes the
oldest keys of a host-fed node to host cold stores at a checkpoint and
promotes them back before any epoch whose input touches them, so the
device tables stay inside the memory budget and the MV stays exact.

Mesh sharding (`device/shard_exec.py`, `parallel/mesh.py`): with a mesh,
every node runs once per shard over vnode-block-partitioned state, each
agg and join input exchanged to its key's owning shard first (a node's
`shard_spec`; the exchange bucket is the "exch" capacity slot), the
stats reduced across shards, and the MV pull merges the shards' sorted
runs — the rows equal the 1-shard run's, in order.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from decimal import Decimal
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dtypes import DataType, TypeKind
from ..expr.expression import InputRef
from ..kernels.binding import KernelLaunchError
from ..kernels.expr_eval import Lowered, expr_eval
from . import resolve_device
from ..utils.failpoint import FailpointError, declare, failpoint
from .capacity import bucket as _bucket

# the device-path failure seams: the epoch dispatch, the blocking pull of
# a sync, the growth replay's re-dispatch and the checkpoint commit. An
# armed point, or a real device fault (`_is_device_fault`), routes the job
# through in-place recovery (`FusedJob._recover_in_place`).
declare("fused.dispatch",
        "fail a fused epoch dispatch (device-path fault mid-epoch)")
declare("fused.device_sync",
        "fail the blocking device sync of a fused checkpoint/SELECT")
declare("fused.growth_replay",
        "fail a fused capacity growth replay mid-re-dispatch")
declare("fused.checkpoint_commit",
        "fail a fused job-state checkpoint commit")


EPOCH_LOG_SPILL = "epoch_log_spill.jsonl"
# the offline skew surface: the skew_report rows of every job of a data
# directory, rewritten at each checkpoint
SKEW_FILE = "skew_stats.json"


class _EpochLog:
    """Bounded log of the epochs dispatched since the last checkpoint,
    one (event_lo, events) pair each: the crash window an in-place
    recovery re-dispatches. Past `cap_bytes` the oldest half spills to
    `epoch_log_spill.jsonl` in the data directory and `entries()` reloads
    it; `clear()` (the checkpoint trim) drops both tiers. Without a data
    directory the log stays in memory. The file has one name per
    directory: two jobs that both spill in one directory share it."""

    ENTRY_BYTES = 16               # accounting unit per (lo, events) pair

    def __init__(self, cap_bytes: int, dir_of):
        self.cap_entries = max(8, int(cap_bytes) // self.ENTRY_BYTES)
        self._dir_of = dir_of      # () -> Optional[data dir], late-bound
        self._mem: List[Tuple[int, int]] = []
        self.spilled = 0           # entries in the spill file now
        self.spill_total = 0       # entries ever spilled

    def _spill_path(self) -> Optional[str]:
        d = self._dir_of()
        return os.path.join(d, EPOCH_LOG_SPILL) if d else None

    def append(self, lo: int, events: int) -> None:
        self._mem.append((int(lo), int(events)))
        if len(self._mem) <= self.cap_entries:
            return
        path = self._spill_path()
        if path is None:
            return
        cut = len(self._mem) // 2
        # a window's first spill truncates: a crashed predecessor's file
        # never splices into this window
        with open(path, "w" if self.spilled == 0 else "a") as f:
            for pair in self._mem[:cut]:
                f.write(json.dumps(pair) + "\n")
        self.spilled += cut
        self.spill_total += cut
        del self._mem[:cut]

    def entries(self) -> List[Tuple[int, int]]:
        """The whole retained window, oldest first: the spill file, then
        memory."""
        out: List[Tuple[int, int]] = []
        if self.spilled:
            path = self._spill_path()
            if path and os.path.exists(path):
                with open(path) as f:
                    for ln in f:
                        ln = ln.strip()
                        if ln:
                            lo, ev = json.loads(ln)
                            out.append((int(lo), int(ev)))
        out.extend(self._mem)
        return out

    def clear(self) -> None:
        self._mem.clear()
        path = self._spill_path()
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass
        self.spilled = 0

    def __len__(self) -> int:
        return self.spilled + len(self._mem)


def _is_device_fault(e: BaseException) -> bool:
    """Failures in-place recovery may absorb: an armed `fused.*`
    failpoint, an error the CUDA runtime raised (out of memory, a
    `torch.AcceleratorError` where torch has it) and a kernel launch the
    runtime refused (`KernelLaunchError`). Argument checks (`ValueError`),
    packed-key bound violations (a plain `RuntimeError`) and control flow
    always propagate: replaying a bug would loop."""
    if isinstance(e, (KeyboardInterrupt, SystemExit)):
        return False
    if isinstance(e, (FailpointError, KernelLaunchError,
                      torch.OutOfMemoryError)):
        return True
    acc = getattr(torch, "AcceleratorError", None)
    return acc is not None and isinstance(e, acc)


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


@dataclass(frozen=True)
class ShardExchange:
    """One input of a node that must be vnode-routed before the node's
    per-shard step can run: rows of `inputs[input]` whose key (packed from
    `key_idx` with the node's PackPlan) hashes to another shard's vnode
    block travel through the exchange (`shard_exec.exchange_delta`).
    `carry_pk` keeps the delta's row identity through the shuffle (joins
    net pairs by it). `ref_idx` names the input columns the node reads
    (None = all): only those ship — the routed delta zero-fills the rest,
    which the node by declaration never touches. `packed`: the routing key
    column already IS the packed key (pre-combined agg deltas carry it as
    column 0)."""
    input: int
    key_idx: Tuple[int, ...]
    carry_pk: bool = False
    ref_idx: Optional[Tuple[int, ...]] = None
    packed: bool = False


@dataclass(frozen=True)
class ShardSpec:
    """A node's mesh-sharding contract: `state` says how its device state
    partitions over the shards — "local" (stateless, or per-shard
    private) or "vnode" (keyed by the vnode of its group / join key, the
    contiguous-block layout of `parallel/mesh.py`) — and `exchanges` names
    the inputs that need the cross-vnode shuffle first."""
    state: str = "local"
    exchanges: Tuple[ShardExchange, ...] = ()


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


def _expr_sig(e) -> Tuple:
    """Structural signature of a device expression (the port's copy of the
    reference's `_expr_sig`): class, return type, column indices,
    literals, function names, constant shifts and the scalar fields of
    any other expression class, then the children's signatures. Built
    from values only (no `id()`), so it is the same in every process."""
    from ..expr.expression import FunctionCall, Literal
    kids = tuple(_expr_sig(c)
                 for c in (e.children() if hasattr(e, "children") else []))
    base: Tuple = (type(e).__name__, str(getattr(e, "return_type", None)))
    if isinstance(e, InputRef):
        base += (e.index,)
    elif isinstance(e, Literal):
        base += (repr(e.value),)
    elif isinstance(e, FunctionCall):
        base += (e.name,)
    elif hasattr(e, "delta"):          # fuse_planner._TsShift
        base += (e.delta,)
    else:
        base += tuple(sorted(
            (k, v) for k, v in vars(e).items()
            if isinstance(v, (bool, int, float, str)) or v is None))
    return base + (kids,)


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
    # state tiering (device/tiering.py): keyed nodes carry a
    # last-touched-epoch column beside their key table and report
    # residency / coldness scalars (tres, tcold) when armed
    tier: bool = False
    # host ingest: this node's `extra` is its staged feed
    takes_feed: bool = False
    # mesh sharding (device/shard_exec.py): the per-(source, destination)
    # bucket capacity of the exchange. None = this node runs unexchanged
    # (stateless nodes, or a program without a mesh); agg and join nodes
    # get it from enable_exchange. A capacity slot ("exch"): the epoch's
    # fullest bucket rides the stats vector into grow + replay.
    exch: Optional[int] = None
    # device bytes per exch slot (budget math): one buffered row across
    # the n destination buckets (set by fuse_planner.arm_exchange)
    exch_bytes: int = 256
    # hot-key replication (device/shard_exec.py; JoinNode only): keys
    # (40-bit masked, the heavy-hitter form) whose rows the exchange
    # special-cases — input `hot_rep_side`'s rows broadcast to every
    # shard, the other input's rows salt by row identity. Routing only:
    # the node's step is unchanged and the keys never enter its
    # signature. Adopted only by FusedJob's checkpoint policy switch
    # (rebuild-replay), so placement stays consistent with the state.
    hot_keys: Tuple[int, ...] = ()
    hot_rep_side: int = 1
    # armed by the planner when hot-key replication and skew telemetry
    # are on: the node is a candidate for the hot-key policy
    hotrep: bool = False

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

    def enable_tiering(self) -> None:
        """Arm recency tracking (before the program is built: the touch
        column wraps the state and two slots, after skew's and flow's,
        extend the stat layout). tres = live keys, tcold = live keys
        untouched for >= TIER_TTL epochs; both MAX-accumulated. No-op for
        un-keyed nodes."""
        if self.keyed and not self.tier:
            self.tier = True
            self.stat_names = tuple(self.stat_names) + ("tres", "tcold")

    # ---- mesh sharding (declarative; device/shard_exec.py executes) ----
    def shard_spec(self) -> ShardSpec:
        """How this node shards over the mesh. Default: stateless / local
        — it runs per shard over whatever rows arrive, no exchange."""
        return ShardSpec()

    def enable_exchange(self, cap: int,
                        slot_bytes: Optional[int] = None) -> None:
        """Arm the exchange of this node's flagged inputs (before the
        program is built, after every telemetry arm: the bucket's fill,
        "exch", is appended to the stat layout and must stay last). The
        [n, exch] send bucket becomes a capacity slot."""
        if not self.shard_spec().exchanges:
            raise ValueError(f"{type(self).__name__} has no exchange stage")
        if self.exch is None:
            self.stat_names = tuple(self.stat_names) + ("exch",)
        self.exch = int(cap)
        if slot_bytes is not None:
            self.exch_bytes = int(slot_bytes)

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

    def _sig(self) -> Tuple:
        """Structural signature: everything that shapes this node's step
        (types, expressions, dtypes, pack plans, arms) and nothing that
        does not (names, program indices). `node_shape_key` digests it."""
        raise NotImplementedError

    def _arm_sig(self) -> Tuple:
        """The armed telemetry and tiering, appended to a keyed node's
        signature only when armed (an un-armed signature keeps its
        shape)."""
        return tuple(a for a, on in (("skew", self.skew), ("flow", self.flow),
                                     ("tier", self.tier)) if on)


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

    def _sig(self):
        return (self.table, tuple(self.gencfg), tuple(self.col_names),
                self.rowid_pos, self.max_events)

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


class IngestNode(Node):
    """Host-fed twin of SourceNode (`device/ingest.py`): the epoch's rows
    arrive as a staged device feed — (count, pk, *shipped columns), each
    column a fixed capacity (the epoch cadence) with the live row count
    masked in — instead of being generated on the device. Carries the
    same static column metadata as SourceNode (dtypes, surrogate
    decoders, proven ranges), so downstream packing proofs are the
    same."""

    takes_feed = True
    stat_names = ("rows_out",)
    stat_sums = ("rows_out",)

    def __init__(self, table: str, gencfg, col_names: Sequence[str],
                 rowid_pos: Optional[int], max_events: Optional[int],
                 schema_dtypes: Sequence[DataType], device=None):
        SourceNode.__init__(self, table, gencfg, col_names, rowid_pos,
                            max_events, schema_dtypes, device=device)
        # feed-column pruning (`fuse_planner.prune_ingest_columns`,
        # before the program is built): only these column positions ship;
        # the rest are dead downstream and zero-filled. None = all ship.
        self.live: Optional[Tuple[int, ...]] = None

    def set_live(self, live: Sequence[int]) -> None:
        live = tuple(sorted(set(int(i) for i in live)))
        if len(live) < len(self.col_names):
            self.live = live

    def _sig(self):
        return ("ingest", self.table, tuple(self.gencfg),
                tuple(self.col_names), self.rowid_pos, self.max_events,
                self.live)

    def apply(self, state, ins, extra, epoch_events):
        cnt, pk = extra[0], extra[1]
        shipped = list(extra[2:])
        n = pk.shape[0]
        if self.live is None:
            cols = shipped
        else:
            zero = torch.zeros((n,), dtype=torch.int64, device=self.device)
            cols = [zero] * len(self.col_names)
            for k, ci in enumerate(self.live):
                cols[ci] = shipped[k]
        # the feed is capacity-padded: only its first `cnt` rows are this
        # epoch's (the rest hold stale bytes of a reused buffer)
        mask = torch.arange(n, dtype=torch.int64, device=self.device) < cnt
        d = Delta(cols, torch.ones((n,), dtype=torch.int32,
                                   device=self.device), mask, pk=pk)
        return state, d, [_nrows(mask)], None


class MapNode(Node):
    """Project: device-evaluable expressions over the input delta. Bare
    column references pass their tensors through; the computed outputs
    are lowered once, here, into one `expr_eval` program (one launch an
    epoch, none when every output is a column reference). A Map keeps
    values only: a NULL row carries the value its expression computes."""

    stat_names = ("rows_in", "rows_out")
    stat_sums = ("rows_in", "rows_out")

    def __init__(self, input: int, exprs: Sequence[Any], device=None):
        self.device = resolve_device(device)
        self.inputs = (input,)
        self.exprs = list(exprs)
        computed = [e for e in self.exprs if not isinstance(e, InputRef)]
        self.lowered = Lowered(computed, "map") if computed else None

    def _sig(self):
        return tuple(_expr_sig(e) for e in self.exprs) + ("rio",)

    def apply(self, state, ins, extra, epoch_events):
        d = ins[0]
        made = iter(expr_eval(self.lowered.program(d.cols), d.cols)
                    if self.lowered else [])
        cols = [d.cols[e.index] if isinstance(e, InputRef) else next(made)
                for e in self.exprs]
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
        self.lowered = Lowered(pred, "mask")

    def _sig(self):
        return (_expr_sig(self.pred), "rio")

    def apply(self, state, ins, extra, epoch_events):
        d = ins[0]
        out = Delta(d.cols, d.sign,
                    expr_eval(self.lowered.program(d.cols), d.cols, d.mask),
                    pk=d.pk, pk2=d.pk2)
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

    def _sig(self):
        return (self.time_col, self.hop, self.size, "rio")

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

    def _sig(self):
        return tuple((type(n).__name__,) + n._sig() for n in self.chain)

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


def _pad_zeros(t: torch.Tensor, n: int) -> torch.Tensor:
    """`t` zero-padded at the tail to length n."""
    pad = n - t.shape[0]
    if pad <= 0:
        return t
    return torch.cat([t, torch.zeros((pad,), dtype=t.dtype,
                                     device=t.device)])


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

    def _sig(self):
        return ("pre", tuple(self.group_idx),
                tuple((c.kind, c.arg) for c in self.calls), self.pack,
                self.spec)

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
    (`spec.minputs`), each a capacity slot `ms{i}` of its own. Tier-armed,
    the state is a `TieredState` whose touch column rides with the key
    table."""

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

    def shard_spec(self):
        if self.combined:
            # the pre-combined delta carries its packed group key as
            # column 0: route by it verbatim; the merge reads every column
            return ShardSpec("vnode", (ShardExchange(0, (0,), packed=True),))
        # state partitions by the vnode of the packed group key; only the
        # columns apply() reads (group key + agg args) ship
        refs = sorted(set(self.group_idx)
                      | {c.arg for c in self.calls if c.arg is not None})
        return ShardSpec("vnode", (ShardExchange(
            0, tuple(self.group_idx), ref_idx=tuple(refs)),))

    def init_state(self):
        from .agg_step import DeviceAggState
        from .minput import ms_make
        state = DeviceAggState(
            self.spec.make_state(self.capacity, self.device),
            tuple(ms_make(c, self.device) for c in self.ms_caps))
        if self.tier:
            from .tiering import TieredState
            return TieredState(state, torch.zeros(
                (self.capacity,), dtype=torch.int64, device=self.device),
                torch.zeros((), dtype=torch.int64, device=self.device))
        return state

    def cap_current(self):
        caps = {"main": self.capacity}
        for i, c in enumerate(self.ms_caps):
            caps[f"ms{i}"] = c
        if self.exch is not None:
            caps["exch"] = self.exch
        return caps

    def cap_needs(self, stats):
        # `touched` guards the change-set compaction bound (2 * capacity):
        # an epoch touching more unique groups than capacity must grow and
        # replay even if enough groups died for the merge itself to fit
        needs = {"main": max(stats["needed"], stats.get("touched", 0))}
        for i in range(len(self.ms_caps)):
            needs[f"ms{i}"] = stats[f"ms{i}"]
        if self.exch is not None:
            needs["exch"] = stats.get("exch", 0)
        return needs

    def cap_needs_cum(self, stats):
        # live groups and multiset entries accumulate across epochs
        needs = {"main": stats["needed"]}
        for i in range(len(self.ms_caps)):
            needs[f"ms{i}"] = stats[f"ms{i}"]
        return needs

    def cap_needs_epoch(self, stats):
        # the exchange bucket re-fills from scratch every epoch too
        needs = {"main": stats.get("touched", 0)}
        if self.exch is not None:
            needs["exch"] = stats.get("exch", 0)
        return needs

    def cap_bytes(self):
        from .minput import MS_SLOT_BYTES
        caps = {"main": 8 * (1 + len(self.spec.dtypes))}
        for i in range(len(self.ms_caps)):
            caps[f"ms{i}"] = MS_SLOT_BYTES
        if self.exch is not None:
            caps["exch"] = self.exch_bytes
        return caps

    def preset_caps(self, caps):
        self.capacity = max(self.capacity, caps.get("main", 0))
        for i in range(len(self.ms_caps)):
            self.ms_caps[i] = max(self.ms_caps[i], caps.get(f"ms{i}", 0))
        if self.exch is not None:
            self.exch = max(self.exch, caps.get("exch", 0))

    def cap_resize(self, state, caps):
        from .agg_step import DeviceAggState
        from .minput import ms_grow
        from .sorted_state import grow_state
        if self.exch is not None and caps.get("exch", 0) > self.exch:
            self.exch = caps["exch"]
        tstate = None
        if self.tier:
            tstate, state = state, state.inner
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
        out = DeviceAggState(main, tuple(ms))
        if tstate is None:
            return out
        # the touch column rides positionally with the key table: the
        # grown tail is EMPTY_KEY, whose rows carry touch 0
        from .tiering import TieredState
        return TieredState(out, _pad_zeros(tstate.touch, main.capacity),
                           tstate.tick)

    def adopt_state(self, state) -> None:
        if self.tier:
            state = state.inner
        self.capacity = state.main.capacity
        self.ms_caps = [m.capacity for m in state.minputs]

    def _sig(self):
        sig = (tuple(self.group_idx),
               tuple((c.kind, c.arg) for c in self.calls),
               self.pack, self.pk_pack, self.spec, self.emit_out)
        if self.combined:
            sig = sig + ("pre",)
        return sig + self._arm_sig()

    def _tier_tail(self, tstate, old_main, new_state, ch):
        """Touch maintenance after the merge: each surviving group carries
        its stamp across the merge's permutation (by key), the epoch's
        touched groups (the change set's keys) take the tick, and
        (tres, tcold) go to the stats. The `touch_stamp` kernel."""
        from ..kernels import touch_stamp
        from .tiering import TIER_TTL, TieredState
        ntouch, counts = touch_stamp(new_state.main.keys, old_main.keys,
                                     tstate.touch, ch["keys"], None,
                                     tstate.tick, TIER_TTL)
        return (TieredState(new_state, ntouch, tstate.tick + 1),
                [counts[0], counts[1]])

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
        from .skew_stats import epoch_topk, node_hists, weighted_topk
        from .sorted_state import EMPTY_KEY
        tstate = None
        if self.tier:
            tstate, state = state, state.inner
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
            table = new_main.keys
            # each combined row weighs its raw-row count: the traffic
            # totals equal the uncombined run's
            weights = cnt.abs() if self.flow else None
            if self.skew:
                # heavy hitters from the exact combined per-key counts
                top = weighted_topk(ch["keys"], ch["in_counts"], EMPTY_KEY)
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
            table, weights = new_state.main.keys, None
            if self.skew:
                top = epoch_topk(keys, live, EMPTY_KEY)
        if self.skew or self.flow:
            # occupancy and traffic in one launch
            occ, traffic = node_hists([table] if self.skew else [],
                                      keys if self.flow else None, live,
                                      weights, EMPTY_KEY)
            if self.skew:
                sk += list(occ) + list(top)
            if self.flow:
                sk += list(traffic)
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
            stats = head + [packbad, rows_in, rows_out] + sk
            if tstate is not None:
                new_state, tst = self._tier_tail(tstate, state.main,
                                                 new_state, ch)
                stats += tst
            return new_state, None, stats, aux
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
        stats = head + [packbad, rows_in, _nrows(mask)] + sk
        if tstate is not None:
            new_state, tst = self._tier_tail(tstate, state.main, new_state,
                                             ch)
            stats += tst
        return new_state, out, stats, ch


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

    def shard_spec(self):
        # co-partitioned with its agg: the change set is already on the
        # group key's owning shard — exchange-free
        return ShardSpec("vnode")

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

    def _sig(self):
        return ("mvk",) + self.agg._sig()

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
    (left pk, right pk); output columns = left columns then right.
    Tier-armed, each build side carries a touch column kept per join key
    (every row of one key shares the stamp)."""

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
        self.cond_lowered = None if cond is None else Lowered(cond, "mask")
        self.cap_a = self.cap_b = self.capacity = capacity
        self.m = pair_capacity
        self.l_val_dtypes = list(l_val_dtypes)
        self.r_val_dtypes = list(r_val_dtypes)
        self.stat_names = ("need_a", "need_b", "need_pairs", "packbad",
                           "rows_in", "rows_out")
        self.stat_sums = ("rows_in", "rows_out")

    def shard_spec(self):
        # both build sides partition by the vnode of the packed join key;
        # both input deltas shuffle first, keeping row identity (the pair
        # netting needs each side's pk)
        return ShardSpec("vnode",
                         (ShardExchange(0, tuple(self.l_keys), True),
                          ShardExchange(1, tuple(self.r_keys), True)))

    def init_state(self):
        from .join_step import make_side
        state = (make_side(self.cap_a, self.l_val_dtypes, self.device),
                 make_side(self.cap_b, self.r_val_dtypes, self.device))
        if self.tier:
            from .tiering import TieredState
            z = lambda c: torch.zeros((c,), dtype=torch.int64,
                                      device=self.device)
            return TieredState(state, (z(self.cap_a), z(self.cap_b)),
                               torch.zeros((), dtype=torch.int64,
                                           device=self.device))
        return state

    def cap_current(self):
        caps = {"a": self.cap_a, "b": self.cap_b, "pairs": self.m}
        if self.exch is not None:
            caps["exch"] = self.exch
        return caps

    def cap_needs(self, stats):
        needs = {"a": stats["need_a"], "b": stats["need_b"],
                 "pairs": stats["need_pairs"]}
        if self.exch is not None:
            needs["exch"] = stats.get("exch", 0)
        return needs

    def cap_needs_cum(self, stats):
        # build sides accumulate rows; the pair buffer does not
        return {"a": stats["need_a"], "b": stats["need_b"]}

    def cap_needs_epoch(self, stats):
        # the probe-output pair buffer is re-filled from scratch every
        # epoch: per-epoch-bounded, never horizon-extrapolated; so is the
        # exchange bucket
        needs = {"pairs": stats["need_pairs"]}
        if self.exch is not None:
            needs["exch"] = stats.get("exch", 0)
        return needs

    def cap_bytes(self):
        # pair buffer: two probe outputs carry both sides' payloads + ids
        pair = 16 * (3 + len(self.l_val_dtypes) + len(self.r_val_dtypes))
        caps = {"a": 8 * (2 + len(self.l_val_dtypes)),
                "b": 8 * (2 + len(self.r_val_dtypes)),
                "pairs": pair}
        if self.exch is not None:
            caps["exch"] = self.exch_bytes
        return caps

    def preset_caps(self, caps):
        self.cap_a = max(self.cap_a, caps.get("a", 0))
        self.cap_b = max(self.cap_b, caps.get("b", 0))
        self.m = max(self.m, caps.get("pairs", 0))
        self.capacity = max(self.cap_a, self.cap_b)
        if self.exch is not None:
            self.exch = max(self.exch, caps.get("exch", 0))

    def cap_resize(self, state, caps):
        from .join_step import grow_side
        if self.exch is not None and caps.get("exch", 0) > self.exch:
            self.exch = caps["exch"]
        tstate = None
        if self.tier:
            tstate, state = state, state.inner
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
        if tstate is None:
            return (a, b)
        from .tiering import TieredState
        ta, tb = tstate.touch
        return TieredState((a, b), (_pad_zeros(ta, a.jk.shape[0]),
                                    _pad_zeros(tb, b.jk.shape[0])),
                           tstate.tick)

    def adopt_state(self, state) -> None:
        if self.tier:
            state = state.inner
        self.cap_a = state[0].jk.shape[0]
        self.cap_b = state[1].jk.shape[0]
        self.capacity = max(self.cap_a, self.cap_b)

    def _sig(self):
        return (tuple(self.l_keys), tuple(self.r_keys), self.pack,
                _expr_sig(self.cond) if self.cond is not None else None,
                tuple(str(d) for d in self.l_val_dtypes),
                tuple(str(d) for d in self.r_val_dtypes)) + self._arm_sig()

    def apply(self, state, ins, extra, epoch_events):
        from .join_step import local_join_step
        tstate = None
        if self.tier:
            tstate, state = state, state.inner
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
            omask = expr_eval(self.cond_lowered.program(ocols), ocols, omask)
        out = Delta(ocols, nsign, omask, pk=njk, pk2=npk)
        live = [d.mask & (d.sign != 0) for d in ins]
        rows_in = _nrows(live[0]) + _nrows(live[1])
        stats = [needed["a"].to(torch.int64), needed["b"].to(torch.int64),
                 needed["pairs"].to(torch.int64), packbad, rows_in,
                 _nrows(omask)]
        if self.skew or self.flow:
            from .skew_stats import epoch_topk, node_hists
            from .sorted_state import EMPTY_KEY
            cat_keys = torch.cat([sides[0], sides[5]])
            cat_live = torch.cat(live)
            # occupancy over both build sides (one key space, added
            # bucket by bucket) and the traffic of both deltas, in one
            # launch
            occ, traffic = node_hists(
                [new_a.jk, new_b.jk] if self.skew else [],
                cat_keys if self.flow else None, cat_live, None, EMPTY_KEY)
        if self.skew:
            # + the epoch's hot join keys of both deltas
            stats += list(occ) + list(epoch_topk(cat_keys, cat_live,
                                                 EMPTY_KEY))
        if self.flow:
            stats += list(traffic)
        if tstate is None:
            return (new_a, new_b), out, stats, None
        # touch per join key: a delta row on either input touches its key
        # on both sides; the rest carry the first old row's stamp
        from ..kernels import sort_cols, touch_stamp
        from .sorted_state import EMPTY_KEY
        from .tiering import TIER_TTL, TieredState
        (tkeys,), _ = sort_cols([torch.cat(
            [torch.where(lv, k, EMPTY_KEY)
             for lv, k in zip(live, (sides[0], sides[5]))])], [])
        ta, tb = tstate.touch
        nta, ca = touch_stamp(new_a.jk, a.jk, ta, tkeys, None, tstate.tick,
                              TIER_TTL)
        ntb, cb = touch_stamp(new_b.jk, b.jk, tb, tkeys, None, tstate.tick,
                              TIER_TTL)
        counts = ca + cb
        return (TieredState((new_a, new_b), (nta, ntb), tstate.tick + 1),
                out, stats + [counts[0], counts[1]], None)


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

    def shard_spec(self):
        # co-partitioned with its join: a pair lives on the shard owning
        # its join key's vnode block, and pair identity (left pk, right
        # pk) is globally unique — exchange-free
        return ShardSpec("vnode")

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

    def _sig(self):
        return (tuple(str(d) for d in self.val_dtypes),)

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


# ---------------------------------------------------------------------------
# Tiered-state device surgery (policy in device/tiering.py; FusedJob
# drives it, single device). An evict compacts the demoted keys out of a
# table in place at the same capacity (the `tier_partition` kernel); a
# promote is `merge` / `merge_side` of the exact stored payload followed
# by the touch carry (the `touch_stamp` kernel in its promote mode), so a
# demote -> promote round trip is exact.
# ---------------------------------------------------------------------------


def _agg_evict_core(tstate, dkeys, node):
    """Demote `dkeys` (sorted, EMPTY_KEY-padded) from a tiered agg state:
    -> (state without those rows — same capacity, count reduced —,
    found[L], payload vals at dkeys, touch at dkeys)."""
    from ..kernels import tier_partition
    from .agg_step import DeviceAggState
    from .sorted_state import EMPTY_KEY, SortedState, _neutral, lookup
    from .tiering import TieredState
    inner, touch = tstate.inner, tstate.touch
    main = inner.main
    cap = main.capacity
    found, dvals = lookup(main, dkeys)
    idx = torch.clamp(torch.searchsorted(main.keys, dkeys), 0, cap - 1)
    dtouch = torch.where(found, touch[idx], 0)
    fills = [EMPTY_KEY] + [_neutral(k, v.dtype) for v, k
                           in zip(main.vals, node.spec.kinds)] + [0]
    rows, _, counts = tier_partition(
        main.keys, [main.keys] + list(main.vals) + [touch], fills, dkeys)
    nmain = SortedState(rows[0], counts[0].clone(), tuple(rows[1:-1]))
    return (TieredState(DeviceAggState(nmain, inner.minputs), rows[-1],
                        tstate.tick), found, dvals, dtouch)


def _mv_evict_core(state, dkeys, node):
    """Lockstep MV demotion (the MVKeyedNode's SortedState, no touch)."""
    from ..kernels import tier_partition
    from .materialize import mv_kinds
    from .sorted_state import EMPTY_KEY, SortedState, _neutral, lookup
    found, dvals = lookup(state, dkeys)
    kinds = mv_kinds(len(node.agg.spec.calls))
    fills = [EMPTY_KEY] + [_neutral(k, v.dtype)
                           for v, k in zip(state.vals, kinds)]
    rows, _, counts = tier_partition(state.keys,
                                     [state.keys] + list(state.vals), fills,
                                     dkeys)
    return (SortedState(rows[0], counts[0].clone(), tuple(rows[1:])),
            found, dvals)


def _join_evict_core(tstate, dkeys, node, side: int):
    """Demote every row of the given join keys from ONE build side: ->
    (new tiered state, demoted jk / pk / vals / touch compacted to a
    prefix, n_demoted)."""
    from ..kernels import tier_partition
    from .join_step import JoinSide
    from .sorted_state import EMPTY_KEY
    from .tiering import TieredState
    a, b = tstate.inner
    ta, tb = tstate.touch
    s, st = (a, ta) if side == 0 else (b, tb)
    cols = [s.jk, s.pk] + list(s.vals) + [st]
    fills = [EMPTY_KEY, EMPTY_KEY] + [0] * len(s.vals) + [0]
    kept, gone, counts = tier_partition(s.jk, cols, fills, dkeys, hits=True)
    ns = JoinSide(kept[0], kept[1], counts[0].clone(), tuple(kept[2:-1]))
    new = ((ns, b), (kept[-1], tb)) if side == 0 else ((a, ns), (ta, kept[-1]))
    return (TieredState(new[0], new[1], tstate.tick), gone[0], gone[1],
            tuple(gone[2:-1]), gone[-1], counts[1].clone())


def _agg_promote_core(tstate, pkeys, pvals, ptouch, node):
    """Insert promoted rows (the exact stored payload and touch; keys
    ascending, EMPTY_KEY-padded at the tail) back into a tiered agg
    state: -> (state, merge `needed` — promotion can overflow capacity
    like any merge, which the next sync's grow-and-replay remedies)."""
    from ..kernels import touch_stamp
    from .agg_step import DeviceAggState
    from .sorted_state import merge
    from .tiering import TIER_TTL, TieredState
    inner = tstate.inner
    main = inner.main
    new_main, needed = merge(main, pkeys, pvals, node.spec.kinds)
    ntouch, _ = touch_stamp(new_main.keys, main.keys, tstate.touch, pkeys,
                            ptouch, tstate.tick, TIER_TTL)
    return (TieredState(DeviceAggState(new_main, inner.minputs), ntouch,
                        tstate.tick), needed)


def _mv_promote_core(state, pkeys, pvals, node):
    from .materialize import mv_kinds
    from .sorted_state import merge
    return merge(state, pkeys, pvals, mv_kinds(len(node.agg.spec.calls)))


def _join_promote_core(tstate, pa, pb, node):
    """Promote cold rows into BOTH build sides: per side (jk, pk, vals,
    touch), (jk, pk)-sorted, EMPTY_KEY-padded. -> (state, (needed_a,
    needed_b))."""
    from ..kernels import touch_stamp
    from .join_step import merge_side
    from .sorted_state import EMPTY_KEY
    from .tiering import TIER_TTL, TieredState
    a, b = tstate.inner
    ta, tb = tstate.touch

    def one(side, st, buf):
        jk, pk, vals, pt = buf
        sign = torch.where(jk != EMPTY_KEY, 1, 0).to(torch.int32)
        ns, needed = merge_side(side, jk, pk, sign, vals)
        nst, _ = touch_stamp(ns.jk, side.jk, st, jk, pt, tstate.tick,
                             TIER_TTL)
        return ns, nst, needed

    na, nta, need_a = one(a, ta, pa)
    nb, ntb, need_b = one(b, tb, pb)
    return (TieredState((na, nb), (nta, ntb), tstate.tick),
            (need_a, need_b))


def node_shape_key(node: Node) -> str:
    """Deterministic digest of a node's structural signature (the port's
    copy of the reference's): stable across processes and planner
    refactors, unlike `hash()` (salted for strings) and unlike program
    indices. Keys the capacity presize registry."""
    import hashlib
    sig = repr((type(node).__name__, node._sig()))
    return hashlib.sha1(sig.encode()).hexdigest()[:16]


def plan_shape_hash(nodes: Sequence[Node], epoch_events: int,
                    mesh_shards: int = 1) -> str:
    """Structural hash of a fused plan: node signatures, topology (input
    edges), the epoch cadence and the mesh shard count — and nothing
    else (no names, no program indices). Two CREATEs of identically
    shaped jobs collide here by design (the warm start's presize); an
    n-shard and a 1-shard plan never collide, since their capacities are
    per-shard and global quantities."""
    import hashlib
    parts = [(node_shape_key(n), n.inputs) for n in nodes]
    if mesh_shards > 1:
        parts.append(("mesh_shards", mesh_shards))
    return hashlib.sha1(repr((parts, epoch_events)).encode()).hexdigest()[:16]


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
    """The chained node graph plus its stats-vector layout.

    With a `mesh` (`parallel/mesh.py`), every node runs once per shard
    (`device/shard_exec.py`): keyed state splits by vnode block into
    per-shard states, each flagged input is exchanged to its key's owning
    shard first, and the stat scalars reduce across shards. The nodes are
    built on the mesh's first device; a shard on another device runs them
    there. The exchange routes by `vnode_bounds` (None: the uniform
    blocks; a rebalanced job's custom bounds) and each node's hot keys;
    a host-fed node takes one feed per shard (its contiguous event
    block). With serving replicas (`mesh.replicas > 1`) every epoch ends
    by copying each shard's state into every replica column
    (`replica_states`)."""

    def __init__(self, nodes: List[Node], epoch_events: int, device=None,
                 mesh=None):
        self.mesh = mesh
        if mesh is not None:
            if device is not None \
                    and resolve_device(device) != mesh.device:
                raise ValueError(f"a mesh program runs on {mesh.device}, "
                                 f"not {device}")
            device = mesh.device
        self.device = resolve_device(device)
        for n in nodes:
            if n.device != self.device:
                raise ValueError(f"{type(n).__name__} is on {n.device}, "
                                 f"the program on {self.device}")
        self.nodes, self.remap = _chain_nodes(nodes)
        self.epoch_events = epoch_events
        # host wall seconds the last epoch() spent dispatching exchanges
        self.last_exchange_s = 0.0
        # vnode-block bounds the exchange routes by: None = the uniform
        # `vnode_block_bounds` layout; a rebalanced job's custom bounds,
        # chosen at a checkpoint. Routing only: no node step sees them.
        self.vnode_bounds: Optional[Tuple[int, ...]] = None
        # serving replicas: every node's states in each replica column
        # (`shard_exec.replicate_states`) and the states tuple they copy
        self.replica_states: Optional[List] = None
        self.replica_of = None
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
        # epoch profiler (utils/profile.py), attached by the owning
        # FusedJob; None (or disabled) = no per-node instrumentation
        self.profiler = None

    def init_states(self):
        states = tuple(n.init_state() for n in self.nodes)
        if self.mesh is not None:
            # identical empty shards: one copy per shard
            from .shard_exec import lift_tree
            states = tuple(lift_tree(s, self.mesh) for s in states)
        return states

    def resize_state(self, i: int, state, caps):
        """Grow node i's state to `caps` (every shard, under a mesh)."""
        node = self.nodes[i]
        if self.mesh is not None:
            from .shard_exec import sharded_resize
            return sharded_resize(node, state, caps, self.mesh)
        return node.cap_resize(state, caps)

    def _node_label(self, i: int) -> str:
        """Compile-event label, the reference's shape: program position,
        node type and the node's hash (its identity: the port builds
        nothing per node signature, so no two nodes share a step)."""
        n = self.nodes[i]
        return f"{i}:{type(n).__name__}:{hash(n) & 0xFFFFFFFF:08x}"

    def _profiled(self):
        prof = self.profiler
        return prof if prof is not None and prof.enabled else None

    def _time_step(self, prof, i: int, t0: float) -> None:
        """With a live profiler: a step flagged pending (a node's first
        step, or a grown node's first at its new capacity) or one whose
        host wall passed the compile threshold is recorded as a compile /
        retrace event. The wall is the launch path's only: no step waits
        for the device."""
        import time as _time
        from ..utils.profile import COMPILE_THRESHOLD_S
        dt = _time.perf_counter() - t0
        kind = prof.pending_compile.pop(i, None)
        if kind is not None or dt > COMPILE_THRESHOLD_S:
            prof.compile_event(self._node_label(i), dt,
                               kind=kind or "retrace")

    def epoch(self, states, event_lo: int, feeds=None):
        """One epoch: every node's step in order, eagerly; only device
        tensors flow between nodes. A node's inputs are the output deltas
        of the nodes it names (one, or a join's left and right). `feeds`
        maps an IngestNode's index to its staged feed. Returns (states',
        stats vector)."""
        if self.mesh is not None:
            return self._epoch_mesh(states, event_lo, feeds)
        import time as _time
        prof = self._profiled()
        outs: List[Optional[Delta]] = []
        auxes: List[Any] = []
        new_states = list(states)
        stats: List[torch.Tensor] = []
        for i, node in enumerate(self.nodes):
            ins = [outs[j] for j in node.inputs]
            if node.takes_event_lo:
                extra = event_lo
            elif node.takes_feed:
                extra = feeds[i]
            elif isinstance(node, MVKeyedNode):
                extra = auxes[node.inputs[0]]
            else:
                extra = None
            if prof is not None:
                t0 = _time.perf_counter()
            st, out, s, aux = node.apply(states[i], ins, extra,
                                         self.epoch_events)
            if prof is not None:
                self._time_step(prof, i, t0)
            new_states[i] = st
            outs.append(out)
            auxes.append(aux)
            stats.extend(s)
        vec = torch.stack(stats) if stats \
            else torch.zeros((1,), dtype=torch.int64, device=self.device)
        return tuple(new_states), vec

    def _epoch_mesh(self, states, event_lo: int, feeds=None):
        """`epoch` over the mesh: each flagged input is exchanged to its
        key's owning shard (the "exch" stat, the fullest bucket, goes last
        in the node's stats), then the node steps on every shard; the
        per-shard stats reduce by psum (row-flow slots) and pmax (the
        rest) into one replicated vector."""
        import time as _time
        from .shard_exec import exchange_delta, reduce_stats, sharded_apply
        prof = self._profiled()
        mesh = self.mesh
        n = mesh.n
        outs: List[Optional[List[Delta]]] = []
        auxes: List[Any] = []
        new_states = list(states)
        per_shard: List[List[torch.Tensor]] = [[] for _ in range(n)]
        exchange_s = 0.0
        for i, node in enumerate(self.nodes):
            ins = [outs[j] for j in node.inputs]
            needs = None
            if node.exch is not None:
                t0 = _time.perf_counter()
                for xi, ex in enumerate(node.shard_spec().exchanges):
                    ins[ex.input], nd = exchange_delta(
                        mesh, node, xi, ins[ex.input],
                        bounds=self.vnode_bounds)
                    needs = nd if needs is None else \
                        [torch.maximum(a, b) for a, b in zip(needs, nd)]
                exchange_s += _time.perf_counter() - t0
            if isinstance(node, MVKeyedNode):
                extras = auxes[node.inputs[0]]
            elif node.takes_feed:
                # one feed per shard: its contiguous event block
                extras = feeds[i]
            else:
                extras = None
            if prof is not None:
                t0 = _time.perf_counter()
            st, out, s, aux = sharded_apply(
                mesh, node, self.epoch_events, states[i], ins, extras,
                event_lo)
            if prof is not None:
                self._time_step(prof, i, t0)
            new_states[i] = st
            outs.append(out)
            auxes.append(aux)
            for k in range(n):
                per_shard[k].extend(s[k])
                if needs is not None:
                    per_shard[k].append(needs[k])
        self.last_exchange_s = exchange_s
        new_states = tuple(new_states)
        if mesh.replicas > 1:
            self.refresh_replicas(new_states)
        if not self.stat_layout:
            return new_states, torch.zeros(
                (1,), dtype=torch.int64, device=self.device)
        return new_states, reduce_stats(mesh, per_shard, self._sum_mask)

    def refresh_replicas(self, states) -> None:
        """Copy every shard's state into each serving-replica column (a
        no-op when they already copy `states`)."""
        from .shard_exec import replicate_states
        if self.replica_of is states:
            return
        self.replica_states = replicate_states(self.mesh, states,
                                               self.replica_states)
        self.replica_of = states

    def step(self, states, event_lo: int, stats_acc: torch.Tensor,
             feeds=None):
        """(states, event_lo, stats_acc) -> (states', folded stats): sum
        slots add, capacity/flag slots keep the high-water."""
        new_states, vec = self.epoch(states, event_lo, feeds)
        acc = torch.where(self._sum_mask, stats_acc + vec,
                          torch.maximum(stats_acc, vec))
        return new_states, acc

    def node_stats(self, i: int, vec: np.ndarray) -> Dict[str, int]:
        return {name: int(vec[k]) for k, (ni, name)
                in enumerate(self.stat_layout) if ni == i}


# job-state table key schema (the reference's `_JS_*`): one (key, value)
# int64 row per fact, newest value wins
_JS_COUNTER = 0              # committed event counter
_JS_REPLAYS = 1              # cumulative growth replays
_JS_RETRACES = 2             # cumulative node re-traces from growth
_JS_GROWTHS = 3              # cumulative capacity-slot increases
_JS_CAP_BASE = 16            # + node_idx * stride + slot ordinal
_JS_CAP_STRIDE = 16          # minimum per-node key stride
# The mesh skew policy's rows (vnode rebalancing, hot-key replication):
# the routing must survive a restart, since the persisted capacities were
# sized under it. Values are VERSIONED (the policy sequence number in the
# high bits) because recovery max-combines duplicate keys: the newest
# policy's rows win, and every change rewrites every slot.
_JS_POLICY_SEQ = 4           # the bare policy sequence number
_JS_VB_BASE = 5              # + s: inner bound s + 1; seq << 16 | bound
_JS_VB_MAX = 10              # keys 5..14: bounds persist for <= 11 shards
_JS_REBALANCES = 15          # cumulative adopted policy switches
_JS_HOT_BASE = 1 << 40       # + node * (SK_TOPK + 1) + rank; value
                             # seq << 41 | key40 << 1 | present; the slot
                             # at rank SK_TOPK holds seq << 2 |
                             # hot_rep_side << 1 | armed


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
    extrapolated over `max_events` (clamped by `hbm_budget_mb`, the
    device-memory budget), so the replay does not immediately overflow a
    downstream node.

    With `ingest` (a `device/ingest.HostIngest`) every epoch's source rows
    come from its staged feeds instead of device datagen. With
    `tier_plans` (`fuse_planner.tier_plans`) and `state_tiering`, a
    `TieringManager` demotes cold keys at checkpoints and promotes them
    back before each dispatch.

    Observability (`utils/`): with `profile` (the default, as
    `DeviceConfig.profile`) a `JobProfiler` records one phase-split span
    per barrier that dispatches (pack, h2d, promote_h2d, dispatch,
    exchange, device_sync, demote_d2h, commit) and a compile event for
    each node's first step; `profiler.attach(data_dir)` mirrors them to
    `epoch_profile.jsonl`. A `FreshnessTracker` set as `freshness`
    receives one commit per checkpoint. `cadence_stretch` (the overload
    ladder's act step) dispatches that many epochs under one barrier.
    None of it waits for the device inside an epoch: the device's time
    lands in `device_sync`.

    Recovery: a device-path fault in a barrier's work (a `fused.*`
    failpoint, a refused kernel launch, a CUDA runtime error) heals in
    place (`_recover_in_place`: rebuild, replay the committed history,
    re-dispatch the crash window from the epoch log) and the barrier
    retries; `recover()` restarts a reopened job at its committed counter
    from the job table, presized, both tiers rebuilt from the tiering
    journal.
    """

    def __init__(self, name: str, program: FusedProgram, pull: MVPull,
                 max_events: Optional[int], device=None,
                 hbm_budget_mb: int = 4096, ingest=None,
                 state_tiering: bool = True, tier_plans=None,
                 profile: bool = True, mv_state_table=None,
                 job_state_table=None, mv_schema_len: Optional[int] = None,
                 persist_every: int = 1, predictive: bool = True,
                 plan_hash: Optional[str] = None, rebalance: bool = True,
                 rebalance_threshold: float = 2.0, hot_key_rep: bool = True,
                 hot_key_frac: float = 0.125):
        import time as _time
        from ..utils.profile import JobProfiler
        self.device = resolve_device(device)
        if program.device != self.device:
            raise ValueError(f"program is on {program.device}, the job "
                             f"on {self.device}")
        # data shards of the program's mesh (1 without one)
        self.mesh_shards = program.mesh.n if program.mesh is not None else 1
        if pull.kind not in ("keyed", "pair"):
            raise ValueError(f"unknown MV pull kind {pull.kind!r}")
        self.name = name
        self.program = program
        # structural identity of this plan (node signatures, topology,
        # epoch cadence, mesh shards): keys the warm-start presize
        # registry, so it survives DROP / re-CREATE and renames
        self.plan_hash = plan_hash or plan_shape_hash(
            program.nodes, program.epoch_events, self.mesh_shards)
        # epoch-timeline profiler: phase-split spans + compile events.
        # Every node's first step is its cold start.
        self.profiler = JobProfiler(name, enabled=profile,
                                    shards=self.mesh_shards)
        self.profiler.pending_compile = {
            i: "compile" for i in range(len(program.nodes))}
        program.profiler = self.profiler
        # data directory (the owner attaches it beside the profiler's)
        self.data_dir: Optional[str] = None
        # source->MV freshness (utils/freshness.py): the owner attaches a
        # tracker; each checkpoint then records commit wall - the wall of
        # the OLDEST epoch dispatch in the window (device datagen: the
        # dispatch is when the epoch's events come into existence; host
        # ingest: when its rows were polled)
        self.freshness = None
        self._window_ingest: Optional[float] = None
        # overload ladder (utils/overload.py): epochs dispatched per
        # barrier, > 1 on the degraded / shedding rungs. The MV is a
        # function of the event counter, not of where the barriers fall,
        # so a stretched job's rows are the same.
        self.cadence_stretch = 1
        # node indices predate the chain transform — remap through it
        pull.node_idx = program.remap.get(pull.node_idx, pull.node_idx)
        self.pull = pull
        self.max_events = max_events
        # the MV's host state table and the job's (key, value) state
        # table (`_JS_*`): with them, checkpoints mirror the MV every
        # `persist_every` epochs' worth of events (and at drain) and
        # persist the committed counter, growth counters and capacities
        self.mv_state_table = mv_state_table
        self.job_state_table = job_state_table
        self.mv_schema_len = mv_schema_len or len(pull.dtypes)
        self.persist_every = max(1, persist_every)
        self._last_persist = -1
        self._persisted: Dict[Tuple, None] = {}
        self._js_stride = max([_JS_CAP_STRIDE]
                              + [len(n.cap_current())
                                 for n in program.nodes])
        self._js_written: Dict[int, int] = {}
        # predictive growth (capacity.project); off = blind pow2 doubling
        # of the overflowed slots only
        self.predictive = predictive
        self.hbm_budget_mb = hbm_budget_mb
        # host-ingest stager: when set, each epoch's source input is a
        # staged feed taken from it; None = device datagen
        self.ingest = ingest
        # tiered state: host cold stores, the demotion journal, the Xor8
        # negative caches. A growth replay rewinds both tiers to the same
        # commit point (`TieringManager.rewind_window`), because the
        # window's promotions moved rows out of the stores.
        self.state_tiering = bool(state_tiering) and bool(tier_plans)
        self.tiering = None
        if state_tiering and tier_plans:
            from .tiering import TieringManager
            self.tiering = TieringManager(tier_plans, self.mesh_shards)
        # promotion merges report truncation like any step: their `needed`
        # high-waters fold here and join the next sync's overflow check
        self._promo_need: Dict[int, Dict[str, int]] = {}
        # host walls of the tier phases (seconds, summed over the run)
        self.tier_walls = {"promote_h2d": 0.0, "demote_d2h": 0.0}
        # growth accounting (cap_report): replays, grown node steps and
        # grown slots, cumulative
        self.growth_replays = 0
        self.retraces = 0
        self.growths = 0
        # the checkpoint-time skew-routing policy of a mesh job (vnode
        # rebalancing, hot-key replication): decided at a checkpoint from
        # the window's skew evidence, staged, and adopted at the NEXT
        # checkpoint by a rebuild-replay. A single-device job never
        # retunes.
        self.rebalance = bool(rebalance) and program.mesh is not None
        self.rebalance_threshold = float(rebalance_threshold)
        self.hot_key_rep = bool(hot_key_rep) and program.mesh is not None
        self.hot_key_frac = float(hot_key_frac)
        self.rebalances = 0          # adopted policy switches
        self._policy_seq = 0
        # the staged policy: (bounds, {node idx: (hot keys, side)}, ready)
        self._pending_policy: Optional[Tuple] = None
        # the epochs dispatched since the last checkpoint (the crash
        # window an in-place recovery re-dispatches), bounded by
        # ROBUSTNESS.fused_epoch_log_bytes, its overflow spilled to the
        # data directory
        from ..config import ROBUSTNESS
        self._epoch_log = _EpochLog(ROBUSTNESS.fused_epoch_log_bytes,
                                    lambda: self.data_dir)
        # in-place recoveries; the attempts reset at each checkpoint
        self.recoveries = 0
        self._recovery_attempts = 0
        self.counter = 0
        self.committed = 0
        # wall-clock anchor of the live eps columns (EXPLAIN ANALYZE)
        self.t_created = _time.monotonic()
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
        """Dispatch this barrier's epochs (`cadence_stretch` of them); at
        a checkpoint barrier, sync and commit. `barrier` needs
        `is_checkpoint` and `epoch.curr`. With the profiler on, the
        barrier is one span; a drained job's barriers get none (their
        zero-event records would evict the real history from the ring;
        a post-drain checkpoint's sync and commit still land in the
        phase totals)."""
        prof = self.profiler if self.profiler.enabled \
            and not self.drained else None
        stretch = max(1, int(self.cadence_stretch))
        e = self.program.epoch_events
        planned = stretch * e
        if self.max_events is not None:
            planned = min(planned, max(0, self.max_events - self.counter))
        if prof is not None:
            prof.begin_epoch(self.counter, planned or e)
        # a device-path fault anywhere in the barrier's work (dispatch,
        # sync, growth replay, commit) recovers in place and the rest of
        # the barrier retries. `dispatched` keeps the retry idempotent: a
        # fault in the checkpoint must not dispatch the epochs twice (the
        # recovery re-dispatched them from the epoch log); `todo` keeps
        # what a fault mid-stretch still owes this barrier.
        dispatched = False
        todo = stretch
        if self.ingest is not None and not self.drained:
            # one admission token per source authorizes one window: a
            # stretched barrier needs `stretch` of them
            self.ingest.epoch_refill(stretch)
        while True:
            try:
                if not self.drained and not dispatched:
                    while todo > 0 and not self.drained:
                        if not self._dispatch_epoch(prof):
                            break  # a deferred or empty ingest window
                        todo -= 1
                    dispatched = True
                if barrier.is_checkpoint:
                    self._checkpoint(barrier.epoch.curr)
                break
            except Exception as err:
                if not _is_device_fault(err):
                    raise
                self._recover_in_place(err)
        if prof is not None:
            prof.end_epoch()
        if self.profiler.enabled and barrier.is_checkpoint:
            # after end_epoch: the checkpoint epoch's own record (the one
            # with device_sync / commit) reaches the file now
            self.profiler.flush()

    def _dispatch_epoch(self, prof=None) -> bool:
        """Dispatch ONE epoch (asynchronously: nothing here reads the
        device, except a tier promotion's merge) and log it in the epoch
        log. A deferred or empty host-ingest window dispatches nothing
        and returns False. With `prof`, the host walls land in its pack /
        h2d / promote_h2d / exchange / dispatch phases — launch walls,
        none of them a device wait."""
        import time as _time
        if failpoint("fused.dispatch"):
            raise FailpointError("fused.dispatch")
        t0 = _time.perf_counter() if prof is not None else 0.0
        feeds = None
        events = self.program.epoch_events
        h2d_s = 0.0
        ingest_ts = None
        if self.ingest is not None:
            w, _pack_s, h2d_s = self.ingest.take(self.counter)
            if w.events <= 0:
                if prof is not None:
                    prof.phase("pack", _time.perf_counter() - t0)
                return False
            self.ingest.ready(w)
            feeds, events, ingest_ts = w.feeds, w.events, w.ingest_ts
        if self._window_ingest is None:
            # first dispatch since the last checkpoint: the next commit's
            # freshness is measured from here
            self._window_ingest = ingest_ts if ingest_ts is not None \
                else _time.time()
        elif ingest_ts is not None:
            self._window_ingest = min(self._window_ingest, ingest_ts)
        if prof is not None:
            t1 = _time.perf_counter()
            prof.phase("pack", t1 - t0 - h2d_s)
            if h2d_s > 0.0:
                prof.phase("h2d", h2d_s)
            t0 = t1
        if self.tiering is not None:
            # promotion BEFORE the step: the step must see every key of
            # the window that lives in a cold store
            self._tier_promote(self.counter, events, prof)
            if prof is not None:
                t0 = _time.perf_counter()
        self.states, self.stats_acc = self.program.step(
            self.states, self.counter, self.stats_acc, feeds)
        if prof is not None:
            dt = _time.perf_counter() - t0
            # the exchanges' launch wall is its own phase; it was measured
            # inside the dispatch window, so subtract to keep phases
            # disjoint
            ex = min(self.program.last_exchange_s, dt)
            if ex > 0.0:
                prof.phase("exchange", ex)
            prof.phase("dispatch", dt - ex)
        self._epoch_log.append(self.counter, events)
        self.counter += events
        return True

    def _recover_in_place(self, err: BaseException) -> None:
        """Recovery from a device-path fault without a restart: rebuild
        empty state at the current capacities, replay the committed
        history to `committed` (both tiers), re-anchor the snapshot, then
        re-dispatch the crash window from the epoch log. The sources are
        deterministic, so the MV equals an undisturbed run's. Past
        ROBUSTNESS.fused_recovery_attempts, or when the log does not run
        on from `committed`, the original error propagates."""
        import time as _time
        from ..config import ROBUSTNESS
        from ..utils.blackbox import RECORDER
        from ..utils.metrics import REGISTRY
        self._recovery_attempts += 1
        if self._recovery_attempts > max(1,
                                         ROBUSTNESS.fused_recovery_attempts):
            raise err
        t_rec = _time.perf_counter()
        target = self.committed
        window = self._epoch_log.entries()
        expect = target
        for lo, ev in window:
            if lo != expect:
                raise err          # a torn log cannot be replayed exactly
            expect += ev
        # work queued before the fault still writes the old tensors: let
        # it finish, drop the staged ingest window and the pending
        # recency pulls, and only then rebuild
        if self.program.mesh is not None:
            self.program.mesh.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.ingest is not None:
            self.ingest.drop_staged()
        # drop the old state before the rebuild allocates the new: one
        # copy of the state on the card, not three; the snapshot (None, 0)
        # is empty state at event 0 (`_sync_inner`)
        self.states = self.snapshot = None
        self.stats_acc = self._zero_stats
        self.states = self.program.init_states()
        self.snapshot = (None, 0)
        self.counter = 0
        self._promo_need = {}
        if self.tiering is not None:
            self.tiering.reset_stores()
        if target:
            self._replay_history(target)
            self.counter = target
            self.sync()
        self.snapshot = (self.states, target)
        if self.tiering is not None:
            # the cold tier as committed: a later growth replay rewinds the
            # crash window's promotions to here
            self.tiering.begin_window()
        self.stats_acc = self._zero_stats
        if expect > target:
            self._dispatch_range(target, expect)
            self.counter = expect
        self.recoveries += 1
        wall = _time.perf_counter() - t_rec
        REGISTRY.counter(
            "fused_recoveries_total",
            "in-place fused-job recoveries (device-path failures healed "
            "without a DDL-replay restart)",
            labels=("job",)).labels(self.name).inc()
        REGISTRY.histogram(
            "fused_recovery_seconds",
            "wall seconds one in-place fused recovery took").observe(wall)
        RECORDER.record("recovery", {
            "job": self.name, "attempt": self._recovery_attempts,
            "replayed_epochs": int(expect - target),
            "error": type(err).__name__, "wall_s": round(wall, 4)})
        RECORDER.maybe_dump("in_place_recovery")

    def _dispatch_range(self, lo: int, hi: int) -> None:
        """Replay epochs [lo, hi) as pure device dispatch; a host-fed job
        replays its retained (or re-derived) ingest windows, promoting
        exactly as the live windows did."""
        if self.ingest is not None:
            for wlo, ev, w in self.ingest.replay_range(lo, hi):
                self.ingest.ready(w)
                if self.tiering is not None:
                    self._tier_promote(wlo, ev, None)
                self.states, self.stats_acc = self.program.step(
                    self.states, wlo, self.stats_acc, w.feeds)
            return
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
        if not self.predictive:
            out: Dict[int, Dict[str, int]] = {}
            for i, node in enumerate(self.program.nodes):
                cur = node.cap_current()
                nd = needs.get(i) or {}
                grown = {s: _bucket(nd[s], lo=cur[s] * 2)
                         for s in cur if nd.get(s, 0) > cur[s]}
                if grown:
                    out[i] = grown
            return out
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
        budget = self.hbm_budget_mb << 20
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
        state overflowed its capacity. The one synchronised pull of the
        stats vector is the profile's `device_sync` phase: it waits for
        every epoch launched since the last sync, replays included."""
        import time as _time
        prof = self.profiler if self.profiler.enabled else None
        t_sync = _time.perf_counter() if prof is not None else 0.0
        try:
            self._sync_inner()
        finally:
            if prof is not None:
                prof.phase("device_sync", _time.perf_counter() - t_sync)

    def _sync_inner(self) -> None:
        while True:
            if failpoint("fused.device_sync"):
                raise FailpointError("fused.device_sync")
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
            # promotion merges can truncate too
            for i, nd in self._promo_need.items():
                for sl, v in nd.items():
                    if v > needs.get(i, {}).get(sl, 0):
                        needs.setdefault(i, {})[sl] = v
                    if v > needs_cum.get(i, {}).get(sl, 0):
                        needs_cum.setdefault(i, {})[sl] = v
            overflow = any(
                needs[i].get(s, 0) > c
                for i, node in enumerate(self.program.nodes)
                for s, c in node.cap_current().items())
            if not overflow:
                return
            targets = self._predict_caps(needs, needs_cum, needs_epoch)
            snap_states, snap_counter = self.snapshot
            # a recovery's replay from empty state keeps no snapshot (one
            # copy of the state on the card): grow empty state and replay
            # the history again, both tiers
            fresh = snap_states is None
            if fresh:
                snap_states = self.program.init_states()
            new_states = []
            for i, node in enumerate(self.program.nodes):
                cur = node.cap_current()
                want = targets.get(i) or {}
                grown = {s: want[s] for s in want if want[s] > cur.get(s, 0)}
                if grown:
                    self.retraces += 1
                    self.growths += len(grown)
                    # the grown node's next step is its first at the new
                    # capacity: the profiler books it as a retrace
                    self.profiler.pending_compile[i] = "retrace"
                    new_states.append(self.program.resize_state(
                        i, snap_states[i], grown))
                else:
                    new_states.append(snap_states[i])
            self.growth_replays += 1
            if failpoint("fused.growth_replay"):
                raise FailpointError("fused.growth_replay")
            target = self.counter
            self.states = tuple(new_states)
            self.snapshot = (None if fresh else self.states, snap_counter)
            self.counter = snap_counter
            self.stats_acc = self._zero_stats
            self._promo_need = {}
            if fresh:
                if self.tiering is not None:
                    self.tiering.reset_stores()
                self._replay_history(target)
            else:
                if self.tiering is not None:
                    # rewind the cold tier to the same commit point: the
                    # window's promotions popped rows that the replay
                    # below promotes again (demotions happen only at
                    # commits)
                    self.tiering.rewind_window()
                self._dispatch_range(snap_counter, target)
            self.counter = target

    def _checkpoint(self, epoch: int) -> None:
        """Sync, fold the window's stats into the job totals, commit (the
        memory gauges; the freshness of the window's oldest dispatch),
        run the demotion tick, advance the restore snapshot (both tiers),
        trim the ingest retention, feed the traffic EWMAs and leave a
        checkpoint record in the flight recorder."""
        import time as _time
        from ..utils.blackbox import RECORDER
        self.sync()
        # after the sync's replays: the vector covers the committed window
        # once (unconditional: node_report stays truthful with the
        # profiler off)
        self._accum_totals(self._last_stats)
        prof = self.profiler if self.profiler.enabled else None
        if prof is not None:
            t0 = _time.perf_counter()
        due = self.counter != self._last_persist and (
            self.drained
            or self.counter - max(0, self._last_persist)
            >= self.persist_every * self.program.epoch_events)
        if due:
            self._persist_mv(epoch)
            self._last_persist = self.counter
        if failpoint("fused.checkpoint_commit"):
            raise FailpointError("fused.checkpoint_commit")
        if self.job_state_table is not None:
            dirty = False
            if self.committed != self.counter or self.committed == 0:
                self.job_state_table.insert((_JS_COUNTER, self.counter))
                dirty = True
            for k, v in self._job_state_rows():
                if self._js_written.get(k) != v:
                    self.job_state_table.insert((k, v))
                    self._js_written[k] = v
                    dirty = True
            if dirty:
                self.job_state_table.commit(epoch)
        if prof is not None:
            self._export_hbm_gauges()
            prof.phase("commit", _time.perf_counter() - t0)
        if self.freshness is not None and self._window_ingest is not None:
            # end-to-end staleness of this commit: from the oldest epoch
            # dispatch of the window to after the verified sync
            self.freshness.commit(self.name, epoch, self._window_ingest,
                                  _time.time())
        self._window_ingest = None
        self._tier_demote_tick(prof)
        self.snapshot = (self.states, self.counter)
        if self.tiering is not None:
            self.tiering.begin_window()
        self._promo_need = {}
        self.stats_acc = self._zero_stats
        self.committed = self.counter
        # the checkpoint closed the window: trim the epoch log and reset
        # the recovery attempts (they bound faults per window)
        self._epoch_log.clear()
        if self.ingest is not None:
            self.ingest.trim(self.committed)
        self._recovery_attempts = 0
        self._update_traffic_ewma()
        rec: Dict[str, Any] = {"job": self.name, "epoch": int(epoch),
                               "events": int(self.counter)}
        if self.tiering is not None:
            rec["tiering"] = {k: int(v)
                              for k, v in self.tiering.counters.items()}
        RECORDER.record("checkpoint", rec)
        # the skew defenses that change the exchange's routing adopt here:
        # committed == counter, and the whole history replays
        # deterministically under a new policy
        self._maybe_retune(epoch)
        if prof is not None:
            t0 = _time.perf_counter()
        self._write_skew_snapshot()
        if prof is not None:
            # the offline skew file is commit work
            prof.phase("commit", _time.perf_counter() - t0)

    def _job_state_rows(self) -> List[Tuple[int, int]]:
        """Growth counters and per-node capacity high-water marks, in the
        job-state key schema (`_JS_*`)."""
        rows = [(_JS_REPLAYS, self.growth_replays),
                (_JS_RETRACES, self.retraces),
                (_JS_GROWTHS, self.growths),
                (_JS_REBALANCES, self.rebalances)]
        stride = self._js_stride
        for i, node in enumerate(self.program.nodes):
            cur = node.cap_current()
            for si, s in enumerate(sorted(cur)):
                rows.append((_JS_CAP_BASE + i * stride + si, cur[s]))
        return rows

    def _persist_mv(self, epoch: int) -> None:
        """Diff the pulled MV against the last persisted image and write
        the change into the MV state table (checkpoint visibility for
        readers off the device, and the committed view a recovery reads)."""
        if self.mv_state_table is None:
            return
        rows = {r: None for r in self._pull_rows()}
        for r in self._persisted:
            if r not in rows:
                self.mv_state_table.delete(r)
        for r in rows:
            if r not in self._persisted:
                self.mv_state_table.insert(r)
        self._persisted = rows
        self.mv_state_table.commit(epoch)

    def recover(self) -> None:
        """Restart over a store: restore the committed event counter and
        the cumulative growth counters from the job table, presize every
        node from its persisted capacity high-water marks (so the replay
        grows nothing), load the tier journal, and regenerate the state
        to the committed counter (`_replay_history`: the sources are
        deterministic, so the state is the one that was committed)."""
        # a crashed predecessor's spilled epoch log is not this window's
        self._epoch_log.clear()
        if self.job_state_table is None:
            return
        rows: Dict[int, int] = {}
        for row in self.job_state_table.iter_all():
            k = int(row[0])
            rows[k] = max(rows.get(k, 0), int(row[1]))
        target = rows.get(_JS_COUNTER, 0)
        self.growth_replays = rows.get(_JS_REPLAYS, 0)
        self.retraces = rows.get(_JS_RETRACES, 0)
        self.growths = rows.get(_JS_GROWTHS, 0)
        self.rebalances = rows.get(_JS_REBALANCES, 0)
        # the routing policy reinstalls BEFORE the replay: the persisted
        # capacities were sized under it
        self._policy_seq = rows.get(_JS_POLICY_SEQ, 0)
        if self._policy_seq and self.program.mesh is not None:
            self._restore_policy(rows)
        preset = False
        for i, node in enumerate(self.program.nodes):
            cur = node.cap_current()
            caps = {}
            for si, s in enumerate(sorted(cur)):
                v = rows.get(_JS_CAP_BASE + i * self._js_stride + si, 0)
                if v > cur[s]:
                    caps[s] = v
            if caps:
                node.preset_caps(caps)
                preset = True
        self._js_written = {k: v for k, v in rows.items()
                            if k != _JS_COUNTER}
        if preset:
            # nothing dispatched yet: rebuild empty state at full size
            self.states = self.snapshot = None
            self.states = self.program.init_states()
        self.snapshot = (None, 0)        # empty state at event 0
        tm = self._tier_journal()
        if target == 0:
            if tm is not None:
                # nothing committed: a predecessor's journal is stale
                tm.clear_journal()
            return
        if tm is not None:
            # the journal is the cold tier's redo log: drop a torn tail
            # past the committed counter, and let the replay re-enact
            # each demotion where it happened
            tm.load_journal()
            tm.truncate_journal(target)
            tm.reset_stores()
        self._replay_history(target)
        self.counter = target
        self.sync()
        # the replay's stats seed the job totals: node_report and
        # skew_report are truthful at once
        self._accum_totals(self._last_stats)
        self.snapshot = (self.states, target)
        if tm is not None:
            tm.begin_window()
        self.stats_acc = self._zero_stats
        self._promo_need = {}
        self.committed = target
        if self.mv_state_table is not None:
            self._persisted = {tuple(r): None
                               for r in self.mv_state_table.iter_all()}
        self._last_persist = -1     # the mirror may be stale: refresh it

    def _replay_history(self, target: int) -> None:
        """Regenerate [0, target) from empty state: the committed range
        split at the tier journal's demotion counters, each demotion
        re-enacted where it happened (`record=False`), so both tiers
        rebuild bit for bit. Untiered, or with nothing demoted, one plain
        replay."""
        if target <= 0:
            return
        tm = self.tiering
        events = tm.events_between(0, target) if tm is not None else []
        if not events:
            self._dispatch_range(0, target)
            return
        plans = {p.node_idx: p for p in tm.plans}
        lo = 0
        for c, evs in events:
            if c > lo:
                self._dispatch_range(lo, c)
                lo = c
            for n, _side, keys in evs:
                p = plans.get(n)
                if p is not None:
                    self._tier_demote_enact(
                        p, np.asarray(keys, np.int64), record=False)
        if target > lo:
            self._dispatch_range(lo, target)

    # ---- the skew-routing policy (vnode rebalance, hot-key replication) --
    def _uniform_bounds(self) -> Tuple[int, ...]:
        from ..core.vnode import VNODE_COUNT
        from ..parallel.mesh import vnode_block_bounds
        return tuple(int(v) for v in vnode_block_bounds(self.mesh_shards,
                                                        VNODE_COUNT))

    def _current_bounds(self) -> Tuple[int, ...]:
        """The vnode-block bounds the exchange routes by now."""
        if self.program.vnode_bounds is not None:
            return self.program.vnode_bounds
        return self._uniform_bounds()

    def _maybe_retune(self, epoch: int) -> None:
        """The checkpoint's policy loop: adopt a staged policy, or read
        the committed skew evidence (occupancy histograms and heavy
        hitters, already on the host from the sync) and stage a new one
        — rebalanced vnode-block bounds when the per-shard load skew
        passes `rebalance_threshold`, and per-join hot-key sets for keys
        seen at `hot_key_frac` of an epoch or more. The node steps are
        untouched: routing never enters a node's signature."""
        if self.program.mesh is None \
                or not (self.rebalance or self.hot_key_rep):
            return
        if self._pending_policy is not None:
            bounds, hot_map, ready = self._pending_policy
            if ready.is_set():
                self._pending_policy = None
                self._apply_policy(epoch, bounds, hot_map)
            return
        from .skew_stats import (SK_BUCKETS, SK_TOPK, balanced_bounds,
                                 shard_skew_ratio, unpack_hot)
        # the lifetime high-waters, not only this window's: occupancy and
        # heavy-hitter slots combine by max, and a drained job's window
        # vector is zero
        vec = np.maximum(self._stat_totals, self._last_stats)
        occ_total = [0] * SK_BUCKETS
        hot_map: Dict[int, Tuple[Tuple[int, ...], int]] = {}
        for i, node in enumerate(self.program.nodes):
            if not node.skew or node.exch is None:
                continue
            st = self.program.node_stats(i, vec)
            for b in range(SK_BUCKETS):
                occ_total[b] += st.get(f"skv{b}", 0)
            if self.hot_key_rep and node.hotrep:
                hots = []
                for r in range(SK_TOPK):
                    key40, cnt = unpack_hot(st.get(f"skh{r}", 0))
                    if cnt >= self.hot_key_frac \
                            * self.program.epoch_events:
                        hots.append(key40)
                hk = tuple(sorted(set(hots)))
                if hk and hk != node.hot_keys:
                    # broadcast the smaller build side (the dimension-like
                    # side is cheap to copy; salting the firehose side
                    # spreads the work)
                    side = 0 if st.get("need_a", 0) \
                        <= st.get("need_b", 0) else 1
                    hot_map[i] = (hk, side)
        new_bounds = None
        cur = self._current_bounds()
        if self.rebalance and sum(occ_total) > 0 \
                and shard_skew_ratio(occ_total, cur) \
                > self.rebalance_threshold:
            nb = balanced_bounds(occ_total, self.mesh_shards)
            if nb != cur:
                new_bounds = nb
        if new_bounds is None and not hot_map:
            return
        self._stage_policy(new_bounds or cur, hot_map)

    def _stage_policy(self, bounds: Tuple[int, ...],
                      hot_map: Dict[int, Tuple[Tuple[int, ...], int]]
                      ) -> None:
        """Stage a routing-policy change for the next checkpoint. The
        port compiles nothing per route (the exchange kernel takes the
        bounds and hot keys as arguments), so there is nothing to warm:
        the stage is ready at once, and the two steps remain so that a
        decision and its adoption fall on different checkpoints, as in
        the reference."""
        import threading
        ready = threading.Event()
        ready.set()
        self._pending_policy = (tuple(int(b) for b in bounds), hot_map,
                                ready)

    def _apply_policy(self, epoch: int, bounds: Tuple[int, ...],
                      hot_map: Dict[int, Tuple[Tuple[int, ...], int]]
                      ) -> None:
        """Adopt a staged routing policy at this checkpoint: swap the
        bounds and hot-key sets, persist them (a restart must replay
        under the routing its capacities were sized for), then
        rebuild-replay — empty state at the current capacities, the
        committed history regenerated under the NEW routing (both tiers),
        the snapshot re-anchored. The sources are deterministic, so the
        rows are the same; a growth the new routing needs (a broadcast
        multiplies rows) replays under the new routing too."""
        import time as _time
        from ..utils.blackbox import RECORDER
        from ..utils.metrics import REGISTRY
        t0 = _time.perf_counter()
        self.program.vnode_bounds = None \
            if tuple(bounds) == self._uniform_bounds() else tuple(bounds)
        for i, (hk, side) in hot_map.items():
            node = self.program.nodes[i]
            node.hot_keys = tuple(hk)
            node.hot_rep_side = int(side)
        self._policy_seq += 1
        # counted before persisting: the commit that records policy seq N
        # carries the switch count that goes with it
        self.rebalances += 1
        self._persist_policy(epoch)
        target = self.committed
        # one copy of the state on the card: drop the old before the new
        self.states = self.snapshot = None
        self.stats_acc = self._zero_stats
        self.states = self.program.init_states()
        self.snapshot = (None, 0)
        self.counter = 0
        self._promo_need = {}
        if self.tiering is not None:
            self.tiering.reset_stores()
        if target:
            self._replay_history(target)
            self.counter = target
            self.sync()
        self.snapshot = (self.states, target)
        if self.tiering is not None:
            self.tiering.begin_window()
        self.stats_acc = self._zero_stats
        wall = _time.perf_counter() - t0
        REGISTRY.counter(
            "fused_rebalances_total",
            "checkpoint-time skew-routing policy switches (vnode "
            "rebalance / hot-key replication)",
            labels=("job",)).labels(self.name).inc()
        REGISTRY.histogram(
            "fused_rebalance_seconds",
            "wall seconds one skew-policy rebuild-replay took").observe(wall)
        RECORDER.record("rebalance", {
            "job": self.name, "epoch": int(epoch),
            "policy_seq": self._policy_seq,
            "bounds": [int(b) for b in bounds],
            "hot_nodes": sorted(int(i) for i in hot_map),
            "wall_s": round(wall, 4)})

    def _persist_policy(self, epoch: int) -> None:
        """The routing policy into the job table, versioned (see the
        `_JS_*` rows): every slot is rewritten at every change, so the
        recovery's max-combine rebuilds one consistent generation."""
        if self.job_state_table is None:
            return
        from .skew_stats import SK_KEY_MASK, SK_TOPK
        seq = self._policy_seq
        rows = [(_JS_POLICY_SEQ, seq), (_JS_REBALANCES, self.rebalances)]
        n = self.mesh_shards
        bounds = self._current_bounds()
        if 0 < n - 1 <= _JS_VB_MAX:
            for s in range(n - 1):
                rows.append((_JS_VB_BASE + s,
                             (seq << 16) | int(bounds[s + 1])))
        for i, node in enumerate(self.program.nodes):
            if not node.hotrep:
                continue
            base = _JS_HOT_BASE + i * (SK_TOPK + 1)
            for r in range(SK_TOPK):
                v = seq << 41
                if r < len(node.hot_keys):
                    v |= ((node.hot_keys[r] & SK_KEY_MASK) << 1) | 1
                rows.append((base + r, v))
            rows.append((base + SK_TOPK,
                         (seq << 2) | (int(node.hot_rep_side) << 1) | 1))
        dirty = False
        for k, v in rows:
            if self._js_written.get(k) != v:
                self.job_state_table.insert((k, v))
                self._js_written[k] = v
                dirty = True
        if dirty:
            self.job_state_table.commit(epoch)

    def _restore_policy(self, rows: Dict[int, int]) -> None:
        """Decode `_persist_policy`'s rows (the recovery side) and
        reinstall the routing before the history replay."""
        from ..core.vnode import VNODE_COUNT
        from .skew_stats import SK_KEY_MASK, SK_TOPK
        n = self.mesh_shards
        if 0 < n - 1 <= _JS_VB_MAX:
            inner = [rows.get(_JS_VB_BASE + s) for s in range(n - 1)]
            if all(v is not None for v in inner):
                bounds = (0,) + tuple(v & 0xFFFF for v in inner) \
                    + (VNODE_COUNT,)
                if all(bounds[s] <= bounds[s + 1] for s in range(n)) \
                        and bounds[-2] <= VNODE_COUNT:
                    self.program.vnode_bounds = None \
                        if bounds == self._uniform_bounds() else bounds
        for i, node in enumerate(self.program.nodes):
            base = _JS_HOT_BASE + i * (SK_TOPK + 1)
            srow = rows.get(base + SK_TOPK)
            if srow is None or not (srow & 1):
                continue
            node.hot_rep_side = (srow >> 1) & 1
            hots = []
            for r in range(SK_TOPK):
                v = rows.get(base + r, 0)
                if v & 1:
                    hots.append((v >> 1) & SK_KEY_MASK)
            node.hot_keys = tuple(sorted(set(hots)))

    def _write_skew_snapshot(self) -> None:
        """The offline skew surface: this job's skew_report rows and its
        routing bounds in the data directory's `skew_stats.json`,
        rewritten at every checkpoint (a dead directory still answers)."""
        if not self.data_dir \
                or not any(n.skew or n.flow for n in self.program.nodes):
            return
        import time as _time
        path = os.path.join(self.data_dir, SKEW_FILE)
        doc: Dict[str, Any] = {"jobs": {}}
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            pass
        doc.setdefault("jobs", {})
        doc["jobs"][self.name] = {
            "ts": _time.time(),
            "epoch_events": self.program.epoch_events,
            "mesh_shards": self.mesh_shards,
            "committed_events": self.committed,
            "vnode_bounds": (list(self._current_bounds())
                             if self.program.mesh is not None else None),
            "rebalances": self.rebalances,
            "rows": [list(r) for r in self.skew_report()],
        }
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass

    def load_states(self, states, counter: int, cold=None) -> None:
        """Install states built elsewhere (`state_io.states_from_numpy`)
        as the committed snapshot at event `counter`; with `cold` (a
        `state_io.cold_from_snapshot` image) the cold stores too."""
        for node, st in zip(self.program.nodes, states):
            if st is not None:
                # a mesh program's state is per shard; shards share
                # capacities
                node.adopt_state(st[0] if self.program.mesh is not None
                                 else st)
        self.states = tuple(states)
        self.snapshot = (self.states, counter)
        self.counter = self.committed = counter
        self.stats_acc = self._zero_stats
        if cold is not None:
            self.tiering.restore(cold)
        if self.tiering is not None:
            self.tiering.begin_window()

    # ---- tiered state (cold demotion, touch promotion) -----------------
    def _set_state(self, i: int, st) -> None:
        states = list(self.states)
        states[i] = st
        self.states = tuple(states)

    def _shard_states(self, i: int) -> List[Any]:
        """Node i's state per shard (one entry without a mesh)."""
        st = self.states[i]
        return list(st) if self.program.mesh is not None else [st]

    def _set_shard_states(self, i: int, sts: Sequence[Any]) -> None:
        self._set_state(i, tuple(sts) if self.program.mesh is not None
                        else sts[0])

    def _shard_devices(self) -> List[torch.device]:
        mesh = self.program.mesh
        return list(mesh.devices) if mesh is not None else [self.device]

    def _fold_promo(self, i: int, slot: str, need: int) -> None:
        """A promotion merge's `needed` high-water (host side): joins the
        next sync's overflow check."""
        if need <= 0:
            return
        d = self._promo_need.setdefault(i, {})
        if need > d.get(slot, 0):
            d[slot] = need

    def _probe_counters(self, store, shard: int,
                        cand: np.ndarray) -> List[int]:
        """One negative-cache probe of one shard's store, with the counter
        bookkeeping."""
        tm = self.tiering
        hits, probes, positives = store.probe(shard, cand)
        tm.counters["filter_probes"] += probes
        tm.counters["filter_hits"] += positives
        if probes and not store.filter_live[shard]:
            # no filter (Xor8.build failed): every candidate paid the
            # index lookup — correct, not cheap
            tm.counters["filter_fallbacks"] += probes
        return hits

    def _tier_promote(self, lo: int, events: int, prof) -> None:
        """Touch promotion for the window at `lo`: each tiered node's
        candidate keys, recomputed from the window's host rows (the
        recipes), are probed against every shard's negative cache and the
        cold hits merged back into that shard's device tables BEFORE the
        step. Any window holding a key restores it first, so replays with
        other window boundaries stay exact."""
        import time as _time
        tm = self.tiering
        if tm is None or self.ingest is None or not tm.any_cold():
            return
        t0 = _time.perf_counter()
        per_source = None
        for plan in tm.plans:
            if not plan.recipes:
                continue
            if plan.kind == "agg":
                if not len(tm.store(plan.node_idx, -1)):
                    continue
            elif not len(tm.store(plan.node_idx, 0)) \
                    and not len(tm.store(plan.node_idx, 1)):
                continue
            if per_source is None:
                per_source = self.ingest.host_window(lo, events)
            cand = np.unique(np.concatenate(
                [r.keys_for(per_source) for r in plan.recipes]))
            if not len(cand):
                continue
            if plan.kind == "agg":
                self._promote_agg(plan, cand)
            else:
                self._promote_join(plan, cand)
        dt = _time.perf_counter() - t0
        self.tier_walls["promote_h2d"] += dt
        if prof is not None:
            prof.phase("promote_h2d", dt)

    def _host_tensor(self, a: np.ndarray, dev=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device if dev is None else dev)

    def _promote_agg(self, plan, cand: np.ndarray) -> None:
        """Cold hits of an agg (and of its lockstep MV) back into the
        device tables, shard by shard: shard s's store holds what shard s
        demoted under the current bounds. Every shard runs the merge at
        one padded length, as the reference's vmap does."""
        from .shard_exec import on_device
        from .sorted_state import EMPTY_KEY
        from .tiering import _pad_pow2
        tm = self.tiering
        i = plan.node_idx
        store = tm.store(i, -1)
        n = self.mesh_shards
        hits = [sorted(self._probe_counters(store, s, cand))
                for s in range(n)]
        if not sum(len(h) for h in hits):
            return
        node = self.program.nodes[i]
        L = _pad_pow2(max(len(h) for h in hits))
        mvstore = tm.stores.get((i, "mv")) if plan.mv_idx is not None \
            else None
        mvnode = self.program.nodes[plan.mv_idx] \
            if mvstore is not None else None
        devs = self._shard_devices()
        tstates = self._shard_states(i)
        mvsts = self._shard_states(plan.mv_idx) \
            if mvstore is not None else None
        need = mneed = 0
        for s, h in enumerate(hits):
            dev = devs[s]
            main = tstates[s].inner.main
            hk = np.asarray(h, np.int64)
            m = len(hk)
            pkeys = np.full((L,), EMPTY_KEY, np.int64)
            ptouch = np.zeros((L,), np.int64)
            pcols = [np.zeros((L,), _np_dtype(v.dtype)) for v in main.vals]
            if m:
                vcols, tchs = store.take_agg_rows(s, hk)
                tm.log_take(store, "agg", hk, vcols, tchs, shard=s)
                pkeys[:m] = hk
                ptouch[:m] = tchs
                for c in range(len(pcols)):
                    pcols[c][:m] = vcols[c]
            with on_device(node, dev):
                tstates[s], nd = _agg_promote_core(
                    tstates[s], self._host_tensor(pkeys, dev),
                    [self._host_tensor(c, dev) for c in pcols],
                    self._host_tensor(ptouch, dev), node)
            need = max(need, int(nd))
            if mvstore is None:
                continue
            # the lockstep MV holds a subset of the agg's demoted keys: the
            # found ones, still ascending, then EMPTY_KEY padding (the
            # port's merge takes no holes)
            mvst = mvsts[s]
            mkeys = np.full((L,), EMPTY_KEY, np.int64)
            mcols_p = [np.zeros((L,), _np_dtype(v.dtype))
                       for v in mvst.vals]
            if m:
                mf, mcols = mvstore.take_flat_rows(s, hk)
                tm.log_take(mvstore, "flat", hk[mf], mcols, shard=s)
                k = int(mf.sum())
                mkeys[:k] = hk[mf]
                if k:
                    for c in range(len(mcols_p)):
                        mcols_p[c][:k] = mcols[c]
            with on_device(mvnode, dev):
                mvsts[s], mnd = _mv_promote_core(
                    mvst, self._host_tensor(mkeys, dev),
                    [self._host_tensor(c, dev) for c in mcols_p], mvnode)
            mneed = max(mneed, int(mnd))
        tm.counters["promotions"] += sum(len(h) for h in hits)
        self._set_shard_states(i, tstates)
        self._fold_promo(i, "main", need)
        if mvstore is not None:
            self._set_shard_states(plan.mv_idx, mvsts)
            self._fold_promo(plan.mv_idx, "main", mneed)

    def _promote_join(self, plan, cand: np.ndarray) -> None:
        """Cold pairs of a join's two build sides back into each shard's
        side tables (per side one padded length over the shards)."""
        from .shard_exec import on_device
        from .sorted_state import EMPTY_KEY
        from .tiering import _pad_pow2
        tm = self.tiering
        i = plan.node_idx
        node = self.program.nodes[i]
        n = self.mesh_shards
        devs = self._shard_devices()
        tstates = self._shard_states(i)
        bufs = [[None] * n for _ in range(2)]
        total = 0
        for side in (0, 1):
            store = tm.store(i, side)
            vdts = [_np_dtype(v.dtype) for v in tstates[0].inner[side].vals]
            taken = []
            for s in range(n):
                ks = sorted(self._probe_counters(store, s, cand))
                rows = store.take_join_rows(s, ks)
                tm.log_take(store, "join", *rows, shard=s)
                taken.append(rows)
            L = _pad_pow2(max(len(t[0]) for t in taken))
            for s, (sjk, spk, svals, stch) in enumerate(taken):
                m = len(sjk)
                jk = np.full((L,), EMPTY_KEY, np.int64)
                pk = np.full((L,), EMPTY_KEY, np.int64)
                tch = np.zeros((L,), np.int64)
                vals = [np.zeros((L,), d) for d in vdts]
                if m:
                    # (jk, pk) is a unique pair identity: the side's order
                    order = np.lexsort((spk, sjk))
                    jk[:m], pk[:m] = sjk[order], spk[order]
                    tch[:m] = stch[order]
                    for c in range(len(vals)):
                        vals[c][:m] = svals[c][order]
                    total += m
                dev = devs[s]
                bufs[side][s] = (self._host_tensor(jk, dev),
                                 self._host_tensor(pk, dev),
                                 tuple(self._host_tensor(v, dev)
                                       for v in vals),
                                 self._host_tensor(tch, dev))
        if not total:
            return
        tm.counters["promotions"] += total
        need_a = need_b = 0
        for s in range(n):
            with on_device(node, devs[s]):
                tstates[s], (na, nb) = _join_promote_core(
                    tstates[s], bufs[0][s], bufs[1][s], node)
            need_a, need_b = max(need_a, int(na)), max(need_b, int(nb))
        self._set_shard_states(i, tstates)
        self._fold_promo(i, "a", need_a)
        self._fold_promo(i, "b", need_b)

    def _tier_demote_tick(self, prof=None) -> None:
        """The checkpoint half of demotion, in two phases so the
        device-to-host copy never blocks an epoch: HARVEST the recency
        pull issued at the last checkpoint (its copy overlapped this
        window), select each shard's cold keys and evict them, then issue
        the next pull for every node whose window residency (the fullest
        shard's) crossed the high water."""
        import time as _time
        from .capacity import tier_waters
        from .agg_step import pull_async, wait_pulled
        from .skew_stats import SK_KEY_MASK, hot_key_set
        from .tiering import select_cold
        tm = self._tier_journal()
        if tm is None:
            return
        t0 = _time.perf_counter()
        did = False
        high, _low = tier_waters()
        vec = np.maximum(self._stat_totals, self._last_stats)
        for plan in tm.plans:
            if not plan.recipes:
                continue                   # demotion-inert (stats only)
            i = plan.node_idx
            node = self.program.nodes[i]
            pend = tm.pending.pop(i, None)
            if pend is not None:
                did = True
                leaves, events = pend
                wait_pulled(events)
                host = [x.numpy() for x in leaves]
                hot = hot_key_set(self.program.node_stats(i, vec)) \
                    if node.skew else ()
                sel = []
                # (keys, touch, count) triples: per shard, per side
                for k, t, c in zip(host[0::3], host[1::3], host[2::3]):
                    d = select_cold(k, t, int(c), k.shape[0], hot,
                                    SK_KEY_MASK)
                    if d is not None:
                        sel.append(d)
                if sel:
                    self._tier_demote_enact(
                        plan, np.unique(np.concatenate(sel)), record=True)
            st = self.program.node_stats(i, self._last_stats)
            tres = int(st.get("tres", 0))
            leaves = []
            if plan.kind == "agg":
                pressure = tres > high * node.capacity
                for ts in self._shard_states(i):
                    leaves += [ts.inner.main.keys, ts.touch,
                               ts.inner.main.count]
            else:
                pressure = tres > high * min(node.cap_a, node.cap_b)
                for ts in self._shard_states(i):
                    a, b = ts.inner
                    ta, tb = ts.touch
                    leaves += [a.jk, ta, a.count, b.jk, tb, b.count]
            if pressure:
                did = True
                # not waited for: the next checkpoint's harvest waits
                tm.pending[i] = pull_async(leaves)
        if did:
            dt = _time.perf_counter() - t0
            self.tier_walls["demote_d2h"] += dt
            if prof is not None:
                prof.phase("demote_d2h", dt)

    def _tier_journal(self):
        """The TieringManager with its journal file bound (late: the owner
        attaches the data directory after construction)."""
        tm = self.tiering
        if tm is not None and tm.journal_path is None \
                and self.data_dir is not None:
            tm.set_journal_path(os.path.join(
                self.data_dir, f"tiering_journal_{self.name}.jsonl"))
        return tm

    def _tier_demote_enact(self, plan, keys: np.ndarray,
                           record: bool) -> None:
        """Evict `keys` from the device table(s) into the cold stores
        (exact payload and touch), rebuild the negative caches, journal
        the event. One key buffer serves every shard: each evicts the
        keys it holds, so a key lands in the store of the shard that owns
        it under the current bounds. The selection may be stale (it came
        from the last checkpoint's pull): only rows the evict finds move.
        With `record=False` it re-enacts a journaled event in a history
        replay."""
        from .shard_exec import on_device
        from .sorted_state import EMPTY_KEY
        from .tiering import _pad_pow2
        tm = self.tiering
        i = plan.node_idx
        node = self.program.nodes[i]
        keys = np.unique(np.asarray(keys, dtype=np.int64))
        if not len(keys):
            return
        dbuf = np.full((_pad_pow2(len(keys)),), EMPTY_KEY, np.int64)
        dbuf[:len(keys)] = keys
        devs = self._shard_devices()
        dkeys = {}
        for dev in devs:
            if dev not in dkeys:
                dkeys[dev] = self._host_tensor(dbuf, dev)
        stored = 0
        if plan.kind == "agg":
            store = tm.store(i, -1)
            tstates = self._shard_states(i)
            mvnode = self.program.nodes[plan.mv_idx] \
                if plan.mv_idx is not None else None
            mvsts = self._shard_states(plan.mv_idx) \
                if mvnode is not None else None
            for s, dev in enumerate(devs):
                with on_device(node, dev):
                    tstates[s], found, dvals, dtouch = _agg_evict_core(
                        tstates[s], dkeys[dev], node)
                idx = np.nonzero(found.cpu().numpy())[0]
                if len(idx):
                    store.put_agg_rows(s, dbuf[idx],
                                       [v.cpu().numpy()[idx] for v in dvals],
                                       dtouch.cpu().numpy()[idx])
                    stored += len(idx)
                store.rebuild_filter(s)
                if mvnode is None:
                    continue
                # lockstep MV demotion: the same groups leave the terminal
                # MV table, merged back at the pull or on promotion
                with on_device(mvnode, dev):
                    mvsts[s], mfnd, mdvals = _mv_evict_core(
                        mvsts[s], dkeys[dev], mvnode)
                midx = np.nonzero(mfnd.cpu().numpy())[0]
                if len(midx):
                    tm.store(i, "mv").put_flat_rows(
                        s, dbuf[midx], [v.cpu().numpy()[midx]
                                        for v in mdvals])
            self._set_shard_states(i, tstates)
            if mvnode is not None:
                self._set_shard_states(plan.mv_idx, mvsts)
        else:
            tstates = self._shard_states(i)
            for side in (0, 1):
                store = tm.store(i, side)
                for s, dev in enumerate(devs):
                    with on_device(node, dev):
                        tstates[s], djk, dpk, dvals, dtouch, ndem = \
                            _join_evict_core(tstates[s], dkeys[dev], node,
                                             side)
                    n = int(ndem)
                    if n:
                        store.extend_join_rows(
                            s, djk[:n].cpu().numpy(), dpk[:n].cpu().numpy(),
                            [v[:n].cpu().numpy() for v in dvals],
                            dtouch[:n].cpu().numpy())
                    stored += n
                    store.rebuild_filter(s)
            self._set_shard_states(i, tstates)
        if record:
            tm.record(self.counter, i, -1, keys)
            tm.counters["demote_events"] += 1
            tm.counters["demotions"] += stored

    def _tier_merge_mv_rows(self, keys, cols, nulls):
        """Pull-time merge of the terminal MV's cold rows (every shard's)
        with the device pull, in ascending key order: packed keys are
        unique across tiers and shards, so this is the untiered pull's
        order."""
        tm = self.tiering
        store = None
        for p in tm.plans:
            if p.mv_idx == self.pull.node_idx:
                store = tm.stores.get((p.node_idx, "mv"))
        if store is None or not len(store):
            return keys, cols, nulls
        parts = [store.flat_columns(s) for s in range(len(store.rows))]
        parts = [(k, cs) for k, cs in parts if len(k)]
        ckeys = np.concatenate([k for k, _ in parts]).astype(np.int64)
        keys_all = np.concatenate([np.asarray(keys), ckeys])
        order = np.argsort(keys_all, kind="stable")
        out_cols, out_nulls = [], []
        for j in range(len(cols)):
            c, nl = np.asarray(cols[j]), np.asarray(nulls[j])
            cc = np.concatenate([cs[1 + 2 * j] for _, cs in parts])
            cn = np.concatenate([cs[2 + 2 * j] for _, cs in parts])
            out_cols.append(np.concatenate(
                [c, cc.astype(c.dtype, copy=False)])[order])
            out_nulls.append(np.concatenate(
                [nl, cn.astype(nl.dtype, copy=False)])[order])
        return keys_all[order], out_cols, out_nulls

    def tiering_report(self) -> List[Tuple]:
        """Per tiered node: (node, kind, resident high-water, cold rows,
        filter live, promotable) and the job-wide counters (demotions,
        promotions, demote_events, filter_probes, filter_hits,
        filter_fallbacks)."""
        tm = self.tiering
        if tm is None:
            return []
        vec = np.maximum(self._stat_totals, self._last_stats)
        resident = {p.node_idx: self.program.node_stats(
            p.node_idx, vec).get("tres", 0) for p in tm.plans}
        c = tm.counters
        tail = (c["demotions"], c["promotions"], c["demote_events"],
                c["filter_probes"], c["filter_hits"], c["filter_fallbacks"])
        return [row + tail
                for row in tm.report_rows(self.program.nodes, resident)]

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

    def _export_hbm_gauges(self) -> None:
        """rw_hbm_bytes{job,node,shards} + budget utilization: the device
        memory the capacity lifecycle allocated, checkpoint-fresh (the
        reference's gauge names; "HBM" is the card's memory here). Bytes
        are PER SHARD (capacities are per shard, the budget per device);
        the `shards` label says how many shards each carry it."""
        from ..utils.metrics import REGISTRY
        from .capacity import node_hbm_bytes
        shards = str(self.mesh_shards)
        g = REGISTRY.gauge("rw_hbm_bytes",
                           "fused per-node device state bytes (per shard)",
                           labels=("job", "node", "shards"))
        total = 0
        for i, node in enumerate(self.program.nodes):
            if not node.cap_current():
                continue
            nbytes = node_hbm_bytes(node)
            g.labels(self.name, f"{i}:{type(node).__name__}",
                     shards).set(nbytes)
            total += nbytes
        REGISTRY.gauge("rw_hbm_budget_utilization",
                       "fused job per-device memory footprint over "
                       "hbm_budget_mb", labels=("job", "shards")).labels(
            self.name, shards).set(total / float(self.hbm_budget_mb << 20))

    def node_report(self) -> List[Tuple]:
        """Per-node/per-slot attribution rows (rw_fused_node_stats):
        (node, type, slot, rows_in, rows_out, entries, capacity,
        occupancy, hbm_mb, overflowed). Row counters are job-lifetime
        sums; `entries` is the slot's high-water observed need — all of
        it from the stats vector the regular syncs already pull, no extra
        device traffic."""
        out: List[Tuple] = []
        totals = self._stat_totals
        for i, node in enumerate(self.program.nodes):
            st = self.program.node_stats(i, totals)
            rows_in = st.get("rows_in", 0)
            rows_out = st.get("rows_out", 0)
            cur = node.cap_current()
            tname = type(node).__name__
            if not cur:
                out.append((i, tname, "-", rows_in, rows_out,
                            0, 0, 0.0, 0.0, False))
                continue
            bpe = node.cap_bytes()
            needs = node.cap_needs(st)
            for s in sorted(cur):
                cap = cur[s]
                entries = needs.get(s, 0)
                out.append((i, tname, s, rows_in, rows_out, entries, cap,
                            entries / cap if cap else 0.0,
                            cap * bpe.get(s, 0) / float(1 << 20),
                            entries > cap))
        return out

    def skew_report(self) -> List[Tuple]:
        """Rows (node, type, metric, ordinal, key, value, share) for the
        skew- and flow-armed nodes, from the committed totals (no device
        traffic): 'vnode_occ' per bucket (high-water live keys, share of
        the total), 'skew_ratio', 'hot_key' per rank (the 40-bit key and
        its per-epoch row count); then 'vnode_traffic' per bucket (routed
        rows), 'traffic_skew', 'traffic_div' and 'traffic_burst'; on a
        mesh 'shard_load' per shard and 'shard_skew' under the current
        bounds, and 'hot_policy' per adopted hot key."""
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
            if node.skew and self.program.mesh is not None:
                # the per-shard load the histogram implies under the
                # CURRENT bounds: what rebalancing evens out (skew_ratio
                # above is the raw key skew, whatever the bounds)
                from .skew_stats import shard_loads, shard_skew_ratio
                bounds = self._current_bounds()
                loads = shard_loads(occ, bounds)
                tot = sum(loads)
                for s, ld in enumerate(loads):
                    out.append((i, tname, "shard_load", s, None,
                                int(ld), ld / tot if tot else 0.0))
                out.append((i, tname, "shard_skew", 0, None, int(tot),
                            shard_skew_ratio(occ, bounds)))
            if node.hot_keys:
                # the adopted hot-key policy (value: the side whose rows
                # broadcast)
                for r, hk in enumerate(node.hot_keys):
                    out.append((i, tname, "hot_policy", r, hk,
                                node.hot_rep_side, None))
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
    def _pull_need(self) -> int:
        """Live-row high-water of the terminal MV node (per shard): the
        job-lifetime totals and the current window's."""
        vec = np.maximum(self._stat_totals, self._last_stats)
        return self.program.node_stats(self.pull.node_idx, vec).get(
            "needed", 0)

    def _pull_rows_mesh(self) -> List[Tuple]:
        """The MV rows of a mesh program: the shards' sorted runs merged
        on the device (a stale bound falls back to a host merge) — keys
        and pair identities are globally unique, so the merged order is
        the 1-shard order; a tiered job's demoted MV rows merge in by
        key."""
        from .shard_exec import merge_keyed_pull, merge_pair_pull
        mesh = self.program.mesh
        i = self.pull.node_idx
        st = self.states[i]
        bound = self._pull_need() * self.mesh_shards
        reps = None
        if mesh.replicas > 1:
            # serving replicas: the pull reads one column, round-robin
            self.program.refresh_replicas(self.states)
            reps = [col[i] for col in self.program.replica_states]
        if self.pull.kind == "pair":
            n, vals = merge_pair_pull(st, mesh, live_bound=bound,
                                      replicas=reps)
            out_cols = [_format_col(dt, dec, np.asarray(v), None)
                        for dt, dec, v in zip(self.pull.dtypes,
                                              self.pull.decoders, vals)]
            return list(zip(*out_cols)) if out_cols else [()] * n
        dts = [c.acc_dtype for c in self.pull.agg.spec.calls]
        keys, cols, nulls = merge_keyed_pull(st, mesh, dts, live_bound=bound,
                                             replicas=reps)
        if self.tiering is not None:
            keys, cols, nulls = self._tier_merge_mv_rows(keys, cols, nulls)
        return self._format_keyed(keys, cols, nulls)

    def _format_keyed(self, keys, cols, nulls) -> List[Tuple]:
        gcols_np = _np_unpack(self.pull.agg.pack, keys)
        out_cols = []
        for pos, (kind, j) in enumerate(self.pull.out_map):
            src = gcols_np[j] if kind == "g" else cols[j]
            null = None if kind == "g" else nulls[j]
            out_cols.append(_format_col(
                self.pull.dtypes[pos], self.pull.decoders[pos],
                np.asarray(src), null))
        return [tuple(c[i] for c in out_cols) for i in range(len(keys))]

    def _pull_rows(self) -> List[Tuple]:
        if self.program.mesh is not None:
            return self._pull_rows_mesh()
        # mesh pulls count inside merge_*_pull; the single-device pull
        # below is one pull all the same — the serving cache's coalescing
        # assertion reads one counter
        from .shard_exec import _count_pull
        _count_pull()
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
        if self.tiering is not None:
            # demoted groups live in the cold store: merge them back in
            # key order, so the rows equal the untiered pull's
            keys, cols, nulls = self._tier_merge_mv_rows(keys, cols, nulls)
        return self._format_keyed(keys, cols, nulls)

    def mv_rows_now(self) -> List[Tuple]:
        """Query serving: sync and pull the CURRENT MV rows, in key order.
        A device fault in the SELECT's sync recovers in place as the
        barrier loop does, and the pull retries (bounded by the recovery
        attempts)."""
        while True:
            try:
                self.sync()
                break
            except Exception as e:
                if not _is_device_fault(e):
                    raise
                self._recover_in_place(e)
        return self._pull_rows()

    def mv_rows_versioned(self) -> Tuple[int, List[Tuple]]:
        """`mv_rows_now` stamped with the epoch counter it reflects (the
        serving cache's fill): a pull that a barrier commit overtakes
        (`counter` or `committed` moved meanwhile) is taken again."""
        while True:
            c0, e0 = self.counter, self.committed
            rows = self.mv_rows_now()
            if self.counter == c0 and self.committed == e0:
                return int(c0), rows

    # ---- capacity introspection -----------------------------------------
    def shape_hints(self) -> Dict[str, Dict[str, int]]:
        """Per-node capacity high-water keyed by the node's structural
        shape key (`node_shape_key`): the registry form that survives
        renames. Structurally identical nodes (q5's twin hop + agg
        chains) merge by max."""
        out: Dict[str, Dict[str, int]] = {}
        for node in self.program.nodes:
            cur = node.cap_current()
            if not cur:
                continue
            prev = out.setdefault(node_shape_key(node), {})
            for s, c in cur.items():
                prev[s] = max(prev.get(s, 0), c)
        return out

    def cap_report(self) -> Dict[str, Any]:
        """Growth accounting and live per-node capacities."""
        nodes = {}
        for i, node in enumerate(self.program.nodes):
            cur = node.cap_current()
            if cur:
                nodes[f"{i}:{type(node).__name__}"] = dict(cur)
        return {"growth_replays": self.growth_replays,
                "retraces": self.retraces, "growths": self.growths,
                "committed_events": self.committed, "nodes": nodes}

    def cap_hints(self) -> Dict[int, Dict[str, Any]]:
        """Per-node capacity snapshot keyed by program node index, each
        entry with its node's structural key (`node_shape_key`; the
        reference stores `hash(node)`, which is not stable across
        processes). Introspection only: presizing reads `shape_hints`."""
        out = {}
        for i, node in enumerate(self.program.nodes):
            cur = node.cap_current()
            if cur:
                out[i] = {"type": type(node).__name__,
                          "sig": node_shape_key(node), "caps": dict(cur)}
        return out


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.zeros(0, dtype=dt).numpy().dtype


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
