"""Hash-aggregation epoch step over sorted-run state (PyTorch port of
`risingwave_tpu/device/agg_step.py`).

The whole epoch's rows are applied as one pass of tensor ops:

    rows -> per-key deltas -> (lookup old outputs) -> merge -> (lookup new)
         -> change set (insert / delete / update-pair material)

so the device never sees data-dependent control flow and the host never
waits inside an epoch.

Supported device aggregates: count / count(col) / sum / avg, and min /
max — either append-only single-extreme state or exact under retraction
via a sorted-multiset side state per input column (`device/minput.py`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import agg_unpack
from . import resolve_device
from .capacity import bucket as _bucket
from .capacity import predict_capacity
from .minput import (SortedMultiset, ms_batch_reduce, ms_find,
                     ms_group_minmax, ms_grow, ms_make, ms_merge)
from .sorted_state import (EMPTY_KEY, ReduceKind, SortedState, _neutral,
                           batch_reduce, grow_state, lookup, make_state,
                           merge, sanitize_keys)

# Aggregate kinds the device step supports.
DEVICE_AGG_KINDS = ("count", "count_star", "sum", "avg", "min", "max")


def torch_dtype(dt) -> torch.dtype:
    """numpy / torch dtype -> torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dt))).dtype


@dataclass(frozen=True)
class DeviceCall:
    """One aggregate call, lowered: which payload columns it owns and how to
    turn them into an output."""
    kind: str                   # one of DEVICE_AGG_KINDS
    acc_dtype: torch.dtype      # dtype of the accumulator / output
    cols: Tuple[int, ...]       # payload column indices (in state.vals)
    minput: Optional[int] = None  # index into spec.minputs (retractable m/m)


@dataclass(frozen=True)
class MinputDesc:
    """One retractable min/max multiset state (minput.py). Shared by every
    min/max call over the same input column (ms_group_minmax returns both
    extremes from one search); call_idx names the value-source call."""
    call_idx: int


class DeviceAggState(NamedTuple):
    """Main sorted-run state + one sorted multiset per retractable
    min/max input."""
    main: SortedState
    minputs: Tuple[SortedMultiset, ...]


@dataclass(frozen=True)
class DeviceAggSpec:
    """Static layout of the state payload.

    Payload column 0 is always row_count (SUM of signs) — group liveness.
    Each call then owns payload columns:
      count      -> [valid_count SUM]
      sum        -> [sum SUM, valid_count SUM]     (NULL when no valid rows)
      avg        -> [sum SUM, valid_count SUM]
      min / max  -> append-only build: [extreme MIN/MAX, valid_count SUM];
                    retractable build: [valid_count SUM] + a SortedMultiset
                    side state (`spec.minputs`)
    """
    calls: Tuple[DeviceCall, ...]
    kinds: Tuple[ReduceKind, ...]
    dtypes: Tuple[torch.dtype, ...]
    append_only: bool
    minputs: Tuple[MinputDesc, ...] = ()

    @staticmethod
    def build(call_kinds: Sequence[str], in_dtypes: Sequence[Any],
              append_only: bool = True,
              arg_ids: Optional[Sequence[Any]] = None) -> "DeviceAggSpec":
        """append_only=True keeps min/max as one extreme column (cheapest;
        wrong under retraction). append_only=False gives min/max calls a
        multiset side state — exact under deletes. arg_ids (hashable per
        call) lets min(x) and max(x) over the same column share one
        multiset."""
        kinds: List[ReduceKind] = [ReduceKind.SUM]       # row_count
        dtypes: List[torch.dtype] = [torch.int64]
        calls: List[DeviceCall] = []
        minputs: List[MinputDesc] = []
        minput_by_arg: Dict[Any, int] = {}
        has_ao_minmax = False
        for i, (k, dt) in enumerate(zip(call_kinds, in_dtypes)):
            if k not in DEVICE_AGG_KINDS:
                raise ValueError(f"agg kind {k!r} has no device path")
            acc = torch.float64 if torch_dtype(dt).is_floating_point \
                else torch.int64
            c0 = len(kinds)
            if k in ("count", "count_star"):
                kinds.append(ReduceKind.SUM)
                dtypes.append(torch.int64)
                calls.append(DeviceCall(k, torch.int64, (c0,)))
            elif k in ("sum", "avg"):
                kinds += [ReduceKind.SUM, ReduceKind.SUM]
                dtypes += [acc, torch.int64]
                calls.append(DeviceCall(k, acc, (c0, c0 + 1)))
            elif append_only:  # min / max, single-extreme state
                has_ao_minmax = True
                kinds += [ReduceKind.MIN if k == "min" else ReduceKind.MAX,
                          ReduceKind.SUM]
                dtypes += [acc, torch.int64]
                calls.append(DeviceCall(k, acc, (c0, c0 + 1)))
            else:  # min / max, retractable multiset state
                kinds.append(ReduceKind.SUM)
                dtypes.append(torch.int64)
                aid = arg_ids[i] if arg_ids is not None else ("call", i)
                mi = minput_by_arg.get(aid)
                if mi is None:
                    mi = len(minputs)
                    minput_by_arg[aid] = mi
                    minputs.append(MinputDesc(len(calls)))
                calls.append(DeviceCall(k, acc, (c0,), minput=mi))
        return DeviceAggSpec(tuple(calls), tuple(kinds), tuple(dtypes),
                             has_ao_minmax, tuple(minputs))

    def make_state(self, capacity: int, device) -> SortedState:
        return make_state(capacity, self.dtypes, self.kinds, device)


def _row_deltas(spec: DeviceAggSpec, signs, mask,
                inputs: Sequence[Tuple[Any, Any]]) -> List[torch.Tensor]:
    """Per-row payload delta columns from raw rows.
    inputs[i] = (values[B], valid[B]) for call i (count_star passes anything).
    """
    s64 = torch.where(mask, signs, 0).to(torch.int64)
    deltas: List[Optional[torch.Tensor]] = [None] * len(spec.kinds)
    deltas[0] = s64
    for call, (vals, valid) in zip(spec.calls, inputs):
        sv = s64 * valid.to(torch.int64)
        if call.kind == "count_star":
            deltas[call.cols[0]] = s64
        elif call.kind == "count":
            deltas[call.cols[0]] = sv
        elif call.kind in ("sum", "avg"):
            v = torch.where(valid & mask, vals, 0).to(call.acc_dtype)
            deltas[call.cols[0]] = v * sv.to(call.acc_dtype)
            deltas[call.cols[1]] = sv
        elif call.minput is not None:
            # retractable min/max: the main state keeps only valid_count;
            # the values live in the multiset side state (epoch_core_full)
            deltas[call.cols[0]] = sv
        else:  # min / max — append-only: neutral where invalid
            kind = spec.kinds[call.cols[0]]
            v = torch.where(valid & mask, vals.to(call.acc_dtype),
                            _neutral(kind, call.acc_dtype))
            deltas[call.cols[0]] = v
            deltas[call.cols[1]] = sv
    return deltas  # type: ignore[return-value]


def _outputs(spec: DeviceAggSpec, vals: Sequence[torch.Tensor]
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Payload columns -> (per-call output arrays, per-call NULL masks)."""
    outs, nulls = [], []
    for call in spec.calls:
        if call.kind in ("count", "count_star"):
            outs.append(vals[call.cols[0]])
            nulls.append(torch.zeros_like(vals[call.cols[0]],
                                          dtype=torch.bool))
        elif call.kind == "avg":
            cnt = vals[call.cols[1]]
            denom = torch.where(cnt == 0, 1, cnt).to(torch.float64)
            outs.append(vals[call.cols[0]].to(torch.float64) / denom)
            nulls.append(cnt == 0)
        elif call.minput is not None:
            # placeholder: the values come from the multiset through
            # epoch_core_full's minput change entries; the NULL mask from
            # valid_count still holds
            outs.append(torch.zeros_like(vals[call.cols[0]]))
            nulls.append(vals[call.cols[0]] == 0)
        else:  # sum, min, max
            outs.append(vals[call.cols[0]])
            nulls.append(vals[call.cols[1]] == 0)
    return outs, nulls


def _core_tail(spec: DeviceAggSpec, state: SortedState,
               ukeys: torch.Tensor, udeltas, ucount: torch.Tensor):
    """The merge half of the epoch pipeline: unique per-key deltas ->
    state merge + old/new change set. Shared by the raw-row path
    (`epoch_core`) and the pre-combined path (`epoch_core_combined`)."""
    old_found, old_vals = lookup(state, ukeys)
    new_state, needed = merge(state, ukeys, udeltas, spec.kinds)
    new_found, new_vals = lookup(new_state, ukeys)
    old_out, old_null = _outputs(spec, old_vals)
    new_out, new_null = _outputs(spec, new_vals)
    changes = {
        "keys": ukeys, "count": ucount,
        "old_found": old_found, "new_found": new_found,
        "old_out": tuple(old_out), "old_null": tuple(old_null),
        "new_out": tuple(new_out), "new_null": tuple(new_null),
        "old_vals": tuple(old_vals), "new_vals": tuple(new_vals),
    }
    return new_state, needed, changes


def epoch_core(spec: DeviceAggSpec, state: SortedState,
               keys: torch.Tensor, signs: torch.Tensor, mask: torch.Tensor,
               inputs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]):
    """One epoch of raw rows: (new_state, needed, change set)."""
    deltas = _row_deltas(spec, signs, mask, inputs)
    ukeys, udeltas, ucount = batch_reduce(keys, mask, deltas, spec.kinds)
    return _core_tail(spec, state, ukeys, udeltas, ucount)


def precombine_core(spec: DeviceAggSpec,
                    keys: torch.Tensor, signs: torch.Tensor,
                    mask: torch.Tensor,
                    inputs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]):
    """Collapse an epoch's raw rows to ONE partial-aggregate row per
    unique group key. Returns (ukeys, ucnt, udeltas): key-sorted with
    EMPTY_KEY padding, live rows a prefix; `ucnt` is the raw-row count
    behind each combined row. Exact only for integer SUM columns and no
    multiset state — the caller guarantees both."""
    live = mask & (signs != 0)
    deltas = _row_deltas(spec, signs, mask, inputs)
    cnt = torch.where(live, 1, 0).to(torch.int64)
    ukeys, uvals, _ = batch_reduce(keys, live, [cnt] + list(deltas),
                                   (ReduceKind.SUM,) + spec.kinds)
    return ukeys, uvals[0], tuple(uvals[1:])


def epoch_core_combined(spec: DeviceAggSpec, state: SortedState,
                        keys: torch.Tensor, counts: torch.Tensor,
                        dvals, mask: torch.Tensor):
    """Epoch pipeline over PRE-COMBINED rows (key, raw-row count, partial
    deltas). Returns (new_state, needed, changes) like `epoch_core`, plus
    changes["rows_in"] (raw rows behind the input) and "in_counts"."""
    ukeys, uvals, ucount = batch_reduce(
        keys, mask, [counts.to(torch.int64)] + list(dvals),
        (ReduceKind.SUM,) + spec.kinds)
    new_state, needed, ch = _core_tail(spec, state, ukeys, uvals[1:],
                                       ucount)
    ch["rows_in"] = torch.sum(uvals[0])
    ch["in_counts"] = uvals[0]
    return new_state, needed, ch


def epoch_core_full(spec: DeviceAggSpec, state: DeviceAggState,
                    keys: torch.Tensor, signs: torch.Tensor,
                    mask: torch.Tensor,
                    inputs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]):
    """epoch_core + the retractable min/max multisets: the main-state
    merge and every minput's sort-merge + extremes. Returns (state',
    (needed, ms_needed), changes).

    changes gains, per minput i, a dict `minput{i}`:
      old_min/old_max/new_min/new_max — group extremes (order-encoded
      int64) aligned with changes["keys"], gated by old/new_found;
      u1/u2/u_cnt — touched (group, value) pairs and their post-merge
      multiplicities (0 = pair died).
    """
    new_main, needed, ch = epoch_core(spec, state.main, keys, signs, mask,
                                      inputs)
    s64 = torch.where(mask, signs, 0).to(torch.int64)
    new_ms: List[SortedMultiset] = []
    ms_needed: List[torch.Tensor] = []
    for mi, desc in enumerate(spec.minputs):
        vals, valid = inputs[desc.call_idx]
        u1, u2, ud = ms_batch_reduce(keys, vals.to(torch.int64), s64,
                                     mask & valid)
        old_f, old_mn, old_mx = ms_group_minmax(state.minputs[mi],
                                                ch["keys"])
        nms, need = ms_merge(state.minputs[mi], u1, u2, ud)
        new_f, new_mn, new_mx = ms_group_minmax(nms, ch["keys"])
        pf, pc = ms_find(nms, u1, u2)
        ch[f"minput{mi}"] = {
            "old_found": old_f, "old_min": old_mn, "old_max": old_mx,
            "new_found": new_f, "new_min": new_mn, "new_max": new_mx,
            "u1": u1, "u2": u2, "u_cnt": torch.where(pf, pc, 0),
        }
        new_ms.append(nms)
        ms_needed.append(need)
    return (DeviceAggState(new_main, tuple(new_ms)),
            (needed, tuple(ms_needed)), ch)


def local_epoch_step(spec: DeviceAggSpec, state: DeviceAggState,
                     keys: torch.Tensor, signs: torch.Tensor,
                     mask: torch.Tensor,
                     inputs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]):
    """One epoch's local aggregation step over the rows this program
    instance owns: on one device, every row (`epoch_core_full`)."""
    return epoch_core_full(spec, state, keys, signs, mask, inputs)


def agg_epoch_step_full(spec: DeviceAggSpec, state: DeviceAggState,
                        keys: torch.Tensor, signs: torch.Tensor,
                        mask: torch.Tensor,
                        inputs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]):
    """The full epoch step (`epoch_core_full`), eagerly."""
    return epoch_core_full(spec, state, keys, signs, mask, inputs)


def agg_epoch_step_packed(spec: DeviceAggSpec, state: DeviceAggState,
                          p64: torch.Tensor, p8: torch.Tensor):
    """agg_epoch_step_full fed from two packed host buffers, so the host
    ships two arrays instead of 3 + 2 * n_calls: ONE int64 matrix
    `p64` [1 + n, B] (row 0: keys; row 1 + i: call i's values, floats as
    raw f64 bits) and ONE int8 matrix `p8` [2 + n, B] (row 0: signs; row
    1: row mask; row 2 + i: call i's validity).

    The rows of `p64` are views: a float call's row becomes float64 by
    reinterpreting its bits, and a minput call's row stays order-encoded
    int64, float column or not. `p8` is unpacked by one launch
    (`kernels.agg_unpack`)."""
    keys = p64[0]
    signs, mask, valid = agg_unpack(p8, len(spec.calls))
    ins = []
    for i, call in enumerate(spec.calls):
        v = p64[1 + i]
        if call.minput is None and call.acc_dtype.is_floating_point:
            v = v.view(torch.float64)
        ins.append((v, valid[i]))
    return epoch_core_full(spec, state, keys, signs, mask, tuple(ins))


def agg_epoch_step(spec: DeviceAggSpec, state: SortedState,
                   keys: torch.Tensor, signs: torch.Tensor,
                   mask: torch.Tensor,
                   inputs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]):
    """Apply one epoch of rows; return (new_state, needed, change set).

    Change set tensors are sized [B] (unique touched keys); the host
    assembles the barrier change chunk from them (insert / delete /
    update pair per key)."""
    return epoch_core(spec, state, keys, signs, mask, inputs)


# change-set entries only the fused pipeline reads; the SQL executor
# derives outputs from the raw payload columns instead, so flush_epoch
# skips transferring these to the host
_PULL_DROP = ("old_out", "new_out", "old_null", "new_null")
# minput entries aligned with changes["keys"] (sliceable to its live head)
_MINPUT_KEYS_ALIGNED = ("old_found", "old_min", "old_max",
                        "new_found", "new_min", "new_max")


def _tree_map(fn, tree):
    """`fn` over every leaf of a dict / tuple / list tree, in order."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _slice_head(tree, m: int):
    """Every leaf of at least one dimension cut to its first m rows (a
    view); scalars as they are."""
    return _tree_map(lambda a: a[:m] if a.dim() >= 1 else a, tree)


def pull_async(leaves: Sequence[torch.Tensor]):
    """Tensors -> (host copies, events): each leaf on a card is copied
    without blocking into a pinned host buffer, and one event is recorded
    on the current stream of each card the leaves lie on; a CPU leaf is
    cloned. The host copies may be read after `wait_pulled(events)`."""
    host, cards = [], set()
    for t in leaves:
        if t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            cards.add(t.device)
        else:
            h = t.clone()
        host.append(h)
    events = []
    for d in cards:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events.append(ev)
    return host, events


def wait_pulled(events) -> None:
    """Block until the copies of a `pull_async` have landed."""
    for ev in events:
        ev.synchronize()


def _to_host(tree):
    """Every tensor leaf of a tree as a numpy array, with one wait per
    card the leaves lie on (`pull_async`)."""
    leaves: List[torch.Tensor] = []
    _tree_map(leaves.append, tree)
    host, events = pull_async(leaves)
    wait_pulled(events)
    arrays = iter([h.numpy() for h in host])
    return _tree_map(lambda _: next(arrays), tree)


def _pull_changes(changes: Dict[str, Any], formatted: bool = True,
                  count: Optional[int] = None) -> Dict[str, Any]:
    """Device change set -> host numpy, moving as little as it can: drop
    pipeline-only entries when unwanted, cut keys-aligned tensors to the
    live-prefix pow2 bucket (batch_reduce compacts live keys to a
    prefix), then one synchronised pull of every leaf (`_to_host`).
    minput u1/u2/u_cnt have their own (possibly longer) live prefix, so
    they come back whole."""
    ch = {k: v for k, v in changes.items()
          if formatted or k not in _PULL_DROP}
    b = ch["keys"].shape[0]
    if count is None:
        count = int(ch["count"])
    m = _bucket(count, lo=256)
    if m < b:
        sliced = {k: _slice_head(v, m) for k, v in ch.items()
                  if not k.startswith("minput")}
        for k, v in ch.items():
            if k.startswith("minput"):
                sub = dict(v)
                sub.update(_slice_head(
                    {kk: sub[kk] for kk in _MINPUT_KEYS_ALIGNED}, m))
                sliced[k] = sub
        ch = sliced
    return _to_host(ch)


def _h2d(a, device) -> torch.Tensor:
    """A host array (or numpy scalar) as a tensor on `device`, its shape
    kept (a 0-d count stays 0-d)."""
    return torch.as_tensor(np.asarray(a), device=device)


def _acc_cast(v: np.ndarray) -> np.ndarray:
    """Host -> device accumulator dtype: floats widen to f64, ints to i64."""
    return v.astype(np.float64 if np.issubdtype(v.dtype, np.floating)
                    else np.int64)


class DeviceHashAgg:
    """Host wrapper: owns the state, buffers the epoch's rows, applies
    them at the barrier, and grows capacity on overflow (grow, then replay
    the epoch on the grown state)."""

    def __init__(self, spec: DeviceAggSpec, capacity: int = 1024,
                 pull_formatted: bool = True, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        # False = flush_epoch skips transferring the device-formatted
        # output entries (the SQL executor formats from raw payloads)
        self.pull_formatted = pull_formatted
        self.state = spec.make_state(capacity, self.device)
        self.minputs: Tuple[SortedMultiset, ...] = tuple(
            ms_make(capacity, self.device) for _ in spec.minputs)
        self._keys: List[np.ndarray] = []
        self._signs: List[np.ndarray] = []
        self._inputs: List[List[Tuple[np.ndarray, np.ndarray]]] = []
        # growth replays made (an epoch re-run on grown state)
        self.growth_replays = 0

    def load_state(self, keys: np.ndarray,
                   vals: Sequence[np.ndarray]) -> None:
        """Recovery: install (key, payload...) rows as the current state
        (rows come from the persisted state table at the committed
        epoch)."""
        keys = sanitize_keys(keys)
        order = np.argsort(keys, kind="stable")
        n = len(keys)
        cap = _bucket(max(n, self.state.capacity))
        st = self.spec.make_state(cap, "cpu")
        st.keys[:n] = torch.from_numpy(keys[order])
        for v0, v in zip(st.vals, vals):
            v0[:n] = torch.from_numpy(np.asarray(v)[order])
        dev = self.device
        self.state = SortedState(st.keys.to(dev), _h2d(np.int32(n), dev),
                                 tuple(v.to(dev) for v in st.vals))

    def live_main(self) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Host pull of the live (key, payload...) rows — watermark state
        cleaning filters these and re-installs via load_state."""
        n = int(self.state.count)
        keys, vals = _to_host((self.state.keys[:n],
                               tuple(v[:n] for v in self.state.vals)))
        return keys, list(vals)

    def live_minput(self, mi: int) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
        ms = self.minputs[mi]
        n = int(ms.count)
        return _to_host((ms.k1[:n], ms.k2[:n], ms.cnt[:n]))

    def load_minput(self, mi: int, k1: np.ndarray, k2: np.ndarray,
                    cnt: np.ndarray) -> None:
        """Recovery: install a minput multiset's (group, value, count)
        rows. Values (k2) are NOT sanitized — padding is k1-discriminated."""
        k1 = sanitize_keys(k1)
        k2 = np.asarray(k2, np.int64)
        order = np.lexsort((k2, k1))
        n = len(k1)
        cap = _bucket(max(n, self.minputs[mi].capacity))
        gk1 = np.full(cap, EMPTY_KEY, np.int64)
        gk2 = np.full(cap, EMPTY_KEY, np.int64)
        gc = np.zeros(cap, np.int64)
        gk1[:n], gk2[:n] = k1[order], k2[order]
        gc[:n] = np.asarray(cnt, np.int64)[order]
        dev = self.device
        ms = SortedMultiset(_h2d(gk1, dev), _h2d(gk2, dev),
                            _h2d(np.int32(n), dev), _h2d(gc, dev))
        self.minputs = self.minputs[:mi] + (ms,) + self.minputs[mi + 1:]

    def push_rows(self, keys: np.ndarray, signs: np.ndarray,
                  inputs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
        if self.spec.append_only and (np.asarray(signs) < 0).any():
            raise ValueError(
                "retraction through an append-only (min/max) device agg — "
                "use the exact host path (aggregate/minput.rs analog)")
        self._keys.append(sanitize_keys(keys))
        self._signs.append(signs.astype(np.int32))
        self._inputs.append([(np.asarray(v), np.asarray(m))
                             for v, m in inputs])

    def flush_epoch(self) -> Optional[Dict[str, Any]]:
        """Run the epoch step; returns the change set (host numpy) or None.

        Two H2D copies carry the epoch (`agg_epoch_step_packed`); the
        capacity needs and the live count come back in one transfer; the
        change set is cut to its live head on the device and pulled with
        one synchronisation (`_pull_changes`), without the formatted
        entries the SQL executor does not read."""
        if not self._keys:
            return None
        keys = np.concatenate(self._keys)
        signs = np.concatenate(self._signs)
        ncalls = len(self.spec.calls)
        ins = []
        for i in range(ncalls):
            vs = np.concatenate([b[i][0] for b in self._inputs])
            ms = np.concatenate([b[i][1] for b in self._inputs])
            ins.append((vs, ms))
        self._keys, self._signs, self._inputs = [], [], []
        b = _bucket(len(keys))
        n = len(keys)
        # two packed buffers -> two H2D transfers in all (see
        # agg_epoch_step_packed): int64 values (floats bit-cast) + int8
        # flags
        p64 = np.zeros((1 + ncalls, b), dtype=np.int64)
        p8 = np.zeros((2 + ncalls, b), dtype=np.int8)
        p64[0, :n] = keys
        p8[0, :n] = signs
        p8[1, :n] = 1
        for i, (v, m) in enumerate(ins):
            av = _acc_cast(v)
            p64[1 + i, :n] = av.view(np.int64) \
                if av.dtype == np.float64 else av
            p8[2 + i, :n] = m.astype(np.int8)
        tp64, tp8 = _h2d(p64, self.device), _h2d(p8, self.device)
        while True:
            full = DeviceAggState(self.state, self.minputs)
            new_full, (needed, ms_needed), changes = agg_epoch_step_packed(
                self.spec, full, tp64, tp8)
            # one transfer for every control scalar
            ctl = torch.stack([t.to(torch.int64) for t in
                               (needed, *ms_needed, changes["count"])]
                              ).cpu().tolist()
            needed_h, ms_needed_h, count_h = ctl[0], ctl[1:-1], ctl[-1]
            # predictive growth (device/capacity.py): size ahead of the
            # observed need so one grow skips the intermediate pow2
            # buckets (each one an epoch replayed)
            grown = False
            if needed_h > self.state.capacity:
                self.state = grow_state(
                    self.state,
                    predict_capacity(needed_h, self.state.capacity),
                    self.spec.kinds)
                grown = True
            for i, nd in enumerate(ms_needed_h):
                if nd > self.minputs[i].capacity:
                    ms = ms_grow(self.minputs[i],
                                 predict_capacity(nd,
                                                  self.minputs[i].capacity))
                    self.minputs = (self.minputs[:i] + (ms,)
                                    + self.minputs[i + 1:])
                    grown = True
            if grown:
                self.growth_replays += 1
                continue
            self.state, self.minputs = new_full.main, new_full.minputs
            return _pull_changes(changes, self.pull_formatted,
                                 count=count_h)
