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

from .minput import (SortedMultiset, ms_batch_reduce, ms_find,
                     ms_group_minmax, ms_merge)
from .sorted_state import (ReduceKind, SortedState, _neutral, batch_reduce,
                           lookup, make_state, merge)

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

