"""DeviceHashAggExecutor — the SQL-visible device aggregation executor
(the port's own copy of the JAX package's `ops/device_agg.py`).

This is the dispatch seam the reference wires in `from_proto/mod.rs:151-197`
(NodeBody::HashAgg -> HashAggExecutor): the planner lowers an eligible
aggregation fragment onto this executor instead of the per-row host
`HashAggExecutor`. Protocol-identical from the outside — consumes
Chunk|Barrier|Watermark, emits barrier-aligned change chunks, commits its
state table — but the group maintenance runs as one device epoch step per
barrier (`device/agg_step.py`: `DeviceHashAgg` over
`agg_epoch_step_packed`, on `cuda:0` unless the caller passes a device),
or, with a `mesh` (`parallel/mesh.py`), the vnode-sharded engine
(`parallel/sharded_agg.ShardedHashAgg`).

Exactness contract:
* group keys: lossless bit-packing for narrow keys, hash64 + host decode
  dictionary with collision DETECTION otherwise (`device/key_codec.py`);
* outputs are derived host-side from the raw device payload columns, so
  integer sum/avg keep the exact Decimal semantics of the host path
  (`expr/agg.py`); float aggregation order differs (segment-reduce vs
  arrival order) — the same non-associativity the reference accepts across
  parallel actors;
* recovery: payload columns persist per dirty key per barrier into the
  state table (the `minput.rs` partial-state analog, not opaque pickles).
"""
from __future__ import annotations

from decimal import Decimal
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core import dtypes as T
from ..core.chunk import Op, StreamChunk, StreamChunkBuilder
from ..core.dtypes import DataType, TypeKind
from ..core.schema import Field, Schema
from ..expr.agg import AggCall
from ..state.state_table import StateTable
from .executor import Executor, UnaryExecutor


def _is_float(d) -> bool:
    """A spec dtype (torch) or a numpy dtype: floating point?"""
    return d.is_floating_point if hasattr(d, "is_floating_point") \
        else np.issubdtype(np.dtype(d), np.floating)
from .message import Barrier, Message, Watermark

_SUMMABLE = (TypeKind.INT16, TypeKind.INT32, TypeKind.INT64, TypeKind.SERIAL,
             TypeKind.FLOAT32, TypeKind.FLOAT64)


def _spec_kinds(calls: Sequence[AggCall]) -> List[str]:
    """Host AggCall kinds -> device spec kinds (count(*) has arg None)."""
    return ["count_star" if c.kind == "count" and c.arg is None else c.kind
            for c in calls]


def device_agg_eligible(calls: Sequence[AggCall],
                        include_minmax: bool = True,
                        append_only: bool = False) -> bool:
    """Can this aggregation fragment run on the device path?

    count/sum/avg are exact under retraction; min/max are exact via the
    sorted-multiset side state (`device/minput.py`, the `minput.rs`
    analog) — or, over an append-only input, via a single monotone extreme
    column (the reference's append-only agg specialization,
    `aggregate/agg_impl.rs`), which needs no side state at all.
    DISTINCT/filtered calls and exotic kinds stay on the exact host path.
    """
    for c in calls:
        if c.distinct or c.filter is not None:
            return False
        if c.kind == "count":
            continue                      # needs only the validity mask
        if c.kind in ("sum", "avg"):
            if c.arg is None or c.arg.return_type.kind not in _SUMMABLE:
                return False
        elif c.kind in ("min", "max"):
            if not (include_minmax or append_only) or c.arg is None:
                return False
            rt = c.arg.return_type
            if rt.device_dtype is None or rt.kind == TypeKind.BOOLEAN:
                return False
        else:
            return False
    return True


def _build_sql_spec(calls: Sequence[AggCall], append_only: bool = False):
    """The device spec for these calls. Retractable (SQL default) unless
    the input fragment is append-only; retractable min/max over the same
    input column (InputRef) share one multiset."""
    from ..device.agg_step import DeviceAggSpec
    from ..expr.expression import InputRef
    arg_ids = [("ref", c.arg.index) if isinstance(c.arg, InputRef)
               else ("call", i) for i, c in enumerate(calls)]
    return DeviceAggSpec.build(_spec_kinds(calls),
                               [_arg_np_dtype(c) for c in calls],
                               append_only=append_only, arg_ids=arg_ids)


def device_payload_dtypes(calls: Sequence[AggCall],
                          append_only: bool = False) -> List[DataType]:
    """SQL dtypes of the persisted device payload columns (state-table
    layout; must match DeviceAggSpec.build's column order)."""
    spec = _build_sql_spec(calls, append_only)
    out = []
    for d in spec.dtypes:
        out.append(T.FLOAT64 if _is_float(d) else T.INT64)
    return out


def device_minput_count(calls: Sequence[AggCall],
                        append_only: bool = False) -> int:
    """How many minput side tables the executor persists (one per
    retractable min/max call): rows are (group..., encoded value, count)."""
    return len(_build_sql_spec(calls, append_only).minputs)


def _arg_np_dtype(c: AggCall):
    if c.arg is None or c.arg.return_type.device_dtype is None:
        return np.int64
    dt = np.dtype(c.arg.return_type.device_dtype)
    return np.float64 if np.issubdtype(dt, np.floating) else np.int64


class DeviceHashAggExecutor(UnaryExecutor):
    """Device-resident group-by aggregation behind the executor protocol.
    `device` (None = `cuda:0`) is where its state lives."""

    def __init__(self, input: Executor, group_key_indices: Sequence[int],
                 calls: Sequence[AggCall],
                 state_table: Optional[StateTable] = None,
                 minput_tables: Sequence[StateTable] = (),
                 mesh: Optional[Any] = None, capacity: int = 1024,
                 append_only: bool = False, device=None):
        in_schema = input.schema
        fields = [in_schema.fields[i] for i in group_key_indices]
        fields += [Field(f"agg#{i}", c.return_type)
                   for i, c in enumerate(calls)]
        super().__init__(input, Schema(fields), "DeviceHashAgg")
        self.group_key_indices = list(group_key_indices)
        self.calls = list(calls)
        self.state_table = state_table
        self.minput_tables = list(minput_tables)
        self._recovered = state_table is None
        self._key_dtypes = [in_schema.fields[i].dtype
                            for i in group_key_indices]
        self._clean_wm: Optional[Tuple[int, Any]] = None
        self.input_append_only = append_only

        from ..device.key_codec import make_codec
        self.spec = _build_sql_spec(calls, append_only)
        assert len(self.minput_tables) in (0, len(self.spec.minputs)), \
            "one minput state table per retractable min/max call"
        # call_idx -> is the minput value order-encoded from floats?
        self._minput_float = {
            ci: np.issubdtype(
                np.dtype(calls[ci].arg.return_type.device_dtype),
                np.floating)
            for ci, dc in enumerate(self.spec.calls) if dc.minput is not None}
        self.codec = make_codec(self._key_dtypes)
        # int64 accumulator overflow guard: running bound on the total
        # absolute magnitude ever pushed into integer sum columns. The host
        # path accumulates in unbounded Decimal; the device wraps at 2^63.
        # The bound is conservative (ignores retraction cancellation), so
        # staying under 2^62 PROVES no wrap occurred; crossing it fails
        # loudly instead of silently diverging.
        self._int_sum_bound = 0
        self._int_sum_calls = [i for i, (c, dc) in
                               enumerate(zip(calls, self.spec.calls))
                               if c.kind in ("sum", "avg")
                               and not _is_float(dc.acc_dtype)]
        self.device = device
        self.mesh = mesh
        self._capacity = capacity
        self.engine: Any = self._make_engine(mesh, capacity)

    def _make_engine(self, mesh: Optional[Any], capacity: int) -> Any:
        if mesh is not None:
            from ..parallel.sharded_agg import ShardedHashAgg
            return ShardedHashAgg(self.spec, mesh, capacity=capacity,
                                  pull_formatted=False)
        from ..device.agg_step import DeviceHashAgg
        return DeviceHashAgg(self.spec, capacity=capacity,
                             pull_formatted=False, device=self.device)

    def rescale_mesh(self, mesh: Optional[Any]) -> None:
        """Barrier-boundary elastic rescale (`scale.rs:2329` analog):
        lift the live device state off the old mesh and re-install it
        vnode-sharded onto the new one (None = single chip). The caller
        (Database._alter_parallelism) guarantees the in-flight barrier
        committed, so the epoch buffers are empty."""
        assert not getattr(self.engine, "_keys", None) \
            and not getattr(self.engine, "_rows", None), \
            "rescale requires a barrier boundary (buffered rows pending)"
        n_new = mesh.n if mesh is not None else 1
        n_old = self.mesh.n if self.mesh is not None else 1
        if n_new == n_old:
            return
        keys, vals = self.engine.live_main()
        minputs = [self.engine.live_minput(mi)
                   for mi in range(len(self.spec.minputs))]
        self.mesh = mesh
        self.engine = self._make_engine(mesh, self._capacity)
        if len(keys):
            self.engine.load_state(keys, vals)
        for mi, (k1, k2, cnt) in enumerate(minputs):
            if len(k1):
                self.engine.load_minput(mi, k1, k2, cnt)

    # ---- recovery -------------------------------------------------------
    def _recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        nk = len(self.group_key_indices)
        rows = list(self.state_table.iter_all())
        if rows:
            key_rows = [r[:nk] for r in rows]
            keys = self.codec.encode_rows(key_rows)
            self.codec.observe_rows(keys, key_rows)
            vals = []
            for j, d in enumerate(self.spec.dtypes):
                npd = np.float64 if _is_float(d) else np.int64
                vals.append(np.array([r[nk + j] for r in rows], dtype=npd))
            self.engine.load_state(keys, vals)
        for mi, tbl in enumerate(self.minput_tables):
            mrows = list(tbl.iter_all())
            if not mrows:
                continue
            key_rows = [r[:nk] for r in mrows]
            k1 = self.codec.encode_rows(key_rows)
            self.codec.observe_rows(k1, key_rows)
            k2 = np.array([r[nk] for r in mrows], dtype=np.int64)
            cnt = np.array([r[nk + 1] for r in mrows], dtype=np.int64)
            self.engine.load_minput(mi, k1, k2, cnt)

    # ---- data plane -----------------------------------------------------
    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        self._recover()
        chunk = chunk.compact()
        data = chunk.data_chunk()
        key_cols = [chunk.columns[i] for i in self.group_key_indices]
        keys = self.codec.encode_columns(key_cols)
        self.codec.observe_columns(keys, key_cols)
        inputs = []
        for ci, c in enumerate(self.calls):
            if c.arg is None:
                z = np.zeros(chunk.capacity, np.int64)
                inputs.append((z, np.ones(chunk.capacity, bool)))
                continue
            col = c.arg.eval(data)
            if self.spec.calls[ci].minput is not None:
                # minput value: order-preserving int64 encoding (floats via
                # order_encode). No sentinel remap — multiset padding is
                # discriminated by the GROUP key (k1) alone, so a value
                # equal to int64 max is legitimate and preserved exactly.
                from ..device.minput import order_encode_f64
                if self._minput_float[ci]:
                    enc = order_encode_f64(col.values.astype(np.float64))
                else:
                    enc = col.values.astype(np.int64, copy=False)
                vals = np.where(col.validity, enc, 0)
                inputs.append((vals.astype(np.int64), col.validity))
                continue
            npd = _arg_np_dtype(c)
            vals = col.values.astype(npd, copy=False) \
                if col.dtype.np_dtype != np.dtype(object) \
                else np.zeros(chunk.capacity, npd)
            vals = np.where(col.validity, vals, 0).astype(npd)
            inputs.append((vals, col.validity))
        for ci in self._int_sum_calls:
            v = inputs[ci][0]
            # float64 magnitude estimate with multiplicative slack covers
            # its rounding error; the 2x headroom to 2^63 does the rest
            self._int_sum_bound += int(
                np.abs(v.astype(np.float64)).sum() * 1.000001) + 1
            if self._int_sum_bound >= 1 << 62:
                raise OverflowError(
                    "device integer sum accumulator cannot prove no-wrap "
                    "(total pushed magnitude >= 2^62); run this query with "
                    "device='off' for unbounded Decimal accumulation")
        self.engine.push_rows(keys, chunk.signs(), inputs)
        return iter(())

    def on_barrier(self, barrier: Barrier) -> Iterator[Message]:
        self._recover()
        ch = self.engine.flush_epoch()
        if ch is not None:
            yield from self._emit_changes(ch, barrier)
        self._clean_state()
        if self.state_table is not None:
            self.state_table.commit(barrier.epoch.curr)
        for tbl in self.minput_tables:
            tbl.commit(barrier.epoch.curr)

    def _format_columns(self, vals: Sequence[np.ndarray], idxs: np.ndarray,
                        mm: Optional[Dict[int, np.ndarray]]
                        ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Vectorized `_format_row` over the selected state rows: per call,
        (values array in the output column's numpy dtype, validity mask).
        Only DECIMAL outputs pay a per-row conversion (object columns)."""
        outs: List[np.ndarray] = []
        valids: List[np.ndarray] = []
        n = len(idxs)
        for ci, (call, dc) in enumerate(zip(self.calls, self.spec.calls)):
            rt = call.return_type
            if call.kind == "count":
                outs.append(vals[dc.cols[0]][idxs].astype(np.int64))
                valids.append(np.ones(n, dtype=bool))
                continue
            if call.kind in ("sum", "avg"):
                acc = vals[dc.cols[0]][idxs]
                cnt = vals[dc.cols[1]][idxs].astype(np.int64)
                valid = cnt > 0
                if rt.kind == TypeKind.DECIMAL:
                    v = np.empty(n, dtype=object)
                    for j in np.flatnonzero(valid).tolist():
                        d = Decimal(int(acc[j]))
                        v[j] = d if call.kind == "sum" \
                            else d / Decimal(int(cnt[j]))
                elif call.kind == "sum":
                    v = acc.astype(rt.np_dtype)
                else:
                    v = (acc.astype(np.float64)
                         / np.where(valid, cnt, 1)).astype(rt.np_dtype)
                outs.append(v)
                valids.append(valid)
            elif dc.minput is not None:
                # retractable min/max: extreme from the multiset changes
                cnt = vals[dc.cols[0]][idxs].astype(np.int64)
                valid = cnt > 0
                if mm is None:
                    valid = np.zeros(n, dtype=bool)
                    enc = np.zeros(n, dtype=np.int64)
                else:
                    enc = mm[ci][idxs]
                if self._minput_float[ci]:
                    from ..device.minput import order_decode_f64
                    outs.append(order_decode_f64(enc).astype(rt.np_dtype))
                else:
                    outs.append(enc.astype(rt.np_dtype))
                valids.append(valid)
            else:  # min / max, append-only: monotone extreme column
                cnt = vals[dc.cols[1]][idxs].astype(np.int64)
                outs.append(vals[dc.cols[0]][idxs].astype(rt.np_dtype))
                valids.append(cnt > 0)
        return outs, valids

    @staticmethod
    def _interleave(old: np.ndarray, new: np.ndarray) -> np.ndarray:
        out = np.empty(2 * len(old), dtype=old.dtype)
        out[0::2] = old
        out[1::2] = new
        return out

    def _emit_changes(self, ch: Dict[str, Any],
                      barrier: Barrier) -> Iterator[Message]:
        from ..device.sorted_state import EMPTY_KEY
        keys = np.asarray(ch["keys"]).reshape(-1)
        old_found = np.asarray(ch["old_found"]).reshape(-1)
        new_found = np.asarray(ch["new_found"]).reshape(-1)
        old_vals = [np.asarray(v).reshape(-1) for v in ch["old_vals"]]
        new_vals = [np.asarray(v).reshape(-1) for v in ch["new_vals"]]
        live = (keys != EMPTY_KEY) & (old_found | new_found)
        idxs = np.flatnonzero(live)
        if len(idxs) == 0:
            return
        # per-call extreme arrays (encoded) for old/new formatting; min and
        # max calls over one column read opposite ends of a shared multiset
        mm_old: Dict[int, np.ndarray] = {}
        mm_new: Dict[int, np.ndarray] = {}
        for ci, dc in enumerate(self.spec.calls):
            if dc.minput is None:
                continue
            sub = ch[f"minput{dc.minput}"]
            which = ("old_max", "new_max") if self.calls[ci].kind == "max" \
                else ("old_min", "new_min")
            mm_old[ci] = np.asarray(sub[which[0]]).reshape(-1)
            mm_new[ci] = np.asarray(sub[which[1]]).reshape(-1)
        of = old_found[idxs]
        nf = new_found[idxs]
        key_cols = self.codec.decode_columns(keys[idxs])
        new_cols, new_valid = self._format_columns(new_vals, idxs, mm_new)
        old_cols, old_valid = self._format_columns(old_vals, idxs, mm_old)
        upd = of & nf
        ins = nf & ~of
        dead = of & ~nf
        # suppress no-op updates (old row == new row, NaN-strict like the
        # host tuple compare: NaN != NaN keeps the update)
        if upd.any():
            same = upd.copy()
            for ov, ovl, nv, nvl in zip(old_cols, old_valid,
                                        new_cols, new_valid):
                with np.errstate(invalid="ignore"):
                    eq = (ov == nv) & ovl & nvl | (~ovl & ~nvl)
                same &= np.asarray(eq, dtype=bool)
            upd &= ~same
        u_ix = np.flatnonzero(upd)
        i_ix = np.flatnonzero(ins)
        d_ix = np.flatnonzero(dead)
        n_out = 2 * len(u_ix) + len(i_ix) + len(d_ix)
        if n_out:
            ops = np.concatenate([
                np.tile(np.array([Op.UPDATE_DELETE, Op.UPDATE_INSERT],
                                 dtype=np.int8), len(u_ix)),
                np.full(len(i_ix), Op.INSERT, dtype=np.int8),
                np.full(len(d_ix), Op.DELETE, dtype=np.int8)])
            out_cols: List[Any] = []
            from ..core.chunk import Column
            nk = len(self.group_key_indices)
            for c in key_cols:
                vv = np.concatenate([self._interleave(c.values[u_ix],
                                                      c.values[u_ix]),
                                     c.values[i_ix], c.values[d_ix]])
                vl = np.concatenate([self._interleave(c.validity[u_ix],
                                                      c.validity[u_ix]),
                                     c.validity[i_ix], c.validity[d_ix]])
                out_cols.append(Column(self._key_dtypes[len(out_cols)],
                                       vv, vl))
            for j in range(len(self.calls)):
                vv = np.concatenate([self._interleave(old_cols[j][u_ix],
                                                      new_cols[j][u_ix]),
                                     new_cols[j][i_ix], old_cols[j][d_ix]])
                vl = np.concatenate([self._interleave(old_valid[j][u_ix],
                                                      new_valid[j][u_ix]),
                                     new_valid[j][i_ix], old_valid[j][d_ix]])
                out_cols.append(Column(self.schema.fields[nk + j].dtype,
                                       vv, vl))
            yield StreamChunk(ops, out_cols)
        self._persist_batch(key_cols, nf, dead, old_vals, new_vals, idxs)
        self._persist_minputs(ch)
        dead_keys = keys[idxs[dead]]
        if len(dead_keys):
            self.codec.forget(dead_keys)

    def _persist_batch(self, key_cols: Sequence[Any], nf: np.ndarray,
                       dead: np.ndarray, old_vals: Sequence[np.ndarray],
                       new_vals: Sequence[np.ndarray],
                       idxs: np.ndarray) -> None:
        """Bulk-upsert every touched live group's payload (and tombstone
        dead groups) into the state table — the per-barrier recovery write,
        vectorized end-to-end (`StateTable.write_chunk`)."""
        if self.state_table is None:
            return
        from ..core.chunk import Column
        n_ix = np.flatnonzero(nf)
        d_ix = np.flatnonzero(dead)
        if len(n_ix) == 0 and len(d_ix) == 0:
            return
        ops = np.concatenate([np.full(len(n_ix), Op.INSERT, dtype=np.int8),
                              np.full(len(d_ix), Op.DELETE, dtype=np.int8)])
        cols: List[Column] = []
        for c, dt in zip(key_cols, self._key_dtypes):
            cols.append(Column(
                dt, np.concatenate([c.values[n_ix], c.values[d_ix]]),
                np.concatenate([c.validity[n_ix], c.validity[d_ix]])))
        for j, d in enumerate(self.spec.dtypes):
            flt = _is_float(d)
            npd = np.float64 if flt else np.int64
            arr = np.concatenate([new_vals[j][idxs][n_ix],
                                  old_vals[j][idxs][d_ix]]).astype(npd)
            cols.append(Column(T.FLOAT64 if flt else T.INT64, arr))
        self.state_table.write_chunk(StreamChunk(ops, cols))

    def _persist_minputs(self, ch: Dict[str, Any]) -> None:
        """Upsert/delete the touched (group, value, count) multiset pairs
        into the per-minput state tables (decode before dead-key forget)."""
        if not self.minput_tables:
            return
        from ..core.chunk import Column
        from ..device.sorted_state import EMPTY_KEY
        for mi in range(len(self.spec.minputs)):
            sub = ch[f"minput{mi}"]
            u1 = np.asarray(sub["u1"]).reshape(-1)
            u2 = np.asarray(sub["u2"]).reshape(-1)
            uc = np.asarray(sub["u_cnt"]).reshape(-1)
            sel = np.flatnonzero(u1 != EMPTY_KEY)
            if len(sel) == 0:
                continue
            gcols = self.codec.decode_columns(u1[sel])
            ops = np.where(uc[sel] == 0, Op.DELETE, Op.INSERT) \
                .astype(np.int8)
            cols = [Column(dt, c.values, c.validity)
                    for c, dt in zip(gcols, self._key_dtypes)]
            cols.append(Column(T.INT64, u2[sel].astype(np.int64)))
            cols.append(Column(T.INT64, uc[sel].astype(np.int64)))
            self.minput_tables[mi].write_chunk(StreamChunk(ops, cols))

    # ---- watermark state cleaning (state_table.rs:1002 analog) ----------
    def _clean_state(self) -> None:
        """Drop groups proven final by a group-key watermark: filter the
        live device rows host-side and re-install via load_state /
        load_minput (no retraction — the MV keeps the rows)."""
        if self._clean_wm is None:
            return
        gi, wv = self._clean_wm
        self._clean_wm = None
        keys, vals = self.engine.live_main()
        if len(keys) == 0:
            return
        tuples = self.codec.decode(keys)
        drop = np.array([t[gi] is not None and t[gi] < wv for t in tuples])
        if not drop.any():
            return
        keep = ~drop
        self.engine.load_state(keys[keep], [v[keep] for v in vals])
        dropped = set(keys[drop].tolist())
        for mi in range(len(self.spec.minputs)):
            k1, k2, cnt = self.engine.live_minput(mi)
            mdrop = np.isin(k1, keys[drop])
            self.engine.load_minput(mi, k1[~mdrop], k2[~mdrop], cnt[~mdrop])
            if mi < len(self.minput_tables):
                tbl = self.minput_tables[mi]
                gts = self.codec.decode(k1[mdrop])
                for gt, v in zip(gts, k2[mdrop].tolist()):
                    tbl.delete(gt + (int(v), 0))
        if self.state_table is not None:
            zeros = tuple(0.0 if _is_float(d) else 0
                          for d in self.spec.dtypes)
            for i in np.flatnonzero(drop).tolist():
                self.state_table.delete(tuples[i] + zeros)
        self.codec.forget(np.fromiter(dropped, dtype=np.int64))

    def on_watermark(self, wm: Watermark) -> Iterator[Message]:
        if wm.col_idx in self.group_key_indices:
            gi = self.group_key_indices.index(wm.col_idx)
            self._clean_wm = (gi, wm.value)
            yield Watermark(gi, wm.dtype, wm.value)
