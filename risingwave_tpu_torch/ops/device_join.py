"""DeviceHashJoinExecutor — the SQL-visible device join executor (the
port's own copy of the JAX package's `ops/device_join.py`).

The dispatch-seam sibling of `ops/device_agg.py` for the reference's
north-star op (`src/stream/src/executor/hash_join.rs:575-686`): an INNER
equi-join whose match-finding runs as one device epoch step over sorted
(join_key, row_id) multimaps (`device/join_step.py`: `DeviceHashJoin`, on
`cuda:0` unless the caller passes a device), or, with a `mesh`
(`parallel/mesh.py`), the vnode-sharded engine
(`parallel/sharded_join.ShardedHashJoin`).

Division of labor:
* device — the quadratic part: per-epoch delta reduce, sorted-multimap
  merge, searchsorted probe, static-shape pair expansion. The state holds
  only (jk_hash, row_hash) per row: payload bytes never cross the PCIe
  boundary on the ingest path.
* host — row materialization: a row_hash -> row dictionary per side (the
  JoinHashMap cache analog) resolves each emitted pk pair to actual rows.
  Row identity is the hash of the WHOLE row, so an upstream update (U-/U+)
  with changed payload never cancels against itself in the delta reduce.
* exactness — emitted pairs are re-checked host-side for actual join-key
  equality (and non-NULL), so a 64-bit jk-hash collision costs a wasted
  candidate, never a wrong row; a row_hash collision is detected and
  raised (same contract as device/key_codec.DictCodec).

Non-inner join types, and conditions that need degree bookkeeping, stay on
the exact host path (`ops/join.py`) — the planner's seam decides.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.chunk import Op, StreamChunk, StreamChunkBuilder
from ..core.schema import Schema
from ..core.vnode import hash_columns64
from ..expr.expression import Expr
from ..state.state_table import StateTable
from .executor import Executor
from .message import Barrier, Message, Watermark


class _RowDict:
    """row_hash -> row with collision detection (one per side)."""

    __slots__ = ("rows",)

    def __init__(self):
        self.rows: Dict[int, Tuple] = {}

    def add(self, h: int, row: Tuple) -> None:
        old = self.rows.get(h)
        if old is None:
            self.rows[h] = row
        elif old != row:
            raise RuntimeError(
                f"64-bit row-identity collision: {old!r} vs {row!r}")

    def get(self, h: int) -> Tuple:
        return self.rows[h]

    def remove(self, h: int) -> None:
        self.rows.pop(h, None)


class DeviceHashJoinExecutor(Executor):
    """Device-resident INNER equi-join behind the executor protocol.
    `device` (None = `cuda:0`) is where its state lives."""

    def __init__(self, left: Executor, right: Executor,
                 left_keys: Sequence[int], right_keys: Sequence[int],
                 condition: Optional[Expr] = None,
                 left_state: Optional[StateTable] = None,
                 right_state: Optional[StateTable] = None,
                 mesh: Optional[Any] = None,
                 capacity: int = 1024, pair_capacity: int = 4096,
                 max_chunk_size: int = 1024, device=None):
        schema = left.schema.concat(right.schema)
        super().__init__(schema, "DeviceHashJoin")
        # INNER join of append-only inputs never retracts
        self.append_only = left.append_only and right.append_only
        self.left_exec, self.right_exec = left, right
        self.key_idx = {"a": list(left_keys), "b": list(right_keys)}
        self.condition = condition
        self.state_tables = {"a": left_state, "b": right_state}
        self._recovered = left_state is None and right_state is None
        self.max_chunk_size = max_chunk_size
        self.device = device
        self.mesh = mesh
        self._capacity = capacity
        self._pair_capacity = pair_capacity
        self.engine: Any = self._make_engine(mesh)
        self.dicts = {"a": _RowDict(), "b": _RowDict()}
        # per-epoch net state-row changes: rh -> (net sign, row). Drives
        # both state-table persistence and row-cache eviction — an entry is
        # evicted only when its NET count is negative, so a delete +
        # re-insert of the same row within one epoch (net zero, row stays
        # live in device state) keeps its cache entry.
        self._epoch_net: Dict[str, Dict[int, Tuple[int, Tuple]]] = \
            {"a": {}, "b": {}}
        # watermark min-alignment on equi-key pairs + state cleaning (same
        # contract as the host HashJoinExecutor)
        self._wm: Dict[str, Dict[int, Any]] = {"a": {}, "b": {}}
        self._emitted_wm: Dict[int, Any] = {}
        self._clean_wm: Dict[int, Any] = {}

    def _make_engine(self, mesh: Optional[Any]) -> Any:
        if mesh is not None:
            from ..parallel.sharded_join import ShardedHashJoin
            return ShardedHashJoin([], [], mesh, capacity=self._capacity,
                                   pair_capacity=self._pair_capacity)
        from ..device.join_step import DeviceHashJoin
        return DeviceHashJoin([], [], capacity=self._capacity,
                              pair_capacity=self._pair_capacity,
                              device=self.device)

    def rescale_mesh(self, mesh: Optional[Any]) -> None:
        """Barrier-boundary elastic rescale: rebuild the engine on the new
        mesh and lazily re-load both sides from the committed state tables
        (the recovery path — join state is fully durable per barrier, so
        re-recovery IS the reshard)."""
        buf = getattr(self.engine, "_buf", None)
        assert not buf or not any(buf.values()), \
            "rescale requires a barrier boundary (buffered rows pending)"
        n_new = mesh.n if mesh is not None else 1
        n_old = self.mesh.n if self.mesh is not None else 1
        if n_new == n_old:
            return
        assert all(st is not None for st in self.state_tables.values()), \
            "join rescale requires state tables (re-recovery reshard)"
        self.mesh = mesh
        self.engine = self._make_engine(mesh)
        self.dicts = {"a": _RowDict(), "b": _RowDict()}
        self._epoch_net = {"a": {}, "b": {}}
        # eager: the execute() generator only checks _recovered at stream
        # start, which already ran — reload both sides now (tables are
        # committed; the caller is at a barrier boundary)
        self._recovered = False
        self._recover()

    # ---- recovery -------------------------------------------------------
    def _recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        from ..core.chunk import Column
        for side in ("a", "b"):
            st = self.state_tables[side]
            if st is None:
                continue
            schema = (self.left_exec if side == "a"
                      else self.right_exec).schema
            n = len(schema)
            rows = [tuple(r[:n]) for r in st.iter_all()]
            if not rows:
                continue
            cols = [Column.from_list(f.dtype, [r[i] for r in rows])
                    for i, f in enumerate(schema.fields)]
            rh = hash_columns64(cols).view(np.int64)
            jk = hash_columns64([cols[i] for i in self.key_idx[side]]
                                ).view(np.int64)
            # NULL-keyed rows were never stored (inner-join semantics)
            for h, row in zip(rh.tolist(), rows):
                self.dicts[side].add(h, row)
            self.engine.load_side(side, jk, rh)

    # ---- data plane -----------------------------------------------------
    def _process_chunk(self, side: str, chunk: StreamChunk) -> None:
        chunk = chunk.compact()
        key_cols = [chunk.columns[i] for i in self.key_idx[side]]
        jk = hash_columns64(key_cols).view(np.int64)
        rh = hash_columns64(chunk.columns).view(np.int64)
        signs = chunk.signs()
        # inner-join NULL semantics: a NULL key matches nothing — such rows
        # are neither probed nor stored (hash_join.rs null-checks keys)
        valid = np.ones(chunk.capacity, bool)
        for c in key_cols:
            valid &= c.validity
        rows = chunk.rows()
        net = self._epoch_net[side]
        d = self.dicts[side]
        for i, row in enumerate(rows):
            if not valid[i]:
                continue
            h = int(rh[i])
            if signs[i] > 0:
                d.add(h, row)
                net[h] = (net.get(h, (0, row))[0] + 1, row)
            else:
                net[h] = (net.get(h, (0, row))[0] - 1, row)
        if valid.any():
            sel = np.flatnonzero(valid)
            self.engine.push_rows(side, jk[sel], rh[sel], signs[sel], [])

    def _assemble(self, outs, dels: List[Tuple], ins: List[Tuple]) -> None:
        sign = np.asarray(outs["sign"]).reshape(-1)
        a_pk = np.asarray(outs["a_pk"]).reshape(-1)
        b_pk = np.asarray(outs["b_pk"]).reshape(-1)
        mask = np.asarray(outs["mask"]).reshape(-1)
        live = np.flatnonzero(mask & (sign != 0))
        if len(live) == 0:
            return
        lk, rk = self.key_idx["a"], self.key_idx["b"]
        cond_rows: List[Tuple[int, Tuple]] = []
        for i in live.tolist():
            arow = self.dicts["a"].get(int(a_pk[i]))
            brow = self.dicts["b"].get(int(b_pk[i]))
            # exactness re-check: jk-hash collisions surface as candidates
            # with unequal actual keys — drop them (join on hash AND real
            # equality == join on real equality)
            ok = all(arow[x] == brow[y] and arow[x] is not None
                     for x, y in zip(lk, rk))
            if not ok:
                continue
            cond_rows.append((int(sign[i]), arow + brow))
        if self.condition is not None and cond_rows:
            from ..core.chunk import DataChunk
            ch = DataChunk.from_rows(self.schema.dtypes,
                                     [r for _, r in cond_rows])
            c = self.condition.eval(ch)
            cond_rows = [pr for pr, ok, vl in
                         zip(cond_rows, c.values, c.validity)
                         if vl and ok]
        for s, row in cond_rows:
            (ins if s > 0 else dels).append(row)

    def _on_barrier(self, barrier: Barrier) -> Iterator[Message]:
        o1, o2 = self.engine.flush_epoch()
        out = StreamChunkBuilder(self.schema.dtypes, self.max_chunk_size)
        # An upstream U-/U+ keeps its _row_id, so the retract pair and the
        # replacement pair share one downstream stream key — pair order off
        # the device is hash order, so emit ALL deletes before ALL inserts
        # (at barrier granularity that's the only per-key ordering that
        # matters). Identical rows are NETTED across the whole epoch pair
        # set first: dA><B_old can insert the exact pair that A_new><dB
        # deletes (e.g. both join sides changed under a non-equi
        # condition); emitting that net-zero pair as delete-then-insert
        # would resurrect a row the join no longer contains.
        dels: List[Tuple] = []
        ins: List[Tuple] = []
        self._assemble(o1, dels, ins)
        self._assemble(o2, dels, ins)
        from collections import Counter
        net: Counter = Counter(ins)
        net.subtract(dels)
        for row, c in net.items():
            if c < 0:
                for _ in range(-c):
                    out.append_row(Op.DELETE, row)
        for row, c in net.items():
            if c > 0:
                for _ in range(c):
                    out.append_row(Op.INSERT, row)
        yield from out.drain()
        # state persistence: net row inserts/deletes this epoch
        for side in ("a", "b"):
            st = self.state_tables[side]
            net = self._epoch_net[side]
            for h, (s, row) in net.items():
                if st is not None:
                    if s > 0:
                        st.insert(row + (0,))
                    elif s < 0:
                        st.delete(row + (0,))
                if s < 0:
                    self.dicts[side].remove(h)
            if st is not None:
                st.commit(barrier.epoch.curr)
            net.clear()

    def _on_watermark(self, side: str, wm: Watermark) -> Iterator[Message]:
        """Equi-key watermark min-alignment; non-key watermarks don't
        survive a join (old state rows resurface in the output)."""
        keys = self.key_idx[side]
        if wm.col_idx not in keys:
            return
        kp = keys.index(wm.col_idx)
        self._wm[side][kp] = wm.value
        ov = self._wm["b" if side == "a" else "a"].get(kp)
        if ov is None:
            return
        low = min(wm.value, ov)
        prev = self._emitted_wm.get(kp)
        if prev is not None and low <= prev:
            return
        self._emitted_wm[kp] = low
        self._clean_wm[kp] = low
        nl = len(self.left_exec.schema)
        yield Watermark(self.key_idx["a"][kp], wm.dtype, low)
        yield Watermark(nl + self.key_idx["b"][kp], wm.dtype, low)

    def _clean_state(self) -> None:
        """Drop state rows below the aligned key watermark: filter the host
        row caches, re-install the device multimaps via load_side, delete
        the persisted rows."""
        if not self._clean_wm:
            return
        for side in ("a", "b"):
            key_cols = self.key_idx[side]
            d = self.dicts[side]
            dead = []
            for h, row in d.rows.items():
                for kp, wv in self._clean_wm.items():
                    v = row[key_cols[kp]]
                    if v is not None and v < wv:
                        dead.append(h)
                        break
            if not dead:
                continue
            dead_set = set(dead)
            st = self.state_tables[side]
            for h in dead:
                if st is not None:
                    st.delete(d.rows[h] + (0,))
                d.remove(h)
            jk, pk = self.engine.live_side(side)
            keep = ~np.isin(pk, np.fromiter(dead_set, dtype=np.int64))
            self.engine.load_side(side, jk[keep], pk[keep])
        self._clean_wm.clear()

    # ---- barrier-aligned two-input loop (hash_join.rs:575-686) ----------
    def execute(self) -> Iterator[Message]:
        self._recover()
        liter = self.left_exec.execute()
        riter = self.right_exec.execute()
        alive = True
        while alive:
            barrier = None
            for side, it in (("a", liter), ("b", riter)):
                while True:
                    try:
                        msg = next(it)
                    except StopIteration:
                        alive = False
                        break
                    if isinstance(msg, Barrier):
                        barrier = msg
                        break
                    if isinstance(msg, StreamChunk):
                        if msg.cardinality:
                            self._process_chunk(side, msg)
                    elif isinstance(msg, Watermark):
                        yield from self._on_watermark(side, msg)
            if barrier is None:
                return
            yield from self._on_barrier(barrier)
            self._clean_state()
            yield barrier.with_trace(self.name)
            if barrier.is_stop():
                return
