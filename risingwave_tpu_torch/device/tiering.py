"""Tiered state beyond device memory: the host-side policy of cold-group
demotion (the port's copy of `risingwave_tpu/device/tiering.py`).

  hot tier   — the device sorted tables, exactly as before, carrying a
               last-touched-epoch column that every keyed node stamps
               inside its epoch (`device/fused.py`, the `touch_stamp`
               kernel).
  cold tier  — per-node host column arenas (`ColdStore`) keyed by the
               packed group / join key, holding the exact payload row and
               its touch stamp, filled at checkpoints from one batched
               device-to-host copy.

Demotion picks the oldest-touched keys (never the key-skew telemetry's
heavy hitters) once occupancy crosses a high-water fraction of capacity,
and drains down to a low-water mark, so the capacity predictor never
needs to grow past the device-memory budget. Promotion is what keeps the
result exact: every epoch's incoming keys, recomputed on the host from
the ingest window's columns, are probed against an Xor8 negative cache
over the demoted keys, and hits are merged back into the device table
before the epoch runs, so the step always sees a complete working set
and the MV equals the untiered run's.

The invariant: a key lives in exactly one tier at any commit point, with
its exact payload. This module holds the policy, the recipes, the stores
and the journal of enacted demotions (in memory, mirrored line by line to
`tiering_journal_<job>.jsonl` in the data directory: the cold tier's redo
log, which a restart loads and re-enacts); it imports no torch. The
device surgery (evict / promote) lives with the node classes in
`device/fused.py`.
"""
from __future__ import annotations

import json
import os
import struct
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .capacity import tier_waters

# epochs a key may go untouched before it counts as cold in the
# `tcold` stat (observability only — selection is oldest-first by
# actual touch stamp, not a TTL cliff)
TIER_TTL = max(1, int(os.environ.get("RW_TIER_TTL", "4")))

# demotion batch buffers (and the evict jit's key argument) are padded
# to pow2 buckets so repeated demotions reuse one executable per bucket
_PAD_LO = 64


def _pad_pow2(n: int, lo: int = _PAD_LO) -> int:
    c = lo
    while c < n:
        c <<= 1
    return c


def np_pack(fields, cols: Sequence[np.ndarray]) -> np.ndarray:
    """Host numpy twin of PackPlan.pack — bit-identical to the device
    packing for in-range values (int64 shifts, floor division)."""
    key = np.zeros_like(np.asarray(cols[0], dtype=np.int64))
    shift = 0
    for c, f in zip(cols, fields):
        c = np.asarray(c, dtype=np.int64)
        v = (c - f.offset) // f.stride if f.stride > 1 else c - f.offset
        key = key + (v.astype(np.int64) << shift)
        shift += f.bits
    return key


def key_bytes(k: int) -> bytes:
    return struct.pack("<q", int(k))


class TieredState(NamedTuple):
    """A tier-armed node's device state: the node's ordinary state plus
    the recency columns the tier policy reads.

    `touch` rides POSITIONALLY with the inner key table(s): an agg keeps
    one int64[capacity] column; a join keeps a (side_a, side_b) pair at
    row granularity. `tick` is the node-local epoch counter the step
    stamps into touched rows (an int64 scalar tensor)."""
    inner: Any                       # the untiered node state (pytree)
    touch: Any                       # int64[cap] | (int64[ca], int64[cb])
    tick: Any                        # int64 scalar epoch stamp


class TierRecipe(NamedTuple):
    """How to recompute one node input's packed key host-side from the
    ingest window's SHIPPED host columns (device/ingest.py retains them
    per window): per key column, its position in the shipped list, plus
    the node's own PackPlan fields. Derived once at plan time by
    walking InputRef-only Map / Filter chains back to the IngestNode."""
    source_ord: int                  # position in HostIngest.sources
    col_pos: Tuple[int, ...]         # per key col: shipped-list index
    fields: Tuple[Any, ...]          # PackPlan.fields (host twin input)

    def keys_for(self, per_source) -> np.ndarray:
        ids, cols = per_source[self.source_ord]
        kcols = [ids if p == -1 else cols[p] for p in self.col_pos]
        return np_pack(self.fields, kcols)


class TierPlan(NamedTuple):
    """One demotion-eligible node: an AggNode (side -1, with its
    lockstep terminal MVKeyedNode if any) or a JoinNode (sides 0/1)."""
    node_idx: int
    kind: str                        # "agg" | "join"
    recipes: Tuple[TierRecipe, ...]  # promotion-candidate derivations
    mv_idx: Optional[int] = None     # lockstep MVKeyedNode index


def derive_recipe(nodes, node_idx: int, col_idx: Sequence[int],
                  fields, source_ords: Dict[int, int]
                  ) -> Optional[TierRecipe]:
    """Walk `col_idx` (positions in nodes[node_idx]'s OUTPUT delta)
    back through Filter (positional passthrough) and InputRef-only Map
    stages — standalone or absorbed into a ChainNode — to an
    IngestNode's shipped host columns. None when any column's lineage
    leaves the traceable set (computed expressions, window columns,
    device datagen, another stateful node): the node stays armed for
    recency stats but is demotion-inert, which is always safe."""
    from .fused import ChainNode, FilterNode, IngestNode, MapNode
    from ..expr.expression import InputRef

    def through(member, cols):
        if isinstance(member, FilterNode):
            return cols
        if isinstance(member, MapNode):
            out = []
            for ci in cols:
                if ci >= len(member.exprs):
                    return None
                e = member.exprs[ci]
                if not isinstance(e, InputRef):
                    return None
                out.append(e.index)
            return out
        return None

    cols = list(col_idx)
    idx = node_idx
    for _ in range(64):                       # cycle guard
        n = nodes[idx]
        if isinstance(n, IngestNode):
            live = n.live if n.live is not None \
                else tuple(range(len(n.col_names)))
            pos = []
            for ci in cols:
                if ci == n.rowid_pos:
                    pos.append(-1)            # the ids array itself
                elif ci in live:
                    pos.append(live.index(ci))
                else:
                    return None
            ordn = source_ords.get(idx)
            if ordn is None:
                return None
            return TierRecipe(ordn, tuple(pos), tuple(fields))
        if isinstance(n, ChainNode):
            for m in reversed(n.chain):
                if isinstance(m, IngestNode):
                    break
                cols = through(m, cols)
                if cols is None:
                    return None
            head = n.chain[0]
            if isinstance(head, IngestNode):
                idx_n = idx
                nodes = list(nodes)
                nodes[idx_n] = head           # re-enter as the ingest
                continue
            if not n.inputs:
                return None
            idx = n.inputs[0]
            continue
        if isinstance(n, (MapNode, FilterNode)):
            cols = through(n, cols)
            if cols is None:
                return None
            idx = n.inputs[0]
            continue
        return None
    return None


def _fill_plan(n: int, freed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Removing the slots `freed` (unique) from an arena of n live slots:
    (holes, movers) — the freed slots below the new end, filled from the
    live slots at or past it, in ascending order each."""
    m = n - len(freed)
    holes = np.sort(freed[freed < m])
    tail = np.ones(n - m, bool)
    tail[freed[freed >= m] - m] = False
    return holes, np.nonzero(tail)[0] + m


class _ArenaMap:
    """Mapping from packed key to a fixed-arity record whose payload
    lives in preallocated contiguous numpy column arenas (pow2-growable)
    instead of per-key Python tuples: bulk demotion is one slice-assign
    per column and bulk promotion gather is one fancy-index slice per
    column. The mapping protocol (get/set/del/in/len/iter/items) stays
    for single-key paths, snapshots, and tests that swap in plain
    dicts.

    `agg=True` presents values as `(vals_tuple, touch)` (the agg cold
    row shape; touch rides as the LAST arena column); `agg=False`
    presents the flat tuple (the lockstep-MV shape). Slot order is
    arena order, not insertion order — every reader either sorts by key
    or is order-insensitive (filters, snapshots)."""

    __slots__ = ("_agg", "_slot", "_keys", "_cols", "_n")

    def __init__(self, agg: bool):
        self._agg = agg
        self._slot: Dict[int, int] = {}
        self._keys = np.empty(0, np.int64)
        self._cols: Optional[List[np.ndarray]] = None
        self._n = 0

    # -- growth ------------------------------------------------------------
    def _ensure(self, extra: int, proto: Sequence[Any]) -> None:
        need = self._n + extra
        if self._cols is None:
            cap = _pad_pow2(max(need, 1))
            self._keys = np.empty(cap, np.int64)
            self._cols = [np.zeros(cap, np.asarray(p).dtype)
                          for p in proto]
            return
        cap = len(self._keys)
        if need <= cap:
            return
        new = _pad_pow2(need)
        self._keys = np.resize(self._keys, new)
        self._cols = [np.resize(c, new) for c in self._cols]

    def _flat(self, value) -> Tuple:
        return tuple(value[0]) + (value[1],) if self._agg \
            else tuple(value)

    def _value(self, slot: int):
        row = tuple(c[slot] for c in self._cols)
        return (row[:-1], int(row[-1])) if self._agg else row

    # -- mapping protocol --------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __contains__(self, k) -> bool:
        return k in self._slot

    def __iter__(self):
        return iter(self._keys[:self._n].tolist())

    def keys(self):
        return self._keys[:self._n].tolist()

    def items(self):
        for i in range(self._n):
            yield int(self._keys[i]), self._value(i)

    def __getitem__(self, k):
        return self._value(self._slot[k])

    def get(self, k, default=None):
        s = self._slot.get(k)
        return default if s is None else self._value(s)

    def __setitem__(self, k, value) -> None:
        flat = self._flat(value)
        s = self._slot.get(k)
        if s is None:
            self._ensure(1, flat)
            s = self._n
            self._n += 1
            self._slot[k] = s
            self._keys[s] = k
        for c, v in zip(self._cols, flat):
            c[s] = v

    def __delitem__(self, k) -> None:
        s = self._slot.pop(k)
        last = self._n - 1
        if s != last:                      # swap-with-last stays dense
            mk = int(self._keys[last])
            self._keys[s] = mk
            for c in self._cols:
                c[s] = c[last]
            self._slot[mk] = s
        self._n = last

    def pop(self, k, *default):
        s = self._slot.get(k)
        if s is None:
            if default:
                return default[0]
            raise KeyError(k)
        v = self._value(s)
        del self[k]
        return v

    # -- bulk (the vectorized tier paths) ----------------------------------
    def put_many(self, keys: np.ndarray,
                 cols: Sequence[np.ndarray]) -> None:
        """Append `len(keys)` NEW rows: one slice-assign per column.
        Keys already present (never the case under the one-tier
        invariant, but journal replays are defensive) overwrite via the
        single-key path."""
        m = len(keys)
        if not m:
            return
        if any(int(k) in self._slot for k in keys):
            for j, k in enumerate(keys.tolist()):
                self[int(k)] = ((tuple(c[j] for c in cols[:-1]),
                                 cols[-1][j]) if self._agg
                                else tuple(c[j] for c in cols))
            return
        self._ensure(m, [c[:1] for c in cols])
        n = self._n
        self._keys[n:n + m] = keys
        for dst, src in zip(self._cols, cols):
            dst[n:n + m] = src
        for j, k in enumerate(keys.tolist()):
            self._slot[int(k)] = n + j
        self._n = n + m

    def take_many(self, keys: np.ndarray
                  ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Remove `keys` (absent ones skipped) and return
        (found_mask, gathered columns — found rows only, in `keys`
        order): ONE fancy-index slice per column, then the arena's live
        tail rows move into the freed slots (O(removed), where the
        reference compacts the whole arena and rebuilds its index; slot
        order is not observable, see the class note)."""
        found = np.array([int(k) in self._slot for k in keys], bool)
        slots = np.fromiter((self._slot[int(k)]
                             for k in keys[found]), np.int64,
                            count=int(found.sum()))
        out = [c[slots].copy() for c in self._cols] \
            if self._cols is not None else []
        if len(slots):
            for k in keys[found].tolist():
                del self._slot[int(k)]
            holes, movers = _fill_plan(self._n, slots)
            self._keys[holes] = self._keys[movers]
            for c in self._cols:
                c[holes] = c[movers]
            for h, k in zip(holes.tolist(), self._keys[holes].tolist()):
                self._slot[int(k)] = h
            self._n -= len(slots)
        return found, out


class _ArenaMultiMap:
    """The join-side cold tier: packed join key -> MANY (pk, vals,
    touch) rows, payload in contiguous column arenas (pk and touch ride
    as the first and last columns). Mapping views materialize per-key
    row lists (snapshots, restores, tests); the tier paths use the bulk
    slice APIs."""

    __slots__ = ("_slot", "_jk", "_cols", "_n")

    def __init__(self):
        self._slot: Dict[int, List[int]] = {}
        self._jk = np.empty(0, np.int64)
        self._cols: Optional[List[np.ndarray]] = None
        self._n = 0

    def _ensure(self, extra: int, proto: Sequence[Any]) -> None:
        need = self._n + extra
        if self._cols is None:
            cap = _pad_pow2(max(need, 1))
            self._jk = np.empty(cap, np.int64)
            self._cols = [np.zeros(cap, np.asarray(p).dtype)
                          for p in proto]
            return
        if need <= len(self._jk):
            return
        new = _pad_pow2(need)
        self._jk = np.resize(self._jk, new)
        self._cols = [np.resize(c, new) for c in self._cols]

    def _rows_of(self, slots: Sequence[int]) -> List[Tuple]:
        return [(int(self._cols[0][s]),
                 tuple(c[s] for c in self._cols[1:-1]),
                 int(self._cols[-1][s])) for s in slots]

    def __len__(self) -> int:
        return len(self._slot)

    def __bool__(self) -> bool:
        return bool(self._slot)

    def __contains__(self, k) -> bool:
        return k in self._slot

    def __iter__(self):
        return iter(self._slot)

    def keys(self):
        return self._slot.keys()

    def items(self):
        for k, slots in self._slot.items():
            yield k, self._rows_of(slots)

    def __getitem__(self, k) -> List[Tuple]:
        return self._rows_of(self._slot[k])

    def get(self, k, default=None):
        slots = self._slot.get(k)
        return default if slots is None else self._rows_of(slots)

    def __setitem__(self, k, rows: List[Tuple]) -> None:
        if k in self._slot:
            self._remove([k])
        if rows:
            self.extend_many(
                np.full(len(rows), int(k), np.int64),
                np.array([r[0] for r in rows], np.int64),
                [np.array([r[1][c] for r in rows])
                 for c in range(len(rows[0][1]))],
                np.array([r[2] for r in rows], np.int64))
        else:
            self._slot[k] = []

    def setdefault(self, k, default):
        if k not in self._slot:
            self[k] = default
        return self[k]

    def pop(self, k, *default):
        slots = self._slot.get(k)
        if slots is None:
            if default:
                return default[0]
            raise KeyError(k)
        rows = self._rows_of(slots)
        self._remove([k])
        return rows

    def _remove(self, ks: Sequence[int]) -> None:
        """Drop every row of `ks`: the arena's live tail rows move into the
        freed slots, each keeping its place in its key's row list (rows of
        a key stay in insertion order; O(removed), where the reference
        compacts the whole arena and rebuilds its index)."""
        drop: List[int] = []
        for k in ks:
            drop.extend(self._slot.pop(k, []))
        if not drop:
            return
        holes, movers = _fill_plan(self._n, np.asarray(drop, np.int64))
        self._jk[holes] = self._jk[movers]
        for c in self._cols:
            c[holes] = c[movers]
        for h, m, k in zip(holes.tolist(), movers.tolist(),
                           self._jk[holes].tolist()):
            lst = self._slot[int(k)]
            lst[lst.index(m)] = h
        self._n -= len(drop)

    # -- bulk --------------------------------------------------------------
    def extend_many(self, jks: np.ndarray, pks: np.ndarray,
                    cols: Sequence[np.ndarray],
                    touch: np.ndarray) -> None:
        m = len(jks)
        if not m:
            return
        payload = [pks] + list(cols) + [touch]
        self._ensure(m, [c[:1] for c in payload])
        n = self._n
        self._jk[n:n + m] = jks
        for dst, src in zip(self._cols, payload):
            dst[n:n + m] = src
        for j, k in enumerate(jks.tolist()):
            self._slot.setdefault(int(k), []).append(n + j)
        self._n = n + m

    def take_groups(self, keys: Sequence[int]
                    ) -> Tuple[np.ndarray, np.ndarray,
                               List[np.ndarray], np.ndarray]:
        """Remove every row of `keys` and return (jk, pk, val columns,
        touch) concatenated in the given key order (rows of one key in
        insertion order) — one fancy-index slice per column."""
        slots: List[int] = []
        for k in keys:
            slots.extend(self._slot.get(int(k), []))
        idx = np.asarray(slots, np.int64)
        if self._cols is None or not len(idx):
            return (np.empty(0, np.int64), np.empty(0, np.int64),
                    [], np.empty(0, np.int64))
        jk = self._jk[idx].copy()
        pk = self._cols[0][idx].copy()
        vals = [c[idx].copy() for c in self._cols[1:-1]]
        tch = self._cols[-1][idx].copy()
        self._remove(list(keys))
        return jk, pk, vals, tch


class ColdStore:
    """Per-node(-side) host tier: one key-indexed numpy column arena
    per shard (packed key -> payload row; `_ArenaMap` for agg/MV
    single-row values, `_ArenaMultiMap` for join multi-row sides) plus
    an Xor8 negative cache over the shard's demoted key set. Demotion
    batches append with one slice per column and promotion gathers with
    one fancy-index per column — no per-key Python dict walk on either
    tier move. The filter is REBUILT on demotion (the key set just
    changed) and left stale-superset on promotion (a stale positive
    costs one index miss; a false negative is impossible). `Xor8.build`
    may return None (construction failure) — the store then degrades
    to always-probe: every candidate pays the index lookup, correctness
    unchanged."""

    def __init__(self, n_shards: int, kind: str = "agg"):
        self.kind = kind                   # "agg" | "mv" | "join"
        self.rows: List[Any] = [self._new_map()
                                for _ in range(n_shards)]
        self.filters: List[Optional[Any]] = [None] * n_shards
        self.filter_live: List[bool] = [False] * n_shards

    def _new_map(self):
        if self.kind == "join":
            return _ArenaMultiMap()
        return _ArenaMap(agg=self.kind == "agg")

    # ---- vectorized tier moves (plain-mapping fallbacks keep the
    # dict-swapping tests and dict-shaped snapshots working) -----------
    def put_agg_rows(self, shard: int, keys: np.ndarray,
                     val_cols: Sequence[np.ndarray],
                     touch: np.ndarray) -> None:
        m = self.rows[shard]
        if isinstance(m, _ArenaMap):
            m.put_many(np.asarray(keys, np.int64),
                       list(val_cols) + [np.asarray(touch, np.int64)])
        else:
            for j, k in enumerate(np.asarray(keys).tolist()):
                m[int(k)] = (tuple(c[j] for c in val_cols),
                             int(touch[j]))

    def take_agg_rows(self, shard: int, keys: np.ndarray
                      ) -> Tuple[List[np.ndarray], np.ndarray]:
        """All keys must be present (they came from `probe`)."""
        m = self.rows[shard]
        keys = np.asarray(keys, np.int64)
        if isinstance(m, _ArenaMap):
            _f, cols = m.take_many(keys)
            return cols[:-1], cols[-1]
        rows = [m.pop(int(k)) for k in keys]
        ncols = len(rows[0][0]) if rows else 0
        return ([np.array([r[0][c] for r in rows])
                 for c in range(ncols)],
                np.array([r[1] for r in rows], np.int64))

    def put_flat_rows(self, shard: int, keys: np.ndarray,
                      cols: Sequence[np.ndarray]) -> None:
        m = self.rows[shard]
        if isinstance(m, _ArenaMap):
            m.put_many(np.asarray(keys, np.int64), list(cols))
        else:
            for j, k in enumerate(np.asarray(keys).tolist()):
                m[int(k)] = tuple(c[j] for c in cols)

    def take_flat_rows(self, shard: int, keys: np.ndarray
                       ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """(found mask, columns of the found rows in `keys` order) —
        absent keys are skipped (the lockstep MV store holds a SUBSET
        of its agg's demoted keys)."""
        m = self.rows[shard]
        keys = np.asarray(keys, np.int64)
        if isinstance(m, _ArenaMap):
            return m.take_many(keys)
        found = np.array([int(k) in m for k in keys], bool)
        rows = [m.pop(int(k)) for k in keys[found]]
        ncols = len(rows[0]) if rows else 0
        return found, [np.array([r[c] for r in rows])
                       for c in range(ncols)]

    def flat_columns(self, shard: int
                     ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Zero-copy view of one shard's (keys, payload columns) — the
        SELECT-time cache-fill gather of demoted MV rows."""
        m = self.rows[shard]
        if isinstance(m, _ArenaMap):
            n = m._n
            if not n or m._cols is None:
                return np.empty(0, np.int64), []
            return m._keys[:n], [c[:n] for c in m._cols]
        ks = list(m.keys())
        rows = [m[k] for k in ks]
        ncols = len(rows[0]) if rows else 0
        return (np.asarray(ks, np.int64),
                [np.array([r[c] for r in rows]) for c in range(ncols)])

    def extend_join_rows(self, shard: int, jks: np.ndarray,
                         pks: np.ndarray,
                         val_cols: Sequence[np.ndarray],
                         touch: np.ndarray) -> None:
        m = self.rows[shard]
        if isinstance(m, _ArenaMultiMap):
            m.extend_many(np.asarray(jks, np.int64),
                          np.asarray(pks, np.int64), list(val_cols),
                          np.asarray(touch, np.int64))
        else:
            for j in range(len(jks)):
                m.setdefault(int(jks[j]), []).append(
                    (int(pks[j]), tuple(c[j] for c in val_cols),
                     int(touch[j])))

    def take_join_rows(self, shard: int, keys: Sequence[int]
                       ) -> Tuple[np.ndarray, np.ndarray,
                                  List[np.ndarray], np.ndarray]:
        m = self.rows[shard]
        if isinstance(m, _ArenaMultiMap):
            return m.take_groups(keys)
        rows: List[Tuple] = []
        for k in keys:
            rows.extend((int(k),) + r for r in m.pop(int(k)))
        if not rows:
            return (np.empty(0, np.int64), np.empty(0, np.int64),
                    [], np.empty(0, np.int64))
        nvals = len(rows[0][2])
        return (np.array([r[0] for r in rows], np.int64),
                np.array([r[1] for r in rows], np.int64),
                [np.array([r[2][c] for r in rows])
                 for c in range(nvals)],
                np.array([r[3] for r in rows], np.int64))

    def __len__(self) -> int:
        return sum(len(d) for d in self.rows)

    def rebuild_filter(self, shard: int) -> None:
        from ..state.xor8 import Xor8
        ks = list(self.rows[shard].keys())
        if not ks:
            self.filters[shard] = None
            self.filter_live[shard] = False
            return
        # dedupe is structural (dict keys) — build() also guards
        f = Xor8.build([key_bytes(k) for k in ks])
        self.filters[shard] = f                  # None => always-probe
        self.filter_live[shard] = f is not None

    def probe(self, shard: int, cand: np.ndarray
              ) -> Tuple[List[int], int, int]:
        """Candidate packed keys -> (hits present in this shard's cold
        dict, filter probes, filter positives). A missing / failed
        filter falls back to probing the dict for every candidate."""
        d = self.rows[shard]
        if not d:
            return [], 0, 0
        f = self.filters[shard]
        hits, pos = [], 0
        if f is None:
            for k in cand.tolist():
                if k in d:
                    hits.append(k)
            return hits, len(cand), len(hits)
        ks = cand.tolist()
        maybe = f.may_contain_many([key_bytes(k) for k in ks])
        for k in np.asarray(ks, dtype=np.int64)[maybe].tolist():
            pos += 1
            if k in d:
                hits.append(k)
        return hits, len(cand), pos

    def snapshot(self):
        return ([dict(d) for d in self.rows], list(self.filters),
                list(self.filter_live))

    def restore(self, snap) -> None:
        rows, filters, live = snap
        new = []
        for d in rows:
            m = self._new_map()
            for k, v in d.items():
                m[k] = v
            new.append(m)
        self.rows = new
        self.filters = list(filters)
        self.filter_live = list(live)


def select_cold(keys: np.ndarray, touch: np.ndarray, count: int,
                capacity: int, hot_keys, key_mask: int
                ) -> Optional[np.ndarray]:
    """Oldest-touched live keys to demote from ONE shard, excluding
    `rw_key_skew` heavy hitters, sized to drain occupancy from above
    high water down to low water. None = no pressure."""
    high, low = tier_waters()
    count = int(count)
    if capacity <= 0 or count <= int(high * capacity):
        return None
    target = count - int(low * capacity)
    if target <= 0:
        return None
    k = np.asarray(keys[:count], dtype=np.int64)
    t = np.asarray(touch[:count], dtype=np.int64)
    if hot_keys:
        hot = np.array(sorted(hot_keys), dtype=np.int64)
        masked = (k.astype(np.uint64) & np.uint64(key_mask)).astype(np.int64)
        cold_ok = ~np.isin(masked, hot)
    else:
        cold_ok = np.ones(count, dtype=bool)
    order = np.argsort(t, kind="stable")
    order = order[cold_ok[order]]
    return k[order[:target]] if len(order) else None


class TieringManager:
    """Coordinator-side bookkeeping for one FusedJob: plans, cold
    stores, the demotion journal, pending async D2H recency pulls, and
    the counters `FusedJob.tiering_report` reports."""

    def __init__(self, plans: Sequence[TierPlan], n_shards: int = 1):
        self.plans = list(plans)
        self.n_shards = max(1, int(n_shards))
        # (node_idx, side) -> ColdStore; side -1 = agg main / its MV
        # rides (node_idx, "mv"); joins use 0/1 per build side
        self.stores: Dict[Tuple[int, Any], ColdStore] = {}
        for p in self.plans:
            if p.kind == "agg":
                self.stores[(p.node_idx, -1)] = ColdStore(self.n_shards,
                                                          "agg")
                if p.mv_idx is not None:
                    self.stores[(p.node_idx, "mv")] = \
                        ColdStore(self.n_shards, "mv")
            else:
                self.stores[(p.node_idx, 0)] = ColdStore(self.n_shards,
                                                         "join")
                self.stores[(p.node_idx, 1)] = ColdStore(self.n_shards,
                                                         "join")
        # journal: ordered (counter, node_idx, side, [keys]) of ENACTED
        # demotions; the file is its restart-durable mirror
        self.journal: List[Tuple[int, int, Any, List[int]]] = []
        self.journal_path: Optional[str] = None
        self._jlock = threading.Lock()
        # pending two-phase recency pulls: node_idx -> opaque handle
        self.pending: Dict[int, Any] = {}
        self.counters: Dict[str, int] = {
            "demotions": 0, "promotions": 0, "demote_events": 0,
            "filter_probes": 0, "filter_hits": 0, "filter_fallbacks": 0}
        self.begin_window()

    # ---- stores ----------------------------------------------------------
    def store(self, node_idx: int, side) -> ColdStore:
        return self.stores[(node_idx, side)]

    def any_cold(self) -> bool:
        return any(len(s) for s in self.stores.values())

    def reset_stores(self) -> None:
        """Empty cold stores (a rebuild re-enacts the journal into them)
        and no pending recency pull."""
        for key, s in self.stores.items():
            self.stores[key] = ColdStore(self.n_shards, s.kind)
        self.pending.clear()

    def snapshot(self):
        return ({k: s.snapshot() for k, s in self.stores.items()},
                dict(self.counters))

    # ---- window rewind (growth replays) ----------------------------------
    # Between two commits only promotions change the stores (demotion runs
    # at the commit itself), so rewinding the cold tier to the last commit
    # is putting back the rows promoted since: O(promoted), where a full
    # `snapshot` at every commit copies every cold row.
    def begin_window(self) -> None:
        """A commit: promotions from here on are logged for a rewind."""
        self._undo: List[Tuple[Any, str, Tuple]] = []
        self._undo_counters = dict(self.counters)

    def log_take(self, store: ColdStore, kind: str, *rows,
                 shard: int = 0) -> None:
        """Rows a promotion took out of shard `shard` of `store` (kind
        "agg": keys, value columns, touch; "flat": keys, columns; "join":
        jk, pk, value columns, touch)."""
        self._undo.append((store, kind, shard, rows))

    def rewind_window(self) -> None:
        """Put back every row promoted since the last commit and restore
        the counters: the cold tier as it was committed."""
        for store, kind, shard, rows in self._undo:
            if kind == "agg":
                store.put_agg_rows(shard, *rows)
            elif kind == "flat":
                store.put_flat_rows(shard, *rows)
            else:
                store.extend_join_rows(shard, *rows)
        self._undo = []
        self.counters.update(self._undo_counters)
        self.pending.clear()

    def restore(self, snap) -> None:
        stores, counters = snap
        for k, s in stores.items():
            self.stores[k].restore(s)
        self.counters.update(counters)
        self.pending.clear()

    # ---- journal ---------------------------------------------------------
    def set_journal_path(self, path: Optional[str]) -> None:
        self.journal_path = path

    def record(self, counter: int, node_idx: int, side,
               keys: Sequence[int]) -> None:
        ev = (int(counter), int(node_idx), side, [int(k) for k in keys])
        with self._jlock:
            self.journal.append(ev)
            if self.journal_path is not None:
                with open(self.journal_path, "a") as f:
                    f.write(json.dumps({"c": ev[0], "n": ev[1],
                                        "s": ev[2], "k": ev[3]}) + "\n")
                    f.flush()

    def load_journal(self) -> None:
        """The journal file into memory (a torn last line is skipped)."""
        self.journal = []
        if self.journal_path is None \
                or not os.path.exists(self.journal_path):
            return
        with open(self.journal_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                self.journal.append((int(r["c"]), int(r["n"]), r["s"],
                                     [int(k) for k in r["k"]]))

    def truncate_journal(self, target: int) -> None:
        """Drop the events past the committed counter (a demotion
        journaled before a crash took its checkpoint never happened as
        far as the state tables know) and rewrite the file to match."""
        keep = [ev for ev in self.journal if ev[0] <= target]
        if len(keep) == len(self.journal):
            return
        self.journal = keep
        if self.journal_path is not None:
            with self._jlock, open(self.journal_path, "w") as f:
                for c, n, s, k in keep:
                    f.write(json.dumps({"c": c, "n": n, "s": s,
                                        "k": k}) + "\n")

    def clear_journal(self) -> None:
        """Forget every demotion: a job with nothing committed (or a
        dropped one) must not inherit a predecessor's history."""
        self.journal = []
        if self.journal_path is not None \
                and os.path.exists(self.journal_path):
            try:
                os.remove(self.journal_path)
            except OSError:
                pass

    def events_between(self, lo: int, hi: int
                       ) -> List[Tuple[int, List[Tuple[int, Any,
                                                       List[int]]]]]:
        """Journal events with lo < counter <= hi, grouped by counter in
        order — the re-enactment schedule for a history replay."""
        by: Dict[int, List[Tuple[int, Any, List[int]]]] = {}
        for c, n, s, k in self.journal:
            if lo < c <= hi:
                by.setdefault(c, []).append((n, s, k))
        return [(c, by[c]) for c in sorted(by)]

    # ---- report ----------------------------------------------------------
    def report_rows(self, nodes, resident: Dict[int, int]
                    ) -> List[Tuple]:
        """(node, kind, resident, cold, filter_live, promotable) per
        tiered node (`FusedJob.tiering_report` appends the job-wide
        counters)."""
        rows = []
        for p in self.plans:
            if p.kind == "agg":
                cold = len(self.stores[(p.node_idx, -1)])
                flt = any(self.stores[(p.node_idx, -1)].filter_live)
            else:
                cold = len(self.stores[(p.node_idx, 0)]) \
                    + len(self.stores[(p.node_idx, 1)])
                flt = any(self.stores[(p.node_idx, 0)].filter_live) \
                    or any(self.stores[(p.node_idx, 1)].filter_live)
            rows.append((p.node_idx, type(nodes[p.node_idx]).__name__,
                         int(resident.get(p.node_idx, 0)), int(cold),
                         bool(flt), bool(p.recipes)))
        return rows
