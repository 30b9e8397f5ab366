"""Sharded hash join: two-sided exchange + per-shard join (the port's own
copy of `risingwave_tpu/parallel/sharded_join.py`).

The device analog of the reference's two-sided join path (hash dispatch
on both inputs -> merge alignment -> eq-join): each source shard

  1. hashes BOTH sides' rows by join key -> destination shards and places
     each side in [n, B] buckets (`bucket_exchange`),
  2. two exchanges (`Mesh.exchange`: one kernel call a side on one
     device) hand each shard its buckets,
  3. each shard runs the sorted-multimap join epoch (`join_core`) on its
     own state shards.

Both sides route by the same key hash, so every jk-equal pair meets on
exactly one shard and the pair change set needs no exchange afterwards.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.vnode import VNODE_COUNT
from ..device.agg_step import _acc_cast, _bucket, _to_host, torch_dtype
from ..device.join_step import (JoinSide, grow_side, join_core, make_side,
                                sanitize_keys)
from ..device.sorted_state import EMPTY_KEY
from .mesh import Mesh
from .rescale import owner_shards
from .sharded_agg import _deal, _exchange, _stack


def make_sharded_join_step(n_a_vals: int, n_b_vals: int, mesh: Mesh, m: int,
                           vnode_count: int = VNODE_COUNT):
    """The distributed join epoch step (eager). Sides are per-shard
    JoinSides; each input side is (per-shard jk, pk, sign, mask, tuple of
    per-shard vals). -> (sides a', b', per-shard pair change sets o1, o2,
    per-shard needs)."""
    if vnode_count != VNODE_COUNT:
        raise ValueError(f"the exchange routes {VNODE_COUNT} vnodes, not "
                         f"{vnode_count}")
    n = mesh.n

    def exchange(jk, pk, signs, mask, vals):
        arrays = [[jk[s], pk[s], signs[s].to(torch.int32)]
                  + [v[s] for v in vals] for s in range(n)]
        fills: List[Any] = [EMPTY_KEY, EMPTY_KEY, 0] + [0] * len(vals)
        recv = _exchange(mesh, jk, mask, arrays, fills)
        return [(r[0], r[1], r[2], r[0] != EMPTY_KEY, tuple(r[3:]))
                for r in recv]

    def step(a, b, a_in, b_in):
        ra = exchange(*a_in)
        rb = exchange(*b_in)
        new_a, new_b, o1s, o2s, needs = [], [], [], [], []
        for d in range(n):
            na, nb, o1, o2, needed = join_core(a[d], b[d], *ra[d], *rb[d], m)
            new_a.append(na)
            new_b.append(nb)
            o1s.append(o1)
            o2s.append(o2)
            needs.append(needed)
        return tuple(new_a), tuple(new_b), o1s, o2s, needs

    return step


class ShardedHashJoin:
    """Host wrapper: per-shard two-sided state + epoch buffering + growth.
    API-compatible with device/join_step.DeviceHashJoin."""

    def __init__(self, a_dtypes: Sequence, b_dtypes: Sequence, mesh: Mesh,
                 capacity: int = 1024, pair_capacity: int = 4096,
                 vnode_count: int = VNODE_COUNT):
        self.mesh = mesh
        self.n = mesh.n
        self.vnode_count = vnode_count
        self.m = pair_capacity
        self.a = self._make_side(capacity, a_dtypes)
        self.b = self._make_side(capacity, b_dtypes)
        self._steps: Dict[int, Any] = {}
        self._buf: Dict[str, List] = {"a": [], "b": []}
        # epochs re-run on grown state or pairs
        self.growth_replays = 0

    def _make_side(self, capacity: int, dtypes: Sequence
                   ) -> Tuple[JoinSide, ...]:
        dts = [torch_dtype(d) for d in dtypes]
        return tuple(make_side(capacity, dts, dev)
                     for dev in self.mesh.devices)

    def _grow_side(self, which: str, capacity: int) -> None:
        setattr(self, which, tuple(grow_side(s, capacity)
                                   for s in getattr(self, which)))

    def live_side(self, side: str) -> Tuple[np.ndarray, np.ndarray]:
        s = self.a if side == "a" else self.b
        dev = self.mesh.device
        counts = torch.stack([x.count.to(dev).to(torch.int64) for x in s]
                             ).cpu().tolist()
        pulled = _to_host([(x.jk[:counts[i]], x.pk[:counts[i]])
                           for i, x in enumerate(s)])
        return (np.concatenate([p[0] for p in pulled]),
                np.concatenate([p[1] for p in pulled]))

    def load_side(self, side: str, jk, pk, vals=()) -> None:
        """Recovery: place rows on the shard owning their join key's
        vnode."""
        which = "a" if side == "a" else "b"
        cur = getattr(self, which)
        jk = sanitize_keys(np.asarray(jk, np.int64))
        pk = sanitize_keys(np.asarray(pk, np.int64))
        dest = owner_shards(jk, self.n, self.vnode_count)
        per = [np.flatnonzero(dest == s) for s in range(self.n)]
        cap = _bucket(max([len(i) for i in per] + [cur[0].jk.shape[0]]))
        new = []
        for s, idx in enumerate(per):
            order = idx[np.lexsort((pk[idx], jk[idx]))]
            k = len(order)
            gjk = np.full(cap, EMPTY_KEY, np.int64)
            gpk = np.full(cap, EMPTY_KEY, np.int64)
            gjk[:k], gpk[:k] = jk[order], pk[order]
            dev = self.mesh.devices[s]
            # payload columns not given stay zero (the executors load
            # (jk, pk) only)
            gvals = []
            for j, v0 in enumerate(cur[0].vals):
                t = torch.zeros(cap, dtype=v0.dtype)
                if j < len(vals):
                    t[:k] = torch.from_numpy(np.asarray(vals[j])[order])
                gvals.append(t.to(dev))
            new.append(JoinSide(torch.from_numpy(gjk).to(dev),
                                torch.from_numpy(gpk).to(dev),
                                torch.tensor(k, dtype=torch.int32).to(dev),
                                tuple(gvals)))
        setattr(self, which, tuple(new))

    def push_rows(self, side: str, jk, pk, signs, vals) -> None:
        self._buf[side].append((sanitize_keys(np.asarray(jk, np.int64)),
                                sanitize_keys(np.asarray(pk, np.int64)),
                                np.asarray(signs, np.int32),
                                [np.asarray(v) for v in vals]))

    def _pack_side(self, buf, nvals, per):
        if buf:
            jk = np.concatenate([x[0] for x in buf])
            pk = np.concatenate([x[1] for x in buf])
            sg = np.concatenate([x[2] for x in buf])
            vals = [np.concatenate([x[3][i] for x in buf])
                    for i in range(nvals)]
        else:
            jk = pk = np.zeros(0, np.int64)
            sg = np.zeros(0, np.int32)
            vals = [np.zeros(0, np.int64)] * nvals
        mask = np.ones(len(jk), bool)
        m = self.mesh
        return (_deal(jk, per, EMPTY_KEY, m), _deal(pk, per, EMPTY_KEY, m),
                _deal(sg, per, 0, m), _deal(mask, per, False, m),
                tuple(_deal(_acc_cast(v), per, 0, m) for v in vals))

    def flush_epoch(self):
        na, nb = len(self.a[0].vals), len(self.b[0].vals)
        bufs = self._buf
        self._buf = {"a": [], "b": []}
        total = max([sum(len(x[0]) for x in bufs[s]) for s in ("a", "b")]
                    + [1])
        per = _bucket(-(-total // self.n), lo=64)
        A = self._pack_side(bufs["a"], na, per)
        B = self._pack_side(bufs["b"], nb, per)
        dev = self.mesh.device
        while True:
            step = self._steps.get(self.m)
            if step is None:
                step = self._steps[self.m] = make_sharded_join_step(
                    na, nb, self.mesh, self.m, self.vnode_count)
            new_a, new_b, o1, o2, needed = step(self.a, self.b, A, B)
            # every shard's three needs in one transfer
            ctl = torch.stack([nd[k].to(dev).to(torch.int64)
                               for k in ("a", "b", "pairs")
                               for nd in needed]).cpu().tolist()
            n = self.n
            na_, nb_, np_ = (max(ctl[:n]), max(ctl[n:2 * n]),
                             max(ctl[2 * n:]))
            if np_ > self.m:
                self.m = _bucket(np_, lo=self.m * 2)
                self.growth_replays += 1
                continue
            grown = False
            if na_ > self.a[0].jk.shape[0]:
                self._grow_side("a", _bucket(na_,
                                             lo=self.a[0].jk.shape[0] * 2))
                grown = True
            if nb_ > self.b[0].jk.shape[0]:
                self._grow_side("b", _bucket(nb_,
                                             lo=self.b[0].jk.shape[0] * 2))
                grown = True
            if grown:
                self.growth_replays += 1
                continue
            self.a, self.b = new_a, new_b
            return _to_host((_stack(o1, dev), _stack(o2, dev)))
