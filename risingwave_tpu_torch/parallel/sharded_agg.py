"""Sharded hash agg: exchange + per-shard epoch apply (the port's own copy
of `risingwave_tpu/parallel/sharded_agg.py`).

The device analog of the reference's vnode hash dispatch -> merge
alignment -> hash-agg apply: each source shard

  1. hashes its rows' keys to vnodes -> destination shards and places them
     in [n, B] buckets (the `bucket_exchange` kernel: one call over every
     source on one device),
  2. each shard receives every source's bucket for it (`Mesh.exchange`:
     the kernel's receiver-major buffers, or `all_to_all` over several
     devices),
  3. each shard runs the sorted-run agg epoch step (`epoch_core_full`) on
     its own state shard.

The change set comes back per shard, stacked into the JAX package's
[n, ...] leaves; the host assembles the barrier change chunk.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.vnode import VNODE_COUNT
from ..device.agg_step import (DeviceAggSpec, DeviceAggState, _PULL_DROP,
                               _acc_cast, _bucket, _to_host, epoch_core_full)
from ..device.minput import SortedMultiset, ms_grow, ms_make
from ..device.sorted_state import (EMPTY_KEY, SortedState, grow_state,
                                   sanitize_keys)
from .mesh import Mesh, move
from .rescale import owner_shards


def _exchange(mesh: Mesh, keys, mask, arrays, fills) -> List[List[torch.Tensor]]:
    """Every source shard's rows bucketized by key (cap = B, the
    reference's `_bucketize` per source) and handed to their owners
    (`Mesh.exchange`): -> per destination shard, each array's n * B
    received rows."""
    recv, _need = mesh.exchange(list(keys), list(mask), keys[0].shape[0],
                                arrays, fills)
    return recv


def _stack(trees: Sequence[Any], dev: torch.device) -> Any:
    """Per-shard dicts / tuples of tensors -> one tree of [n, ...]
    tensors on `dev` (the JAX package's sharded change-set leaves)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], dev) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([t[i] for t in trees], dev)
                           for i in range(len(first)))
    return torch.stack([move(t, dev) for t in trees])


def make_sharded_agg_step(spec: DeviceAggSpec, mesh: Mesh,
                          vnode_count: int = VNODE_COUNT):
    """The distributed epoch step (eager): per-shard bucketize,
    `all_to_all`, then the agg epoch step on every shard.

        step(states, minputs, keys, signs, mask, inputs)
          states:  per-shard SortedStates
          minputs: per minput, per-shard SortedMultisets
          keys / signs / mask: per-shard [B] int64 / int32 / bool
          inputs:  per call, (per-shard values, per-shard valid)
        -> (states', minputs', per-shard needed, per minput per-shard
            need, per-shard change sets)
    """
    if vnode_count != VNODE_COUNT:
        raise ValueError(f"the exchange routes {VNODE_COUNT} vnodes, not "
                         f"{vnode_count}")
    n = mesh.n
    ncalls = len(spec.calls)

    def step(states, minputs, keys, signs, mask, inputs):
        arrays = [[keys[s], signs[s].to(torch.int32)]
                  + [t for v, m in inputs for t in (v[s], m[s])]
                  for s in range(n)]
        fills: List[Any] = [EMPTY_KEY, 0] + [0, False] * ncalls
        recv = _exchange(mesh, keys, mask, arrays, fills)
        new_states, new_ms, needed, ms_needed, changes = [], [], [], [], []
        for d in range(n):
            r = recv[d]
            rkeys, rsigns = r[0], r[1]
            rmask = rkeys != EMPTY_KEY
            rinputs = tuple((r[2 + 2 * i], r[3 + 2 * i])
                            for i in range(ncalls))
            full = DeviceAggState(states[d],
                                  tuple(m[d] for m in minputs))
            new_full, (nd, msn), ch = epoch_core_full(
                spec, full, rkeys, rsigns, rmask, rinputs)
            new_states.append(new_full.main)
            new_ms.append(new_full.minputs)
            needed.append(nd)
            ms_needed.append(msn)
            changes.append({**ch, "count": ch["count"].reshape(1)})
        minputs_out = tuple(tuple(new_ms[d][mi] for d in range(n))
                            for mi in range(len(spec.minputs)))
        ms_out = tuple([ms_needed[d][mi] for d in range(n)]
                       for mi in range(len(spec.minputs)))
        return tuple(new_states), minputs_out, needed, ms_out, changes

    return step


class ShardedHashAgg:
    """Host wrapper: per-shard states + epoch buffering + growth."""

    def __init__(self, spec: DeviceAggSpec, mesh: Mesh, capacity: int = 1024,
                 vnode_count: int = VNODE_COUNT,
                 pull_formatted: bool = True):
        self.spec = spec
        self.pull_formatted = pull_formatted
        self.mesh = mesh
        self.n = mesh.n
        self.vnode_count = vnode_count
        self._step = make_sharded_agg_step(spec, mesh, vnode_count)
        self.state: Tuple[SortedState, ...] = self._make_state(capacity)
        self.minputs: Tuple[Tuple[SortedMultiset, ...], ...] = tuple(
            self._make_minput(capacity) for _ in spec.minputs)
        self._rows: List[Tuple] = []
        # epochs re-run on grown state
        self.growth_replays = 0

    def _make_state(self, capacity: int) -> Tuple[SortedState, ...]:
        return tuple(self.spec.make_state(capacity, dev)
                     for dev in self.mesh.devices)

    def _make_minput(self, capacity: int) -> Tuple[SortedMultiset, ...]:
        return tuple(ms_make(capacity, dev) for dev in self.mesh.devices)

    def _grow_minput(self, mi: int, capacity: int) -> None:
        new = tuple(ms_grow(m, capacity) for m in self.minputs[mi])
        self.minputs = self.minputs[:mi] + (new,) + self.minputs[mi + 1:]

    @staticmethod
    def _flatten_sharded(per_shard: Sequence[Sequence[torch.Tensor]],
                         counts: Sequence[int]) -> List[np.ndarray]:
        """Per-shard columns + live counts -> concatenated live rows (one
        synchronised pull)."""
        pulled = _to_host([[c[:counts[s]] for c in cols]
                           for s, cols in enumerate(per_shard)])
        return [np.concatenate([p[j] for p in pulled])
                for j in range(len(per_shard[0]))]

    def _counts(self, tensors: Sequence[torch.Tensor]) -> List[int]:
        dev = self.mesh.device
        return torch.stack([t.to(dev).to(torch.int64) for t in tensors]
                           ).cpu().tolist()

    def live_main(self) -> Tuple[np.ndarray, List[np.ndarray]]:
        counts = self._counts([st.count for st in self.state])
        flat = self._flatten_sharded(
            [(st.keys,) + tuple(st.vals) for st in self.state], counts)
        return flat[0], flat[1:]

    def live_minput(self, mi: int) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
        ms = self.minputs[mi]
        counts = self._counts([m.count for m in ms])
        k1, k2, cnt = self._flatten_sharded(
            [(m.k1, m.k2, m.cnt) for m in ms], counts)
        return k1, k2, cnt

    def load_minput(self, mi: int, k1: np.ndarray, k2: np.ndarray,
                    cnt: np.ndarray) -> None:
        """Recovery: place (group, value, count) pairs on the shard owning
        the GROUP key's vnode (the main state's routing)."""
        k1 = sanitize_keys(np.asarray(k1, np.int64))
        k2 = np.asarray(k2, np.int64)   # values are k1-discriminated
        cnt = np.asarray(cnt, np.int64)
        dest = owner_shards(k1, self.n, self.vnode_count)
        per = [np.flatnonzero(dest == s) for s in range(self.n)]
        cap = _bucket(max([len(i) for i in per]
                          + [self.minputs[mi][0].capacity]))
        new = []
        for s, idx in enumerate(per):
            order = idx[np.lexsort((k2[idx], k1[idx]))]
            k = len(order)
            gk1 = np.full(cap, EMPTY_KEY, np.int64)
            gk2 = np.full(cap, EMPTY_KEY, np.int64)
            gc = np.zeros(cap, np.int64)
            gk1[:k], gk2[:k], gc[:k] = k1[order], k2[order], cnt[order]
            dev = self.mesh.devices[s]
            new.append(SortedMultiset(
                torch.from_numpy(gk1).to(dev), torch.from_numpy(gk2).to(dev),
                torch.tensor(k, dtype=torch.int32).to(dev),
                torch.from_numpy(gc).to(dev)))
        self.minputs = self.minputs[:mi] + (tuple(new),) \
            + self.minputs[mi + 1:]

    @property
    def capacity(self) -> int:
        return self.state[0].capacity

    def push_rows(self, keys: np.ndarray, signs: np.ndarray,
                  inputs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
        if self.spec.append_only and (np.asarray(signs) < 0).any():
            raise ValueError(
                "retraction through an append-only (min/max) device agg — "
                "use the exact host path (aggregate/minput.rs analog)")
        self._rows.append((sanitize_keys(keys), signs.astype(np.int32),
                           [(np.asarray(v), np.asarray(m))
                            for v, m in inputs]))

    def _grow(self, capacity: int) -> None:
        self.state = tuple(grow_state(st, capacity, self.spec.kinds)
                           for st in self.state)

    def load_state(self, keys: np.ndarray,
                   vals: Sequence[np.ndarray]) -> None:
        """Recovery: place (key, payload...) rows on their owning shards
        (the vnode of the device key, as the exchange routes it) and
        install them as the sharded state."""
        keys = sanitize_keys(np.asarray(keys, np.int64))
        dest = owner_shards(keys, self.n, self.vnode_count)
        per_shard = [np.flatnonzero(dest == s) for s in range(self.n)]
        cap = _bucket(max([len(i) for i in per_shard] + [self.capacity]))
        new = []
        for s, idx in enumerate(per_shard):
            order = idx[np.argsort(keys[idx], kind="stable")]
            k = len(order)
            st = self.spec.make_state(cap, "cpu")
            st.keys[:k] = torch.from_numpy(keys[order])
            for v0, v in zip(st.vals, vals):
                v0[:k] = torch.from_numpy(np.asarray(v)[order])
            dev = self.mesh.devices[s]
            new.append(SortedState(st.keys.to(dev),
                                   torch.tensor(k, dtype=torch.int32).to(dev),
                                   tuple(v.to(dev) for v in st.vals)))
        self.state = tuple(new)

    def rescale(self, new_mesh: Mesh) -> None:
        """Barrier-synchronized elastic re-shard onto a different mesh
        (the reference's scale.rs analog). Epoch buffers must be flushed
        first."""
        assert not self._rows, "rescale must happen at a barrier boundary"
        from .rescale import reshard_multiset, reshard_state
        self.state = reshard_state(self.state, self.spec.kinds, new_mesh,
                                   self.vnode_count)
        self.minputs = tuple(reshard_multiset(m, new_mesh, self.vnode_count)
                             for m in self.minputs)
        self.mesh = new_mesh
        self.n = new_mesh.n
        self._step = make_sharded_agg_step(self.spec, new_mesh,
                                           self.vnode_count)

    def flush_epoch(self) -> Optional[Dict[str, Any]]:
        if not self._rows:
            return None
        keys = np.concatenate([r[0] for r in self._rows])
        signs = np.concatenate([r[1] for r in self._rows])
        ins = [(np.concatenate([r[2][i][0] for r in self._rows]),
                np.concatenate([r[2][i][1] for r in self._rows]))
               for i in range(len(self.spec.calls))]
        self._rows = []
        # rows round-robin across the source shards (fixes each key's
        # order of additions), padded to [n, per]
        total = len(keys)
        per = _bucket(-(-total // self.n), lo=64)
        mesh = self.mesh
        gkeys = _deal(keys, per, EMPTY_KEY, mesh)
        gsigns = _deal(signs, per, 0, mesh)
        mask = _deal(np.ones(total, bool), per, False, mesh)
        gins = tuple((_deal(_acc_cast(v), per, 0, mesh),
                      _deal(m.astype(bool), per, False, mesh))
                     for v, m in ins)
        while True:
            new_state, new_ms, needed, ms_needed, changes = self._step(
                self.state, self.minputs, gkeys, gsigns, mask, gins)
            # every shard's needs in one transfer
            ctl = self._counts(list(needed)
                               + [t for nd in ms_needed for t in nd])
            grown = False
            nmax = max(ctl[:self.n])
            if nmax > self.capacity:
                self._grow(_bucket(nmax, lo=self.capacity * 2))
                grown = True
            for mi in range(len(ms_needed)):
                m = max(ctl[self.n * (1 + mi): self.n * (2 + mi)])
                cap = self.minputs[mi][0].capacity
                if m > cap:
                    self._grow_minput(mi, _bucket(m, lo=cap * 2))
                    grown = True
            if grown:
                self.growth_replays += 1
                continue
            self.state, self.minputs = new_state, new_ms
            # pipeline-only formatted outputs skip the pull when the
            # consumer formats from raw payloads
            keep = [{k: v for k, v in ch.items()
                     if self.pull_formatted or k not in _PULL_DROP}
                    for ch in changes]
            return _to_host(_stack(keep, self.mesh.device))


def _deal(a: np.ndarray, per: int, fill, mesh: Mesh) -> List[torch.Tensor]:
    """Host rows dealt round-robin to the source shards (shard s takes
    `a[s::n]` — the reference's order, which fixes each key's order of
    additions), each padded to `per` with `fill` -> per-shard tensors on
    their devices (one transfer when every shard shares a device: the
    rows are views)."""
    n = mesh.n
    out = np.full((n, per), fill, dtype=a.dtype)
    for s in range(n):
        piece = a[s::n]
        out[s, : len(piece)] = piece
    if mesh.single_device:
        t = torch.from_numpy(out).to(mesh.device)
        return [t[s] for s in range(n)]
    return [torch.from_numpy(out[s]).to(mesh.devices[s]) for s in range(n)]
