"""Elastic rescale: move vnode-sharded device state between mesh sizes
(the port's own copy of `risingwave_tpu/parallel/rescale.py`).

Analog of the reference's ScaleController reschedule plus the vnode
bitmap updates stateful executors apply at barriers: state rows move to
the shard that owns their vnode under the new mapping. It runs at a
barrier boundary (no epoch in flight), through host memory — rescale is
rare and control-plane-paced, so the steady-state path never pays for
it. Each new shard's part is placed on its device.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..core.vnode import VNODE_COUNT
from ..device.sorted_state import EMPTY_KEY, SortedState, _neutral
from .mesh import Mesh, shard_of_vnode


def _vnode_of_keys(keys: np.ndarray, vnode_count: int) -> np.ndarray:
    """vnode per key — the exchange kernel's CRC32 routing, on the host
    (the C++ host kernel)."""
    return native.vnodes_i64(keys, vnode_count)


def owner_shards(keys: np.ndarray, n: int,
                 vnode_count: int = VNODE_COUNT) -> np.ndarray:
    """The shard owning each int64 key's vnode among n (host routing:
    recovery loads and reshards place rows where the exchange sends
    them)."""
    return shard_of_vnode(_vnode_of_keys(keys, vnode_count)
                          .astype(np.int64), n, vnode_count)


def _host_cat(per_shard: Sequence[Tuple[torch.Tensor, ...]]
              ) -> List[np.ndarray]:
    """Each column's per-shard tensors concatenated on the host."""
    from ..device.agg_step import _to_host
    pulled = _to_host([list(t) for t in per_shard])
    return [np.concatenate([p[j] for p in pulled])
            for j in range(len(pulled[0]))]


def _np_neutral(kind, dtype: torch.dtype):
    v = _neutral(kind, dtype)
    return v.item() if hasattr(v, "item") else v


def reshard_state(state: Sequence[SortedState], kinds, new_mesh: Mesh,
                  vnode_count: int = VNODE_COUNT,
                  min_capacity: int = 64) -> Tuple[SortedState, ...]:
    """Redistribute per-shard SortedStates onto `new_mesh`. Each new
    shard's rows stay sorted (keys were globally hashed, so filtering a
    sorted run keeps it sorted); the capacity grows to the largest new
    shard (pow2)."""
    n_new = new_mesh.n
    cols = _host_cat([(st.keys,) + tuple(st.vals) for st in state])
    keys, vals = cols[0], cols[1:]
    live = keys != EMPTY_KEY
    lkeys = keys[live]
    lvals = [v[live] for v in vals]
    dest = owner_shards(lkeys, n_new, vnode_count)
    counts = np.bincount(dest, minlength=n_new)
    cap = max(min_capacity, 1 << int(max(1, counts.max()) - 1).bit_length())
    dtypes = [v.dtype for v in state[0].vals]
    out = []
    for s in range(n_new):
        sel = dest == s
        ks = lkeys[sel]
        order = np.argsort(ks, kind="stable")
        k = len(ks)
        nk = np.full(cap, EMPTY_KEY, dtype=np.int64)
        nk[:k] = ks[order]
        nvals = []
        for src, kind, dt in zip(lvals, kinds, dtypes):
            col = np.full(cap, _np_neutral(kind, dt), dtype=src.dtype)
            col[:k] = src[sel][order]
            nvals.append(col)
        dev = new_mesh.devices[s]
        out.append(SortedState(
            torch.from_numpy(nk).to(dev),
            torch.tensor(k, dtype=torch.int32).to(dev),
            tuple(torch.from_numpy(v).to(dev) for v in nvals)))
    return tuple(out)


def reshard_multiset(ms, new_mesh: Mesh, vnode_count: int = VNODE_COUNT,
                     min_capacity: int = 64):
    """Redistribute per-shard SortedMultisets (retractable min/max side
    state) onto `new_mesh` — pairs follow their GROUP key's vnode, the
    routing of the main state's rows."""
    from ..device.minput import SortedMultiset
    n_new = new_mesh.n
    k1, k2, cnt = _host_cat([(m.k1, m.k2, m.cnt) for m in ms])
    live = k1 != EMPTY_KEY
    k1, k2, cnt = k1[live], k2[live], cnt[live]
    dest = owner_shards(k1, n_new, vnode_count)
    counts = np.bincount(dest, minlength=n_new)
    cap = max(min_capacity, 1 << int(max(1, counts.max()) - 1).bit_length())
    out = []
    for s in range(n_new):
        sel = dest == s
        order = np.lexsort((k2[sel], k1[sel]))
        k = int(sel.sum())
        nk1 = np.full(cap, EMPTY_KEY, dtype=np.int64)
        nk2 = np.full(cap, EMPTY_KEY, dtype=np.int64)
        ncnt = np.zeros(cap, dtype=np.int64)
        nk1[:k] = k1[sel][order]
        nk2[:k] = k2[sel][order]
        ncnt[:k] = cnt[sel][order]
        dev = new_mesh.devices[s]
        out.append(SortedMultiset(
            torch.from_numpy(nk1).to(dev), torch.from_numpy(nk2).to(dev),
            torch.tensor(k, dtype=torch.int32).to(dev),
            torch.from_numpy(ncnt).to(dev)))
    return tuple(out)
