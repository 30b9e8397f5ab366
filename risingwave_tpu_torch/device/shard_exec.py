"""Mesh-sharded execution of fused epoch programs (the port's own copy of
`risingwave_tpu/device/shard_exec.py`, without its ahead-of-time compile
half: the port runs eagerly).

* **State partitioning** — a stateful node's sharded state is a tuple of
  `n` per-shard states, shard s on `mesh.devices[s]`; shard s owns the
  contiguous vnode block `vnode_block_bounds(n)[s] : [s + 1]` of the
  group / join keys. Each shard's step is the node's own single-device
  `apply`, unchanged.

* **Exchange** — rows whose key hashes to another shard's vnode block are
  shuffled before the node's step: `Mesh.exchange` places every source
  shard's rows into `[n, exch]` buckets with the `bucket_exchange`
  kernel (the vnode, the destination and the stable slot computed inside
  it) — on one device one call over all sources, whose receiver-major
  buffers hand shard d every source's bucket d, source-major; over
  several devices a call per source and the mesh's `all_to_all`. Which
  inputs exchange on which key columns is the node's declaration
  (`Node.shard_spec`).

* **Reduced stats** — each node's per-shard stat scalars reduce across
  shards, row-flow counters (`Node.stat_sums`) by `psum`, capacity needs
  and flags by `pmax`, so the job's stats accumulator and capacity
  lifecycle work unchanged and size per-shard capacities by the
  high-water shard.

* **Exchange capacity** — the send bucket is a capacity slot ("exch"):
  its fill (`need`, the largest bucket count) rides the stats vector, and
  an overflow grows and replays like any other slot.

Semantics: sharding is an execution detail. Source shards cover
contiguous event-id blocks and each receiver's buffer is source-major, so
every key sees its rows in event order — the order of the 1-shard run —
and an n-shard run equals the 1-shard run bit for bit, row order
included.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import Mesh, data_shards, mesh_replicas

# ---------------------------------------------------------------------------
# state lifting: a node-local state <-> a tuple of per-shard states
# ---------------------------------------------------------------------------


def _tmap(fn, tree):
    """`fn` over every tensor leaf of a state tree (NamedTuples, tuples,
    lists, dicts; None and non-tensors kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tmap(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tmap(fn, v) for v in tree)
    return tree


def lift_tree(tree, mesh: Mesh) -> Optional[Tuple]:
    """A node-local state -> one copy per shard, on each shard's device
    (initial states are identical empty shards, so a copy is the right
    per-shard initialization). None stays None."""
    if tree is None:
        return None
    return tuple(_tmap(lambda x: x.to(dev, copy=True), tree)
                 for dev in mesh.devices)


def sharded_resize(node, state, caps, mesh: Mesh):
    """A node's local `cap_resize` on every shard (the node's capacity
    attributes update at the first shard; the rest find them set)."""
    if state is None:
        node.cap_resize(None, caps)       # attribute-only (exch) update
        return None
    return tuple(node.cap_resize(st, caps) for st in state)


@contextlib.contextmanager
def on_device(node, dev: torch.device):
    """Run a node (and a chain's members) with `device` set to one
    shard's device; a no-op where it is already there."""
    members = [node] + list(getattr(node, "chain", []))
    old = [getattr(m, "device", None) for m in members]
    if all(o == dev for o in old):
        yield
        return
    for m in members:
        m.device = dev
    try:
        yield
    finally:
        for m, o in zip(members, old):
            m.device = o


# ---------------------------------------------------------------------------
# the bucket exchange
# ---------------------------------------------------------------------------


def _exchange_arrays(node, xi: int, d, hot_keys, hot_side):
    """(key, live mask, sign, pk, shipped arrays, their column indices,
    hot mode) of one input delta under the node's exchange spec."""
    from ..kernels.exchange import HOT_BCAST, HOT_NONE, HOT_SALT
    ex = node.shard_spec().exchanges[xi]
    if ex.packed:
        # pre-combined deltas carry the packed key verbatim (column 0)
        key = d.cols[ex.key_idx[0]]
    else:
        key = node.pack.pack([d.cols[i] for i in ex.key_idx])
    sign = d.sign.to(torch.int32)
    ncols = len(d.cols)
    refs = list(ex.ref_idx) if ex.ref_idx is not None else list(range(ncols))
    # only the columns the node declares it reads ship; the routed delta
    # zero-fills the rest (never read, by declaration)
    arrays = [d.cols[i] for i in refs] + [sign]
    if ex.carry_pk:
        arrays.append(d.pk)
    hot_mode = HOT_NONE
    if hot_keys:
        hot_mode = HOT_BCAST if (xi == hot_side or not ex.carry_pk
                                 or d.pk is None) else HOT_SALT
    return key.contiguous(), d.mask, sign, d.pk, arrays, refs, hot_mode


def _exchange_local(mesh: Mesh, node, xi: int, d, abstract: bool = True,
                    bounds: Optional[Sequence[int]] = None,
                    hot_keys: Sequence[int] = (), hot_side: int = 1):
    """The JAX package's abstract form of one source shard's exchange:
    its rows routed to the owning shards' vnode blocks and placed in
    `[n, exch]` send buckets (`bucket_exchange`, one source), flattened
    into a routed Delta with no collective -> (Delta, need). The
    collective form is `exchange_apply`, over every source at once, so
    `abstract` must be True."""
    if not abstract:
        raise ValueError("_exchange_local: the collective form is "
                         "exchange_apply")
    from ..kernels import bucket_exchange
    from .skew_stats import SK_KEY_MASK
    n = data_shards(mesh)
    key, mask, sign, pk, arrays, refs, hot_mode = _exchange_arrays(
        node, xi, d, hot_keys, hot_side)
    bufs, _counts, need = bucket_exchange(
        key, mask, n, node.exch, arrays, [0] * len(arrays), sign=sign,
        pk=pk, bounds=bounds, hot_keys=tuple(hot_keys), hot_mode=hot_mode,
        hot_mask=SK_KEY_MASK)
    ex = node.shard_spec().exchanges[xi]
    return _routed(d, [b.reshape(-1) for b in bufs], refs, ex.carry_pk,
                   {}), need


def _routed(d, flat: List[torch.Tensor], refs: List[int], carry_pk: bool,
            zeros: dict):
    """A routed Delta from one shard's received flat arrays (shipped
    columns, sign, pk); each unshipped column is a zero column, shared
    through `zeros` ((dtype, device) -> tensor)."""
    from .fused import Delta
    sign = flat[len(refs)]
    at = {c: k for k, c in enumerate(refs)}
    cols = []
    for i, c in enumerate(d.cols):
        if i in at:
            cols.append(flat[at[i]])
            continue
        k = (c.dtype, sign.device)
        if k not in zeros:
            zeros[k] = torch.zeros(sign.shape[0], dtype=c.dtype,
                                   device=sign.device)
        cols.append(zeros[k])
    return Delta(cols, sign, sign != 0,
                 pk=flat[len(refs) + 1] if carry_pk else None)


def exchange_apply(mesh: Mesh, node, xi: int, deltas: Sequence,
                   bounds: Optional[Sequence[int]] = None,
                   hot_keys: Sequence[int] = (), hot_side: int = 1):
    """The exchange of one input over every shard: every source shard's
    rows bucketed and handed to their owners by `Mesh.exchange` (one
    `bucket_exchange` call over all sources on one device). -> (per-shard
    routed Deltas of n * exch rows, per-shard need)."""
    from .skew_stats import SK_KEY_MASK
    ex = node.shard_spec().exchanges[xi]
    parts = [_exchange_arrays(node, xi, d, hot_keys, hot_side)
             for d in deltas]
    keys, masks, signs, pks, arrays, refs, modes = map(list, zip(*parts))
    recv, needs = mesh.exchange(
        keys, masks, node.exch, arrays, [0] * len(arrays[0]), signs,
        None if any(p is None for p in pks) else pks, bounds=bounds,
        hot_keys=tuple(hot_keys), hot_mode=modes[0], hot_mask=SK_KEY_MASK)
    zeros: dict = {}
    return [_routed(deltas[d], recv[d], refs[0], ex.carry_pk, zeros)
            for d in range(len(recv))], needs


def exchange_delta(mesh: Mesh, node, xi: int, deltas: Sequence):
    """Exchange of one input, routed by the uniform vnode blocks (no
    rebalance or hot-key policy is ported: ROADMAP queue 1 item 5)."""
    EXCH_STATS["calls"] += 1
    return exchange_apply(mesh, node, xi, deltas)


# exchange accounting: calls of `exchange_delta`
EXCH_STATS = {"calls": 0}


def exchange_stats() -> dict:
    """Exchange-dispatch accounting (the port compiles nothing ahead of
    time, so the calls are all there is to count)."""
    return {"calls": EXCH_STATS["calls"]}


# ---------------------------------------------------------------------------
# the sharded per-node epoch step
# ---------------------------------------------------------------------------


def sharded_apply(mesh: Mesh, node, epoch_events: int, states, ins,
                  extras, event_lo: Optional[int] = None):
    """`Node.apply` on every shard -> (per-shard states or None, per-shard
    output Deltas, per-shard stat lists, per-shard aux).

    A source-rooted node generates its shard's contiguous block of the
    epoch's event ids, `event_lo + s * ev_local` with `ev_local =
    ceil(epoch_events / n)`; ids at or past `event_lo + epoch_events`
    (the padded tail of a cadence that does not divide) are masked out and
    `rows_out` recounted, so the reduced stats equal the 1-shard run's.
    Other nodes consume their own (or exchanged) rows; `extras[s]` is
    shard s's cross-node input (an MV's agg change set). The stats reduce
    across shards afterwards (`reduce_stats`)."""
    from .fused import Delta, _nrows
    n = data_shards(mesh)
    ev_local = epoch_events
    pad = 0
    if node.takes_event_lo:
        ev_local = -(-epoch_events // n)
        pad = n * ev_local - epoch_events
    names = node.stat_names
    new_states, outs, stats, auxes = [], [], [], []
    for s in range(n):
        st = states[s] if states is not None else None
        lins = [d[s] if d is not None else None for d in ins]
        if node.takes_event_lo:
            ex = event_lo + s * ev_local
        else:
            ex = extras[s] if extras is not None else None
        with on_device(node, mesh.devices[s]):
            nst, out, sts, aux = node.apply(st, lins, ex, ev_local)
        if pad and node.takes_event_lo and out is not None \
                and out.pk is not None:
            live = out.mask & (out.pk < event_lo + epoch_events)
            out = Delta(out.cols, out.sign, live, pk=out.pk, pk2=out.pk2)
            if "rows_out" in names:
                sts = list(sts)
                sts[names.index("rows_out")] = _nrows(live)
        new_states.append(nst)
        outs.append(out)
        stats.append(list(sts))
        auxes.append(aux)
    nst = None if states is None and all(x is None for x in new_states) \
        else tuple(new_states)
    return nst, outs, stats, auxes


def reduce_stats(mesh: Mesh, per_shard: Sequence[Sequence[torch.Tensor]],
                 sum_mask: torch.Tensor) -> torch.Tensor:
    """Per-shard stat scalars (one list per shard, one layout) -> the
    replicated vector on shard 0's device: `psum` where `sum_mask`, else
    `pmax`."""
    vecs = [torch.stack(list(s)) for s in per_shard]
    return torch.where(sum_mask, mesh.psum(vecs), mesh.pmax(vecs))


# ---------------------------------------------------------------------------
# host pull: merge per-shard sorted runs back into the single-device order
# ---------------------------------------------------------------------------

def replica_device_get(mesh: Mesh, tree):
    """Every tensor leaf of `tree` as numpy in one synchronised pull (one
    replica: serving replicas are not ported)."""
    from .agg_step import _to_host
    if mesh is not None and mesh_replicas(mesh) > 1:
        raise NotImplementedError("mesh replicas are not ported")
    return _to_host(tree)


def _gather_keyed(mesh: Mesh, states, nc: int, m: int):
    """Device-side merge of a sharded keyed MV: every shard's table
    gathered on shard 0's device and sorted by key (keys are globally
    unique, EMPTY_KEY pads sort last), cut to the live bound `m`."""
    from ..kernels import sort_cols
    keys = mesh.gather([st.keys for st in states])
    vals = [mesh.gather([st.vals[1 + 2 * i] for st in states])
            for i in range(nc)]
    nulls = [mesh.gather([st.vals[2 + 2 * i] for st in states])
             for i in range(nc)]
    (sk,), cols = sort_cols([keys], vals + nulls)
    total = mesh.psum([st.count.to(torch.int64) for st in states])
    return (total, sk[:m], [c[:m] for c in cols[:nc]],
            [u[:m] for u in cols[nc:]])


def _gather_pair(mesh: Mesh, sides, m: int):
    from ..kernels import sort_cols
    jk = mesh.gather([s.jk for s in sides])
    pk = mesh.gather([s.pk for s in sides])
    vals = [mesh.gather([s.vals[i] for s in sides])
            for i in range(len(sides[0].vals))]
    _keys, vals = sort_cols([jk, pk], vals)
    total = mesh.psum([s.count.to(torch.int64) for s in sides])
    return total, [v[:m] for v in vals]


def merge_keyed_pull(states, mesh: Mesh, col_dtypes, live_bound=None):
    """A sharded keyed MV merged by ascending packed key — keys are
    globally unique (each lives on its vnode's shard), so the merged order
    IS the 1-shard `mv_rows` order. With `live_bound` (the caller's
    high-water live-row estimate) the merge runs on the device and one
    transfer brings it back; a stale bound (more live rows than that)
    falls back to the host merge of each shard's live prefix, so
    correctness never rests on the estimate."""
    from .capacity import bucket
    n = data_shards(mesh)
    nc = len(col_dtypes)
    if live_bound:
        cap_total = n * states[0].keys.shape[0]
        m = min(cap_total, bucket(max(1, int(live_bound)), lo=256))
        total, keys, cols, nulls = replica_device_get(
            mesh, _gather_keyed(mesh, states, nc, m))
        total = int(total)
        if total <= m:
            return (keys[:total], [c[:total] for c in cols],
                    [u[:total] for u in nulls])
    from .agg_step import _to_host
    counts = [int(c) for c in _to_host([st.count for st in states])]
    pulled = _to_host(
        [[states[s].keys[:counts[s]]]
         + [states[s].vals[1 + 2 * i][:counts[s]] for i in range(nc)]
         + [states[s].vals[2 + 2 * i][:counts[s]] for i in range(nc)]
         for s in range(n)])
    keys = np.concatenate([p[0] for p in pulled])
    order = np.argsort(keys, kind="stable")
    cols = [np.concatenate([p[1 + i] for p in pulled])[order]
            for i in range(nc)]
    nulls = [np.concatenate([p[1 + nc + i] for p in pulled])[order]
             for i in range(nc)]
    return keys[order], cols, nulls


def merge_pair_pull(sides, mesh: Mesh, live_bound=None):
    """A sharded pair-MV JoinSide merged by (jk, pk) — the sort key of the
    single-device multimap and a globally unique pair identity, so the
    merged order is the 1-shard pull's. -> (rows, value columns). With
    `live_bound` the merge runs on the device (see merge_keyed_pull); a
    stale bound falls back to the host merge."""
    from .capacity import bucket
    from .agg_step import _to_host
    n = data_shards(mesh)
    if live_bound:
        cap_total = n * sides[0].jk.shape[0]
        m = min(cap_total, bucket(max(1, int(live_bound)), lo=256))
        total, vals = replica_device_get(mesh, _gather_pair(mesh, sides, m))
        total = int(total)
        if total <= m:
            return total, [v[:total] for v in vals]
    counts = [int(c) for c in _to_host([s.count for s in sides])]
    pulled = _to_host(
        [[sides[s].jk[:counts[s]], sides[s].pk[:counts[s]]]
         + [v[:counts[s]] for v in sides[s].vals] for s in range(n)])
    jk = np.concatenate([p[0] for p in pulled])
    pk = np.concatenate([p[1] for p in pulled])
    order = np.lexsort((pk, jk))
    nv = len(sides[0].vals)
    return (jk.shape[0],
            [np.concatenate([p[2 + i] for p in pulled])[order]
             for i in range(nv)])
