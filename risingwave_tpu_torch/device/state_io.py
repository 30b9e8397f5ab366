"""Carrying a fused job's device state across packages.

`states_from_numpy` turns per-node states read from the JAX package's
job (`jax.device_get(job.states)`: numpy leaves in its SortedState /
DeviceAggState tuples) into the port's state tuples, leaf by leaf and
dtype by dtype; `states_to_numpy` goes the other way. Both are driven by
the port's program, so each node's state takes the shape its node
expects: AggNode -> DeviceAggState(SortedState, (SortedMultiset, ...)),
MVKeyedNode ->
SortedState, JoinNode -> (JoinSide, JoinSide), MVPairNode -> JoinSide,
stateless nodes -> None. A tier-armed node's state is a
`TieredState(inner, touch, tick)` around those (touch one column for an
agg, a pair for a join).

A mesh program's (`FusedProgram(..., mesh=)`) states are per shard: there
both functions take and give the JAX package's sharded layout, every leaf
with a leading `[n, ...]` shard axis, and split it into (or stack it
from) the port's tuples of per-shard states, shard s on its device. The
sharded engines' states go the same way: `shards_from_numpy` turns a
`ShardedHashAgg`'s `[n, C]` SortedState, a multiset or a `ShardedHashJoin`
side into per-shard states, `shards_to_numpy` stacks them back.

`key_from_numpy` / `key_to_numpy` carry a PRNG key of the fused device
pipeline (`device/pipeline.py`): the JAX package's raw threefry key
(uint32 [2]) <-> the port's (int64 [2], the same two words).

`cold_from_snapshot` turns a `TieringManager.snapshot()` of either
package into the port's image of the same cold stores (payload rows,
touch stamps, filters with their exact fingerprints, counters), for
`FusedJob.load_states(..., cold=...)`.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from . import resolve_device
from .agg_step import DeviceAggState
from .fused import AggNode, FusedProgram, JoinNode, MVKeyedNode, MVPairNode
from .join_step import JoinSide
from .minput import SortedMultiset
from .sorted_state import SortedState
from .tiering import TieredState


def _leaf(a: Any, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _sorted_from(st: Any, device: torch.device) -> SortedState:
    return SortedState(_leaf(st.keys, device), _leaf(st.count, device),
                       tuple(_leaf(v, device) for v in st.vals))


def _sorted_to(st: SortedState) -> SortedState:
    return SortedState(st.keys.cpu().numpy(), st.count.cpu().numpy(),
                       tuple(v.cpu().numpy() for v in st.vals))


def _ms_from(ms: Any, device: torch.device) -> SortedMultiset:
    return SortedMultiset(_leaf(ms.k1, device), _leaf(ms.k2, device),
                          _leaf(ms.count, device), _leaf(ms.cnt, device))


def _ms_to(ms: SortedMultiset) -> SortedMultiset:
    return SortedMultiset(ms.k1.cpu().numpy(), ms.k2.cpu().numpy(),
                          ms.count.cpu().numpy(), ms.cnt.cpu().numpy())


def _side_from(st: Any, device: torch.device) -> JoinSide:
    return JoinSide(_leaf(st.jk, device), _leaf(st.pk, device),
                    _leaf(st.count, device),
                    tuple(_leaf(v, device) for v in st.vals))


def _side_to(st: JoinSide) -> JoinSide:
    return JoinSide(st.jk.cpu().numpy(), st.pk.cpu().numpy(),
                    st.count.cpu().numpy(),
                    tuple(v.cpu().numpy() for v in st.vals))


def key_from_numpy(key: Any, device=None) -> torch.Tensor:
    """A `jax.random.PRNGKey` (uint32 [2], as numpy) -> the port's key on
    `device`."""
    a = np.asarray(key)
    if a.shape != (2,) or a.dtype != np.uint32:
        raise ValueError(f"expected a uint32 [2] threefry key, got "
                         f"{a.dtype} {list(a.shape)}")
    return torch.from_numpy(a.astype(np.int64)).to(resolve_device(device))


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """The port's key -> the JAX package's raw key (uint32 [2])."""
    return key.cpu().numpy().astype(np.uint32)


def _shard(tree: Any, s: int) -> Any:
    """Shard s of a numpy tree with a leading shard axis on every leaf."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_shard(v, s) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_shard(v, s) for v in tree)
    return np.asarray(tree)[s]


def _stack(trees) -> Any:
    """Per-shard numpy trees -> one tree of `[n, ...]` leaves."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack([t[i] for t in trees])
                             for i in range(len(first))))
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return np.stack([np.asarray(t) for t in trees])


def shards_from_numpy(kind: str, tree: Any, mesh) -> Tuple:
    """A sharded engine state in the JAX package's layout (`[n, C]`
    leaves) -> per-shard states: `kind` is "sorted" (SortedState),
    "multiset" (SortedMultiset) or "side" (JoinSide)."""
    conv = {"sorted": _sorted_from, "multiset": _ms_from,
            "side": _side_from}[kind]
    return tuple(conv(_shard(tree, s), dev)
                 for s, dev in enumerate(mesh.devices))


def shards_to_numpy(states: Tuple) -> Any:
    """Per-shard SortedStates, SortedMultisets or JoinSides -> the JAX
    package's `[n, C]` leaves."""
    conv = {SortedState: _sorted_to, SortedMultiset: _ms_to,
            JoinSide: _side_to}[type(states[0])]
    return _stack([conv(st) for st in states])


def states_from_numpy(program: FusedProgram, np_states: Tuple,
                      device=None) -> Tuple:
    """numpy per-node states (the reference's layout) -> the port's
    states on `device`; under a mesh, per-shard states on the shards'
    devices."""
    if len(np_states) != len(program.nodes):
        raise ValueError(f"{len(np_states)} node states for a program of "
                         f"{len(program.nodes)} nodes")
    mesh = program.mesh
    if mesh is None:
        return _states_from(program, np_states, resolve_device(device))
    per = [_states_from(program, [_shard(st, s) for st in np_states], dev)
           for s, dev in enumerate(mesh.devices)]
    return tuple(None if per[0][i] is None
                 else tuple(p[i] for p in per)
                 for i in range(len(program.nodes)))


def _states_from(program: FusedProgram, np_states, dev) -> Tuple:
    out = []
    for node, st in zip(program.nodes, np_states):
        tier = None
        if getattr(node, "tier", False):
            tier, st = st, st.inner
        if isinstance(node, AggNode):
            if len(st.minputs) != len(node.spec.minputs):
                raise ValueError(f"{len(st.minputs)} multisets for an agg "
                                 f"of {len(node.spec.minputs)}")
            out.append(DeviceAggState(
                _sorted_from(st.main, dev),
                tuple(_ms_from(ms, dev) for ms in st.minputs)))
        elif isinstance(node, MVKeyedNode):
            out.append(_sorted_from(st, dev))
        elif isinstance(node, JoinNode):
            out.append(tuple(_side_from(side, dev) for side in st))
        elif isinstance(node, MVPairNode):
            out.append(_side_from(st, dev))
        elif st is not None:
            raise ValueError(f"unexpected state for stateless "
                             f"{type(node).__name__}")
        else:
            out.append(None)
        if tier is not None:
            touch = tuple(_leaf(t, dev) for t in tier.touch) \
                if isinstance(node, JoinNode) else _leaf(tier.touch, dev)
            out[-1] = TieredState(out[-1], touch, _leaf(tier.tick, dev))
    return tuple(out)


def states_to_numpy(program: FusedProgram, states: Tuple) -> Tuple:
    """The port's per-node states -> numpy leaves in the same tuples
    (under a mesh, stacked on a leading shard axis)."""
    if program.mesh is None:
        return _states_to(program, states)
    per = [_states_to(program, [None if st is None else st[s]
                                for st in states])
           for s in range(program.mesh.n)]
    return tuple(_stack([p[i] for p in per])
                 for i in range(len(program.nodes)))


def _states_to(program: FusedProgram, states) -> Tuple:
    out = []
    for node, st in zip(program.nodes, states):
        tier = None
        if getattr(node, "tier", False):
            tier, st = st, st.inner
        if isinstance(node, AggNode):
            out.append(DeviceAggState(_sorted_to(st.main),
                                      tuple(_ms_to(ms) for ms in st.minputs)))
        elif isinstance(node, MVKeyedNode):
            out.append(_sorted_to(st))
        elif isinstance(node, JoinNode):
            out.append(tuple(_side_to(side) for side in st))
        elif isinstance(node, MVPairNode):
            out.append(_side_to(st))
        else:
            out.append(None)
        if tier is not None:
            touch = tuple(t.cpu().numpy() for t in tier.touch) \
                if isinstance(node, JoinNode) else tier.touch.cpu().numpy()
            out[-1] = TieredState(out[-1], touch, tier.tick.cpu().numpy())
    return tuple(out)


def cold_from_snapshot(snap) -> Any:
    """A `TieringManager.snapshot()` — ({(node, side): (per-shard row
    mappings, filters, filter_live)}, counters) — from either package, as
    the port's `TieringManager.restore` image: rows copied as plain
    mappings, each filter rebuilt as the port's `Xor8` with the same
    seed, segment size, fingerprints and layout (so the same keys give
    the same false positives). Store keys are the reference's node
    indices; remap them first where the programs differ."""
    from ..state.xor8 import Xor8
    stores, counters = snap
    out = {}
    for key, (rows, filters, live) in stores.items():
        out[key] = ([dict(d.items()) for d in rows],
                    [None if f is None else Xor8(f.seed, f.seg, bytes(f.fp),
                                                 f.ver)
                     for f in filters], list(live))
    return out, dict(counters)
