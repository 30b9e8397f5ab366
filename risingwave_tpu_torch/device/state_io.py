"""Carrying a fused job's device state across packages.

`states_from_numpy` turns per-node states read from the JAX package's
job (`jax.device_get(job.states)`: numpy leaves in its SortedState /
DeviceAggState tuples) into the port's state tuples, leaf by leaf and
dtype by dtype; `states_to_numpy` goes the other way. Both are driven by
the port's program, so each node's state takes the shape its node
expects: AggNode -> DeviceAggState(SortedState, (SortedMultiset, ...)),
MVKeyedNode ->
SortedState, JoinNode -> (JoinSide, JoinSide), MVPairNode -> JoinSide,
stateless nodes -> None.
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


def states_from_numpy(program: FusedProgram, np_states: Tuple,
                      device=None) -> Tuple:
    """numpy per-node states (the reference's layout) -> the port's
    states on `device`."""
    dev = resolve_device(device)
    if len(np_states) != len(program.nodes):
        raise ValueError(f"{len(np_states)} node states for a program of "
                         f"{len(program.nodes)} nodes")
    out = []
    for node, st in zip(program.nodes, np_states):
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
    return tuple(out)


def states_to_numpy(program: FusedProgram, states: Tuple) -> Tuple:
    """The port's per-node states -> numpy leaves in the same tuples."""
    out = []
    for node, st in zip(program.nodes, states):
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
    return tuple(out)
