"""Fused device pipeline: datagen source -> hash agg -> materialized view
(PyTorch port of `risingwave_tpu/device/pipeline.py`).

One epoch is one program with no host traffic in steady state: bids are
generated on the card (`gen_bids`), aggregated by the sorted-run hash agg
(`epoch_core`) and applied to the device MV (`mv_apply_changes`).
Overflow ("needed") scalars accumulate on the device and are checked
once, at the end, so the epoch loop never syncs.

Where the reference jits the epoch into one XLA program, the port
captures it once as one CUDA graph (`capture_bid_epoch`): a replay is
one epoch, and the host does nothing but launch the graph.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels import LAUNCHES, binding
from . import resolve_device
from .agg_step import DeviceAggSpec, epoch_core
from .datagen import gen_bids, prng_key
from .materialize import make_mv_state, mv_apply_changes
from .sorted_state import SortedState


def bid_agg_epoch(spec: DeviceAggSpec, n: int, n_auctions: int,
                  agg_state: SortedState, mv_state: SortedState,
                  rng: torch.Tensor, max_needed: torch.Tensor):
    """(states, rng, max_needed) -> one epoch applied. All on the
    device."""
    auction, price, rng = gen_bids(rng, n, n_auctions)
    dev = auction.device
    ones_i = torch.ones(n, dtype=torch.int32, device=dev)
    ones_b = torch.ones(n, dtype=torch.bool, device=dev)
    inputs = tuple((price, ones_b) for _ in spec.calls)
    new_agg, needed_a, ch = epoch_core(spec, agg_state, auction, ones_i,
                                       ones_b, inputs)
    upsert = ch["new_found"]
    delete = ch["old_found"] & ~ch["new_found"]
    new_mv, needed_m = mv_apply_changes(mv_state, ch["keys"], upsert, delete,
                                        ch["new_out"], ch["new_null"])
    max_needed = torch.maximum(max_needed,
                               torch.maximum(needed_a, needed_m))
    return new_agg, new_mv, rng, max_needed


def make_bid_pipeline(spec: DeviceAggSpec, capacity: int, device=None
                      ) -> Tuple[SortedState, SortedState]:
    dev = resolve_device(device)
    agg_state = spec.make_state(capacity, dev)
    mv_dtypes = [c.acc_dtype for c in spec.calls]
    mv_state = make_mv_state(capacity, mv_dtypes, dev)
    return agg_state, mv_state


def _copy_into(dst: SortedState, src: SortedState) -> None:
    dst.keys.copy_(src.keys)
    dst.count.copy_(src.count)
    for d, s in zip(dst.vals, src.vals):
        d.copy_(s)


class BidEpochGraph:
    """`bid_agg_epoch` captured once as a CUDA graph over static buffers:
    the agg and MV states, the key and `max_needed` (all from
    `make_bid_pipeline`, `prng_key(seed)` and 0). The captured region ends
    by copying the epoch's new states, key and `max_needed` into those
    buffers, so each `step()` — one `replay()`, nothing else on the host —
    applies one more epoch in place.

    Built by `capture_bid_epoch`: the kernel library is loaded and one
    epoch runs on a side stream first (its results are dropped: every
    core is functional, so the buffers still hold the initial state),
    then the epoch is captured. A capture that fails raises; there is no
    eager fallback. `launches` holds the kernel launches of one epoch, as
    counted while it was captured."""

    def __init__(self, spec: DeviceAggSpec, n: int, n_auctions: int,
                 capacity: int, device=None, seed: int = 42):
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError("capture_bid_epoch: a CUDA graph needs a CUDA "
                             f"device, got {dev}")
        binding.build()
        self.agg, self.mv = make_bid_pipeline(spec, capacity, dev)
        self.rng = prng_key(seed, dev)
        self.max_needed = torch.zeros((), dtype=torch.int32, device=dev)
        args = (spec, n, n_auctions)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            bid_agg_epoch(*args, self.agg, self.mv, self.rng,
                          self.max_needed)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            # the kernels launch on the stream being captured
            if binding._stream(self.rng) != \
                    torch.cuda.current_stream(dev).cuda_stream:
                raise RuntimeError("capture_bid_epoch: the kernels' stream "
                                   "is not the capture stream")
            agg, mv, rng, mn = bid_agg_epoch(*args, self.agg, self.mv,
                                             self.rng, self.max_needed)
            _copy_into(self.agg, agg)
            _copy_into(self.mv, mv)
            self.rng.copy_(rng)
            self.max_needed.copy_(mn)
        self.launches: Dict[str, int] = {
            k: v - before[k] for k, v in LAUNCHES.items() if v > before[k]}

    def step(self) -> None:
        self.graph.replay()


def capture_bid_epoch(spec: DeviceAggSpec, n: int, n_auctions: int,
                      capacity: int, device=None, seed: int = 42
                      ) -> BidEpochGraph:
    """One epoch of `n` bids over `n_auctions` auctions, from empty states
    of `capacity` slots and `prng_key(seed)`, captured as a CUDA graph:
    `.step()` replays one epoch; `.agg`, `.mv`, `.rng` and `.max_needed`
    hold the state after the last replay."""
    return BidEpochGraph(spec, n, n_auctions, capacity, device, seed)
