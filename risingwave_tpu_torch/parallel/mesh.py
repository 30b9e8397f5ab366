"""The shard mesh and its collectives (the port's own copy of
`risingwave_tpu/parallel/mesh.py`).

Vnodes are assigned to shards in contiguous blocks (the reference's
WorkerSlotMapping): a shard's key range stays compact, which the
sorted-run state wants, and a rescale moves block boundaries instead of
reshuffling everything.

A `Mesh` holds `n` data shards and the torch device of each. The shards
are laid on the devices it is given, shard s on `devices[s % len]`: on a
host with one card all shards share `cuda:0`, on a host with n cards each
has its own. Nothing falls back to the CPU; the CPU is used only when the
caller passes it.

The collectives the JAX package takes from `lax` work over a list of
per-shard tensors, one per shard, each on its shard's device:

* `all_to_all(send)`: shard s sends `send[s][d]` to shard d; the receiver
  stacks what it gets by source, `recv[d][s] = send[s][d]` (split and
  concat on axis 0, untiled); a buffer bound for another device moves
  by a non-blocking `Tensor.to`.
* `exchange(keys, masks, cap, cols, fills, ...)`: one bucket exchange of
  every source shard's rows — with every shard on one device, one call
  of the `bucket_exchange` kernel over all sources, whose receiver-major
  buffers are what each shard receives as they stand (no copy); over
  several devices, one call per source on its device (n_src = 1), then
  `all_to_all`.
* `psum` / `pmax`: the sum / maximum of per-shard tensors of one shape,
  on shard 0's device, with no host synchronisation.
* `gather`: the per-shard tensors concatenated on shard 0's device.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.vnode import VNODE_COUNT


class Mesh:
    """`n` data shards, shard s on `devices[s]` (one torch.device each)."""

    def __init__(self, n: int, devices: Sequence):
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        if not devices:
            raise ValueError("a mesh needs at least one device")
        from ..device import resolve_device
        devs = [resolve_device(d) for d in devices]   # "cuda" -> cuda:0
        self.n = int(n)
        self.devices: List[torch.device] = [devs[s % len(devs)]
                                            for s in range(self.n)]
        # every shard on one device: exchanges are indexing and one copy
        self.single_device = len(set(self.devices)) == 1

    @property
    def device(self) -> torch.device:
        """Shard 0's device: where replicated results (stats, pulls)
        land."""
        return self.devices[0]

    def layout(self) -> str:
        """Shards per device, e.g. `8 shards on cuda:0`."""
        per = {}
        for d in self.devices:
            per[str(d)] = per.get(str(d), 0) + 1
        return ", ".join(f"{c} shard{'s' if c > 1 else ''} on {d}"
                         for d, c in per.items())

    def __repr__(self) -> str:
        return f"Mesh({self.n}: {self.layout()})"

    # ---- collectives ----------------------------------------------------
    def all_to_all(self, send: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """send[s] is shard s's [n, ...] buffer (row d for shard d) ->
        recv[d] = [n, ...] with recv[d][s] = send[s][d], on shard d's
        device."""
        if len(send) != self.n:
            raise ValueError(f"all_to_all: {len(send)} buffers for "
                             f"{self.n} shards")
        return [torch.stack([send[s][d].to(self.devices[d],
                                           non_blocking=True)
                             for s in range(self.n)])
                for d in range(self.n)]

    def exchange(self, keys: Sequence[torch.Tensor],
                 masks: Sequence[torch.Tensor], cap: int,
                 cols: Sequence[Sequence[torch.Tensor]],
                 fills: Sequence[Any], signs=None, pks=None, **route
                 ) -> Tuple[List[List[torch.Tensor]], List[torch.Tensor]]:
        """One bucket exchange of every source shard's rows (`keys[s]`,
        `masks[s]`, its columns `cols[s]`, `signs` / `pks` per source or
        None, all on shard s's device; `route`: `bounds`, `hot_keys`,
        `hot_mode`, `hot_mask` of `bucket_exchange_sources`) -> (recv,
        need): recv[d] is shard d's received arrays, one per column, each
        [n * cap] rows, source-major; need[s] is source s's fullest
        bucket before the drop, an int64 scalar on its device.

        With every shard on one device this is one call of the kernel
        over every source: its receiver-major [n_dst, n_src, cap] buffers
        are the result as they stand. Otherwise each source calls the
        same kernel alone (n_src = 1) on its device and its [n, cap]
        buffers move by `all_to_all`."""
        from ..kernels.exchange import bucket_exchange_sources
        n = self.n
        if self.single_device:
            bufs, _counts, need = bucket_exchange_sources(
                keys, masks, n, cap, cols, fills, signs, pks, **route)
            return ([[b[d].reshape(n * cap) for b in bufs]
                     for d in range(n)], list(need.unbind(0)))
        sends, needs = [], []
        for s in range(n):
            bufs, _counts, need = bucket_exchange_sources(
                [keys[s]], [masks[s]], n, cap, [cols[s]], fills,
                None if signs is None else [signs[s]],
                None if pks is None else [pks[s]], **route)
            sends.append([b[:, 0] for b in bufs])
            needs.append(need[0])
        recv = [self.all_to_all([sends[s][j] for s in range(n)])
                for j in range(len(fills))]
        return [[r[d].reshape(n * cap) for r in recv]
                for d in range(n)], needs

    def _on0(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(xs) != self.n:
            raise ValueError(f"{len(xs)} per-shard tensors for {self.n} "
                             "shards")
        dev = self.device
        return torch.stack([x.to(dev, non_blocking=True) for x in xs])

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum over shards of per-shard tensors of one shape."""
        return self._on0(xs).sum(0)

    def pmax(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Maximum over shards of per-shard tensors of one shape."""
        return self._on0(xs).amax(0)

    def gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-shard tensors concatenated (axis 0) on shard 0's device."""
        dev = self.device
        return torch.cat([x.to(dev, non_blocking=True) for x in xs])


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence]
              = None, replicas: int = 1) -> Mesh:
    """A mesh of `n_devices` data shards over `devices` (default: the
    entry points' device, `cuda:0`; n defaults to the CUDA device count).
    With fewer devices than shards, shards share devices round-robin —
    there is no CPU fallback: with no GPU and no `devices` this raises.
    Serving replicas are not ported (`replicas > 1` raises)."""
    if int(replicas) > 1:
        raise NotImplementedError(
            "mesh replicas are not ported (ROADMAP queue 1 item 8)")
    if devices is None:
        from ..device import resolve_device
        devices = [resolve_device()]
    if n_devices is None:
        n_devices = torch.cuda.device_count() if any(
            torch.device(d).type == "cuda" for d in devices) \
            else len(devices)
    return Mesh(int(n_devices), devices)


def data_shards(mesh: Mesh) -> int:
    """Size of the vnode-partition (data) axis."""
    return mesh.n


def mesh_replicas(mesh: Mesh) -> int:
    """Replica count: always 1 (replicas are not ported)."""
    return 1


def vnode_block_bounds(n_shards: int, vnode_count: int = VNODE_COUNT
                       ) -> np.ndarray:
    """start vnode of each shard's contiguous block, plus end sentinel."""
    return (np.arange(n_shards + 1) * vnode_count) // n_shards


def shard_of_vnode(vnodes, n_shards: int, vnode_count: int = VNODE_COUNT):
    """Owning shard of each vnode — the exact inverse of
    `vnode_block_bounds`: shard k owns [bounds[k], bounds[k+1]), i.e. the
    largest k with (k * vnode_count) // n_shards <= v. The naive
    `(v * n) // vnode_count` disagrees at block boundaries whenever
    n_shards does not divide vnode_count. Works on numpy arrays and torch
    tensors (integer arithmetic)."""
    return ((vnodes + 1) * n_shards - 1) // vnode_count
