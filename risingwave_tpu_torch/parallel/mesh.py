"""The shard mesh and its collectives (the port's own copy of
`risingwave_tpu/parallel/mesh.py`).

Vnodes are assigned to shards in contiguous blocks (the reference's
WorkerSlotMapping): a shard's key range stays compact, which the
sorted-run state wants, and a rescale moves block boundaries instead of
reshuffling everything.

A `Mesh` holds `n` data shards and the torch device of each. The shards
are laid on a set of devices, shard s on `devices[s % len]`. The set is
`device_set`'s, the counterpart of the reference's `jax.devices()`: from
a CUDA device, every visible card in index order starting from it (on a
host with one card all shards share `cuda:0`, on a host with n cards each
has its own); from the CPU, the CPU alone; or the sequence the caller
gives, whose first entry is shard 0's device. Nothing falls back to the
CPU; the CPU is used only when the caller passes it, and a set that names
a card the host does not have raises.

Serving replicas: `make_mesh(n, devices, replicas=r)` lays out `n * r`
device slots in the reference's order (`devices.reshape(n, r)`: slot
[d, k] holds data shard d of replica column k, on `devices[(d * r + k) %
len]`). Column 0 is where the shards run; every other column holds a
copy of every shard's state (`shard_exec.replicate_states`), which a
SELECT may read instead (`shard_exec.replica_device_get`). Collectives
work over the data shards only, as the reference's name only its
`shard` axis.

The collectives the JAX package takes from `lax` work over a list of
per-shard tensors, one per shard, each on its shard's device:

* `all_to_all(send)`: shard s sends `send[s][d]` to shard d; the receiver
  stacks what it gets by source, `recv[d][s] = send[s][d]` (split and
  concat on axis 0, untiled); a buffer bound for another device moves
  by `move`: without blocking onto a card, synchronously onto the CPU.
* `exchange(keys, masks, cap, cols, fills, ...)`: one bucket exchange of
  every source shard's rows — with every shard on one device, one call
  of the `bucket_exchange` kernel over all sources, whose receiver-major
  buffers are what each shard receives as they stand (no copy); over
  several devices, one call per source on its device (n_src = 1), then
  `all_to_all`.
* `psum` / `pmax`: the sum / maximum of per-shard tensors of one shape,
  on shard 0's device, with no host synchronisation when that device is a
  card.
* `gather`: the per-shard tensors concatenated on shard 0's device.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.vnode import VNODE_COUNT

SHARD_AXIS = "shard"
REPLICA_AXIS = "replica"


class Mesh:
    """`n` data shards, shard s on `devices[s]` (one torch.device each),
    and `replicas` columns of device slots (`slots[s][k]`)."""

    def __init__(self, n: int, devices: Sequence, replicas: int = 1):
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        if not devices:
            raise ValueError("a mesh needs at least one device")
        devs = device_set(list(devices))          # "cuda" -> cuda:0
        self.n = int(n)
        self.replicas = max(1, int(replicas))
        r = self.replicas
        self.slots: List[List[torch.device]] = [
            [devs[(s * r + k) % len(devs)] for k in range(r)]
            for s in range(self.n)]
        self.devices: List[torch.device] = [row[0] for row in self.slots]
        # every shard on one device: exchanges are indexing and one copy
        self.single_device = len(set(self.devices)) == 1

    def cuda_devices(self) -> List[torch.device]:
        """The distinct cards of every slot, in index order."""
        return cuda_devices(d for row in self.slots for d in row)

    def synchronize(self) -> None:
        """Wait for the work queued on every card of the mesh."""
        for d in self.cuda_devices():
            torch.cuda.synchronize(d)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (SHARD_AXIS,) if self.replicas == 1 \
            else (SHARD_AXIS, REPLICA_AXIS)

    def column(self, k: int) -> List[torch.device]:
        """The devices of replica column k, one per data shard."""
        return [row[k] for row in self.slots]

    @property
    def device(self) -> torch.device:
        """Shard 0's device: where replicated results (stats, pulls)
        land."""
        return self.devices[0]

    def layout(self) -> str:
        """Shards per device, e.g. `8 shards on cuda:0` (and the replica
        columns, e.g. `x 2 replicas`)."""
        per = {}
        for d in self.devices:
            per[str(d)] = per.get(str(d), 0) + 1
        out = ", ".join(f"{c} shard{'s' if c > 1 else ''} on {d}"
                        for d, c in per.items())
        return out if self.replicas == 1 \
            else f"{out} x {self.replicas} replicas"

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
        return [torch.stack([move(send[s][d], self.devices[d])
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

    def _on0(self, xs: Sequence[torch.Tensor], dev=None) -> torch.Tensor:
        if len(xs) != self.n:
            raise ValueError(f"{len(xs)} per-shard tensors for {self.n} "
                             "shards")
        dev = self.device if dev is None else dev
        return torch.stack([move(x, dev) for x in xs])

    def psum(self, xs: Sequence[torch.Tensor], dev=None) -> torch.Tensor:
        """Sum over shards of per-shard tensors of one shape, on `dev`
        (default shard 0's device)."""
        return self._on0(xs, dev).sum(0)

    def pmax(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Maximum over shards of per-shard tensors of one shape."""
        return self._on0(xs).amax(0)

    def gather(self, xs: Sequence[torch.Tensor], dev=None) -> torch.Tensor:
        """Per-shard tensors concatenated (axis 0) on `dev` (default shard
        0's device)."""
        dev = self.device if dev is None else dev
        return torch.cat([move(x, dev) for x in xs])


def move(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`x` on `dev`. Onto a card the copy does not block the host (the
    card's stream orders it before any use there); onto the CPU it does:
    a non-blocking copy from a card lands in pinned memory after the call
    returns, and nothing would order a CPU read after it."""
    return x.to(dev, non_blocking=dev.type == "cuda")


def cuda_devices(devices) -> List[torch.device]:
    """The distinct CUDA devices among `devices`, in index order."""
    return sorted({d for d in devices if d.type == "cuda"},
                  key=lambda d: d.index)


def device_set(device=None) -> List[torch.device]:
    """The devices a mesh lays its shards over, shard 0's first — the
    counterpart of the reference's `jax.devices()`:

    * a sequence: those devices, in its order;
    * a CUDA device (None: `cuda:0`): every visible card in index order,
      starting from it (`cuda:i`, ..., then `cuda:0`, ..., `cuda:i-1`);
    * the CPU: that one device.

    A set that names a card the host does not have raises: nothing falls
    back to the CPU (with no GPU and no device, `resolve_device` raises
    too)."""
    from ..device import resolve_device
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("a mesh needs at least one device")
        devs = [resolve_device(d) for d in device]
    else:
        first = resolve_device(device)
        count = torch.cuda.device_count() if first.type == "cuda" else 0
        devs = [first] if count <= 1 else [
            torch.device("cuda", (first.index + i) % count)
            for i in range(count)]
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for d in devs:
        if d.type == "cuda" and d.index >= count:
            raise RuntimeError(
                f"risingwave_tpu_torch: the device set names {d}, but "
                f"this host has {count} CUDA device(s)")
    return devs


def make_mesh(n_devices: Optional[int] = None, devices=None,
              replicas: int = 1) -> Mesh:
    """A mesh of `n_devices` data shards (default: one for each device)
    over `device_set(devices)` (default: every visible card from
    `cuda:0`), times `replicas` serving-replica columns (`n * replicas`
    device slots, slot [d, k] on `devices[(d * replicas + k) % len]`).
    With fewer devices than slots, slots share devices round-robin —
    there is no CPU fallback: with no GPU and no `devices` this
    raises."""
    devs = device_set(devices)
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(int(n_devices), devs, replicas=replicas)


def data_shards(mesh: Mesh) -> int:
    """Size of the vnode-partition (data) axis."""
    return mesh.n


def mesh_replicas(mesh: Mesh) -> int:
    """Replica columns (1 without serving replicas)."""
    return mesh.replicas


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
