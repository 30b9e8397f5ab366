"""The bucket exchange of the sharded paths: a hand-written CUDA kernel
beside its plain PyTorch version.

| core              | replaces (risingwave_tpu/)                          |
|-------------------|-----------------------------------------------------|
| `bucket_exchange` | `device/shard_exec.py` `_exchange_local` :165 with   |
|                   | `_route_dest` :148; `parallel/sharded_agg.py`        |
|                   | `_bucketize` :36                                     |

A source shard's rows go to the shard that owns their key's vnode block:
each live row takes the next slot of its destination's bucket, in row
order, and every column is scattered into an [n, cap] send buffer with
its own fill in the slots no row takes. `need`, the fullest bucket's
count before rows past `cap` drop, is the overflow signal (`need > cap`).
Hot keys (`key & hot_mask` in `hot_keys`) broadcast (a slot in every
bucket, ranked among the rows bound there) or salt (destination `pk`
floor-mod n).

As in the package's `__init__`: the dispatch function sends CUDA tensors
to the kernel (`csrc/exchange.cu`, bound by `binding.py`) and CPU tensors
to `bucket_exchange_plain`, with no switch and no fallback, and every
launch adds one to `LAUNCHES["bucket_exchange"]`.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from . import LAUNCHES, _bits, binding

HOT_NONE, HOT_BCAST, HOT_SALT = 0, 1, 2


def route_dest(vn: torch.Tensor, n: int,
               bounds: Optional[Sequence[int]]) -> torch.Tensor:
    """Owning shard (int64) of each vnode: the uniform contiguous blocks
    (`shard_of_vnode`) when `bounds` is None, else shard s owns
    [bounds[s], bounds[s + 1]) (empty blocks allowed)."""
    from ..core.vnode import VNODE_COUNT
    from ..parallel.mesh import shard_of_vnode
    vn = vn.to(torch.int64)
    if bounds is None:
        return shard_of_vnode(vn, n, VNODE_COUNT)
    dest = torch.zeros_like(vn)
    for b in bounds[1:-1]:
        dest = dest + (vn >= int(b)).to(torch.int64)
    return dest


def _check(n: int, bounds, hot_keys, hot_mode, pk) -> None:
    if not 1 <= n <= binding.EXCH_MAX_SHARDS:
        raise ValueError(f"bucket_exchange: 1 to {binding.EXCH_MAX_SHARDS} "
                         f"shards, got {n}")
    if bounds is not None and len(bounds) != n + 1:
        raise ValueError(f"bucket_exchange: {len(bounds)} bounds for {n} "
                         "shards")
    if hot_mode not in (HOT_NONE, HOT_BCAST, HOT_SALT):
        raise ValueError(f"bucket_exchange: hot mode {hot_mode}")
    if len(hot_keys) > binding.EXCH_MAX_HOT:
        raise ValueError(f"bucket_exchange: at most {binding.EXCH_MAX_HOT} "
                         "hot keys")
    if hot_keys and hot_mode == HOT_SALT and pk is None:
        raise ValueError("bucket_exchange: salted hot keys need pk")


def bucket_exchange_plain(key: torch.Tensor, mask: torch.Tensor, n: int,
                          cap: int, cols: Sequence[torch.Tensor],
                          fills: Sequence[Any], sign=None, pk=None,
                          bounds=None, hot_keys: Sequence[int] = (),
                          hot_mode: int = HOT_NONE, hot_mask: int = -1
                          ) -> Tuple[List[torch.Tensor], torch.Tensor,
                                     torch.Tensor]:
    """The JAX package's composition in torch ops (see `bucket_exchange`):
    one-hot of the destinations, cumsum for the slots, one scatter per
    column."""
    from ..core.vnode import compute_vnodes_dev
    _check(n, bounds, hot_keys, hot_mode, pk)
    dev = key.device
    live = mask if sign is None else mask & (sign != 0)
    dest = route_dest(compute_vnodes_dev(key), n, bounds)
    bcast = None
    if hot_keys and hot_mode != HOT_NONE:
        k40 = key & hot_mask
        is_hot = torch.zeros_like(live)
        for hk in hot_keys:
            is_hot = is_hot | (k40 == int(hk))
        is_hot = is_hot & live
        if hot_mode == HOT_BCAST:
            bcast = is_hot
        else:
            dest = torch.where(is_hot, torch.remainder(pk, n), dest)
    shards = torch.arange(n, dtype=torch.int64, device=dev)
    onehot = (dest[None, :] == shards[:, None]) & live[None, :]
    if bcast is not None:
        onehot = onehot | bcast[None, :]
    counts = onehot.sum(1, dtype=torch.int64)
    need = counts.max() if n else torch.zeros((), dtype=torch.int64)
    pos = torch.cumsum(onehot.to(torch.int64), 1) - 1
    take = onehot & (pos < cap)
    d_idx, r_idx = torch.nonzero(take, as_tuple=True)
    slots = pos[d_idx, r_idx]
    bufs = []
    for c, f in zip(cols, fills):
        buf = torch.full((n, cap), f, dtype=c.dtype, device=dev)
        buf[d_idx, slots] = c[r_idx]
        bufs.append(buf)
    return bufs, counts, need


def bucket_exchange(key: torch.Tensor, mask: torch.Tensor, n: int, cap: int,
                    cols: Sequence[torch.Tensor], fills: Sequence[Any],
                    sign=None, pk=None, bounds=None,
                    hot_keys: Sequence[int] = (), hot_mode: int = HOT_NONE,
                    hot_mask: int = -1,
                    out: Optional[Sequence[torch.Tensor]] = None
                    ) -> Tuple[List[torch.Tensor], torch.Tensor,
                               torch.Tensor]:
    """Route one source shard's rows to `n` destination buckets of `cap`
    slots and place every column there -> (buffers [n, cap] per column,
    counts int64 [n], need int64 scalar).

    A row is live when `mask` (and, given `sign`, sign != 0). Its
    destination is the owner of its key's vnode (`route_dest`); a hot key
    broadcasts or salts (`hot_mode`). Its slot is the count of earlier
    live rows bound to the same destination (a broadcast row counts in
    every bucket); slots at or past `cap` drop, and `need` reports the
    largest bucket count before the drop. Each column's slots no row
    takes hold its fill. `out`, when given, are the [n, cap] buffers to
    write (views of one allocation, for a one-copy `all_to_all`).

    CUDA: three launches — per-tile class counts, a scan of them over the
    tiles, and a pass that ranks each 256-row round by warp matches and
    writes every column at its slot, beside blocks that write the fills
    (`csrc/exchange.cu`)."""
    if not key.is_cuda:
        bufs, counts, need = bucket_exchange_plain(
            key, mask, n, cap, cols, fills, sign, pk, bounds, hot_keys,
            hot_mode, hot_mask)
        if out is not None:
            for o, b in zip(out, bufs):
                o.copy_(b)
            bufs = list(out)
        return bufs, counts, need
    _check(n, bounds, hot_keys, hot_mode, pk)
    cols = [c.contiguous() for c in cols]
    if out is None:
        out = [torch.empty((n, cap), dtype=c.dtype, device=key.device)
               for c in cols]
    if not hot_keys:
        hot_mode = HOT_NONE
    counts, need = binding.bucket_exchange(
        key.contiguous(), mask.contiguous(),
        None if sign is None else sign.to(torch.int32).contiguous(),
        None if pk is None else pk.contiguous(), int(n), int(cap), cols,
        [_bits(f, c.dtype) for f, c in zip(fills, cols)], bounds,
        list(hot_keys), int(hot_mode), int(hot_mask), out)
    LAUNCHES["bucket_exchange"] += 1
    return list(out), counts, need
