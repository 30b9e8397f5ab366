"""The bucket exchange of the sharded paths: a hand-written CUDA kernel
beside its plain PyTorch version.

| core              | replaces (risingwave_tpu/)                          |
|-------------------|-----------------------------------------------------|
| `bucket_exchange` | `device/shard_exec.py` `_exchange_local` :165 with   |
|                   | `_route_dest` :148; `parallel/sharded_agg.py`        |
|                   | `_bucketize` :36                                     |

One call is one whole exchange (`bucket_exchange_sources`): the rows of
every source shard go to the shard that owns their key's vnode block.
Each live row takes the next slot of its destination's bucket among the
rows of its own source, in row order, and every column is scattered into
a receiver-major buffer [n_dst, n_src, cap] with its own fill in the
slots no row takes, so receiver d's rows are buffer[d], source-major.
`need`, a source's fullest bucket before rows past `cap` drop, is the
overflow signal (`need > cap`). Hot keys (`key & hot_mask` in
`hot_keys`) broadcast (a slot in every bucket, ranked among the rows
bound there) or salt (destination `pk` floor-mod n). `bucket_exchange`
is the one-source form ([n, cap] buffers), the same kernel at n_src = 1.

As in the package's `__init__`: the dispatch sends CUDA tensors to the
kernel (`csrc/exchange.cu`, bound by `binding.py`) and CPU tensors to
the plain version, with no switch and no fallback, and every call of the
kernel adds one to `LAUNCHES["bucket_exchange"]`.
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


def bucket_exchange_sources_plain(keys: Sequence[torch.Tensor],
                                  masks: Sequence[torch.Tensor], n: int,
                                  cap: int,
                                  cols: Sequence[Sequence[torch.Tensor]],
                                  fills: Sequence[Any], signs=None, pks=None,
                                  bounds=None, hot_keys: Sequence[int] = (),
                                  hot_mode: int = HOT_NONE,
                                  hot_mask: int = -1
                                  ) -> Tuple[List[torch.Tensor], torch.Tensor,
                                             torch.Tensor]:
    """Every source by `bucket_exchange_plain`, stacked receiver-major
    (see `bucket_exchange_sources`)."""
    _check_sources(keys, masks, cols, signs, pks)
    per = [bucket_exchange_plain(
        keys[s], masks[s], n, cap, cols[s], fills,
        None if signs is None else signs[s], None if pks is None else pks[s],
        bounds, hot_keys, hot_mode, hot_mask) for s in range(len(keys))]
    bufs = [torch.stack([p[0][j] for p in per], 1) for j in range(len(fills))]
    return (bufs, torch.stack([p[1] for p in per]),
            torch.stack([p[2] for p in per]))


def _check_sources(keys, masks, cols, signs, pks) -> None:
    n_src = len(keys)
    if not 1 <= n_src <= binding.EXCH_MAX_SOURCES:
        raise ValueError(f"bucket_exchange: 1 to {binding.EXCH_MAX_SOURCES} "
                         f"source shards, got {n_src}")
    if len(masks) != n_src or len(cols) != n_src \
            or (signs is not None and len(signs) != n_src) \
            or (pks is not None and len(pks) != n_src):
        raise ValueError("bucket_exchange: one key, mask, sign, pk and "
                         "column list per source shard")
    b = keys[0].shape[0]
    if any(k.shape[0] != b for k in keys):
        raise ValueError("bucket_exchange: every source shard needs the same "
                         f"row count, got {[k.shape[0] for k in keys]}")


def bucket_exchange_sources(keys: Sequence[torch.Tensor],
                            masks: Sequence[torch.Tensor], n: int, cap: int,
                            cols: Sequence[Sequence[torch.Tensor]],
                            fills: Sequence[Any], signs=None, pks=None,
                            bounds=None, hot_keys: Sequence[int] = (),
                            hot_mode: int = HOT_NONE, hot_mask: int = -1,
                            out: Optional[Sequence[torch.Tensor]] = None
                            ) -> Tuple[List[torch.Tensor], torch.Tensor,
                                       torch.Tensor]:
    """One whole exchange: route the rows of every source shard s (`keys[s]`,
    `masks[s]`, its columns `cols[s]`, each source with the same row
    count) to `n` destination buckets of `cap` slots and place every
    column there -> (buffers [n, n_src, cap] per column, receiver-major:
    buffer[d] is what shard d receives, source-major; counts int64
    [n_src, n]; need int64 [n_src]).

    A row is live when its mask (and, given `signs`, sign != 0). Its
    destination is the owner of its key's vnode (`route_dest`); a hot key
    broadcasts or salts (`hot_mode`, salting by `pks`). Its slot is the
    count of earlier live rows of its source bound to the same
    destination (a broadcast row counts in every bucket); slots at or
    past `cap` drop, and `need` reports each source's largest bucket
    count before the drop. Each column's slots no row takes hold its
    fill. `out`, when given, are the [n, n_src, cap] buffers to write.

    CUDA: one host call, three launches whatever n_src is — a memset of
    the call's work words, one pass over every source's tiles with
    decoupled look-back inside each source, and the fill
    (`csrc/exchange.cu`)."""
    _check(n, bounds, hot_keys, hot_mode, pks)
    if not keys[0].is_cuda:
        bufs, counts, need = bucket_exchange_sources_plain(
            keys, masks, n, cap, cols, fills, signs, pks, bounds, hot_keys,
            hot_mode, hot_mask)
        if out is not None:
            for o, b in zip(out, bufs):
                o.copy_(b)
            bufs = list(out)
        return bufs, counts, need
    _check_sources(keys, masks, cols, signs, pks)
    n_src = len(keys)
    cols = [[c.contiguous() for c in cs] for cs in cols]
    if out is None:
        out = [torch.empty((n, n_src, cap), dtype=c.dtype,
                           device=keys[0].device) for c in cols[0]]
    if not hot_keys:
        hot_mode = HOT_NONE
    counts, need = binding.bucket_exchange(
        [k.contiguous() for k in keys], [m.contiguous() for m in masks],
        None if signs is None
        else [s.to(torch.int32).contiguous() for s in signs],
        None if pks is None else [p.contiguous() for p in pks], int(n),
        int(cap), cols, [_bits(f, c.dtype) for f, c in zip(fills, cols[0])],
        bounds, list(hot_keys), int(hot_mode), int(hot_mask), out)
    LAUNCHES["bucket_exchange"] += 1
    return list(out), counts, need


def bucket_exchange(key: torch.Tensor, mask: torch.Tensor, n: int, cap: int,
                    cols: Sequence[torch.Tensor], fills: Sequence[Any],
                    sign=None, pk=None, bounds=None,
                    hot_keys: Sequence[int] = (), hot_mode: int = HOT_NONE,
                    hot_mask: int = -1,
                    out: Optional[Sequence[torch.Tensor]] = None
                    ) -> Tuple[List[torch.Tensor], torch.Tensor,
                               torch.Tensor]:
    """One source shard's exchange: `bucket_exchange_sources` with one
    source -> (buffers [n, cap] per column, counts int64 [n], need int64
    scalar). `out`, when given, are the [n, cap] buffers to write."""
    bufs, counts, need = bucket_exchange_sources(
        [key], [mask], n, cap, [cols], fills,
        None if sign is None else [sign], None if pk is None else [pk],
        bounds, hot_keys, hot_mode, hot_mask,
        None if out is None else [o.view(n, 1, cap) for o in out])
    if out is not None:
        return list(out), counts[0], need[0]
    return [b.view(n, cap) for b in bufs], counts[0], need[0]
