"""Virtual-node hashing of int64 keys (the port's own copy of the int64
half of `risingwave_tpu/core/vnode.py`).

A key's vnode is CRC32 (IEEE, reflected — zlib's) of its 8-byte
big-endian serialization, mod the vnode count. Two versions:

* `compute_vnodes` — numpy on the host (table-driven, the oracle);
* `crc32_u64` / `compute_vnodes_dev` — torch ops on the key tensor's
  device.

torch has no `>>` or `^` for uint32 / uint64 on the CPU, so the device
version carries the 32-bit CRC in int64: the CRC stays in [0, 2^32), so
its arithmetic shift is a logical one, and a key byte is an arithmetic
shift of the key masked to 8 bits (the sign bits never reach it).
"""
from __future__ import annotations

import numpy as np
import torch

# Default vnode count (the reference's 256).
VNODE_COUNT = 256

_POLY = 0xEDB88320


def _make_crc32_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        table[i] = c
    return table


CRC32_TABLE = _make_crc32_table()


def compute_vnodes(values: np.ndarray, vnode_count: int = VNODE_COUNT
                   ) -> np.ndarray:
    """Host vnode of each int64 key: int32 [n]."""
    v = np.asarray(values).astype(np.int64, copy=False).astype(np.uint64)
    crc = np.full(v.shape, 0xFFFFFFFF, dtype=np.uint32)
    for b in range(8):
        byte = ((v >> np.uint64(8 * (7 - b))) & np.uint64(0xFF)) \
            .astype(np.uint32)
        crc = (crc >> np.uint32(8)) ^ CRC32_TABLE[(crc ^ byte)
                                                  & np.uint32(0xFF)]
    crc ^= np.uint32(0xFFFFFFFF)
    return (crc % np.uint32(vnode_count)).astype(np.int32)


def bucket_parity(buckets: int, vnode_count: int = VNODE_COUNT):
    """The bucket `vnode(key) * buckets // vnode_count` of an int64 key as
    parities: bit j is `popcount(key & masks[j]) % 2 ^ (flip >> j) & 1`.

    The CRC of a fixed-length message is affine over GF(2): crc(a ^ b) =
    crc(a) ^ crc(b) ^ crc(0). With both counts powers of two, the bucket
    is bits log2(vnode_count / buckets) .. log2(vnode_count) - 1 of the
    CRC, so bit j of mask j's key bit i is that bucket bit of
    crc(1 << i) ^ crc(0), and `flip` is the bucket of key 0. Derived from
    `compute_vnodes` (this module's table) -> (masks, flip)."""
    shift = (vnode_count // buckets).bit_length() - 1
    if buckets << shift != vnode_count or buckets & (buckets - 1):
        raise ValueError("bucket_parity: counts must be powers of two")
    keys = np.array([0] + [1 << i for i in range(63)] + [-(1 << 63)],
                    np.int64)
    b = compute_vnodes(keys, vnode_count).astype(np.int64) >> shift
    flip = int(b[0])
    masks = [sum(1 << i for i in range(64) if (int(b[1 + i]) ^ flip) >> j & 1)
             for j in range(buckets.bit_length() - 1)]
    return tuple(masks), flip


_TABLES = {}


def _table(device) -> torch.Tensor:
    t = _TABLES.get(device)
    if t is None:
        t = torch.from_numpy(CRC32_TABLE.astype(np.int64)).to(device)
        _TABLES[device] = t
    return t


def crc32_u64(values: torch.Tensor) -> torch.Tensor:
    """CRC32 of each int64 key's 8 big-endian bytes, as int64 in
    [0, 2^32)."""
    table = _table(values.device)
    crc = torch.full(values.shape, 0xFFFFFFFF, dtype=torch.int64,
                     device=values.device)
    for b in range(8):
        byte = (values >> (8 * (7 - b))) & 0xFF
        crc = (crc >> 8) ^ table[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def compute_vnodes_dev(values: torch.Tensor,
                       vnode_count: int = VNODE_COUNT) -> torch.Tensor:
    """Vnode of each int64 key on its device: int32 [n]."""
    return (crc32_u64(values) % vnode_count).to(torch.int32)
