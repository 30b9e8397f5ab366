"""Virtual-node hashing (the port's own copy of the JAX package's
`core/vnode.py`).

A row's vnode is CRC32 (IEEE, reflected — zlib's) of its distribution
key's serialization (big-endian 8 bytes for an integral key, the UTF-8
bytes of a string, a sentinel for NULL, chained across columns), mod the
vnode count. Three versions:

* `compute_vnodes` — on the host over `Column`s, any key types, with
  `vnode_of_row` its scalar form: a single non-null integral key goes
  through the C++ host kernel `native.vnodes_i64`, as in the JAX
  package; other keys through the table-driven numpy CRC
  (`crc32_bytes_matrix`);
* `vnodes_i64_plain` — `native.vnodes_i64` in numpy, its plain version
  (the tests and `chip_smoke.py` hold the kernel to it);
* `crc32_u64` / `compute_vnodes_dev` — torch ops on an int64 key
  tensor's device.

`column_hash64` / `hash_columns64` are the stable null-aware 64-bit key
hashes that project host-only types onto the device.

torch has no `>>` or `^` for uint32 / uint64 on the CPU, so the device
version carries the 32-bit CRC in int64: the CRC stays in [0, 2^32), so
its arithmetic shift is a logical one, and a key byte is an arithmetic
shift of the key masked to 8 bits (the sign bits never reach it).
"""
from __future__ import annotations

import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from .. import native
from .chunk import Column
from .dtypes import TypeKind

# Default vnode count (the reference's 256, max 2^15).
VNODE_COUNT = 256
MAX_VNODE_COUNT = 1 << 15

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


def vnodes_i64_plain(values: np.ndarray, vnode_count: int = VNODE_COUNT
                     ) -> np.ndarray:
    """Host vnode of each int64 key: int32 [n] (`native.vnodes_i64` in
    numpy)."""
    v = np.asarray(values).astype(np.int64, copy=False).astype(np.uint64)
    crc = np.full(v.shape, 0xFFFFFFFF, dtype=np.uint32)
    for b in range(8):
        byte = ((v >> np.uint64(8 * (7 - b))) & np.uint64(0xFF)) \
            .astype(np.uint32)
        crc = (crc >> np.uint32(8)) ^ CRC32_TABLE[(crc ^ byte)
                                                  & np.uint32(0xFF)]
    crc ^= np.uint32(0xFFFFFFFF)
    return (crc % np.uint32(vnode_count)).astype(np.int32)


def crc32_bytes_matrix(data: np.ndarray,
                       init: Optional[np.ndarray] = None) -> np.ndarray:
    """CRC32 of each row of a (n, k) uint8 matrix, vectorized across n.
    Matches zlib.crc32(row_bytes) bit-for-bit."""
    assert data.dtype == np.uint8 and data.ndim == 2
    n, k = data.shape
    crc = (np.full(n, 0xFFFFFFFF, dtype=np.uint32) if init is None
           else (init ^ np.uint32(0xFFFFFFFF)))
    for j in range(k):
        idx = (crc ^ data[:, j]) & np.uint32(0xFF)
        crc = (crc >> np.uint32(8)) ^ CRC32_TABLE[idx]
    return crc ^ np.uint32(0xFFFFFFFF)


def _int_key_bytes(values: np.ndarray) -> np.ndarray:
    """Serialize integral key values to (n, 8) big-endian bytes — the key
    serialization contract for hashing (value-encoding analog of the
    reference's HashKey, `src/common/src/hash/key_v2.rs:221`)."""
    v = values.astype(np.int64, copy=False).astype(np.uint64)
    out = np.empty((len(v), 8), dtype=np.uint8)
    for b in range(8):
        out[:, b] = ((v >> np.uint64(8 * (7 - b))) & np.uint64(0xFF)).astype(np.uint8)
    return out


_NULL_SENTINEL_BYTES = b"\x00null\x00"
FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(0x100000001B3)


def _fnv1a64_bytes_matrix(data: np.ndarray, lengths: Optional[np.ndarray] = None,
                          init: Optional[np.ndarray] = None) -> np.ndarray:
    """FNV-1a 64 over each row of an (n, k) uint8 matrix."""
    n, k = data.shape
    h = np.full(n, FNV_OFFSET, dtype=np.uint64) if init is None else init.copy()
    with np.errstate(over="ignore"):
        for j in range(k):
            if lengths is not None:
                active = j < lengths
                h = np.where(active, (h ^ data[:, j].astype(np.uint64)) * FNV_PRIME, h)
            else:
                h = (h ^ data[:, j].astype(np.uint64)) * FNV_PRIME
    return h


def column_hash64(col: Column) -> np.ndarray:
    """Stable null-aware 64-bit hash per row (FNV-1a over the serialized
    value). For host-only dtypes this is the device-side key projection."""
    n = len(col)
    kind = col.dtype.kind
    if col.dtype.is_fixed_width:
        if kind == TypeKind.BOOLEAN:
            data = col.values.astype(np.uint8).reshape(n, 1)
        elif kind == TypeKind.FLOAT32 or kind == TypeKind.FLOAT64:
            # normalize -0.0 to 0.0 so equal SQL values hash equal
            v = col.values.astype(np.float64, copy=True)
            v[v == 0.0] = 0.0
            data = v.view(np.uint64).reshape(n, 1)
            data = _int_key_bytes(data.view(np.int64).ravel())
        else:
            data = _int_key_bytes(col.values)
        h = _fnv1a64_bytes_matrix(data)
    else:
        h = np.empty(n, dtype=np.uint64)
        for i in range(n):
            v = col.values[i]
            if v is None:
                h[i] = 0
                continue
            if isinstance(v, str):
                b = v.encode("utf-8")
            elif isinstance(v, bytes):
                b = v
            else:
                b = repr(v).encode("utf-8")
            acc = FNV_OFFSET
            with np.errstate(over="ignore"):
                for byte in b:
                    acc = (acc ^ np.uint64(byte)) * FNV_PRIME
            h[i] = acc
    # null → fixed sentinel hash
    null_h = np.uint64(0x9E3779B97F4A7C15)
    return _avoid_device_sentinel(np.where(col.validity, h, null_h))


# int64 max is the device state's EMPTY_KEY padding sentinel
# (device/sorted_state.py): a hash landing there would be silently treated
# as padding (masked from reduce, dropped by merge, filtered from the
# all-to-all receive mask). Every host->device key projection remaps it.
_DEVICE_EMPTY = np.uint64(0x7FFFFFFFFFFFFFFF)


def _avoid_device_sentinel(h: np.ndarray) -> np.ndarray:
    return np.where(h == _DEVICE_EMPTY, _DEVICE_EMPTY - np.uint64(1), h)


def hash_columns64(cols: Sequence[Column]) -> np.ndarray:
    """Combine per-column hash64s into one 64-bit key hash (boost-style mix)."""
    assert cols
    h = column_hash64(cols[0])
    with np.errstate(over="ignore"):
        for c in cols[1:]:
            h2 = column_hash64(c)
            h = h ^ (h2 + np.uint64(0x9E3779B97F4A7C15)
                     + (h << np.uint64(6)) + (h >> np.uint64(2)))
    return _avoid_device_sentinel(h)


def compute_vnodes(key_cols: Sequence[Column], n: Optional[int] = None,
                   vnode_count: int = VNODE_COUNT) -> np.ndarray:
    """Per-row vnode for a chunk's distribution-key columns
    (`VirtualNode::compute_chunk`, vnode.rs:151 upstream).

    Contract: CRC32 over the concatenated big-endian key serialization
    (nulls contribute a sentinel), mod vnode_count. All shards/processes must
    agree on this function — it defines the state layout.
    """
    if not key_cols:
        # Singleton distribution: everything on vnode 0.
        assert n is not None
        return np.zeros(n, dtype=np.int32)
    n = len(key_cols[0])
    # fast path: a single non-null integral key -> the C++ host kernel
    if len(key_cols) == 1:
        col = key_cols[0]
        if (col.dtype.is_fixed_width and col.validity.all()
                and col.dtype.kind not in (TypeKind.BOOLEAN, TypeKind.FLOAT32,
                                           TypeKind.FLOAT64)):
            return native.vnodes_i64(col.values, vnode_count)
    crc = None
    for col in key_cols:
        if col.dtype.is_fixed_width:
            kind = col.dtype.kind
            if kind == TypeKind.BOOLEAN:
                data = col.values.astype(np.uint8).reshape(n, 1)
            elif kind in (TypeKind.FLOAT32, TypeKind.FLOAT64):
                v = col.values.astype(np.float64, copy=True)
                v[v == 0.0] = 0.0
                data = _int_key_bytes(v.view(np.int64))
            else:
                data = _int_key_bytes(col.values)
            # null handling: splice in sentinel bytes per-row where invalid
            if not col.validity.all():
                crc_part_valid = crc32_bytes_matrix(data, init=crc)
                sent = np.frombuffer(_NULL_SENTINEL_BYTES, dtype=np.uint8)
                sent_mat = np.broadcast_to(sent, (n, len(sent))).copy()
                crc_part_null = crc32_bytes_matrix(sent_mat, init=crc)
                crc = np.where(col.validity, crc_part_valid, crc_part_null)
            else:
                crc = crc32_bytes_matrix(data, init=crc)
        else:
            out = np.empty(n, dtype=np.uint32)
            for i in range(n):
                v = col.values[i]
                if not col.validity[i]:
                    b = _NULL_SENTINEL_BYTES
                elif isinstance(v, str):
                    b = v.encode("utf-8")
                elif isinstance(v, bytes):
                    b = v
                else:
                    b = repr(v).encode("utf-8")
                # zlib.crc32(data, prev) chains CRCs exactly like our
                # table-driven matrix version with init=prev.
                out[i] = zlib.crc32(b, int(crc[i])) if crc is not None else zlib.crc32(b)
            crc = out.astype(np.uint32)
    return (crc % np.uint32(vnode_count)).astype(np.int32)


def vnode_of_row(key: Sequence, vnode_count: int = VNODE_COUNT) -> int:
    """Single-row vnode (must agree with compute_vnodes)."""
    crc = 0
    started = False
    for v in key:
        if v is None:
            b = _NULL_SENTINEL_BYTES
        elif isinstance(v, bool):
            b = bytes([int(v)])
        elif isinstance(v, (int, np.integer)):
            b = int(v).to_bytes(8, "big", signed=True)
        elif isinstance(v, (float, np.floating)):
            fv = 0.0 if v == 0.0 else float(v)
            b = np.array([fv]).view(np.int64)[0].item().to_bytes(8, "big", signed=True)
        elif isinstance(v, str):
            b = v.encode("utf-8")
        elif isinstance(v, bytes):
            b = v
        else:
            b = repr(v).encode("utf-8")
        crc = zlib.crc32(b, crc) if started else zlib.crc32(b)
        started = True
    return crc % vnode_count


def bucket_parity(buckets: int, vnode_count: int = VNODE_COUNT):
    """The bucket `vnode(key) * buckets // vnode_count` of an int64 key as
    parities: bit j is `popcount(key & masks[j]) % 2 ^ (flip >> j) & 1`.

    The CRC of a fixed-length message is affine over GF(2): crc(a ^ b) =
    crc(a) ^ crc(b) ^ crc(0). With both counts powers of two, the bucket
    is bits log2(vnode_count / buckets) .. log2(vnode_count) - 1 of the
    CRC, so bit j of mask j's key bit i is that bucket bit of
    crc(1 << i) ^ crc(0), and `flip` is the bucket of key 0. Derived from
    `native.vnodes_i64` -> (masks, flip)."""
    shift = (vnode_count // buckets).bit_length() - 1
    if buckets << shift != vnode_count or buckets & (buckets - 1):
        raise ValueError("bucket_parity: counts must be powers of two")
    keys = np.array([0] + [1 << i for i in range(63)] + [-(1 << 63)],
                    np.int64)
    b = native.vnodes_i64(keys, vnode_count).astype(np.int64) >> shift
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
