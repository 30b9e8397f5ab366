"""Key / value encodings for state and checkpoints.

Re-design of the reference's two encodings:

* memcomparable key encoding (`src/common/src/util/memcmp_encoding.rs:38`):
  byte strings whose lexicographic order equals the row order — used for state
  table primary keys and range scans, including DESC columns and null
  ordering.
* value encoding (`src/common/src/util/value_encoding/mod.rs:57`): compact
  non-ordered serialization for row payloads in checkpoints.

Host-side only (checkpoint/restore and ordered iteration are host concerns);
the device path never sees encoded bytes.
"""
from __future__ import annotations

import struct
from decimal import Decimal
from typing import Any, List, Optional, Sequence, Tuple

from .dtypes import DataType, Interval, TypeKind

# ---------------------------------------------------------------------------
# Memcomparable encoding
# ---------------------------------------------------------------------------
# Format per datum: 1 tag byte (null ordering) + payload.
#   ASC:  null tag 0x00 (nulls first... reference uses NULLS LAST default for
#         ASC in storage: tag 0x01 for non-null, 0x02 for null) — we follow
#         "non-null < null" = NULLS LAST for ASC, matching RW's default
#         `OrderType::ascending()` (nulls last).
# DESC is handled by bit-flipping the whole datum encoding.

_NONNULL_TAG = b"\x01"
_NULL_TAG = b"\x02"  # sorts after non-null => NULLS LAST under ASC


def _enc_uint_like(v: int, width: int) -> bytes:
    return v.to_bytes(width, "big", signed=False)


def _flip_sign_int(v: int, width: int) -> bytes:
    # two's complement with sign bit flipped orders correctly unsigned
    u = (v + (1 << (8 * width))) % (1 << (8 * width))
    u ^= 1 << (8 * width - 1)
    return _enc_uint_like(u, width)


def _enc_float(v: float) -> bytes:
    bits = struct.unpack(">Q", struct.pack(">d", float(v)))[0]
    if bits & (1 << 63):
        bits = ~bits & ((1 << 64) - 1)   # negative: flip all
    else:
        bits |= 1 << 63                   # positive: flip sign
    return _enc_uint_like(bits, 8)


def _enc_bytes_escaped(b: bytes) -> bytes:
    # escape 0x00 so shorter prefixes sort first and terminator is unambiguous
    return b.replace(b"\x00", b"\x00\xff") + b"\x00\x00"


def encode_datum_memcomparable(v: Any, dtype: DataType, desc: bool = False,
                               nulls_first: Optional[bool] = None) -> bytes:
    """Encode one datum; lexicographic byte order == SQL ORDER BY order.
    Default null ordering follows RW: ASC => nulls last, DESC => nulls first.
    """
    if nulls_first is None:
        nulls_first = desc
    if v is None:
        out = (b"\x00" if nulls_first else _NULL_TAG)
        payload = out
    else:
        kind = dtype.kind
        if kind == TypeKind.BOOLEAN:
            body = b"\x01" if v else b"\x00"
        elif kind in (TypeKind.INT16,):
            body = _flip_sign_int(int(v), 2)
        elif kind in (TypeKind.INT32, TypeKind.DATE):
            body = _flip_sign_int(int(v), 4)
        elif kind in (TypeKind.INT64, TypeKind.TIME, TypeKind.TIMESTAMP,
                      TypeKind.TIMESTAMPTZ, TypeKind.SERIAL):
            body = _flip_sign_int(int(v), 8)
        elif kind in (TypeKind.FLOAT32, TypeKind.FLOAT64):
            body = _enc_float(float(v))
        elif kind == TypeKind.DECIMAL:
            # order-preserving: encode as (sign-adjusted) scaled float prefix +
            # exact text for tiebreak. Sufficient for ordering Nexmark-scale
            # decimals; TODO exact decimal memcomparable like memcmp_encoding.rs
            d = Decimal(v)
            body = _enc_float(float(d)) + _enc_bytes_escaped(str(d.normalize()).encode())
        elif kind == TypeKind.VARCHAR:
            body = _enc_bytes_escaped(str(v).encode("utf-8"))
        elif kind == TypeKind.BYTEA:
            body = _enc_bytes_escaped(bytes(v))
        elif kind == TypeKind.INTERVAL:
            iv: Interval = v
            body = _flip_sign_int(iv.total_usecs_approx(), 16)
        else:
            raise NotImplementedError(f"memcomparable for {dtype}")
        payload = _NONNULL_TAG + body
    if desc:
        payload = bytes(0xFF - b for b in payload)
    return payload


def encode_key(row: Sequence[Any], dtypes: Sequence[DataType],
               order: Optional[Sequence[bool]] = None) -> bytes:
    """Encode a pk row; order[i]=True means DESC for column i."""
    out = bytearray()
    for i, (v, dt) in enumerate(zip(row, dtypes)):
        desc = bool(order[i]) if order is not None else False
        out += encode_datum_memcomparable(v, dt, desc=desc)
    return bytes(out)


# fixed-width memcomparable kinds: payload bytes per non-null datum
_FIXED_KEY_WIDTH = {
    TypeKind.BOOLEAN: 1,
    TypeKind.INT16: 2,
    TypeKind.INT32: 4, TypeKind.DATE: 4,
    TypeKind.INT64: 8, TypeKind.TIME: 8, TypeKind.TIMESTAMP: 8,
    TypeKind.TIMESTAMPTZ: 8, TypeKind.SERIAL: 8,
    TypeKind.FLOAT32: 8, TypeKind.FLOAT64: 8,   # both encode as f64 bits
}


def encode_key_matrix(cols: Sequence, dtypes: Sequence[DataType],
                      order: Optional[Sequence[bool]] = None):
    """Vectorized `encode_key` over whole columns.

    Returns an (n, W) uint8 matrix whose rows are byte-for-byte identical
    to `encode_key` of the corresponding row — or None when a column kind
    is not fixed-width or any datum is NULL (those batches take the exact
    per-row path). The bulk write path (`StateTable.write_chunk`) depends
    on the byte-for-byte contract: point lookups re-encode per-row.
    """
    import numpy as np
    if not cols:
        return None
    n = len(cols[0])
    widths = []
    for c, dt in zip(cols, dtypes):
        w = _FIXED_KEY_WIDTH.get(dt.kind)
        if w is None or not c.validity.all():
            return None
        widths.append(w)
    total = sum(w + 1 for w in widths)
    mat = np.empty((n, total), dtype=np.uint8)
    off = 0
    for i, (c, dt, w) in enumerate(zip(cols, dtypes, widths)):
        mat[:, off] = _NONNULL_TAG[0]
        kind = dt.kind
        if kind == TypeKind.BOOLEAN:
            body = c.values.astype(np.uint8).reshape(n, 1)
        elif kind in (TypeKind.FLOAT32, TypeKind.FLOAT64):
            bits = np.ascontiguousarray(
                c.values.astype(np.float64)).view(np.uint64)
            neg = (bits >> np.uint64(63)).astype(bool)
            bits = np.where(neg, ~bits, bits | np.uint64(1 << 63))
            body = bits.astype(">u8").view(np.uint8).reshape(n, 8)
        else:
            v = c.values.astype(np.int64, copy=False)
            if w == 8:
                u = (v ^ np.int64(-2**63)).view(np.uint64)
                body = u.astype(">u8").view(np.uint8).reshape(n, 8)
            else:
                mask_w = np.int64((1 << (8 * w)) - 1)
                u = (v & mask_w) ^ np.int64(1 << (8 * w - 1))
                body = u.astype(f">u{w}").view(np.uint8).reshape(n, w)
        mat[:, off + 1: off + 1 + w] = body
        if order is not None and order[i]:
            mat[:, off: off + 1 + w] = \
                np.uint8(0xFF) - mat[:, off: off + 1 + w]
        off += 1 + w
    return mat


# ---------------------------------------------------------------------------
# Value encoding (compact, non-ordered) — checkpoint row payloads
# ---------------------------------------------------------------------------

def encode_value_datum(v: Any, dtype: DataType) -> bytes:
    if v is None:
        return b"\x00"
    kind = dtype.kind
    if kind == TypeKind.BOOLEAN:
        body = b"\x01" if v else b"\x00"
    elif kind in (TypeKind.INT16,):
        body = struct.pack("<h", int(v))
    elif kind in (TypeKind.INT32, TypeKind.DATE):
        body = struct.pack("<i", int(v))
    elif kind in (TypeKind.INT64, TypeKind.TIME, TypeKind.TIMESTAMP,
                  TypeKind.TIMESTAMPTZ, TypeKind.SERIAL):
        body = struct.pack("<q", int(v))
    elif kind == TypeKind.FLOAT32:
        body = struct.pack("<f", float(v))
    elif kind == TypeKind.FLOAT64:
        body = struct.pack("<d", float(v))
    elif kind == TypeKind.DECIMAL:
        s = str(v)
        body = struct.pack("<I", len(s)) + s.encode()
    elif kind == TypeKind.VARCHAR:
        b = str(v).encode("utf-8")
        body = struct.pack("<I", len(b)) + b
    elif kind in (TypeKind.BYTEA, TypeKind.JSONB):
        b = bytes(v) if kind == TypeKind.BYTEA else str(v).encode()
        body = struct.pack("<I", len(b)) + b
    elif kind == TypeKind.INTERVAL:
        iv: Interval = v
        body = struct.pack("<iiq", iv.months, iv.days, iv.usecs)
    else:
        raise NotImplementedError(f"value encoding for {dtype}")
    return b"\x01" + body


def decode_value_datum(buf: bytes, pos: int, dtype: DataType) -> Tuple[Any, int]:
    tag = buf[pos]
    pos += 1
    if tag == 0:
        return None, pos
    kind = dtype.kind
    if kind == TypeKind.BOOLEAN:
        return buf[pos] == 1, pos + 1
    if kind == TypeKind.INT16:
        return struct.unpack_from("<h", buf, pos)[0], pos + 2
    if kind in (TypeKind.INT32, TypeKind.DATE):
        return struct.unpack_from("<i", buf, pos)[0], pos + 4
    if kind in (TypeKind.INT64, TypeKind.TIME, TypeKind.TIMESTAMP,
                TypeKind.TIMESTAMPTZ, TypeKind.SERIAL):
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if kind == TypeKind.FLOAT32:
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if kind == TypeKind.FLOAT64:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if kind == TypeKind.DECIMAL:
        ln = struct.unpack_from("<I", buf, pos)[0]
        s = buf[pos + 4: pos + 4 + ln].decode()
        return Decimal(s), pos + 4 + ln
    if kind == TypeKind.VARCHAR:
        ln = struct.unpack_from("<I", buf, pos)[0]
        return buf[pos + 4: pos + 4 + ln].decode("utf-8"), pos + 4 + ln
    if kind in (TypeKind.BYTEA, TypeKind.JSONB):
        ln = struct.unpack_from("<I", buf, pos)[0]
        raw = buf[pos + 4: pos + 4 + ln]
        return (bytes(raw) if kind == TypeKind.BYTEA else raw.decode()), pos + 4 + ln
    if kind == TypeKind.INTERVAL:
        months, days, usecs = struct.unpack_from("<iiq", buf, pos)
        return Interval(months, days, usecs), pos + 16
    raise NotImplementedError(f"value decoding for {dtype}")


def encode_row(row: Sequence[Any], dtypes: Sequence[DataType]) -> bytes:
    out = bytearray()
    for v, dt in zip(row, dtypes):
        out += encode_value_datum(v, dt)
    return bytes(out)


def decode_row(buf: bytes, dtypes: Sequence[DataType]) -> Tuple[Any, ...]:
    pos = 0
    out: List[Any] = []
    for dt in dtypes:
        v, pos = decode_value_datum(buf, pos, dt)
        out.append(v)
    return tuple(out)


class SortKey:
    """Python-comparable wrapper for ordered in-memory state iteration —
    delegates to the memcomparable encoding so in-memory order and on-disk
    order always agree."""

    __slots__ = ("enc",)

    def __init__(self, row: Sequence[Any], dtypes: Sequence[DataType],
                 order: Optional[Sequence[bool]] = None):
        self.enc = encode_key(row, dtypes, order)

    def __lt__(self, other: "SortKey") -> bool:
        return self.enc < other.enc

    def __eq__(self, other: object) -> bool:
        return isinstance(other, SortKey) and self.enc == other.enc

    def __hash__(self) -> int:
        return hash(self.enc)
