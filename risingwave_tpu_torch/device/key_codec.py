"""Group/join key <-> int64 device key codecs.

The device state (`sorted_state.py`, `join_step.py`) keys everything on one
int64. The reference never keys state on a lossy projection — `HashKey`
serializes the actual key bytes (`src/common/src/hash/key_v2.rs:221`). The
device analog (the port's own copy of the JAX package's
`device/key_codec.py`):

* `PackCodec` — LOSSLESS bit-packing for narrow key tuples (null bit +
  value bits per column, total <= 63 bits). Encode and decode are fully
  vectorized; no host-side state.
* `DictCodec` — 64-bit hash projection (`core/vnode.hash_columns64`) plus a
  host dictionary mapping hash -> actual key tuple. The dictionary makes the
  projection exact: decode is a lookup, and a birthday collision (two
  distinct tuples with one hash, ~2^-64 per pair) is DETECTED at observe
  time and raised instead of silently merging groups.

`make_codec(dtypes)` picks PackCodec when the tuple fits, else DictCodec —
so int-keyed fragments pay no host dictionary at all.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.chunk import Column
from ..core.dtypes import DataType, TypeKind
from ..core.vnode import hash_columns64

# value-bit width per packable kind (see core/dtypes.py host representations;
# all are integral on host). Floats are excluded (NaN/-0.0 bit-pattern
# aliasing) and 64-bit kinds can't fit beside their null bit.
_PACK_BITS = {
    TypeKind.BOOLEAN: 1,
    TypeKind.INT16: 16,
    TypeKind.INT32: 32,
    TypeKind.DATE: 32,
}


class KeyCollisionError(RuntimeError):
    """Two distinct key tuples hashed to the same 64-bit device key."""


def _tuple_eq(a: Tuple, b: Tuple) -> bool:
    """NaN-aware tuple equality: SQL grouping treats NaN = NaN (and 0.0 =
    -0.0, which Python == already gives)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x == y:
            continue
        if isinstance(x, float) and isinstance(y, float) \
                and x != x and y != y:   # both NaN
            continue
        return False
    return True


class PackCodec:
    """Lossless <=63-bit packing: per column [null bit][value bits].

    Never emits the EMPTY_KEY sentinel (int64 max = 63 low bits all ones):
    that pattern would require some field's null bit AND all its value bits
    set simultaneously, but encode zeroes the value bits of null fields.
    """

    def __init__(self, dtypes: Sequence[DataType]):
        self.dtypes = list(dtypes)
        self.bits = [_PACK_BITS[d.kind] for d in dtypes]
        assert sum(b + 1 for b in self.bits) <= 63

    def encode_columns(self, cols: Sequence[Column]) -> np.ndarray:
        n = len(cols[0])
        out = np.zeros(n, dtype=np.uint64)
        for col, b in zip(cols, self.bits):
            mask = np.uint64((1 << b) - 1)
            v = col.values.astype(np.int64, copy=False).astype(np.uint64) & mask
            v = np.where(col.validity, v, np.uint64(0))
            nullbit = (~col.validity).astype(np.uint64)
            out = (out << np.uint64(b + 1)) | (nullbit << np.uint64(b)) | v
        return out.view(np.int64)

    def encode_rows(self, rows: Sequence[Tuple]) -> np.ndarray:
        cols = [Column.from_list(d, [r[i] for r in rows])
                for i, d in enumerate(self.dtypes)]
        return self.encode_columns(cols)

    def decode_columns(self, keys: np.ndarray) -> List[Column]:
        """Vectorized unpack into typed columns (no per-row Python)."""
        k = np.asarray(keys, dtype=np.int64).view(np.uint64)
        out: List[Column] = []
        for dt, b in zip(reversed(self.dtypes), reversed(self.bits)):
            mask = np.uint64((1 << b) - 1)
            v = (k & mask).astype(np.uint64)
            isnull = ((k >> np.uint64(b)) & np.uint64(1)).astype(bool)
            k = k >> np.uint64(b + 1)
            if dt.kind == TypeKind.BOOLEAN:
                vals = v.astype(bool)
            else:
                # sign-extend two's complement of width b
                sign = np.uint64(1 << (b - 1))
                vals = (v.astype(np.int64)
                        - ((v & sign).astype(np.int64) << np.int64(1)))
                vals = vals.astype(dt.np_dtype)
            out.append(Column(dt, vals, ~isnull))
        out.reverse()
        return out

    def decode(self, keys: np.ndarray) -> List[Tuple]:
        """Unpack back to host key tuples."""
        cols = self.decode_columns(keys)
        parts = [[None if not ok else v for v, ok in
                  zip(c.values.tolist(), c.validity.tolist())] for c in cols]
        return list(zip(*parts))

    def observe_columns(self, keys: np.ndarray, cols: Sequence[Column]) -> None:
        pass  # stateless

    def observe_rows(self, keys: np.ndarray, rows: Sequence[Tuple]) -> None:
        pass

    def forget(self, keys: np.ndarray) -> None:
        pass


class DictCodec:
    """hash64 projection + host decode dictionary with collision detection."""

    def __init__(self, dtypes: Sequence[DataType]):
        self.dtypes = list(dtypes)
        self._decode: Dict[int, Tuple] = {}

    def encode_columns(self, cols: Sequence[Column]) -> np.ndarray:
        return hash_columns64(cols).view(np.int64)

    def encode_rows(self, rows: Sequence[Tuple]) -> np.ndarray:
        cols = [Column.from_list(d, [r[i] for r in rows])
                for i, d in enumerate(self.dtypes)]
        return self.encode_columns(cols)

    def observe_columns(self, keys: np.ndarray, cols: Sequence[Column]) -> None:
        """Record key -> tuple for the UNIQUE keys of a batch (vectorized
        unique; O(distinct) dict work, not O(rows))."""
        uniq, idx = np.unique(np.asarray(keys, np.int64), return_index=True)
        for h, i in zip(uniq.tolist(), idx.tolist()):
            t = tuple(c.get(i) for c in cols)
            old = self._decode.get(h)
            if old is None:
                self._decode[h] = t
            elif not _tuple_eq(old, t):
                raise KeyCollisionError(
                    f"64-bit key collision: {old!r} vs {t!r} (hash {h}); "
                    "re-plan this fragment on the exact host path")

    def observe_rows(self, keys: np.ndarray, rows: Sequence[Tuple]) -> None:
        for h, r in zip(np.asarray(keys, np.int64).tolist(), rows):
            t = tuple(r)
            old = self._decode.get(h)
            if old is None:
                self._decode[h] = t
            elif not _tuple_eq(old, t):
                raise KeyCollisionError(
                    f"64-bit key collision: {old!r} vs {t!r} (hash {h})")

    def forget(self, keys: np.ndarray) -> None:
        """Drop decode entries for dead groups (bounds the dictionary to
        live keys; a returning key re-observes on its next row)."""
        for k in np.asarray(keys, np.int64).tolist():
            self._decode.pop(k, None)

    def decode(self, keys: np.ndarray) -> List[Tuple]:
        return [self._decode[k] for k in np.asarray(keys, np.int64).tolist()]

    def decode_columns(self, keys: np.ndarray) -> List[Column]:
        rows = self.decode(keys)
        return [Column.from_list(d, [r[i] for r in rows])
                for i, d in enumerate(self.dtypes)]


def make_codec(dtypes: Sequence[DataType]):
    """PackCodec when the tuple fits losslessly in 63 bits, else DictCodec."""
    if dtypes and all(d.kind in _PACK_BITS for d in dtypes) \
            and sum(_PACK_BITS[d.kind] + 1 for d in dtypes) <= 63:
        return PackCodec(dtypes)
    return DictCodec(dtypes)
