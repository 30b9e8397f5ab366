"""Columnar chunks — the unit of dataflow (the port's own copy of the JAX
package's `core/chunk.py`).

Re-design of the reference's array/chunk layer
(`src/common/src/array/data_chunk.rs:66` `DataChunk`,
`src/common/src/array/stream_chunk.rs:106` `StreamChunk`, `:45` `Op`).

* One generic `Column` (numpy values + numpy validity) instead of 20 typed
  array impls — numpy gives vectorized kernels on the host, and the
  device path only needs the fixed-width subset.
* `DeviceChunk` is the torch projection of a chunk: fixed-width columns
  padded to a static capacity, with a row mask in place of the visibility
  bitmap, on an explicit device (`cuda:0` unless the caller asks for the
  CPU). String/decimal columns enter the device as stable 64-bit hashes
  (sufficient for group keys / join keys; exact values round-trip on
  the host).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .dtypes import DataType, TypeKind, VARCHAR


class Op(enum.IntEnum):
    """Row operation tag (`src/common/src/array/stream_chunk.rs:45`)."""
    INSERT = 0
    DELETE = 1
    UPDATE_DELETE = 2
    UPDATE_INSERT = 3

    @property
    def is_insert(self) -> bool:
        return self in (Op.INSERT, Op.UPDATE_INSERT)

    @property
    def is_delete(self) -> bool:
        return self in (Op.DELETE, Op.UPDATE_DELETE)

    @property
    def sign(self) -> int:
        """+1 for inserts, -1 for deletes — the retraction algebra."""
        return 1 if self.is_insert else -1


def _sign_of_ops(ops: np.ndarray) -> np.ndarray:
    """Vectorized Op.sign: +1 insert-like, -1 delete-like."""
    return np.where((ops == Op.INSERT) | (ops == Op.UPDATE_INSERT), 1, -1).astype(np.int32)


class Column:
    """A column: values array + validity mask (True = non-null).

    Object-dtype columns (varchar/decimal/...) store Python scalars; nulls are
    None in `values` AND False in `validity` (both maintained to keep host
    kernels simple).
    """

    __slots__ = ("dtype", "values", "validity")

    def __init__(self, dtype: DataType, values: np.ndarray,
                 validity: Optional[np.ndarray] = None):
        values = np.asarray(values, dtype=dtype.np_dtype)
        if validity is None:
            if dtype.np_dtype == np.dtype(object):
                validity = np.array([v is not None for v in values], dtype=np.bool_)
            else:
                validity = np.ones(len(values), dtype=np.bool_)
        self.dtype = dtype
        self.values = values
        self.validity = np.asarray(validity, dtype=np.bool_)
        assert len(self.values) == len(self.validity)

    # ---- constructors ----
    @classmethod
    def from_list(cls, dtype: DataType, items: Sequence[Any]) -> "Column":
        validity = np.array([x is not None for x in items], dtype=np.bool_)
        if dtype.np_dtype == np.dtype(object):
            values = np.empty(len(items), dtype=object)
            for i, x in enumerate(items):
                values[i] = x
        else:
            # fill nulls with 0 to keep fixed-width arrays dense
            fill = False if dtype.kind == TypeKind.BOOLEAN else 0
            values = np.array([fill if x is None else x for x in items],
                              dtype=dtype.np_dtype)
        return cls(dtype, values, validity)

    # ---- basics ----
    def __len__(self) -> int:
        return len(self.values)

    def get(self, i: int) -> Any:
        if not self.validity[i]:
            return None
        v = self.values[i]
        if self.dtype.np_dtype == np.dtype(object):
            return v
        return v.item() if isinstance(v, np.generic) else v

    def to_list(self) -> List[Any]:
        if self.dtype.np_dtype == np.dtype(object):
            out = list(self.values)
        else:
            out = self.values.tolist()   # C-speed scalar conversion
        if not self.validity.all():
            for i in np.flatnonzero(~self.validity).tolist():
                out[i] = None
        return out

    def take(self, indices: np.ndarray) -> "Column":
        return Column(self.dtype, self.values[indices], self.validity[indices])

    def filter(self, mask: np.ndarray) -> "Column":
        return Column(self.dtype, self.values[mask], self.validity[mask])

    def concat(self, other: "Column") -> "Column":
        return Column(self.dtype,
                      np.concatenate([self.values, other.values]),
                      np.concatenate([self.validity, other.validity]))

    def hash64(self) -> np.ndarray:
        """Stable per-row 64-bit hash, null-aware. Used for device-side keys of
        host-only types and for multi-column key compression."""
        from . import vnode as _vnode
        return _vnode.column_hash64(self)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Column({self.dtype}, n={len(self)})"


class DataChunk:
    """A batch of columns + optional row visibility
    (`src/common/src/array/data_chunk.rs:66`)."""

    __slots__ = ("columns", "visibility")

    def __init__(self, columns: Sequence[Column],
                 visibility: Optional[np.ndarray] = None):
        self.columns: List[Column] = list(columns)
        n = len(self.columns[0]) if self.columns else 0
        for c in self.columns:
            assert len(c) == n, "ragged chunk"
        self.visibility = (np.asarray(visibility, dtype=np.bool_)
                           if visibility is not None else None)
        if self.visibility is not None:
            assert len(self.visibility) == n

    # ---- constructors ----
    @classmethod
    def from_rows(cls, dtypes: Sequence[DataType],
                  rows: Iterable[Sequence[Any]]) -> "DataChunk":
        rows = list(rows)
        cols = []
        for j, dt in enumerate(dtypes):
            cols.append(Column.from_list(dt, [r[j] for r in rows]))
        return cls(cols)

    # ---- basics ----
    @property
    def capacity(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def __len__(self) -> int:
        return self.capacity

    @property
    def cardinality(self) -> int:
        """Number of visible rows."""
        if self.visibility is None:
            return self.capacity
        return int(self.visibility.sum())

    def vis_mask(self) -> np.ndarray:
        if self.visibility is None:
            return np.ones(self.capacity, dtype=np.bool_)
        return self.visibility

    def row_at(self, i: int) -> Tuple[Any, ...]:
        return tuple(c.get(i) for c in self.columns)

    def rows(self) -> List[Tuple[Any, ...]]:
        """Visible rows as tuples (columns convert in bulk, then one zip)."""
        out = list(zip(*(c.to_list() for c in self.columns))) \
            if self.columns else []
        mask = self.vis_mask()
        if not mask.all():
            out = [r for r, ok in zip(out, mask.tolist()) if ok]
        return out

    def compact(self) -> "DataChunk":
        """Drop invisible rows (`DataChunk::compact` in the reference)."""
        if self.visibility is None:
            return self
        mask = self.visibility
        return DataChunk([c.filter(mask) for c in self.columns])

    def project(self, indices: Sequence[int]) -> "DataChunk":
        return DataChunk([self.columns[i] for i in indices], self.visibility)

    def with_visibility(self, mask: np.ndarray) -> "DataChunk":
        base = self.vis_mask() & np.asarray(mask, dtype=np.bool_)
        return DataChunk(self.columns, base)

    @property
    def dtypes(self) -> List[DataType]:
        return [c.dtype for c in self.columns]

    def __repr__(self) -> str:  # pragma: no cover
        return f"DataChunk(cols={len(self.columns)}, rows={self.cardinality}/{self.capacity})"


class StreamChunk(DataChunk):
    """DataChunk + per-row Op tags (`src/common/src/array/stream_chunk.rs:106`)."""

    __slots__ = ("ops",)

    def __init__(self, ops: np.ndarray, columns: Sequence[Column],
                 visibility: Optional[np.ndarray] = None):
        super().__init__(columns, visibility)
        self.ops = np.asarray(ops, dtype=np.int8)
        assert len(self.ops) == self.capacity

    # ---- constructors ----
    @classmethod
    def from_rows(cls, dtypes: Sequence[DataType],
                  op_rows: Iterable[Tuple[Op, Sequence[Any]]]) -> "StreamChunk":
        op_rows = list(op_rows)
        ops = np.array([int(op) for op, _ in op_rows], dtype=np.int8)
        cols = [Column.from_list(dt, [r[j] for _, r in op_rows])
                for j, dt in enumerate(dtypes)]
        return cls(ops, cols)

    @classmethod
    def all_inserts(cls, chunk: DataChunk) -> "StreamChunk":
        ops = np.full(chunk.capacity, int(Op.INSERT), dtype=np.int8)
        return cls(ops, chunk.columns, chunk.visibility)

    # ---- basics ----
    def data_chunk(self) -> DataChunk:
        return DataChunk(self.columns, self.visibility)

    def signs(self) -> np.ndarray:
        """Vectorized retraction signs (+1/-1) for visible-row math."""
        return _sign_of_ops(self.ops)

    def compact(self) -> "StreamChunk":
        if self.visibility is None:
            return self
        mask = self.visibility
        return StreamChunk(self.ops[mask], [c.filter(mask) for c in self.columns])

    def project(self, indices: Sequence[int]) -> "StreamChunk":
        return StreamChunk(self.ops, [self.columns[i] for i in indices],
                           self.visibility)

    def with_visibility(self, mask: np.ndarray) -> "StreamChunk":
        base = self.vis_mask() & np.asarray(mask, dtype=np.bool_)
        return StreamChunk(self.ops, self.columns, base)

    def op_rows(self) -> List[Tuple[Op, Tuple[Any, ...]]]:
        mask = self.vis_mask()
        return [(Op(int(self.ops[i])), self.row_at(i))
                for i in range(self.capacity) if mask[i]]

    def concat(self, other: "StreamChunk") -> "StreamChunk":
        a, b = self.compact(), other.compact()
        return StreamChunk(
            np.concatenate([a.ops, b.ops]),
            [ca.concat(cb) for ca, cb in zip(a.columns, b.columns)])

    def __repr__(self) -> str:  # pragma: no cover
        return f"StreamChunk(cols={len(self.columns)}, rows={self.cardinality}/{self.capacity})"


class StreamChunkBuilder:
    """Row-appending builder with max chunk size
    (`src/common/src/array/stream_chunk_builder.rs`)."""

    def __init__(self, dtypes: Sequence[DataType], max_chunk_size: int = 1024):
        self.dtypes = list(dtypes)
        self.max_chunk_size = max_chunk_size
        self._ops: List[int] = []
        self._rows: List[Sequence[Any]] = []
        self._pending: List[StreamChunk] = []

    def append_row(self, op: Op, row: Sequence[Any]) -> None:
        self._ops.append(int(op))
        self._rows.append(row)
        # Keep U-/U+ pairs in one chunk: never split right after UPDATE_DELETE.
        if (len(self._rows) >= self.max_chunk_size
                and op != Op.UPDATE_DELETE):
            self._flush()

    def append_update(self, old_row: Sequence[Any],
                      new_row: Sequence[Any]) -> None:
        self.append_row(Op.UPDATE_DELETE, old_row)
        self.append_row(Op.UPDATE_INSERT, new_row)

    def __len__(self) -> int:
        return len(self._rows)

    def _flush(self) -> None:
        if not self._rows:
            return
        ops = np.array(self._ops, dtype=np.int8)
        cols = [Column.from_list(dt, [r[j] for r in self._rows])
                for j, dt in enumerate(self.dtypes)]
        self._ops, self._rows = [], []
        self._pending.append(StreamChunk(ops, cols))

    def drain(self) -> List[StreamChunk]:
        """All completed chunks + the current buffer; resets the builder."""
        self._flush()
        out, self._pending = self._pending, []
        return out

    def take(self) -> Optional[StreamChunk]:
        """Single-chunk convenience: concatenation of everything appended.
        Use `drain()` on paths that may exceed max_chunk_size."""
        chunks = self.drain()
        if not chunks:
            return None
        out = chunks[0]
        for c in chunks[1:]:
            out = out.concat(c)
        return out


# ---------------------------------------------------------------------------
# Device projection
# ---------------------------------------------------------------------------

@dataclass
class DeviceChunk:
    """The device projection of a StreamChunk: static-capacity padded
    columns + row mask + retraction signs, as torch tensors on one device.

    `cols[i]` is the tensor of column i if it is fixed-width, else its
    64-bit hash projection. Shapes are `(capacity,)` with `mask` False
    past `n_rows` (and for invisible rows).
    """
    cols: List[Any]          # torch tensors
    mask: Any                # bool (capacity,)
    signs: Any               # int32 (capacity,) +1/-1
    capacity: int
    n_rows: int


def _pad_to(arr: np.ndarray, capacity: int, fill=0) -> np.ndarray:
    if len(arr) == capacity:
        return arr
    out = np.full(capacity, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def to_device_chunk(chunk: StreamChunk, capacity: Optional[int] = None,
                    columns: Optional[Sequence[int]] = None,
                    device=None) -> DeviceChunk:
    """Project a StreamChunk onto `device` (`cuda:0` by default) with a
    static capacity.

    capacity defaults to the next power of two >= len(chunk), as in the
    JAX package (there it bounds the number of compiled program shapes).
    """
    import torch
    from ..device import resolve_device

    dev = resolve_device(device)
    n = chunk.capacity
    if capacity is None:
        capacity = max(16, 1 << (n - 1).bit_length()) if n else 16
    assert capacity >= n
    idxs = range(len(chunk.columns)) if columns is None else columns

    def put(a: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cols = []
    for i in idxs:
        c = chunk.columns[i]
        if c.dtype.is_fixed_width:
            vals = c.values.astype(c.dtype.device_dtype, copy=False)
        else:
            # uint64 hashes carried as their int64 bit pattern
            vals = c.hash64().view(np.int64)
        cols.append(put(_pad_to(vals, capacity)))
    mask = _pad_to(chunk.vis_mask(), capacity, fill=False)
    signs = _pad_to(chunk.signs(), capacity, fill=0)
    return DeviceChunk(cols=cols, mask=put(mask), signs=put(signs),
                       capacity=capacity, n_rows=n)
