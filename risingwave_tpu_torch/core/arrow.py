"""Arrow interop: DataChunk/StreamChunk <-> pyarrow RecordBatch, and the
host->device seam (the port's own copy of the JAX package's
`core/arrow.py`).

Reference: `src/common/src/array/arrow/arrow_impl.rs:64` (ToArrow) and
`:472` (FromArrow) — the reference's external columnar boundary (UDFs,
Iceberg, connectors) is Arrow; this module is the same seam. Fixed-width
columns cross WITHOUT copying values (`pa.Array.from_buffers` over the
numpy buffer; only the validity bitmap is packed), and `to_torch` moves a
column into a device tensor from the shared numpy buffer
(`torch.from_numpy` shares it; `.to(device)` is the one copy, host to
device).

`pyarrow` is imported only when an Arrow function is called (`_pa`), so
the port's device path imports without it.
"""
from __future__ import annotations

from decimal import Decimal
from typing import Any, List, Optional, Tuple

import numpy as np

from . import dtypes as T
from .chunk import Column, DataChunk, Op, StreamChunk
from .dtypes import DataType, TypeKind
from .schema import Schema


def _pa():
    import pyarrow
    return pyarrow


# fixed-width kinds that cross zero-copy (value buffer shared)
_FIXED = {
    TypeKind.INT16: "int16", TypeKind.INT32: "int32",
    TypeKind.INT64: "int64", TypeKind.SERIAL: "int64",
    TypeKind.FLOAT32: "float32", TypeKind.FLOAT64: "float64",
}


def _arrow_type(dtype: DataType):
    pa = _pa()
    k = dtype.kind
    if k in _FIXED:
        return getattr(pa, _FIXED[k])()
    if k == TypeKind.BOOLEAN:
        return pa.bool_()
    if k == TypeKind.VARCHAR:
        return pa.string()
    if k == TypeKind.BYTEA:
        return pa.binary()
    if k == TypeKind.TIMESTAMP:
        return pa.timestamp("us")
    if k == TypeKind.TIMESTAMPTZ:
        return pa.timestamp("us", tz="UTC")
    if k == TypeKind.DATE:
        return pa.date32()
    if k == TypeKind.TIME:
        return pa.time64("us")
    if k == TypeKind.DECIMAL:
        # rw_int256-free subset: 38 digits, dynamic scale handled at
        # conversion (arrow_impl.rs maps Decimal -> Decimal128 likewise)
        return pa.decimal128(38, 9)
    if k == TypeKind.INTERVAL:
        return pa.month_day_nano_interval()
    raise ValueError(f"no arrow mapping for {dtype}")


def _validity_buffer(validity: np.ndarray):
    pa = _pa()
    if validity.all():
        return None
    return pa.py_buffer(np.packbits(validity, bitorder="little").tobytes())


def column_to_arrow(col: Column):
    """Column -> pa.Array; fixed-width value buffers are SHARED."""
    pa = _pa()
    k = col.dtype.kind
    if k in _FIXED:
        vals = np.ascontiguousarray(col.values)
        typ = _arrow_type(col.dtype)
        return pa.Array.from_buffers(
            typ, len(vals),
            [_validity_buffer(col.validity), pa.py_buffer(vals)],
            null_count=int((~col.validity).sum()))
    if k in (TypeKind.TIMESTAMP, TypeKind.TIMESTAMPTZ, TypeKind.TIME):
        vals = np.ascontiguousarray(col.values.astype(np.int64))
        return pa.Array.from_buffers(
            _arrow_type(col.dtype), len(vals),
            [_validity_buffer(col.validity), pa.py_buffer(vals)],
            null_count=int((~col.validity).sum()))
    if k == TypeKind.DATE:
        vals = np.ascontiguousarray(col.values.astype(np.int32))
        return pa.Array.from_buffers(
            _arrow_type(col.dtype), len(vals),
            [_validity_buffer(col.validity), pa.py_buffer(vals)],
            null_count=int((~col.validity).sum()))
    # variable width / object columns: element-wise conversion
    items = [col.get(i) for i in range(len(col))]
    if k == TypeKind.INTERVAL:
        pa_ = _pa()
        items = [None if v is None else
                 pa_.MonthDayNano([v.months, v.days, v.usecs * 1000])
                 for v in items]
        return pa_.array(items, type=_arrow_type(col.dtype))
    if k == TypeKind.DECIMAL:
        items = [None if v is None else Decimal(v) for v in items]
    return _pa().array(items, type=_arrow_type(col.dtype))


def column_from_arrow(arr, dtype: DataType) -> Column:
    """pa.Array -> Column; fixed-width value buffers are SHARED."""
    arr = arr.combine_chunks() if hasattr(arr, "combine_chunks") else arr
    k = dtype.kind
    n = len(arr)
    if k in _FIXED or k in (TypeKind.TIMESTAMP, TypeKind.TIMESTAMPTZ,
                            TypeKind.TIME, TypeKind.DATE):
        np_dt = {TypeKind.TIMESTAMP: np.int64, TypeKind.TIMESTAMPTZ: np.int64,
                 TypeKind.TIME: np.int64, TypeKind.DATE: np.int32}.get(
                     k, np.dtype(_FIXED.get(k, "int64")))
        buffers = arr.buffers()
        off = arr.offset
        vals = np.frombuffer(buffers[1], dtype=np_dt,
                             count=n + off)[off:]
        if buffers[0] is None:
            validity = np.ones(n, dtype=bool)
        else:
            bits = np.frombuffer(buffers[0], dtype=np.uint8)
            validity = np.unpackbits(bits, bitorder="little",
                                     count=n + off)[off:].astype(bool)
        return Column(dtype, vals, validity)
    items = arr.to_pylist()
    if k == TypeKind.INTERVAL:
        from .dtypes import Interval
        items = [None if v is None else
                 Interval(v.months, v.days, v.nanoseconds // 1000)
                 for v in items]
    return Column.from_list(dtype, items)


def datachunk_to_arrow(chunk: DataChunk, names: Optional[List[str]] = None):
    pa = _pa()
    names = names or [f"c{i}" for i in range(len(chunk.columns))]
    return pa.RecordBatch.from_arrays(
        [column_to_arrow(c) for c in chunk.columns], names=names)


def datachunk_from_arrow(batch, dtypes: List[DataType]) -> DataChunk:
    cols = [column_from_arrow(batch.column(i), dt)
            for i, dt in enumerate(dtypes)]
    return DataChunk(cols)


def streamchunk_to_arrow(chunk: StreamChunk,
                         names: Optional[List[str]] = None):
    """StreamChunk -> RecordBatch with a leading `__op__` int8 column
    (I/U-/U+/D), visibility compacted away first."""
    pa = _pa()
    chunk = chunk.compact()
    names = names or [f"c{i}" for i in range(len(chunk.columns))]
    arrays = [pa.array(chunk.ops, type=pa.int8())] \
        + [column_to_arrow(c) for c in chunk.columns]
    return pa.RecordBatch.from_arrays(arrays, names=["__op__"] + names)


def streamchunk_from_arrow(batch, dtypes: List[DataType]) -> StreamChunk:
    ops = np.asarray(batch.column(0)).astype(np.int8)
    cols = [column_from_arrow(batch.column(i + 1), dt)
            for i, dt in enumerate(dtypes)]
    return StreamChunk(ops, cols)


def _device_representable(dtype: DataType) -> bool:
    return dtype.kind in _FIXED or dtype.kind in (
        TypeKind.TIMESTAMP, TypeKind.DATE, TypeKind.BOOLEAN)


def to_torch(col: Column, device=None):
    """Device transfer of a column: numpy -> torch tensor on `device`
    (`cuda:0` by default; `torch.from_numpy` shares the buffer, so on the
    CPU nothing is copied). Only fixed-width, non-null columns cross —
    the device path's contract."""
    import torch
    from ..device import resolve_device
    if not col.validity.all():
        raise ValueError(
            "NULLs do not cross the device seam (mask first) — use "
            "to_torch_masked() to carry a validity bitmap alongside "
            "sentinel-filled values, or filter the NULL rows host-side "
            "before the transfer")
    if not _device_representable(col.dtype):
        raise ValueError(f"{col.dtype} has no device representation")
    return torch.from_numpy(np.ascontiguousarray(col.values)).to(
        resolve_device(device))


def to_torch_masked(col: Column, sentinel=0, device=None):
    """Nullable fixed-width column -> (values tensor, valid bool tensor)
    on `device`: NULL slots are filled with `sentinel` (any in-range
    value — downstream device code must gate on the mask, never on the
    fill) and the validity bitmap rides along as a bool tensor. A column
    with no NULLs crosses from its own buffer; only one that holds NULLs
    pays a host-side `np.where` for the fill."""
    import torch
    from ..device import resolve_device
    if not _device_representable(col.dtype):
        raise ValueError(f"{col.dtype} has no device representation")
    dev = resolve_device(device)
    valid = np.ascontiguousarray(col.validity)
    vals = col.values
    if not valid.all():
        vals = np.where(valid, vals,
                        np.asarray(sentinel, dtype=np.asarray(vals).dtype))
    return (torch.from_numpy(np.ascontiguousarray(vals)).to(dev),
            torch.from_numpy(valid).to(dev))
