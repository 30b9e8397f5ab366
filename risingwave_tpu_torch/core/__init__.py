"""Core: types, columnar chunks, vnode hashing, epochs, encodings (the
port's own copy of the JAX package's `core/`)."""
from . import dtypes
from .chunk import Column, DataChunk, DeviceChunk, Op, StreamChunk, StreamChunkBuilder, to_device_chunk
from .dtypes import DataType, Interval, TypeKind, parse_interval, type_from_sql_name
from .epoch import EpochPair, INVALID_EPOCH, now_epoch
from .schema import Field, Schema
from .vnode import VNODE_COUNT, compute_vnodes, hash_columns64, vnode_of_row

__all__ = [
    "dtypes", "Column", "DataChunk", "DeviceChunk", "Op", "StreamChunk",
    "StreamChunkBuilder", "to_device_chunk", "DataType", "Interval", "TypeKind",
    "parse_interval", "type_from_sql_name", "EpochPair", "INVALID_EPOCH",
    "now_epoch", "Field", "Schema", "VNODE_COUNT", "compute_vnodes",
    "hash_columns64", "vnode_of_row",
]
