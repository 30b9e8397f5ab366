"""Datagen source: deterministic generated rows at a configurable rate.

Reference: the `datagen` connector (`src/connector/src/source/datagen/`) —
per-column sequence or random generators, split-parallel, seed-stable.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.chunk import Column, Op, StreamChunk
from ..core.dtypes import DataType
from ..core.schema import Schema
from ..ops.source import SourceReader


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic stateless PRNG (public splitmix64 constants)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    with np.errstate(over="ignore"):
        z = x
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return z


class FieldGen:
    """Per-column generator. kind = 'sequence' | 'random' | 'zipf'
    (power-law over [start, end), pmf ~ rank^-s with `s` > 1; rank 1 =
    `start`, the stationary hot key — reproducible skewed workloads)."""

    def __init__(self, kind: str = "sequence", start: int = 0, end: int = 2**31,
                 seed: int = 0, length: int = 10,
                 values: Optional[List[Any]] = None, s: float = 1.5):
        self.kind = kind
        self.start = start
        self.end = end
        self.seed = seed
        self.length = length
        self.values = values
        self.s = max(float(s), 1.0 + 1e-6)

    def generate(self, dtype: DataType, offsets: np.ndarray) -> Column:
        n = len(offsets)
        if self.kind == "sequence":
            vals = (self.start + offsets).astype(np.int64)
            if dtype.np_dtype == np.dtype(object):
                return Column.from_list(dtype, [str(v) for v in vals])
            return Column(dtype, vals.astype(dtype.np_dtype))
        r = splitmix64(offsets.astype(np.uint64) + np.uint64(self.seed << 32))
        if self.kind == "zipf":
            span = np.int64(max(1, self.end - self.start))
            u = (r >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)
            rank = np.floor(np.power(1.0 - u, -1.0 / (self.s - 1.0)))
            rank = np.clip(rank, 1.0, float(span)).astype(np.int64)
            vals = self.start + rank - 1
            if dtype.np_dtype == np.dtype(object):
                return Column.from_list(dtype, [str(v) for v in vals])
            return Column(dtype, vals.astype(dtype.np_dtype))
        if self.values is not None:
            idx = (r % np.uint64(len(self.values))).astype(np.int64)
            return Column.from_list(dtype, [self.values[i] for i in idx])
        if dtype.np_dtype == np.dtype(object):
            return Column.from_list(
                dtype, ["s" + format(int(v) & ((1 << (4 * self.length)) - 1),
                                     f"0{self.length}x") for v in r])
        span = max(1, self.end - self.start)
        vals = self.start + (r % np.uint64(span)).astype(np.int64)
        return Column(dtype, vals.astype(dtype.np_dtype))


class DatagenReader(SourceReader):
    def __init__(self, schema: Schema, fields: Optional[Dict[str, FieldGen]] = None,
                 rows_per_chunk: int = 1024, max_rows: Optional[int] = None,
                 split_id: str = "0"):
        self.schema = schema
        self.fields = fields or {}
        self.rows_per_chunk = rows_per_chunk
        self.max_rows = max_rows
        self.offset = 0
        self.split_id = split_id

    def poll(self) -> Optional[StreamChunk]:
        if self.max_rows is not None and self.offset >= self.max_rows:
            return None
        import time
        n = self.rows_per_chunk
        if self.max_rows is not None:
            n = min(n, self.max_rows - self.offset)
        offs = np.arange(self.offset, self.offset + n, dtype=np.int64)
        cols = []
        for f in self.schema.fields:
            gen = self.fields.get(f.name, FieldGen("sequence"))
            cols.append(gen.generate(f.dtype, offs))
        self.offset += n
        ops = np.zeros(n, dtype=np.int8)  # all inserts
        # generated data "arrives" the moment it is minted — the stamp
        # the freshness ground-truth tests anchor against
        self.last_ingest_ts = time.time()
        return StreamChunk(ops, cols)

    def split_states(self) -> Dict[str, Any]:
        return {self.split_id: self.offset}

    def seek(self, states: Dict[str, Any]) -> None:
        if self.split_id in states:
            self.offset = int(states[self.split_id])


class ListReader(SourceReader):
    """Feed a fixed list of chunks — the `MockSource` analog for tests
    (`src/stream/src/executor/test_utils/`)."""

    def __init__(self, chunks: Sequence[StreamChunk], split_id: str = "0"):
        self.chunks = list(chunks)
        self.pos = 0
        self.split_id = split_id

    def push(self, chunk: StreamChunk) -> None:
        self.chunks.append(chunk)

    def poll(self) -> Optional[StreamChunk]:
        if self.pos >= len(self.chunks):
            return None
        c = self.chunks[self.pos]
        self.pos += 1
        return c

    def split_states(self) -> Dict[str, Any]:
        return {self.split_id: self.pos}

    def seek(self, states: Dict[str, Any]) -> None:
        if self.split_id in states:
            self.pos = int(states[self.split_id])
