"""Connector framework: splits, enumerators, readers, parsers (the port's
own copy of the JAX package's `connectors/base.py`).

Re-design of the reference's source stack (`src/connector/src/source/
base.rs:77` `SplitEnumerator`, `:474` `SplitReader`, parser at
`src/connector/src/parser/mod.rs`) collapsed to the pieces the
single-process runtime needs:

* `SourceSplit` — one unit of parallel ingestion (a file, a partition, a
  generator shard) with a resumable offset.
* `SplitEnumerator` — discovers the current split set (re-run per poll so
  late-arriving splits, e.g. new files, are picked up).
* `SplitReader` — reads raw records from one split starting at an offset.
* `Parser` — raw records -> columnar StreamChunk for a schema, with PG-ish
  type coercion. Parsing is host-side and batched: records come in lists
  and columns are built once per batch, not per field.
* `SplitSourceReader` — composes the three behind the runtime's
  `SourceReader` protocol (`ops/source.py`): round-robins live splits,
  tracks per-split offsets, and persists/restores them through the split
  state table (offset-in-state recovery, `source_executor.rs:53`).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.chunk import Column, Op, StreamChunk
from ..core.dtypes import DataType, TypeKind
from ..core.schema import Schema
from ..ops.source import SourceReader


@dataclass(frozen=True)
class SourceSplit:
    """One resumable unit of ingestion (`SplitImpl` analog)."""
    split_id: str
    meta: Any = None


class SplitEnumerator:
    """Discovers the live split set (`SplitEnumerator::list_splits`)."""

    def list_splits(self) -> List[SourceSplit]:
        raise NotImplementedError


class SplitReader:
    """Reads raw records from one split (`SplitReader::into_stream`)."""

    def read(self, split: SourceSplit, offset: Any, max_records: int
             ) -> Tuple[List[bytes], Any]:
        """Up to max_records raw records from `offset`; returns
        (records, next_offset). Empty list = nothing available now."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Parsers
# ---------------------------------------------------------------------------

def _coerce(v: Any, dtype: DataType) -> Any:
    """JSON value -> host representation for `dtype` (PG-ish casts)."""
    if v is None:
        return None
    kind = dtype.kind
    if kind in (TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
                TypeKind.SERIAL):
        return int(v)
    if kind in (TypeKind.FLOAT32, TypeKind.FLOAT64):
        return float(v)
    if kind == TypeKind.BOOLEAN:
        if isinstance(v, str):
            return v.strip().lower() in ("t", "true", "1", "yes", "on")
        return bool(v)
    if kind == TypeKind.VARCHAR:
        return v if isinstance(v, str) else json.dumps(v)
    if kind in (TypeKind.TIMESTAMP, TypeKind.TIMESTAMPTZ):
        if isinstance(v, (int, float)):
            return int(v)                      # already epoch usecs
        from datetime import datetime, timezone
        dt = datetime.fromisoformat(str(v))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return int(dt.timestamp() * 1_000_000)
    if kind == TypeKind.DATE:
        from datetime import date
        return (date.fromisoformat(v) - date(1970, 1, 1)).days \
            if isinstance(v, str) else int(v)
    if kind == TypeKind.DECIMAL:
        from decimal import Decimal
        return Decimal(str(v))
    raise NotImplementedError(f"json coercion for {dtype}")


class Parser:
    """Raw record batch -> StreamChunk (`ByteStreamSourceParser` analog)."""

    def __init__(self, schema: Schema):
        self.schema = schema

    def parse(self, records: Sequence[bytes]) -> StreamChunk:
        raise NotImplementedError

    def _chunk_from_rows(self, rows: List[List[Any]]) -> StreamChunk:
        cols = [Column.from_list(f.dtype, [r[i] for r in rows])
                for i, f in enumerate(self.schema.fields)]
        return StreamChunk(np.zeros(len(rows), dtype=np.int8), cols)


class JsonParser(Parser):
    """One JSON object per record, fields matched by column name
    (`parser/json_parser.rs` analog): missing fields are NULL, unknown
    fields are ignored, malformed records are skipped with a count."""

    def __init__(self, schema: Schema):
        super().__init__(schema)
        self.errors = 0

    def parse(self, records: Sequence[bytes]) -> StreamChunk:
        names = [f.name for f in self.schema.fields]
        dtypes = [f.dtype for f in self.schema.fields]
        rows: List[List[Any]] = []
        for rec in records:
            try:
                obj = json.loads(rec)
                if not isinstance(obj, dict):   # e.g. bare array/number
                    self.errors += 1
                    continue
                rows.append([_coerce(obj.get(n), d)
                             for n, d in zip(names, dtypes)])
            except (ValueError, TypeError, KeyError, ArithmeticError):
                self.errors += 1    # ArithmeticError covers bad DECIMALs
        return self._chunk_from_rows(rows)


class CsvParser(Parser):
    """Delimiter-separated records, positional columns, RFC-4180 quoting
    (`parser/csv_parser.rs` analog). Empty unquoted field = NULL.
    Values with embedded newlines need a record-aware reader upstream —
    the newline-framed `LineFileReader` hands over one line per record."""

    def __init__(self, schema: Schema, delimiter: str = ","):
        super().__init__(schema)
        self.delimiter = delimiter
        self.errors = 0

    def parse(self, records: Sequence[bytes]) -> StreamChunk:
        import csv
        dtypes = [f.dtype for f in self.schema.fields]
        rows: List[List[Any]] = []
        for rec in records:
            try:
                parts = next(csv.reader([rec.decode("utf-8")],
                                        delimiter=self.delimiter))
                rows.append([
                    _coerce(p if p != "" else None, d)
                    for p, d in zip(parts + [None] * len(dtypes), dtypes)])
            except (ValueError, TypeError, StopIteration, ArithmeticError):
                self.errors += 1
        return self._chunk_from_rows(rows)


def make_parser(fmt: str, schema: Schema, options: Dict[str, str]) -> Parser:
    fmt = fmt.lower()
    if fmt in ("json", "jsonl", "ndjson"):
        return JsonParser(schema)
    if fmt == "csv":
        return CsvParser(schema, options.get("csv.delimiter", ","))
    raise ValueError(f"unknown source format {fmt!r}")


# ---------------------------------------------------------------------------
# Generic reader
# ---------------------------------------------------------------------------

class SplitSourceReader(SourceReader):
    """Enumerator + reader + parser behind the runtime SourceReader
    protocol. Per-split offsets are the recovery state: they persist into
    the split state table at every checkpoint and `seek` restores them."""

    def __init__(self, enumerator: SplitEnumerator, reader: SplitReader,
                 parser: Parser, records_per_poll: int = 4096):
        self.enumerator = enumerator
        self.reader = reader
        self.parser = parser
        self.records_per_poll = records_per_poll
        # admission batch throttle in (0, 1]: the overload control plane
        # (ops/source._poll_gated) shrinks the per-poll batch together
        # with the poll cadence when downstream credit starves — the
        # unread records stay in the split at their offset, which IS the
        # backpressure reaching the connector
        self.throttle = 1.0
        self.offsets: Dict[str, Any] = {}
        self._rr: int = 0   # round-robin cursor over the live split list
        # wall of the last successful poll — the source->MV freshness
        # measure anchors here (data "exists" the moment it is read off
        # the split, BEFORE parsing: parse cost is inside the measure)
        self.last_ingest_ts: Optional[float] = None

    def poll(self) -> Optional[StreamChunk]:
        import time
        splits = self.enumerator.list_splits()
        if not splits:
            return None
        # round-robin: give every split a chance before returning None
        budget = max(1, int(self.records_per_poll
                            * min(1.0, max(0.0, self.throttle))))
        for probe in range(len(splits)):
            s = splits[(self._rr + probe) % len(splits)]
            records, nxt = self.reader.read(
                s, self.offsets.get(s.split_id), budget)
            if records:
                read_ts = time.time()
                self._rr = (self._rr + probe + 1) % len(splits)
                self.offsets[s.split_id] = nxt
                chunk = self.parser.parse(records)
                if chunk.cardinality > 0:
                    self.last_ingest_ts = read_ts
                    return chunk
        self._rr = (self._rr + 1) % max(1, len(splits))
        return None

    def split_states(self) -> Dict[str, Any]:
        return dict(self.offsets)

    def seek(self, states: Dict[str, Any]) -> None:
        self.offsets.update(states)
