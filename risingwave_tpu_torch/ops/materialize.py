"""Materialize executor — writes the MV table.

Reference: `src/stream/src/executor/mview/materialize.rs:59,77,166` with
conflict behaviors Overwrite / IgnoreConflict / NoCheck. Under Overwrite the
executor corrects the change stream against current state (an INSERT hitting
an existing pk becomes an update pair), so downstream MVs stay consistent.
"""
from __future__ import annotations

import enum
from typing import Iterator, List, Optional, Sequence, Tuple

from ..core.chunk import Op, StreamChunk, StreamChunkBuilder
from ..core.schema import Schema
from ..state.state_table import StateTable
from .executor import Executor, UnaryExecutor
from .message import Barrier, Message


class ConflictBehavior(enum.Enum):
    NO_CHECK = "no_check"
    OVERWRITE = "overwrite"
    IGNORE = "ignore"
    DO_UPDATE_IF_NOT_NULL = "do_update_if_not_null"


class MaterializeExecutor(UnaryExecutor):
    def __init__(self, input: Executor, table: StateTable,
                 conflict: ConflictBehavior = ConflictBehavior.NO_CHECK,
                 name: str = "Materialize"):
        super().__init__(input, input.schema, name)
        # conflict rewriting (OVERWRITE / DO_UPDATE_IF_NOT_NULL) can turn an
        # insert into an update pair when a pk collides, so only the
        # NO_CHECK path preserves the append-only property (creators use
        # NO_CHECK when the pk is a minted rowid, which never collides)
        self.append_only = (input.append_only
                            and conflict == ConflictBehavior.NO_CHECK)
        self.table = table
        self.conflict = conflict

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        chunk = chunk.compact()
        if self.conflict == ConflictBehavior.NO_CHECK:
            self.table.write_chunk(chunk)
            yield chunk
            return
        # conflict-checked path: rewrite the chunk against current state
        out = StreamChunkBuilder(self.schema.dtypes)
        pk_idx = self.table.pk_indices
        for op, row in chunk.op_rows():
            pk = [row[i] for i in pk_idx]
            existing = self.table.get_by_pk(pk)
            if op.is_insert:
                if existing is None:
                    self.table.insert(row)
                    out.append_row(Op.INSERT, row)
                elif self.conflict == ConflictBehavior.OVERWRITE:
                    if tuple(existing) != tuple(row):
                        self.table.update(existing, row)
                        out.append_update(existing, row)
                elif self.conflict == ConflictBehavior.DO_UPDATE_IF_NOT_NULL:
                    merged = tuple(row[i] if row[i] is not None else existing[i]
                                   for i in range(len(row)))
                    if merged != tuple(existing):
                        self.table.update(existing, merged)
                        out.append_update(existing, merged)
                # IGNORE: keep the first row, drop the new one
            else:
                if existing is not None:
                    self.table.delete(existing)
                    out.append_row(Op.DELETE, existing)
                # deleting a non-existent pk is a no-op under conflict handling
        result = out.take()
        if result is not None:
            yield result

    def on_barrier(self, barrier: Barrier) -> Iterator[Message]:
        self.table.commit(barrier.epoch.curr)
        return iter(())


class BatchScan:
    """Snapshot read of a materialized table at the committed epoch —
    the `StorageTable::batch_iter_with_pk_bounds` analog
    (`src/storage/src/table/batch_table/mod.rs:892`)."""

    def __init__(self, table: StateTable, schema: Schema):
        self.table = table
        self.schema = schema

    def rows(self) -> List[Tuple]:
        return list(self.table.iter_all())

    def sorted_rows(self) -> List[Tuple]:
        """Rows in global pk order (iter_all is vnode-major, so re-sort)."""
        from ..core.encoding import SortKey
        pk_idx = self.table.pk_indices
        return sorted(
            self.rows(),
            key=lambda r: SortKey([r[i] for i in pk_idx],
                                  self.table.pk_dtypes, self.table.order_desc))
