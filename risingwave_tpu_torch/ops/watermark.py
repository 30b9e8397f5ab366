"""Watermark generation and filtering (the port's own copy of the JAX
package's `ops/watermark.py`).

Reference: `src/stream/src/executor/watermark_filter.rs:37` — derives the
watermark `max(event_time) - delay` from the data, emits `Watermark`
messages downstream, filters rows older than the current watermark, and
persists the watermark for recovery. The reference stores one watermark per
vnode; here a fragment's vnode range lives in one executor, so
a single persisted scalar is the same contract.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np

from ..core.chunk import StreamChunk
from ..state.state_table import StateTable
from .executor import Executor, UnaryExecutor
from .message import Barrier, Message, Watermark


class WatermarkFilterExecutor(UnaryExecutor):
    def __init__(self, input: Executor, time_col: int, delay: int,
                 state_table: Optional[StateTable] = None):
        super().__init__(input, input.schema, "WatermarkFilter")
        self.append_only = input.append_only
        self.time_col = time_col
        self.delay = delay
        self.watermark: Optional[Any] = None
        self.state_table = state_table
        self._recovered = state_table is None
        self._wm_dirty = False
        self._persisted: Optional[Any] = None

    def _recover(self) -> None:
        if self._recovered:
            return
        self._recovered = True
        for row in self.state_table.iter_all():
            self.watermark = row[1] if self.watermark is None \
                else max(self.watermark, row[1])
        if self.watermark is not None:
            # re-announce the recovered watermark downstream (the reference
            # emits the persisted watermark on startup) so e.g. a recovered
            # EOWC agg can close its pre-crash windows even on a quiet stream
            self._wm_dirty = True
            self._persisted = self.watermark

    def on_chunk(self, chunk: StreamChunk) -> Iterator[Message]:
        self._recover()
        col = chunk.columns[self.time_col]
        vis = chunk.vis_mask() & col.validity
        # filter with the PREVIOUS watermark, then advance — a chunk's own
        # max must not retroactively drop its older sibling rows
        # (watermark_filter.rs evaluates `ts >= watermark` before updating)
        if self.watermark is not None:
            # the reference's filter expression is `ts >= watermark`: late
            # rows AND NULL-ts rows evaluate not-true and are dropped
            # (NULL would otherwise accumulate as never-closing groups in
            # downstream EOWC aggs)
            late = (vis & (col.values < self.watermark)) \
                | (chunk.vis_mask() & ~col.validity)
            if late.any():
                chunk = chunk.with_visibility(chunk.vis_mask() & ~late)
                vis = vis & ~late
        if vis.any():
            cand = col.values[vis].max() - self.delay
            if self.watermark is None or cand > self.watermark:
                self.watermark = cand
                self._wm_dirty = True
        if chunk.cardinality > 0:
            yield chunk

    def on_barrier(self, barrier: Barrier) -> Iterator[Message]:
        self._recover()
        if self.watermark is not None and self._wm_dirty:
            self._wm_dirty = False
            yield Watermark(self.time_col,
                            self.schema.fields[self.time_col].dtype,
                            self.watermark)
        if self.state_table is not None and \
                self.watermark != self._persisted:
            # persist only on change — an idle stream must not produce a
            # spill-run per epoch for an unchanged watermark
            self._persisted = self.watermark
            self.state_table.insert((0, self.watermark))
            self.state_table.commit(barrier.epoch.curr)
