"""Local stream runtime: drives a dataflow to barrier boundaries.

Plays the combined role of the reference's `LocalStreamManager` +
`LocalBarrierManager` (`src/stream/src/task/stream_manager.rs:92`,
`task/barrier_manager.rs:1005`) and, for the single-process case, the meta
`GlobalBarrierWorker` loop (`src/meta/src/barrier/worker.rs:380-450`): pull
the sink stream until a barrier emerges (all state committed), then commit
the epoch to the store — the `HummockManager::commit_epoch` analog.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from ..core.chunk import StreamChunk
from ..core.epoch import INVALID_EPOCH
from ..ops.executor import Executor
from ..ops.message import Barrier, BarrierKind, Message, Watermark
from ..ops.source import BarrierInjector
from ..state.store import StateStore


class StreamJob:
    """One running dataflow, pulled from its terminal executor."""

    def __init__(self, sink: Executor, injector: BarrierInjector,
                 store: StateStore):
        self.sink = sink
        self.injector = injector
        self.store = store
        self._iter: Optional[Iterator[Message]] = None
        self.committed_epoch = INVALID_EPOCH
        self.barriers_seen = 0
        self.output_chunks: List[StreamChunk] = []
        self.collect_output = False
        self.stopped = False
        self.chunks_seen = 0

    def _stream(self) -> Iterator[Message]:
        if self._iter is None:
            self._iter = self.sink.execute()
            self.injector.inject()  # BarrierKind::Initial bootstraps the DAG
        return self._iter

    def run_until_barrier(self) -> Optional[Barrier]:
        """Advance until the next barrier fully traverses the DAG."""
        it = self._stream()
        for msg in it:
            if isinstance(msg, Barrier):
                self.barriers_seen += 1
                if msg.is_checkpoint:
                    self.store.commit_epoch(msg.epoch.curr)
                    self.committed_epoch = msg.epoch.curr
                if msg.is_stop():
                    self.stopped = True
                return msg
            if isinstance(msg, StreamChunk):
                self.chunks_seen += 1
                if self.collect_output:
                    self.output_chunks.append(msg)
        self.stopped = True
        return None

    def flush(self) -> Optional[Barrier]:
        """Explicit barrier + run to it (the `FLUSH` statement semantics)."""
        self.injector.inject(BarrierKind.CHECKPOINT)
        return self.run_until_barrier()

    def run_barriers(self, n: int) -> None:
        for _ in range(n):
            if self.stopped:
                return
            self.run_until_barrier()

    def run_until_idle(self, max_barriers: int = 10_000) -> None:
        """Drain bounded sources: run until sources are exhausted (signalled by
        two consecutive auto-injected barriers with no data in between)."""
        quiet = 0
        for _ in range(max_barriers):
            if self.stopped:
                return
            n_before = self.chunks_seen
            self.run_until_barrier()
            if self.chunks_seen == n_before:
                quiet += 1
                if quiet >= 2:
                    return
            else:
                quiet = 0

    def stop(self) -> None:
        self.injector.inject_stop()
        while not self.stopped:
            if self.run_until_barrier() is None:
                break
