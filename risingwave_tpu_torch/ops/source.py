"""Source executor + barrier injection.

Reference: `src/stream/src/executor/source/source_executor.rs:53` — a source
actor owns a split reader and a barrier channel; barriers interleave with data
chunks and split offsets are persisted in a split state table at each barrier.

Here `BarrierInjector` plays the role of the meta barrier RPC fan-out
(`ControlStreamManager::inject_barrier`, `src/meta/src/barrier/rpc.rs:598`):
every registered source gets a copy of each barrier; Merge/Join alignment
downstream reconverges them.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional, Sequence

from ..core.chunk import StreamChunk
from ..core.epoch import EpochPair, now_epoch
from ..core.schema import Schema
from ..core import dtypes as T
from ..state.state_table import StateTable
from ..utils.failpoint import declare, failpoint
from .executor import Executor
from .message import Barrier, BarrierKind, Message, Mutation, MutationKind, Watermark

declare("overload.burst",
        "ingest-burst chaos: while armed, each source epoch admits 10x "
        "the normal chunk budget — the deterministic offered-load spike "
        "the overload ladder must absorb")


class SourceReader:
    """Connector-side reader protocol (`SplitReader` analog,
    `src/connector/src/source/base.rs:474`). Readers that know when
    their data actually arrived set `last_ingest_ts` (wall clock of the
    last successful poll) — the source->MV freshness measure anchors on
    it; readers without it fall back to the executor's yield wall."""

    last_ingest_ts: Optional[float] = None

    def poll(self) -> Optional[StreamChunk]:
        """Next chunk, or None if no data is currently available."""
        raise NotImplementedError

    def split_states(self) -> Dict[str, Any]:
        """split_id -> offset, persisted at each barrier."""
        return {}

    def seek(self, states: Dict[str, Any]) -> None:
        """Restore split offsets on recovery."""


class BarrierInjector:
    """Creates barriers and fans them out to every registered source."""

    def __init__(self, checkpoint_frequency: int = 1,
                 start_epoch: Optional[int] = None):
        import time as _time
        self.queues: List[Deque[Barrier]] = []
        self.checkpoint_frequency = max(1, checkpoint_frequency)
        self._tick = 0
        curr = start_epoch if start_epoch is not None else now_epoch()
        self.epoch = EpochPair.new_initial(curr)
        self._initial_sent = False
        # freshness seam: the epoch each barrier seals opened when the
        # PREVIOUS barrier went out — no event of the epoch can predate
        # that, so it is the conservative ingest fallback
        self._last_inject_ts = _time.time()

    def register(self) -> Deque[Barrier]:
        q: Deque[Barrier] = deque()
        self.queues.append(q)
        return q

    def inject(self, kind: Optional[BarrierKind] = None,
               mutation: Optional[Mutation] = None) -> Barrier:
        if not self._initial_sent:
            k = BarrierKind.INITIAL
            self._initial_sent = True
        elif kind is not None:
            k = kind
        else:
            self._tick += 1
            k = (BarrierKind.CHECKPOINT
                 if self._tick % self.checkpoint_frequency == 0
                 else BarrierKind.BARRIER)
            self.epoch = self.epoch.next(now_epoch(self.epoch.curr))
        import time as _time
        b = Barrier(self.epoch, k, mutation)
        b.open_ts = self._last_inject_ts
        self._last_inject_ts = _time.time()
        for q in self.queues:
            q.append(b)
        return b

    def inject_stop(self) -> Barrier:
        return self.inject(BarrierKind.CHECKPOINT, Mutation(MutationKind.STOP))

    @property
    def any_pending(self) -> bool:
        return any(q for q in self.queues)


class BarrierSource(Executor):
    """Chunk-less source: yields only the injector's barriers. Feeds
    executors that are driven by barriers alone (Now, Values — the
    reference's barrier-receiver registration,
    `src/stream/src/task/barrier_manager.rs` for `now.rs`)."""

    def __init__(self, injector: "BarrierInjector"):
        super().__init__(Schema([]), "BarrierSource")
        self.append_only = True
        self.injector = injector
        self.queue = injector.register()

    def execute(self) -> Iterator[Message]:
        while True:
            if self.queue:
                b = self.queue.popleft()
                yield b.with_trace(self.name)
                if b.is_stop():
                    return
            else:
                # idle: tick (same deadlock-avoidance as SourceExecutor)
                self.injector.inject()


class SourceExecutor(Executor):
    def __init__(self, schema: Schema, reader: SourceReader,
                 injector: BarrierInjector,
                 split_state_table: Optional[StateTable] = None,
                 name: str = "Source", append_only: bool = False):
        super().__init__(schema, name)
        # connector sources only ever insert; DML tables push retractions
        # through their reader, so the creator decides
        self.append_only = append_only
        self.reader = reader
        self.injector = injector
        self.queue = injector.register()
        self.split_state_table = split_state_table
        self._recovered = False
        # wall of the FIRST chunk of the current epoch (freshness stamp)
        self._first_chunk_ts: Optional[float] = None
        # source admission control (utils/overload.AdmissionBucket, set
        # by the Database for connector sources): a per-epoch token
        # bucket whose rate follows the downstream overload ladder. None
        # = ungated (DML tables, ad-hoc scans) — exactly the old path.
        self.admission = None

    def _persist_splits(self, epoch: int) -> None:
        if self.split_state_table is None:
            return
        for split_id, offset in self.reader.split_states().items():
            self.split_state_table.insert((split_id, repr(offset)))
        self.split_state_table.commit(epoch)

    def _recover_splits(self) -> None:
        if self.split_state_table is None or self._recovered:
            return
        self._recovered = True
        states = {}
        for row in self.split_state_table.iter_all():
            import ast
            states[row[0]] = ast.literal_eval(row[1])
        if states:
            self.reader.seek(states)

    def _poll_gated(self) -> Optional[StreamChunk]:
        """Admission-gated reader poll. `defer` skips the poll entirely
        — the unread data stays AT the connector (file offset, generator
        cursor), which is backpressure propagated to the source itself.
        `shed` (shedding rung + RW_LOAD_SHED only) polls the window and
        drops it, recording the audited gap through the bucket's shed
        sink (`rw_shed_log`)."""
        adm = self.admission
        if adm is None:
            return self.reader.poll()
        verdict = adm.admit()
        if verdict == "defer":
            return None
        # batch throttle rides along with cadence throttle: readers that
        # expose a `throttle` knob shrink their per-poll batch too
        if hasattr(self.reader, "throttle"):
            self.reader.throttle = adm.factor
        chunk = self.reader.poll()
        if chunk is None or chunk.cardinality == 0:
            return chunk
        if verdict == "shed":
            adm.note_shed(self.injector.epoch.curr,
                          int(chunk.cardinality))
            return None
        adm.note_admitted(int(chunk.cardinality))
        return chunk

    def _stamp_ingest(self) -> None:
        """First chunk of the current epoch: remember when its data came
        off the connector (the reader's poll wall when it reports one,
        else now) — folded onto the sealing barrier for the source->MV
        freshness measure."""
        if self._first_chunk_ts is None:
            import time as _time
            self._first_chunk_ts = getattr(self.reader, "last_ingest_ts",
                                           None) or _time.time()

    def execute(self) -> Iterator[Message]:
        paused = False
        self._first_chunk_ts = None
        # Data available when a barrier is pending still belongs to the epoch
        # the barrier seals — drain it first (bounded, so an unbounded reader
        # cannot starve barriers; reference bounds this with channel capacity).
        max_chunks_before_barrier = 64
        drained = 0
        burst = 1
        while True:
            if self.queue:
                # cadence stretch (degraded rung): bigger epochs amortize
                # barrier overhead; burst chaos: 10x the offered budget
                stretch = (self.admission.stretch
                           if self.admission is not None else 1)
                limit = max_chunks_before_barrier * max(1, stretch) * burst
                if (not paused and drained < limit
                        and self.queue[0].kind != BarrierKind.INITIAL):
                    chunk = self._poll_gated()
                    if chunk is not None and chunk.cardinality > 0:
                        drained += 1
                        self._stamp_ingest()
                        yield chunk
                        continue
                drained = 0
                b = self.queue.popleft()
                burst = 10 if failpoint("overload.burst") else 1
                # per-EPOCH admission refill at the sealing barrier: the
                # budget is `capacity * factor` poll tokens, scaled by
                # the same stretch/burst multipliers the drain limit
                # uses (the overload manager re-rates `factor` per tick)
                if self.admission is not None:
                    self.admission.epoch_refill(
                        max(1, self.admission.stretch) * burst)
                if b.kind == BarrierKind.INITIAL:
                    self._recover_splits()
                if b.is_checkpoint:
                    self._persist_splits(b.epoch.curr)
                if b.mutation is not None:
                    if b.mutation.kind == MutationKind.PAUSE:
                        paused = True
                    elif b.mutation.kind == MutationKind.RESUME:
                        paused = False
                if self._first_chunk_ts is not None:
                    # mutate the injector's SHARED instance (the yielded
                    # copy never reaches the coordinator's tick loop)
                    b.note_ingest(self._first_chunk_ts)
                    self._first_chunk_ts = None
                yield b.with_trace(self.name)
                if b.is_stop():
                    return
                continue
            if paused:
                # no data while paused; force the runner to tick barriers
                self.injector.inject()
                continue
            chunk = self._poll_gated()
            if chunk is not None and chunk.cardinality > 0:
                self._stamp_ingest()
                yield chunk
            else:
                # idle: auto-tick a barrier for ALL sources so bounded inputs
                # drain deterministically and alignment never deadlocks
                self.injector.inject()
