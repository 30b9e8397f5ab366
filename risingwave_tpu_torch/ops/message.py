"""Stream messages: Chunk | Barrier | Watermark.

Mirrors the reference's `Message` enum and `Barrier` struct
(`src/stream/src/executor/mod.rs:1039`, `:324`): barriers carry the epoch
pair, a kind (initial/barrier/checkpoint), and mutations (scale, pause,
config change) that executors apply when the barrier passes through them.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from ..core.chunk import StreamChunk
from ..core.dtypes import DataType
from ..core.epoch import EpochPair


class BarrierKind(enum.Enum):
    """`BarrierKind` (`src/meta/src/barrier/command.rs:452`): not every barrier
    is a checkpoint — state flushes to durable storage only on checkpoint
    barriers (every `checkpoint_frequency` ticks)."""
    INITIAL = "initial"
    BARRIER = "barrier"
    CHECKPOINT = "checkpoint"


class MutationKind(enum.Enum):
    """Barrier mutations (`src/stream/src/executor/mod.rs:304`)."""
    STOP = "stop"
    PAUSE = "pause"
    RESUME = "resume"
    ADD = "add"                  # new downstream job attached (backfill start)
    UPDATE = "update"            # scale: dispatcher/vnode bitmap changes
    SOURCE_CHANGE_SPLIT = "source_change_split"
    THROTTLE = "throttle"


@dataclass
class Mutation:
    kind: MutationKind
    # vnode re-assignment for scale: actor/shard id -> vnode bitmap
    vnode_bitmaps: Optional[Dict[int, Any]] = None
    # split assignment changes for sources
    splits: Optional[Dict[str, Any]] = None
    payload: Any = None


@dataclass
class Barrier:
    epoch: EpochPair
    kind: BarrierKind = BarrierKind.CHECKPOINT
    mutation: Optional[Mutation] = None
    # passed_actors-style tracing breadcrumb (which executors saw it)
    trace: List[str] = field(default_factory=list)
    # source->MV freshness stamp: wall time the OLDEST event of the
    # epoch this barrier seals came into existence. Sources fold their
    # first-chunk poll wall in via `note_ingest` (min wins — the
    # injector hands every source the SAME Barrier instance, so the
    # coordinator reads the cluster-wide minimum after the tick);
    # `open_ts` is the injector's conservative fallback (the previous
    # barrier's injection wall — no event of this epoch can predate it).
    ingest_ts: Optional[float] = None
    open_ts: Optional[float] = None

    @property
    def is_checkpoint(self) -> bool:
        return self.kind in (BarrierKind.CHECKPOINT, BarrierKind.INITIAL)

    def is_stop(self) -> bool:
        return self.mutation is not None and self.mutation.kind == MutationKind.STOP

    def note_ingest(self, ts: float) -> None:
        self.ingest_ts = ts if self.ingest_ts is None \
            else min(self.ingest_ts, ts)

    def best_ingest_ts(self) -> Optional[float]:
        """The freshness anchor: a source-stamped first-chunk wall when
        any source stamped one, else the epoch-open fallback."""
        return self.ingest_ts if self.ingest_ts is not None else self.open_ts

    def with_trace(self, name: str) -> "Barrier":
        b = Barrier(self.epoch, self.kind, self.mutation,
                    self.trace + [name])
        b.ingest_ts = self.ingest_ts
        b.open_ts = self.open_ts
        return b


@dataclass
class Watermark:
    """Column watermark (`src/stream/src/executor/mod.rs:964`): all future rows
    have col > value is FALSE; i.e. no row with column value <= `value` - delay
    will arrive. Used for window emission + state cleaning."""
    col_idx: int
    dtype: DataType
    value: Any


Message = Union[StreamChunk, Barrier, Watermark]


def is_chunk(m: Message) -> bool:
    return isinstance(m, StreamChunk)
