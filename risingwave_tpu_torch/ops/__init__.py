"""Stream executors (reference: `src/stream/src/executor/`).

The port holds the executor protocol, the source and materialize
executors, and the two per-operator device executors; the JAX package's
host executors (`agg.py`, `join.py`, `simple.py`, ...) are still to port.
"""
from .executor import Executor, SharedStream, UnaryExecutor
from .materialize import BatchScan, ConflictBehavior, MaterializeExecutor
from .message import (Barrier, BarrierKind, Message, Mutation, MutationKind,
                      Watermark, is_chunk)
from .source import (BarrierInjector, BarrierSource, SourceExecutor,
                     SourceReader)
from .device_agg import DeviceHashAggExecutor, device_agg_eligible
from .device_join import DeviceHashJoinExecutor

__all__ = [
    "Executor", "SharedStream", "UnaryExecutor", "BatchScan",
    "ConflictBehavior", "MaterializeExecutor", "Barrier", "BarrierKind",
    "Message", "Mutation", "MutationKind", "Watermark", "is_chunk",
    "BarrierInjector", "BarrierSource", "SourceExecutor", "SourceReader",
    "DeviceHashAggExecutor", "device_agg_eligible",
    "DeviceHashJoinExecutor",
]
