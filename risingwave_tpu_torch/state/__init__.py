"""State layer: stores + relational state tables (reference:
`src/storage/`, `src/stream/src/common/table/`): the in-memory store, the
durable spill store (`hummock.py`) and the Xor8 filter that its run files
and the cold tier share (`xor8.py`)."""
from .hummock import SpillStateStore
from .state_table import StateTable
from .store import MemoryStateStore, StateStore

__all__ = ["StateTable", "MemoryStateStore", "SpillStateStore", "StateStore"]
