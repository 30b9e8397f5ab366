"""State layer: stores + relational state tables (reference:
`src/storage/`, `src/stream/src/common/table/`), and the cold tier's Xor8
filter (`xor8.py`)."""
from .state_table import StateTable
from .store import MemoryStateStore, StateStore

__all__ = ["StateTable", "MemoryStateStore", "StateStore"]
