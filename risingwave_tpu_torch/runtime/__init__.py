"""Runtime: local stream job driving (reference: `src/stream/src/task/`)."""
from .local import StreamJob

__all__ = ["StreamJob"]
