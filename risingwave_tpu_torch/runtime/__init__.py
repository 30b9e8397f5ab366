"""Runtime: local stream job driving (reference: `src/stream/src/task/`)
and, of the process-placed fragment runtime, the dead-letter queue
(`remote_fragments.py`)."""
from .local import StreamJob
from .remote_fragments import DeadLetterQueue

__all__ = ["StreamJob", "DeadLetterQueue"]
