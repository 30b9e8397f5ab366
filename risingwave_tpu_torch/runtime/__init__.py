"""Runtime: local stream job driving (reference: `src/stream/src/task/`)
and the process-placed fragment runtime: the credit-flow socket exchange
(`exchange_net.py`), the worker process (`worker.py`), and the
coordinator's worker sets with their supervisor and dead-letter queue
(`remote_fragments.py`)."""
from .local import StreamJob
from .exchange_net import (ExchangeServer, MetricsFrame, NetChannel,
                           RemoteInput)
from .remote_fragments import (DeadLetterQueue, FragmentSupervisor,
                               RemoteFragmentSet, RemoteStatefulSet,
                               RemoteWorkerDied)

__all__ = ["StreamJob", "ExchangeServer", "MetricsFrame", "NetChannel",
           "RemoteInput", "DeadLetterQueue", "FragmentSupervisor",
           "RemoteFragmentSet", "RemoteStatefulSet", "RemoteWorkerDied"]
