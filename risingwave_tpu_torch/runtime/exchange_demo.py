"""Two-process Nexmark q4: the cross-process deployment shape (the port's
own copy of the JAX package's `runtime/exchange_demo.py`).

Process A (producer, `python -m risingwave_tpu_torch.runtime.exchange_demo
producer PORT N K`): nexmark bid source -> hash DispatchExecutor on the
auction column -> K remote exchange channels (ExchangeServer). The
reference's source compute node.

Process B (consumer, in-process — see tests/test_torch_exchange_net.py): K
RemoteInputs -> K HashAgg fragments -> barrier-aligned Merge -> MV. The
reference's downstream compute node; barriers injected in A align in B
across the process boundary (`merge.rs:235` over
`exchange_service.rs:77` streams).
"""
from __future__ import annotations

import sys
from typing import List, Optional

from ..core import dtypes as T
from ..core.schema import Field, Schema
from ..ops import BarrierInjector, DispatchExecutor, SourceExecutor
from .exchange_net import ExchangeServer

BID_SCHEMA = Schema([
    Field("auction", T.INT64), Field("bidder", T.INT64),
    Field("price", T.INT64), Field("channel", T.VARCHAR),
    Field("url", T.VARCHAR), Field("date_time", T.TIMESTAMP),
    Field("extra", T.VARCHAR)])

def make_bid_source(n_events: int, injector: BarrierInjector,
                    chunk: int = 1024) -> SourceExecutor:
    from ..connectors.nexmark import NexmarkGenerator, NexmarkReader
    reader = NexmarkReader("bid", NexmarkGenerator(), events_per_poll=chunk,
                           max_events=n_events,
                           columns=[f.name for f in BID_SCHEMA.fields])
    return SourceExecutor(BID_SCHEMA, reader, injector,
                          name="Source(bid)", append_only=True)


def run_producer(port: int, n_events: int, k: int,
                 chunk: int = 1024) -> None:
    """Serve the bid stream hash-partitioned over `k` remote channels."""
    injector = BarrierInjector(checkpoint_frequency=1)
    src = make_bid_source(n_events, injector, chunk)
    server = ExchangeServer(port=port)
    chans = [server.register(i, BID_SCHEMA.dtypes) for i in range(k)]
    disp = DispatchExecutor(src, chans, kind="hash", key_indices=[0])
    # drive: one barrier per pump; the bounded reader drains, then a stop
    # barrier flows so every consumer terminates cleanly
    ticks = n_events // (64 * chunk) + 3
    for _ in range(ticks):
        injector.inject()
        if disp.pump_until_barrier() is None:
            break
    injector.inject_stop()
    disp.pump_until_barrier()
    for ch in chans:
        ch.close()
    server.wait_drained(timeout=120)
    server.close()


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) >= 4 and argv[0] == "producer":
        run_producer(int(argv[1]), int(argv[2]), int(argv[3]),
                     int(argv[4]) if len(argv) > 4 else 1024)
        return 0
    print("usage: exchange_demo producer PORT N_EVENTS K [CHUNK]",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
