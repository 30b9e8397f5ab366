"""q5e at a small size on the CPU: Nexmark q5 as the planner's executor
graph (chip_smoke.q5e_graph) with the port's device executors on
`device="cpu"` (their plain versions) over a `SpillStateStore`. Its MV
must equal the host twin's (the same graph of host executors, what the
planner builds without a `DeviceConfig`), the JAX package's same device
graph's — every state table too — and the numpy q5 oracle over the
readers' bids; every engine grows and replays; a second store opened on
the directory reads every state table back equal."""
from types import SimpleNamespace

import pytest
import torch

import chip_smoke as C

EVENTS, EPOCH, POLL = 1 << 13, 1 << 11, 1 << 10
CAP, MAX_CAP = 1 << 6, 1 << 3


def ref_ns():
    """The JAX package's names for `q5e_graph` (its device executors take
    no `device=`)."""
    from risingwave_tpu import ops
    from risingwave_tpu.connectors import nexmark as NX
    from risingwave_tpu.core import dtypes as T
    from risingwave_tpu.expr import AggCall, InputRef, build_func
    from risingwave_tpu.ops import device_agg as DA
    from risingwave_tpu.ops.device_join import DeviceHashJoinExecutor
    from risingwave_tpu.runtime import StreamJob
    from risingwave_tpu.state import (MemoryStateStore, SpillStateStore,
                                      StateTable)
    return SimpleNamespace(
        ops=ops, DeviceHashJoinExecutor=DeviceHashJoinExecutor, T=T,
        StateTable=StateTable, StreamJob=StreamJob,
        MemoryStateStore=MemoryStateStore, SpillStateStore=SpillStateStore,
        NexmarkConfig=NX.NexmarkConfig, NexmarkGenerator=NX.NexmarkGenerator,
        NexmarkReader=NX.NexmarkReader, BID_SCHEMA=NX.BID_SCHEMA,
        InputRef=InputRef, AggCall=AggCall, build_func=build_func,
        parse_interval=T.parse_interval,
        payload_dtypes=DA.device_payload_dtypes,
        minput_count=DA.device_minput_count, exec_kw={})


def run(ns, store, device):
    g = C.q5e_graph(ns, store, device, capacity=CAP, max_capacity=MAX_CAP,
                    poll=POLL)
    C.q5e_drive(g, EVENTS, EPOCH)
    return g


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    port = C.q5e_ns(torch.device("cpu"))
    d = str(tmp_path_factory.mktemp("q5e_port"))
    dev = run(port, port.SpillStateStore(d), True)
    twin = run(port, port.MemoryStateStore(), False)
    ref = ref_ns()
    rdev = run(ref, ref.MemoryStateStore(), True)
    return SimpleNamespace(port=port, ref=ref, dir=d, dev=dev, twin=twin,
                           rdev=rdev)


def test_rows_equal_twin_reference_and_oracle(graphs):
    rows = C.mv_rows(graphs.dev[2])
    assert rows, "q5e produced no rows"
    assert rows == C.mv_rows(graphs.twin[2])
    assert rows == C.mv_rows(graphs.rdev[2])
    C.check_q5_rows(rows, C.q5e_oracle(graphs.port, EVENTS))
    # the numpy oracle over the reference reader's bids is the same
    assert C.q5e_oracle(graphs.ref, EVENTS) == C.q5e_oracle(graphs.port,
                                                            EVENTS)


def test_state_tables_equal_reference(graphs):
    """Same table ids, layouts and rows as the JAX package's graph."""
    mine, theirs = graphs.dev[4], graphs.rdev[4]
    assert [(t.table_id, [repr(d) for d in t.dtypes], t.pk_indices)
            for t in mine] == [(t.table_id, [repr(d) for d in t.dtypes],
                                t.pk_indices) for t in theirs]
    for a, b in zip(mine, theirs):
        assert list(a.iter_all()) == list(b.iter_all()), a.table_id


def test_every_engine_grew(graphs):
    devs = graphs.dev[1]
    assert [type(d).__name__ for d in devs] == (
        ["DeviceHashAggExecutor"] * 3 + ["DeviceHashJoinExecutor"])
    assert all(d.engine.growth_replays >= 1 for d in devs), \
        [d.engine.growth_replays for d in devs]
    assert devs[2].spec.minputs, "the max agg keeps no multiset"


def test_reopened_store_equals_live(graphs):
    counts = C.check_reopened(graphs.dir, graphs.dev[4], graphs.port)
    assert len(counts) == 7 and all(n > 0 for n in counts.values())
    size, runs = C.dir_usage(graphs.dir)
    assert size > 0 and runs > 0
