"""chip_smoke's q4sql and q5sql phases at a small size on the CPU:
Nexmark q4 and q5 from `CREATE SOURCE` + `CREATE MATERIALIZED VIEW`
through the port's `Database` (`DeviceConfig(fuse=False)`,
`torch_device="cpu"`: the device executors' plain versions) over a spill
store. The phases check the plans (device executors, no host agg or
join), q5's state tables against `q5e_graph`'s, the rows against numpy
oracles, q5's against q5e's and a host-only `Database`'s, and q5's
reopen; this file runs them and holds their reports, and checks the
same plans in the JAX package's planner."""
import pytest
import torch

import chip_smoke as C

CPU = torch.device("cpu")
Q4_EVENTS, Q4_CHUNK, Q4_CAP = 1 << 17, 1 << 10, 1 << 8
Q5_EVENTS, Q5_CHUNK, Q5_CAP = 1 << 13, 1 << 6, 1 << 6


def test_q4sql():
    rep = C.q4sql_phase(CPU, "cpu", events=Q4_EVENTS, chunk=Q4_CHUNK,
                        capacity=Q4_CAP, kernels=())
    assert rep["plan"].get("DeviceHashAggExecutor") == 1
    assert "HashAggExecutor" not in rep["plan"]
    # one tick carries 64 chunks; the first carries the source's initial
    # barrier alone and the last none
    assert rep["event_ticks"] == Q4_EVENTS // (64 * Q4_CHUNK)
    assert rep["ticks"] == rep["event_ticks"] + 2
    assert rep["growth_replays"] >= 1
    assert rep["groups"] > 1000


@pytest.fixture(scope="module")
def q5e_rows():
    """q5e's MV rows at this size (the executor graph built by hand)."""
    ns = C.q5e_ns(CPU)
    g = C.q5e_graph(ns, ns.MemoryStateStore(), True, capacity=Q5_CAP,
                    max_capacity=Q5_CAP, poll=64 * Q5_CHUNK)
    C.q5e_drive(g, Q5_EVENTS, 64 * Q5_CHUNK)
    return C.mv_rows(g[2])


def test_q5sql(q5e_rows):
    rep = C.q5sql_phase(CPU, "cpu", q5e_rows, events=Q5_EVENTS,
                        chunk=Q5_CHUNK, capacity=Q5_CAP, kernels=())
    assert rep["plan"]["DeviceHashAggExecutor"] == 3
    assert rep["plan"]["DeviceHashJoinExecutor"] == 1
    # three aggs' tables, the max's multiset, the join's two sides, the MV
    assert rep["state_tables"] == 7
    # the source's catalog id and its split-offset table come first
    assert rep["state_table_id_shift"] == 2
    assert rep["rows"] == len(q5e_rows) > 0
    assert max(rep["growth_replays"].values()) >= 1


def test_q5sql_catches_wrong_rows(q5e_rows):
    """The phase compares with q5e's rows: one row off fails it."""
    bad = list(q5e_rows)
    bad[0] = (bad[0][0] + 1,) + tuple(bad[0][1:])
    with pytest.raises(AssertionError, match="differ from q5e"):
        C.q5sql_phase(CPU, "cpu", bad, events=Q5_EVENTS, chunk=Q5_CHUNK,
                      capacity=Q5_CAP, kernels=())


def test_reference_plans_the_same_state_tables():
    """The JAX package's planner lays q5's state tables out as the port's
    does (ids, dtypes, pks), and q4's plan has the same device agg."""
    from risingwave_tpu.config import DeviceConfig as RDC
    from risingwave_tpu.sql import Database as RDB
    from risingwave_tpu.sql.database import _walk_executors
    ref = RDB(device=RDC(fuse=False, capacity=Q5_CAP),
              checkpoint_frequency=1)
    ref.run(C.SQL_BID_SRC.format(n=Q5_EVENTS, c=Q5_CHUNK))
    ref.run(C.SQL_Q5_MV)
    ref.run(C.SQL_Q4_MV)
    port = C.sql_database(None, CPU, Q5_CAP)
    port.run(C.SQL_BID_SRC.format(n=Q5_EVENTS, c=Q5_CHUNK))
    port.run(C.SQL_Q5_MV)
    port.run(C.SQL_Q4_MV)

    def ref_tables(name):
        tables = {}
        for e in _walk_executors(ref.catalog.get(name)
                                 .runtime["shared"].upstream):
            for attr in ("state_table", "left_state", "right_state"):
                t = getattr(e, attr, None)
                if t is not None and hasattr(t, "table_id"):
                    tables[t.table_id] = t
            for t in list(getattr(e, "minput_tables", ()) or ()) + list(
                    (getattr(e, "state_tables", None) or {}).values()):
                if hasattr(t, "table_id"):
                    tables[t.table_id] = t
        mv = ref.catalog.get(name).runtime["state_table"]
        tables[mv.table_id] = mv
        return [(tid, [repr(d) for d in t.dtypes], list(t.pk_indices))
                for tid, t in sorted(tables.items())]

    for name in ("nexmark_q5", "q4"):
        assert C.sql_state_tables(port, name) == ref_tables(name)
    ref_cls = {}
    for e in _walk_executors(ref.catalog.get("q4").runtime["shared"]
                             .upstream):
        ref_cls[type(e).__name__] = ref_cls.get(type(e).__name__, 0) + 1
    assert C.sql_classes(port, "q4") == ref_cls
