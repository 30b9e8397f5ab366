"""The port's host Nexmark source against the JAX package's: the
`NexmarkReader` chunks of the person, auction and bid tables equal column
by column over seeds, poll sizes and key distributions, and the twelve
graphs of the reference's tests/test_e2e_slice.py (source -> filter /
project -> materialize under the barrier loop, and the generator's own
checks) run in both packages with equal traces."""
from decimal import Decimal

import numpy as np
import pytest

from host_parity import (D, I, PKGS, UD, UI, assert_same, drive_job,
                         fixed_epochs, norm_chunk)  # noqa: F401


def reader_chunks(P, table, seed, poll, key_dist, strings_on=True,
                  columns=None, events=3000):
    cfg = P.conn.NexmarkConfig(seed=seed, key_dist=key_dist,
                               strings_on=strings_on)
    r = P.conn.NexmarkReader(table, P.conn.NexmarkGenerator(cfg),
                             events_per_poll=poll, max_events=events,
                             columns=columns)
    out = []
    while True:
        c = r.poll()
        if c is None:
            break
        out.append(norm_chunk(c))
    return out + [r.next_event, r.split_states()]


@pytest.mark.parametrize("key_dist", ["", "zipf:1.5"], ids=["hot", "zipf"])
@pytest.mark.parametrize("seed,poll", [(0, 1000), (7, 333), (1 << 33, 4096)])
@pytest.mark.parametrize("table", ["person", "auction", "bid"])
def test_reader_chunks(table, seed, poll, key_dist):
    ref, port = (reader_chunks(P, table, seed, poll, key_dist)
                 for P in PKGS)
    assert_same(ref, port)


@pytest.mark.parametrize("table,columns", [
    ("bid", ["date_time", "auction", "price"]), ("person", ["id", "name"])])
def test_reader_projection_without_strings(table, columns):
    for strings_on in (False, True):
        ref, port = (reader_chunks(P, table, 3, 700, "", strings_on,
                                   columns) for P in PKGS)
        assert_same(ref, port)


def test_reader_unknown_column_raises():
    for P in PKGS:
        with pytest.raises(ValueError, match="no columns"):
            P.conn.NexmarkReader("bid", P.conn.NexmarkGenerator(),
                                 columns=["nope"])


def test_port_reader_reads_port_key_dist():
    """The zipf picks parse their exponent with the port's own
    `device/nexmark_gen.key_dist_s` (and refuse s <= 1 the same way)."""
    for P in PKGS:
        gen = P.conn.NexmarkGenerator(P.conn.NexmarkConfig(key_dist="zipf:1"))
        with pytest.raises(ValueError, match="exponent"):
            gen.gen_range(0, 100)


# ---------------------------------------------------------------------------
# tests/test_e2e_slice.py's graphs, in both packages
# ---------------------------------------------------------------------------


def make_job(P, reader, schema, exprs=None, predicate=None, pk=(0,),
             conflict="NO_CHECK", checkpoint_frequency=1):
    store = P.state.MemoryStateStore()
    inj = P.ops.BarrierInjector(checkpoint_frequency=checkpoint_frequency)
    src = P.ops.SourceExecutor(schema, reader, inj,
                               split_state_table=P.state.StateTable(
                                   store, 900, [P.T.VARCHAR, P.T.VARCHAR],
                                   [0]))
    node = src
    if predicate is not None:
        node = P.ops.FilterExecutor(node, predicate)
    if exprs is not None:
        node = P.ops.ProjectExecutor(node, exprs)
    table = P.state.StateTable(store, 1, node.schema.dtypes, list(pk))
    mat = P.ops.MaterializeExecutor(node, table,
                                    getattr(P.ops.ConflictBehavior, conflict))
    return mat, inj, store, table


def _q1(P):
    gen = P.conn.NexmarkGenerator(P.conn.NexmarkConfig(seed=7))
    reader = P.conn.NexmarkReader("bid", gen, events_per_poll=500,
                                  max_events=2000)
    exprs = [P.ref(0, "INT64"), P.ref(1, "INT64"),
             P.func("multiply", P.lit(Decimal("0.908"), "DECIMAL"),
                    P.ref(2, "INT64")),
             P.ref(5, "TIMESTAMP")]
    mat, inj, store, _ = make_job(P, reader, P.conn.BID_SCHEMA, exprs=exprs,
                                  pk=(0, 1, 3))
    return drive_job(P, mat, inj, [store])


def _q2(P):
    gen = P.conn.NexmarkGenerator(P.conn.NexmarkConfig(seed=3))
    reader = P.conn.NexmarkReader("bid", gen, events_per_poll=1000,
                                  max_events=5000)
    pred = P.func("equal", P.func("modulus", P.ref(0, "INT64"),
                                  P.lit(123, "INT64")), P.lit(0, "INT64"))
    exprs = [P.ref(0, "INT64"), P.ref(2, "INT64"), P.ref(5, "TIMESTAMP")]
    mat, inj, store, _ = make_job(P, reader, P.conn.BID_SCHEMA, exprs=exprs,
                                  predicate=pred, pk=(0, 1, 2))
    return drive_job(P, mat, inj, [store])


def _list(P, kinds, chunks, **kw):
    reader = P.ListReader([P.chunk(kinds, c) for c in chunks])
    mat, inj, store, _ = make_job(P, reader, P.schema(kinds, ["k", "v"][
        :len(kinds)]), **kw)
    return drive_job(P, mat, inj, [store])


def _update_pairs(P):
    pred = P.func("less_than", P.ref(1, "INT64"), P.lit(50, "INT64"))
    return _list(P, ["INT64", "INT64"], [
        [(I, (1, 10)), (I, (2, 100))],
        [(UD, (1, 10)), (UI, (1, 200)), (UD, (2, 100)), (UI, (2, 30))]],
        predicate=pred, conflict="OVERWRITE")


def _overwrite(P):
    return _list(P, ["INT64", "VARCHAR"], [
        [(I, (1, "a")), (I, (1, "b")), (I, (2, "c"))]], conflict="OVERWRITE")


def _deletes_updates(P):
    return _list(P, ["INT64", "INT64"], [
        [(I, (i, i * 10)) for i in range(5)],
        [(D, (2, 20)), (UD, (3, 30)), (UI, (3, 99))]])


def _barrier_commit(P):
    reader = P.ListReader([P.chunk(["INT64"], [(I, (1,))])])
    mat, inj, store, _ = make_job(P, reader, P.schema(["INT64"]))
    job = P.StreamJob(mat, inj, store)
    b1 = job.run_until_barrier()
    out = [b1.kind.name, job.barriers_seen]
    job.flush()
    return out + [job.committed_epoch, store.committed_epoch,
                  job.barriers_seen]


def _checkpoint_frequency(P):
    mat, inj, store, _ = make_job(P, P.ListReader([]), P.schema(["INT64"]),
                                  checkpoint_frequency=3)
    job = P.StreamJob(mat, inj, store)
    return [job.run_until_barrier().kind.value for _ in range(7)]


def _split_recovery(P):
    gen = P.conn.NexmarkGenerator()
    store = P.state.MemoryStateStore()
    inj = P.ops.BarrierInjector()
    split = P.state.StateTable(store, 900, [P.T.VARCHAR, P.T.VARCHAR], [0])
    reader = P.conn.NexmarkReader("bid", gen, events_per_poll=100,
                                  max_events=300)
    src = P.ops.SourceExecutor(P.conn.BID_SCHEMA, reader, inj, split)
    table = P.state.StateTable(store, 1, P.conn.BID_SCHEMA.dtypes,
                               [0, 1, 5])
    trace = drive_job(P, P.ops.MaterializeExecutor(src, table), inj,
                      [store])
    reader2 = P.conn.NexmarkReader("bid", gen, events_per_poll=100)
    inj2 = P.ops.BarrierInjector()
    src2 = P.ops.SourceExecutor(P.conn.BID_SCHEMA, reader2, inj2, split)
    it = src2.execute()
    inj2.inject()
    next(it)
    return trace + [reader.next_event, reader2.next_event]


def _gen(fn):
    def run(P):
        return fn(P, P.conn.NexmarkGenerator)
    return run


def _deterministic(P, G):
    c1 = G(P.conn.NexmarkConfig(seed=5)).gen_range(0, 1000)
    c2 = G(P.conn.NexmarkConfig(seed=5)).gen_range(0, 1000)
    assert all(c1[k].rows() == c2[k].rows() for k in c1)
    return [(k, norm_chunk(c1[k])) for k in sorted(c1)]


def _proportions(P, G):
    out = G().gen_range(0, 5000)
    return [(k, out[k].capacity) for k in sorted(out)]


def _plausibility(P, G):
    out = G().gen_range(0, 5000)
    ids = out["auction"].columns[0].values
    bids = out["bid"].columns[0].values
    return [int(ids.min()), int(ids.max()), int(bids.min()),
            int(bids.max())]


def _timestamps(P, G):
    out = G().gen_range(0, 2000)
    return [(k, out[k].columns[{"person": 6, "auction": 5,
                                "bid": 5}[k]].values.tolist())
            for k in sorted(out)]


E2E_CASES = {"q1_currency_conversion": _q1, "q2_filter_and_project": _q2,
             "update_pairs_through_filter": _update_pairs,
             "materialize_overwrite_conflict": _overwrite,
             "deletes_and_updates": _deletes_updates,
             "barrier_epochs_commit": _barrier_commit,
             "checkpoint_frequency": _checkpoint_frequency,
             "source_split_recovery": _split_recovery,
             "gen_deterministic": _gen(_deterministic),
             "gen_proportions": _gen(_proportions),
             "gen_referential_plausibility": _gen(_plausibility),
             "gen_timestamps_monotone": _gen(_timestamps)}


@pytest.mark.parametrize("case", list(E2E_CASES))
def test_e2e_slice(fixed_epochs, case):
    ref, port = (E2E_CASES[case](P) for P in PKGS)
    assert_same(ref, port)
