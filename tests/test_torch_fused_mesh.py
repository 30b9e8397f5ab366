"""The port's fused programs on a shard mesh (`device/shard_exec.py`)
against the JAX package's 1-shard fused runs.

The reference's contract is that an n-shard fused run equals the 1-shard
run bit for bit, row order included. The port's q4 (raw and
pre-combined), q3a and q5 at 8 shards and at 3 (a cadence that does not
divide, so the last source shard's block is padded) are held against
the reference's 1-shard rows and the port's own 1-shard rows, in order;
the row-flow totals against the 1-shard run's; an exchange bucket forced
to 4 slots must overflow, grow and replay; a mesh program's states carry
across through `state_io` in the reference's sharded layout; a host-fed
tiered group-by runs at 3 shards with per-shard feeds and cold stores.
The reference's own 8-shard runs are the oracle of
`test_torch_sql_mirror_mesh_fused.py` and
`test_torch_sql_mirror_mesh_skew.py` (under `torch_ref_mesh.ref_mesh()`)."""
import numpy as np
import pytest

import jax

import risingwave_tpu.device.shard_exec as JSE
import test_torch_fused_q3 as F3
import test_torch_fused_q4 as F4
import test_torch_fused_q5 as F5
from risingwave_tpu.parallel.mesh import make_mesh as jmake_mesh
from risingwave_tpu_torch.device import capacity as pcap
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.device.state_io import (states_from_numpy,
                                                  states_to_numpy)
from risingwave_tpu_torch.parallel.mesh import make_mesh
from torch_parity import assert_same, port_job

QUERIES = {
    "q4": (lambda: F4.reference_run("0"), 64, F4.TICKS),
    "q4_combined": (lambda: F4.reference_run("1"), 64, F4.TICKS),
    "q3a": (F3.reference_run, F3.CAP, F3.TICKS),
    "q5": (F5.reference_run, F5.CAP, F5.TICKS),
}


def barrier(epoch):
    return F4.barrier(epoch)


def run(job, ticks):
    for t in range(ticks):
        job.on_barrier(barrier(t + 1))
    return job.mv_rows_now()


_SINGLE = {}


def single(q):
    """The reference job, its 1-shard rows, and the port's 1-shard job
    and rows."""
    if q not in _SINGLE:
        ref_fn, cap, ticks = QUERIES[q]
        ref_job, _, want = ref_fn()
        job = port_job(ref_job, cap)
        _SINGLE[q] = (ref_job, want, job, run(job, ticks))
    return _SINGLE[q]


def flow_totals(job):
    """Every node's row-flow totals (the SUM slots) of the committed run,
    but a pre-combine's output count: it combines shard by shard, before
    the exchange, so a group seen by k source shards leaves it k times."""
    prog = job.program
    return {(i, nm): int(job._stat_totals[k])
            for k, (i, nm) in enumerate(prog.stat_layout)
            if nm in prog.nodes[i].stat_sums
            and not (nm == "rows_out"
                     and isinstance(prog.nodes[i], PF.PrecombineNode))}


@pytest.mark.parametrize("n", [8, 3])
@pytest.mark.parametrize("q", list(QUERIES))
def test_mesh_rows_equal_single_shard(q, n):
    ref_job, want, one, one_rows = single(q)
    _, cap, ticks = QUERIES[q]
    mesh = make_mesh(n, devices=["cpu"])
    job = port_job(ref_job, cap, mesh=mesh)
    assert job.mesh_shards == n
    got = run(job, ticks)
    assert len(got) == len(want) > 0
    assert got == want                       # same rows, same order
    assert one_rows == want
    assert flow_totals(job) == flow_totals(one)
    assert job.committed == ref_job.committed
    exch = [nd for nd in job.program.nodes if nd.exch is not None]
    assert exch and all(nd.stat_names[-1] == "exch" for nd in exch)
    if n == 3:
        assert job.program.epoch_events % n     # the tail really pads


def test_exchange_overflow_grows_and_replays(monkeypatch):
    """tests/test_mesh_fused.py:203 — a send bucket of 4 slots overflows
    the "exch" stat, grows through the normal replay path, and the rows
    still equal the 1-shard run's."""
    monkeypatch.setattr(pcap, "exchange_cap",
                        lambda epoch_events, n_shards, lo=4: 4)
    ref_job, want, _, _ = single("q4")
    job = port_job(ref_job, 512, mesh=make_mesh(8, devices=["cpu"]))
    assert all(nd.exch == 4 for nd in job.program.nodes
               if nd.exch is not None)
    assert run(job, F4.TICKS) == want
    assert job.growth_replays >= 1
    grown = [nd.exch for nd in job.program.nodes if nd.exch is not None]
    assert grown and all(e > 4 for e in grown)


def test_mesh_states_carry_across():
    """A mesh program's states in the reference's sharded layout: the
    initial states match the reference's `lift_tree` leaf for leaf, and a
    run carried across mid-way through `state_io` ends with the same
    rows."""
    ref_job, want, _, _ = single("q3a")
    mesh = make_mesh(8, devices=["cpu"])
    job = port_job(ref_job, F3.CAP, mesh=mesh)
    init = states_to_numpy(job.program, job.program.init_states())
    for port_st, ref_node in zip(init, ref_job.program.nodes):
        ref_st = jax.device_get(JSE.lift_tree(ref_node.init_state(),
                                              jmake_mesh(8))) \
            if ref_node.init_state() is not None else None
        if ref_st is None:
            assert port_st is None
            continue
        # the reference node's capacity may have grown in its own run;
        # compare the layout: tree, dtypes, leading shard axis
        p, r = jax.tree_util.tree_leaves(port_st), \
            jax.tree_util.tree_leaves(ref_st)
        assert len(p) == len(r)
        for a, b in zip(p, r):
            assert a.dtype == b.dtype and a.shape[0] == b.shape[0] == 8
    for t in range(2):
        job.on_barrier(barrier(t + 1))
    np_states = states_to_numpy(job.program, job.states)
    job2 = port_job(ref_job, F3.CAP, mesh=mesh)
    states = states_from_numpy(job2.program, np_states)
    assert_same(states_to_numpy(job2.program, states), np_states)
    job2.load_states(states, job.counter)
    for t in range(2, F3.TICKS):
        job2.on_barrier(barrier(t + 1))
    assert job2.mv_rows_now() == want


def test_tiering_and_ingest_run_under_mesh():
    """Host ingest and state tiering now run under a mesh: the
    reference's host-fed q1a-shaped group-by under a tier clamp, rebuilt
    for the port at 3 shards (a cadence that does not divide) with
    per-shard feeds and per-shard cold stores, returns the reference's
    1-shard rows in order, demotes on more than one shard, and every
    demoted key sits in the store of the shard that owns its vnode."""
    import test_torch_fused_tiering as FT
    from risingwave_tpu_torch.core.vnode import vnodes_i64
    from risingwave_tpu_torch.parallel.mesh import shard_of_vnode
    n = 3
    with pytest.MonkeyPatch.context() as mp:
        FT._arm(mp)
        ref_job, want, ticks, _ = FT.reference_run(
            FT.QA_MV, "qa", 512, 16384, 8, hbm_mb=1)
        job = port_job(ref_job, 256, mesh=make_mesh(n, devices=["cpu"]))
        assert job.ingest is not None and job.ingest.n_shards == n
        assert job.tiering is not None and job.tiering.n_shards == n
        assert job.program.epoch_events % n        # the last block pads
        rows = FT.port_run(job, ticks)
    assert len(rows) == len(want) > 3 * 256
    assert rows == want                          # 1-shard rows, in order
    tm = job.tiering
    assert tm.counters["promotions"] > 0
    assert tm.counters["demotions"] > 0
    store = tm.store(next(p.node_idx for p in tm.plans), -1)
    held = [np.asarray(list(store.rows[s].keys()), np.int64)
            for s in range(n)]
    assert sum(1 for h in held if len(h)) >= 2
    for s, h in enumerate(held):
        if len(h):
            own = shard_of_vnode(vnodes_i64(h), n)
            assert (np.asarray(own) == s).all()
