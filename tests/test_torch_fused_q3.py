"""The port's fused q3a program (on the CPU) against the JAX package's
fused q3a job, built by the reference SQL front end: a filtered inner
equi-join of bids and auctions into a pair MV.

The port's node graph is built from the reference job's own node
parameters (generator config, columns, join keys, pack fields, filter
predicate, projection, epoch cadence); both jobs are driven barrier by
barrier from capacity 64, so both grow and replay, and must return the
same MV rows in the same (bid pk, auction pk) order.
"""
from types import SimpleNamespace

import numpy as np
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import risingwave_tpu.device.fused as JF
from risingwave_tpu.config import DeviceConfig
from risingwave_tpu.core import dtypes as JT
from risingwave_tpu.expr.expression import InputRef, Literal
from risingwave_tpu.expr.functions import build_func
from risingwave_tpu.sql import Database
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.device.state_io import (states_from_numpy,
                                                  states_to_numpy)
from torch_parity import (assert_same, port_expr, port_job, port_pack,
                          torch_dtype)

N = 5_000
CHUNK = 32          # fused epoch = 64 * CHUNK = 2048 events
TICKS = N // (64 * CHUNK) + 3
HALF = 2            # carry-across point: after this many checkpoints
CAP = 64
BID_SRC = ("CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,"
           " channel VARCHAR, url VARCHAR, date_time TIMESTAMP,"
           " extra VARCHAR) WITH (connector='nexmark',"
           " nexmark.table='bid', nexmark.max.events='{n}',"
           " nexmark.chunk.size='{c}')")
AUCTION_SRC = ("CREATE SOURCE auction (id BIGINT, item_name VARCHAR,"
               " description VARCHAR, initial_bid BIGINT, reserve BIGINT,"
               " date_time TIMESTAMP, expires TIMESTAMP, seller BIGINT,"
               " category BIGINT, extra VARCHAR) WITH (connector='nexmark',"
               " nexmark.table='auction', nexmark.max.events='{n}',"
               " nexmark.chunk.size='{c}')")
Q3A = ("CREATE MATERIALIZED VIEW q3a AS SELECT b.auction, b.price,"
       " a.seller, a.category FROM bid b JOIN auction a"
       " ON b.auction = a.id WHERE b.price > 500")

_RUN = {}


def reference_run():
    """Drive the reference fused q3a job to the end (capacity 64, so it
    grows and replays); keep its states at the carry-across point."""
    if not _RUN:
        db = Database(device=DeviceConfig(capacity=CAP, aot_compile=False))
        db.run(BID_SRC.format(n=N, c=CHUNK))
        db.run(AUCTION_SRC.format(n=N, c=CHUNK))
        db.run(Q3A)
        job = db._fused["q3a"]
        half = None
        for t in range(TICKS):
            db.tick()
            if t + 1 == HALF:
                half = (jax.device_get(job.states), job.counter)
        _RUN["run"] = (job, half, job.mv_rows_now())
    return _RUN["run"]


def barrier(epoch):
    return SimpleNamespace(is_checkpoint=True,
                           epoch=SimpleNamespace(curr=epoch))


def test_q3a_rows_match_reference():
    ref_job, _, want = reference_run()
    job = port_job(ref_job, CAP)
    assert [type(n).__name__ for n in job.program.nodes] == \
        [type(n).__name__ for n in ref_job.program.nodes]
    for t in range(TICKS):
        job.on_barrier(barrier(t + 1))
    got = job.mv_rows_now()
    assert len(got) == len(want) > 0
    assert got == want                 # same rows, same (pk, pk2) order
    assert job.growth_replays >= 1     # capacity 64 had to grow
    assert ref_job.growth_replays >= 1
    assert job.committed == ref_job.committed


def test_q3a_state_carry_across():
    """Run the reference halfway, carry its states into the port (and
    back, leaf by leaf), finish the port: the same rows."""
    ref_job, (np_states, counter), want = reference_run()
    job = port_job(ref_job, CAP)
    states = states_from_numpy(job.program, np_states, "cpu")
    back = states_to_numpy(job.program, states)
    for st, ref in zip(back, np_states):
        got, exp = (jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(ref))
        assert len(got) == len(exp)
        for a, b in zip(got, exp):
            assert a.dtype == np.asarray(b).dtype
            assert np.array_equal(a, np.asarray(b))
    job.load_states(states, counter)
    for t in range(HALF, TICKS):
        job.on_barrier(barrier(t + 1))
    assert job.mv_rows_now() == want


def test_chip_smoke_q3a_builder():
    """chip_smoke's hand-built q3a graph, at this size, returns the
    reference's SQL-built rows — and its numpy oracle agrees."""
    ref_job, _, want = reference_run()
    dev = torch.device("cpu")
    job = chip_smoke.q3a_job(dev, N, ref_job.program.epoch_events, CAP)
    assert job.program.nodes[2].pack == port_pack(ref_job.program.nodes[2]
                                                  .pack)
    for t in range(TICKS):
        job.on_barrier(barrier(t + 1))
    got = job.mv_rows_now()
    assert got == want
    chip_smoke.check_q3a_rows(got, chip_smoke.q3a_oracle(dev, N))


def test_join_filter_mvpair_nodes():
    """JoinNode (with a non-equi condition), FilterNode and MVPairNode
    applied node by node: every leaf of states, deltas and stats equal."""
    ref_job, _, _ = reference_run()
    jj = ref_job.program.nodes[2]
    cond = build_func("less_than", [InputRef(1, JT.INT64),
                                    InputRef(3, JT.INT64)])
    pred = build_func("and", [
        build_func("greater_than", [InputRef(2, JT.INT64),
                                    Literal(0, JT.INT64)]),
        build_func("not", [build_func("equal", [InputRef(0, JT.INT64),
                                                Literal(3, JT.INT64)])])])
    dts = [jnp.int64, jnp.int64, jnp.float64]
    rj = [JF.JoinNode(0, 1, [0], [0], jj.pack, cond, 16, 32, dts, dts),
          JF.FilterNode(2, pred), JF.MVPairNode(3, dts + dts, 16)]
    rp = [PF.JoinNode(0, 1, [0], [0], port_pack(jj.pack), port_expr(cond),
                      16, 32, [torch_dtype(d) for d in dts],
                      [torch_dtype(d) for d in dts], device="cpu"),
          PF.FilterNode(2, port_expr(pred), device="cpu"),
          PF.MVPairNode(3, [torch_dtype(d) for d in dts + dts], 16, device="cpu")]
    sj = [n.init_state() for n in rj]
    sp = [n.init_state() for n in rp]
    assert_same(sp, sj)
    rng = np.random.default_rng(3)
    n = 24
    for _ in range(3):
        ins = []
        for _side in range(2):
            key = rng.integers(1000, 1006, n)
            cols = [key, rng.integers(-5, 5, n), rng.normal(0, 1, n)]
            sign = rng.choice([-1, 1, 1], n).astype(np.int32)
            mask = rng.random(n) < 0.9
            pk = rng.integers(0, 40, n)
            ins.append((cols, sign, mask, pk))
        jd = [JF.Delta([jnp.asarray(c) for c in cols], jnp.asarray(sg),
                       jnp.asarray(mk), pk=jnp.asarray(pk))
              for cols, sg, mk, pk in ins]
        pd = [PF.Delta([torch.from_numpy(c) for c in cols],
                       torch.from_numpy(sg), torch.from_numpy(mk),
                       pk=torch.from_numpy(pk))
              for cols, sg, mk, pk in ins]
        for i, (a, b) in enumerate(zip(rj, rp)):
            sj[i], jd, jstats, _ = a.apply(sj[i], jd, None, n)
            sp[i], pd, pstats, _ = b.apply(sp[i], pd, None, n)
            assert_same((sp[i], pd, pstats), (sj[i], jd, jstats))
            jd, pd = [jd], [pd]
