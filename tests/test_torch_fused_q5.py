"""The port's fused Nexmark q5 program (on the CPU) against the JAX
package's fused q5 job, built by the reference SQL front end with
pre-combine on: two HOP(2 s, 10 s) branches — count per (window,
auction), and the max of those counts per window through a retractable
max (a multiset fed the first agg's retracting change stream) — meet in
a join on the window with the non-equi condition num >= maxn.

The port's node graph is built from the reference job's own node
parameters; both jobs are driven barrier by barrier from capacity 16, so
both grow and replay (the multiset too), and must return the same MV rows
in the same (left pk, right pk) order and the same states when carried
across. Armed with the reference's default telemetry, the retractable
max agg (not pre-combined) takes the raw-agg arm (`epoch_topk` over its
change stream), and every armed node's stat slots and `skew_report` rows
must equal the reference's.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

import chip_smoke
import risingwave_tpu.device.fused as JF
from risingwave_tpu.config import DeviceConfig
from risingwave_tpu.sql import Database
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.device.state_io import (states_from_numpy,
                                                  states_to_numpy)
from torch_parity import port_job, port_pack, ref_to_port

N = 4096
CHUNK = 32          # fused epoch = 64 * CHUNK = 2048 events
TICKS = N // (64 * CHUNK) + 2
HALF = 1            # carry-across point: after this many checkpoints
CAP = 16
BID_SRC = ("CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,"
           " channel VARCHAR, url VARCHAR, date_time TIMESTAMP,"
           " extra VARCHAR) WITH (connector='nexmark',"
           " nexmark.table='bid', nexmark.max.events='{n}',"
           " nexmark.chunk.size='{c}')")
Q5 = """CREATE MATERIALIZED VIEW nexmark_q5 AS
SELECT AuctionBids.auction, AuctionBids.num FROM (
    SELECT bid.auction, count(*) AS num, window_start AS starttime
    FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND)
    GROUP BY window_start, bid.auction
) AS AuctionBids
JOIN (
    SELECT max(CountBids.num) AS maxn, CountBids.starttime_c
    FROM (
        SELECT count(*) AS num, window_start AS starttime_c
        FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND)
        GROUP BY bid.auction, window_start
    ) AS CountBids
    GROUP BY CountBids.starttime_c
) AS MaxBids
ON AuctionBids.starttime = MaxBids.starttime_c
   AND AuctionBids.num >= MaxBids.maxn"""

_RUN = {}


def reference_run(armed=False):
    """Drive the reference fused q5 job to the end (capacity 16, so it
    grows and replays); keep its states at the carry-across point. With
    `armed`, key-skew and flow telemetry and the state-tiering recency
    arm ride every keyed node (the reference's default)."""
    if armed not in _RUN:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RW_AGG_PRECOMBINE", "1")
            if armed:
                for k, v in (("RW_SKEW_STATS", "1"), ("RW_FLOW_STATS", "1"),
                             ("RW_STATE_TIERING", "1")):
                    mp.setenv(k, v)
            db = Database(device=DeviceConfig(capacity=CAP,
                                              aot_compile=False))
            db.run(BID_SRC.format(n=N, c=CHUNK))
            db.run(Q5)
            job = db._fused["nexmark_q5"]
            half = None
            for t in range(TICKS):
                db.tick()
                if t + 1 == HALF:
                    half = (jax.device_get(job.states), job.counter)
            _RUN[armed] = (job, half, job.mv_rows_now())
    return _RUN[armed]


def barrier(epoch):
    return SimpleNamespace(is_checkpoint=True,
                           epoch=SimpleNamespace(curr=epoch))


def drive(job, lo, hi):
    for t in range(lo, hi):
        job.on_barrier(barrier(t + 1))
    return job.mv_rows_now()


def test_q5_rows_match_reference():
    ref_job, _, want = reference_run()
    job = port_job(ref_job, CAP)
    assert [type(n).__name__ for n in job.program.nodes] == \
        [type(n).__name__ for n in ref_job.program.nodes]
    kinds = [type(n).__name__ for n in job.program.nodes]
    assert kinds.count("HopNode") == 2 and "JoinNode" in kinds
    got = drive(job, 0, TICKS)
    assert len(got) == len(want) > 0
    assert got == want                 # same rows, same (pk, pk2) order
    # both grow the same way: the same replays, the same capacities —
    # the retractable max's multiset among them
    assert job.growth_replays == ref_job.growth_replays >= 3
    assert [n.cap_current() for n in job.program.nodes] == \
        [n.cap_current() for n in ref_job.program.nodes]
    ms = [n for n in job.program.nodes
          if isinstance(n, PF.AggNode) and n.spec.minputs]
    assert len(ms) == 1 and ms[0].ms_caps[0] > CAP
    assert job.committed == ref_job.committed


def test_q5_state_carry_across():
    """Run the reference halfway, carry its states into the port (and
    back, leaf by leaf), finish the port: the same rows."""
    ref_job, (np_states, counter), want = reference_run()
    job = port_job(ref_job, CAP)
    states = states_from_numpy(job.program, np_states, "cpu")
    back = states_to_numpy(job.program, states)
    n_ms = 0
    for node, st, ref in zip(job.program.nodes, back, np_states):
        got, exp = (jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(ref))
        assert len(got) == len(exp)
        for a, b in zip(got, exp):
            assert a.dtype == np.asarray(b).dtype
            assert np.array_equal(a, np.asarray(b))
        if isinstance(node, PF.AggNode):
            n_ms += len(st.minputs)
    assert n_ms == 1
    job.load_states(states, counter)
    assert drive(job, HALF, TICKS) == want


def test_chip_smoke_q5_builder():
    """chip_smoke's hand-built q5 graph, at this size, has the reference
    plan's packs and returns its SQL-built rows — and its numpy oracle
    agrees."""
    ref_job, _, want = reference_run()
    dev = torch.device("cpu")
    job = chip_smoke.q5_job(dev, N, ref_job.program.epoch_events, CAP)
    packs = [(type(n).__name__, port_pack(n.pack) if hasattr(n, "pack")
              else None) for n in ref_job.program.nodes]
    assert [(type(n).__name__, getattr(n, "pack", None))
            for n in job.program.nodes] == packs
    assert [port_pack(n.pk_pack) for n in ref_job.program.nodes
            if isinstance(n, JF.AggNode) and n.pk_pack is not None] == \
        [n.pk_pack for n in job.program.nodes
         if isinstance(n, PF.AggNode) and n.pk_pack is not None]
    got = drive(job, 0, TICKS)
    assert got == want
    chip_smoke.check_q5_rows(got, chip_smoke.q5_oracle(dev, N))


def test_q5_armed_telemetry_matches_reference():
    """Under the default telemetry and tiering arm: the same rows, the
    same states (touch columns and ticks included), and on each of the
    four keyed nodes — the raw retractable max agg among them — the same
    stat slots (tres and tcold included) and `skew_report` rows."""
    ref_job, _, want = reference_run(armed=True)
    job = port_job(ref_job, CAP)
    at = ref_to_port(ref_job, job)
    assert drive(job, 0, TICKS) == want
    assert job.growth_replays == ref_job.growth_replays
    tiered = [i for i, n in enumerate(ref_job.program.nodes) if n.tier]
    assert len(tiered) == 4 and all(job.program.nodes[at[i]].tier
                                    for i in tiered)
    for st, ref in zip(states_to_numpy(job.program, job.states),
                       jax.device_get(ref_job.states)):
        got, exp = (jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(ref))
        assert len(got) == len(exp)
        for a, b in zip(got, exp):
            assert a.dtype == np.asarray(b).dtype
            assert np.array_equal(a, np.asarray(b))
    armed = [i for i, n in enumerate(ref_job.program.nodes)
             if n.skew and n.flow]
    raw = [i for i in armed if isinstance(ref_job.program.nodes[i], JF.AggNode)
           and not ref_job.program.nodes[i].combined]
    assert len(armed) == 4 and len(raw) == 1
    for i in armed:
        assert job.program.node_stats(at[i], job._stat_totals) == \
            ref_job.program.node_stats(i, ref_job._stat_totals)
    report = [(at[r[0]],) + tuple(r[1:]) for r in ref_job.skew_report()]
    assert job.skew_report() == report
    hot = [r for r in report if r[0] == at[raw[0]] and r[2] == "hot_key"]
    assert hot and all(r[5] > 0 for r in hot)
