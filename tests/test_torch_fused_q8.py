"""The port's fused Nexmark q8 program (on the CPU) against the JAX
package's fused q8 job, built by the reference SQL front end under the
reference's default arms (key-skew and flow stats and the state-tiering
recency column on every keyed node): two TUMBLE(10 s) distincts —
persons per (id, name, window), sellers per (seller, window) — joined on
(id = seller, window).

The port's node graph is built from the reference job's own node
parameters and telemetry arms, pre-combine on and off; both jobs are
driven barrier by barrier from capacity 64, so both grow and replay, and
must return the same MV rows in the same (left pk, right pk) order, the
same states (touch columns and ticks included; also when carried
across), the same stat slots on every armed node (tres and tcold
included) and the same `skew_report` rows. Exact: there are no floats
but the report's shares, which come from the same integers.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

import bench
import chip_smoke
from risingwave_tpu.config import DeviceConfig
from risingwave_tpu.sql import Database
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.device.state_io import (states_from_numpy,
                                                  states_to_numpy)
from torch_parity import port_job, port_pack, ref_to_port

N = 1 << 15
CHUNK = 128         # fused epoch = 64 * CHUNK = 8192 events
TICKS = N // (64 * CHUNK) + 2
HALF = 2            # carry-across point: after this many checkpoints
CAP = 64
PERSON_SRC = ("CREATE SOURCE person (id BIGINT, name VARCHAR,"
              " email_address VARCHAR, credit_card VARCHAR, city VARCHAR,"
              " state VARCHAR, date_time TIMESTAMP, extra VARCHAR)"
              " WITH (connector='nexmark', nexmark.table='person',"
              " nexmark.max.events='{n}', nexmark.chunk.size='{c}')")
AUCTION_SRC = ("CREATE SOURCE auction (id BIGINT, item_name VARCHAR,"
               " description VARCHAR, initial_bid BIGINT, reserve BIGINT,"
               " date_time TIMESTAMP, expires TIMESTAMP, seller BIGINT,"
               " category BIGINT, extra VARCHAR) WITH (connector='nexmark',"
               " nexmark.table='auction', nexmark.max.events='{n}',"
               " nexmark.chunk.size='{c}')")

_RUN = {}


def reference_run(pre):
    """Drive the reference fused q8 job (telemetry armed, pre-combine
    `pre`) to the end from capacity 64; keep its states at the
    carry-across point."""
    if pre not in _RUN:
        with pytest.MonkeyPatch.context() as mp:
            for k, v in (("RW_SKEW_STATS", "1"), ("RW_FLOW_STATS", "1"),
                         ("RW_STATE_TIERING", "1"),
                         ("RW_AGG_PRECOMBINE", pre)):
                mp.setenv(k, v)
            db = Database(device=DeviceConfig(capacity=CAP,
                                              aot_compile=False))
            db.run(PERSON_SRC.format(n=N, c=CHUNK))
            db.run(AUCTION_SRC.format(n=N, c=CHUNK))
            db.run(bench.Q8_MV)
            job = db._fused["nexmark_q8"]
            half = None
            for t in range(TICKS):
                db.tick()
                if t + 1 == HALF:
                    half = (jax.device_get(job.states), job.counter)
            _RUN[pre] = (job, half, job.mv_rows_now())
    return _RUN[pre]


def barrier(epoch):
    return SimpleNamespace(is_checkpoint=True,
                           epoch=SimpleNamespace(curr=epoch))


def drive(job, lo, hi):
    for t in range(lo, hi):
        job.on_barrier(barrier(t + 1))
    return job.mv_rows_now()


def assert_states_equal(program, states, ref_states):
    for st, ref in zip(states_to_numpy(program, states), ref_states):
        got, exp = (jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(ref))
        assert len(got) == len(exp)
        for a, b in zip(got, exp):
            assert a.dtype == np.asarray(b).dtype
            assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("pre", ["1", "0"])
def test_q8_rows_states_and_telemetry_match_reference(pre):
    ref_job, _, want = reference_run(pre)
    job = port_job(ref_job, CAP)
    at = ref_to_port(ref_job, job)
    kinds = [type(n).__name__ for n in job.program.nodes]
    assert kinds == [type(n).__name__ for n in ref_job.program.nodes]
    assert kinds.count("PrecombineNode") == (2 if pre == "1" else 0)
    got = drive(job, 0, TICKS)
    assert len(got) == len(want) > 0
    assert got == want                 # same rows, same (pk, pk2) order
    assert job.growth_replays == ref_job.growth_replays >= 2
    assert [n.cap_current() for n in job.program.nodes] == \
        [n.cap_current() for n in ref_job.program.nodes]
    assert_states_equal(job.program, job.states,
                        jax.device_get(ref_job.states))
    # the three keyed nodes are armed, and every one of their stat slots
    # (skew and flow ones included) equals the reference's, in the last
    # pulled window and over the job's lifetime
    armed = [i for i, n in enumerate(ref_job.program.nodes)
             if n.skew and n.flow]
    assert [kinds[at[i]] for i in armed] == ["AggNode", "AggNode",
                                             "JoinNode"]
    for i in armed:
        for vec, ref_vec in ((job._stat_totals, ref_job._stat_totals),
                             (job._last_stats, ref_job._last_stats)):
            assert job.program.node_stats(at[i], vec) == \
                ref_job.program.node_stats(i, ref_vec)
    report = [(at[r[0]],) + tuple(r[1:]) for r in ref_job.skew_report()]
    assert job.skew_report() == report
    assert {r[2] for r in report} >= {"vnode_occ", "skew_ratio", "hot_key",
                                      "vnode_traffic", "traffic_skew",
                                      "traffic_div", "traffic_burst"}
    for i in armed:
        assert job.node_skew_ratio(at[i]) == ref_job.node_skew_ratio(i)


def test_q8_state_carry_across():
    """Run the reference halfway, carry its states into the port (and
    back, leaf by leaf), finish the port: the same rows and states."""
    ref_job, (np_states, counter), want = reference_run("1")
    job = port_job(ref_job, CAP)
    states = states_from_numpy(job.program, np_states, "cpu")
    assert_states_equal(job.program, states, np_states)
    job.load_states(states, counter)
    assert drive(job, HALF, TICKS) == want
    assert_states_equal(job.program, job.states,
                        jax.device_get(ref_job.states))


def test_chip_smoke_q8_builder():
    """chip_smoke's hand-built q8 graph, at this size, has the reference
    plan's packs and returns its SQL-built rows; its numpy oracle agrees
    with bench.py's, and its telemetry checks hold."""
    ref_job, _, want = reference_run("1")
    dev = torch.device("cpu")
    job = chip_smoke.q8_job(dev, N, ref_job.program.epoch_events, CAP)
    assert [(type(n).__name__, getattr(n, "pack", None), n.skew, n.flow,
             n.tier) for n in job.program.nodes] == \
        [(type(n).__name__, port_pack(n.pack) if hasattr(n, "pack")
          else None, n.skew, n.flow, n.tier) for n in ref_job.program.nodes]
    assert [port_pack(n.pk_pack) for n in ref_job.program.nodes
            if getattr(n, "pk_pack", None) is not None] == \
        [n.pk_pack for n in job.program.nodes
         if isinstance(n, PF.AggNode)]
    got = drive(job, 0, TICKS)
    assert got == want
    streams = chip_smoke.q8_streams(dev, N)
    (pid, pname, pts), (seller, ats) = streams
    oracle = chip_smoke.numpy_q8(pid, pname, pts, seller, ats)
    pool = job.pull.decoders[1][1]
    assert [(int(i), pool[n], int(w)) for i, n, w in oracle] == \
        bench.numpy_q8(pid, pool[pname], pts, seller, ats)
    chip_smoke.check_q8_rows(got, oracle, pool)
    checked = chip_smoke.check_q8_telemetry(job, streams)
    assert [v["routed_rows"] for v in checked.values()] == \
        [len(pid), len(seller)]
    with pytest.raises(AssertionError):
        chip_smoke.check_q8_rows(got[1:], oracle, pool)
