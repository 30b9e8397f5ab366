"""The port's fused Nexmark q7 program (on the CPU) against the JAX
package's fused q7 job, built by the reference SQL front end with
pre-combine on: the max price per TUMBLE(10 s) window, joined back to
the bids on price, filtered on date_time BETWEEN window_end - 10 s AND
window_end (the planner's timestamp shift).

The port's node graph is built from the reference job's own node
parameters; both jobs are driven barrier by barrier from capacity 64, so
both grow and replay, and must return the same MV rows in the same
(left pk, right pk) order and the same states when carried across.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from risingwave_tpu.config import DeviceConfig
from risingwave_tpu.sql import Database
from risingwave_tpu_torch.device import fuse_planner as PFP
from risingwave_tpu_torch.device.state_io import (states_from_numpy,
                                                  states_to_numpy)
from risingwave_tpu_torch.expr.expression import InputRef
from risingwave_tpu_torch.core import dtypes as PT
from torch_parity import port_job, port_pack

N = 1 << 17
CHUNK = 1024        # fused epoch = 64 * CHUNK = 65536 events
TICKS = N // (64 * CHUNK) + 2
HALF = 1            # carry-across point: after this many checkpoints
CAP = 64
BID_SRC = ("CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,"
           " channel VARCHAR, url VARCHAR, date_time TIMESTAMP,"
           " extra VARCHAR) WITH (connector='nexmark',"
           " nexmark.table='bid', nexmark.max.events='{n}',"
           " nexmark.chunk.size='{c}')")
Q7 = """CREATE MATERIALIZED VIEW nexmark_q7 AS
SELECT B.auction, B.price, B.bidder, B.date_time
FROM bid B
JOIN (
    SELECT MAX(price) AS maxprice, window_end as date_time
    FROM TUMBLE(bid, date_time, INTERVAL '10' SECOND)
    GROUP BY window_end
) B1 ON B.price = B1.maxprice
WHERE B.date_time BETWEEN B1.date_time - INTERVAL '10' SECOND
      AND B1.date_time"""

_RUN = {}


def reference_run():
    """Drive the reference fused q7 job to the end (capacity 64, so it
    grows and replays); keep its states at the carry-across point."""
    if not _RUN:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RW_AGG_PRECOMBINE", "1")
            db = Database(device=DeviceConfig(capacity=CAP,
                                              aot_compile=False))
            db.run(BID_SRC.format(n=N, c=CHUNK))
            db.run(Q7)
            job = db._fused["nexmark_q7"]
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


def drive(job, lo, hi):
    for t in range(lo, hi):
        job.on_barrier(barrier(t + 1))
    return job.mv_rows_now()


def test_q7_rows_match_reference():
    ref_job, _, want = reference_run()
    job = port_job(ref_job, CAP)
    assert [type(n).__name__ for n in job.program.nodes] == \
        [type(n).__name__ for n in ref_job.program.nodes]
    got = drive(job, 0, TICKS)
    assert len(got) == len(want) == 10
    assert got == want                 # same rows, same (pk, pk2) order
    assert len({r[-1] for r in got}) == 2          # two tumble windows
    assert job.growth_replays == ref_job.growth_replays >= 1
    assert [n.cap_current() for n in job.program.nodes] == \
        [n.cap_current() for n in ref_job.program.nodes]
    assert job.committed == ref_job.committed


def test_q7_state_carry_across():
    """Run the reference halfway, carry its states into the port (and
    back, leaf by leaf), finish the port: the same rows."""
    ref_job, (np_states, counter), want = reference_run()
    job = port_job(ref_job, CAP)
    states = states_from_numpy(job.program, np_states, "cpu")
    for st, ref in zip(states_to_numpy(job.program, states), np_states):
        got, exp = (jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(ref))
        assert len(got) == len(exp)
        for a, b in zip(got, exp):
            assert a.dtype == np.asarray(b).dtype
            assert np.array_equal(a, np.asarray(b))
    job.load_states(states, counter)
    assert drive(job, HALF, TICKS) == want


def test_ts_shift():
    """The planner's timestamp shift: ts + delta, validity passed on."""
    e = PFP._TsShift(InputRef(0, PT.TIMESTAMP), -10_000_000)
    ts = torch.tensor([1_500_000_010_000_000, 0, -5], dtype=torch.int64)
    v, ok = e.eval_device([ts])
    assert v.tolist() == [1_500_000_000_000_000, -10_000_000, -10_000_005]
    assert ok.dtype == torch.bool and bool(ok.all())
    assert e.return_type == PT.TIMESTAMP and e.children()[0].index == 0


def test_chip_smoke_q7_builder():
    """chip_smoke's hand-built q7 graph, at this size, has the reference
    plan's packs and returns its SQL-built rows — and its numpy oracle
    agrees."""
    ref_job, _, want = reference_run()
    dev = torch.device("cpu")
    job = chip_smoke.q7_job(dev, N, ref_job.program.epoch_events, CAP)
    assert [(type(n).__name__, getattr(n, "pack", None))
            for n in job.program.nodes] == \
        [(type(n).__name__, port_pack(n.pack) if hasattr(n, "pack")
          else None) for n in ref_job.program.nodes]
    got = drive(job, 0, TICKS)
    assert got == want
    chip_smoke.check_q7_rows(got, chip_smoke.q7_oracle(dev, N))
