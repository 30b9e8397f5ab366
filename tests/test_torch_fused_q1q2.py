"""The port's fused q1c and q2c jobs (on the CPU) against the JAX
package's, built by the reference SQL front end: Nexmark q1's currency
conversion over a per-bidder aggregate, and q2's selection over a
per-auction aggregate — the paths whose Map and Filter compute, so the
port runs them through the `expr_eval` program.

    q1c: Source -> Map[$1, divide(multiply($2, 908), 1000), ...]
         -> Precombine -> Agg -> MVKeyed
    q2c: Source -> Filter[equal(modulus($0, 123), 0)] -> Map[$0, $2]
         -> Precombine -> Agg -> MVKeyed

The port's node graph is rebuilt from the reference job's own nodes
(`torch_parity.port_job`, expressions through the port's `build_func`);
both are driven barrier by barrier and must return the same MV rows in
the same (key) order, with pre-combine on and off.
"""
from types import SimpleNamespace

import pytest

from risingwave_tpu.config import DeviceConfig
from risingwave_tpu.sql import Database
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.kernels.expr_eval import OP_NAMES
from torch_parity import port_job

N = 5_000
CHUNK = 32          # fused epoch = 64 * CHUNK = 2048 events
TICKS = N // (64 * CHUNK) + 3
CAP = 512
BID_SRC = ("CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,"
           " channel VARCHAR, url VARCHAR, date_time TIMESTAMP,"
           " extra VARCHAR) WITH (connector='nexmark',"
           " nexmark.table='bid', nexmark.max.events='{n}',"
           " nexmark.chunk.size='{c}')")
QUERIES = {
    "q1c": ("CREATE MATERIALIZED VIEW q1c AS SELECT bidder, count(*) AS n,"
            " sum(price * 908 / 1000) AS dol_eur,"
            " max(price * 908 / 1000) AS top_eur FROM bid GROUP BY bidder"),
    "q2c": ("CREATE MATERIALIZED VIEW q2c AS SELECT auction, count(*) AS n,"
            " sum(price) AS dol FROM bid WHERE auction % 123 = 0"
            " GROUP BY auction"),
}
SHAPES = {"q1c": ["SourceNode", "MapNode", "PrecombineNode", "AggNode",
                  "MVKeyedNode"],
          "q2c": ["SourceNode", "FilterNode", "MapNode", "PrecombineNode",
                  "AggNode", "MVKeyedNode"]}
# q1c's Map computes price * 908 / 1000 twice (for sum and for max)
PROGRAMS = {"q1c": ["col", "lit", "multiply", "lit", "divide", "out"] * 2,
            "q2c": ["col", "lit", "modulus", "lit", "equal", "mask"]}

_RUNS = {}


def reference_run(name, precombine):
    """Drive the reference fused job to the end (capacity 512)."""
    key = (name, precombine)
    if key not in _RUNS:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RW_AGG_PRECOMBINE", precombine)
            db = Database(device=DeviceConfig(capacity=CAP,
                                              aot_compile=False))
            db.run(BID_SRC.format(n=N, c=CHUNK))
            db.run(QUERIES[name])
            job = db._fused[name]
            for _ in range(TICKS):
                db.tick()
            _RUNS[key] = (job, job.mv_rows_now())
    return _RUNS[key]


def flat_nodes(job):
    out = []
    for n in job.program.nodes:
        out += list(getattr(n, "chain", [n]))
    return out


@pytest.mark.parametrize("precombine", ["1", "0"])
@pytest.mark.parametrize("name", ["q1c", "q2c"])
def test_rows_match_reference(name, precombine):
    ref_job, want = reference_run(name, precombine)
    shape = [type(n).__name__ for n in flat_nodes(ref_job)]
    assert shape == [s for s in SHAPES[name]
                     if precombine == "1" or s != "PrecombineNode"]
    job = port_job(ref_job, CAP)
    # the computing node lowered to one program, the q4-like Maps to none
    lowered = [n.lowered.declared for n in flat_nodes(job)
               if isinstance(n, (PF.MapNode, PF.FilterNode)) and n.lowered]
    assert [[OP_NAMES[o] for o, _, _ in p.ins] for p in lowered] == \
        [PROGRAMS[name]]
    for t in range(TICKS):
        job.on_barrier(SimpleNamespace(is_checkpoint=True,
                                       epoch=SimpleNamespace(curr=t + 1)))
    got = job.mv_rows_now()
    assert len(got) == len(want) > 0
    assert got == want                       # same rows, same key order
    assert job.committed == ref_job.committed
