"""The port's host-ingest feed (on the CPU) against the JAX package's:
`connectors/nexmark.gen_surrogates` bit for bit against the port's device
generator and the reference's host generator; `device/ingest.HostIngest`
staging, prefetch, retention and trim; and host-fed fused jobs — a
q1a-shaped agg and the q3a join, built by the reference SQL front end
with host ingest armed (`tests/test_ingest.py:143-196` shapes) — whose
rows equal the reference's host-fed rows and the port's device-datagen
rows, across growth replays that re-pack the retained windows.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from risingwave_tpu.config import DeviceConfig
from risingwave_tpu.connectors import nexmark as JN
from risingwave_tpu.sql import Database
from risingwave_tpu_torch.connectors import nexmark as PN
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.device.ingest import HostIngest, NexmarkIngestSource
from risingwave_tpu_torch.device.nexmark_gen import GenCfg, gen_table
from torch_parity import port_job

N = 4096
CHUNK = 32          # fused epoch = 64 * CHUNK = 2048 events
TICKS = N // (64 * CHUNK) + 3
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
Q1_MV = ("CREATE MATERIALIZED VIEW q1a AS SELECT bidder,"
         " count(*) AS n, sum(price) AS dol, max(price) AS top"
         " FROM bid GROUP BY bidder")
Q3_MV = ("CREATE MATERIALIZED VIEW q3a AS SELECT b.auction, b.price,"
         " a.seller, a.category FROM bid b JOIN auction a"
         " ON b.auction = a.id WHERE b.price > 500")
KIND = {"person": 0, "auction": 1, "bid": 2}


@pytest.mark.parametrize("key_dist", ["", "zipf:1.5"])
@pytest.mark.parametrize("table", ["bid", "auction", "person"])
def test_gen_surrogates_bit_identical(table, key_dist):
    cfg = GenCfg.from_config(PN.NexmarkConfig(key_dist=key_dist))
    ref_cfg = JN.NexmarkConfig(key_dist=key_dist)
    ids = np.arange(3 << 15, (3 << 15) + 20000, dtype=np.int64)
    ids = ids[PN._event_kinds(ids) == KIND[table]]
    got = PN.gen_surrogates(cfg, table, ids)
    dev = gen_table(cfg, table, torch.from_numpy(ids))
    ref = JN.gen_surrogates(ref_cfg, table, ids)
    assert list(got) == list(ref)
    for c in got:
        assert got[c].dtype == ref[c].dtype == np.int64
        assert np.array_equal(got[c], ref[c]), c
        assert np.array_equal(got[c], dev[c].numpy()), c
    # a pruned generation equals the same columns of the full one
    some = list(got)[1::2]
    pruned = PN.gen_surrogates(cfg, table, ids, cols=some)
    assert all(np.array_equal(pruned[c], got[c]) for c in some)


def test_host_ingest_stages_windows():
    """take / prefetch / replay / trim on the CPU: each window's feed is
    the generator's rows of that range, count-masked, live columns only."""
    gc = GenCfg.from_config(PN.NexmarkConfig())
    names = ["auction", "bidder", "price", "_row_id"]
    src = NexmarkIngestSource("bid", "bid", gc, names, 3, 5000,
                              live=(0, 2, 3))
    ing = HostIngest([(4, src)], 2048, max_events=5000, device="cpu")
    seen = []
    lo = 0
    while lo < 5000:
        w, _p, _h = ing.take(lo)
        ing.ready(w)
        cnt, pk, *cols = w.feeds[4]
        k = int(cnt)
        ids = np.arange(lo, min(lo + 2048, 5000))
        ids = ids[PN._event_kinds(ids) == 2]
        assert w.events == min(2048, 5000 - lo) and k == len(ids)
        assert pk.shape == (2048,) and len(cols) == 3
        assert np.array_equal(pk[:k].numpy(), ids)
        g = PN.gen_surrogates(gc, "bid", ids)
        assert np.array_equal(cols[0][:k].numpy(), g["auction"])
        assert np.array_equal(cols[1][:k].numpy(), g["price"])
        assert np.array_equal(cols[2][:k].numpy(), ids)
        seen.append((lo, w.events))
        lo += w.events
    assert seen == [(0, 2048), (2048, 2048), (4096, 904)]
    # a replay of the retained range re-packs the same rows
    rep = list(ing.replay_range(2048, 5000))
    assert [(a, b) for a, b, _ in rep] == seen[1:]
    ids = ing.host_window(2048, 2048)[0][0]
    assert np.array_equal(rep[0][2].feeds[4][1][:len(ids)].numpy(), ids)
    ing.trim(4096)
    assert ing.stats()["retained_windows"] == 1
    st = ing.stats()
    assert st["windows"] == 3 and st["events"] == 5000
    assert st["sources"] == {"bid": int(np.sum(
        PN._event_kinds(np.arange(5000)) == 2))}
    ing.close()


def _run_ref(mp, mv_sql, name, srcs, ingest, cap):
    mp.setenv("RW_HOST_INGEST", "1" if ingest else "0")
    mp.setenv("RW_STATE_TIERING", "1")
    db = Database(device=DeviceConfig(capacity=cap, aot_compile=False,
                                      compile_buckets=0))
    for s in srcs:
        db.run(s.format(n=N, c=CHUNK))
    db.run(mv_sql)
    job = db.catalog.get(name).runtime["fused_job"]
    for _ in range(TICKS):
        db.tick()
    return job, job.mv_rows_now()


def _drive(job):
    for t in range(TICKS):
        job.on_barrier(SimpleNamespace(is_checkpoint=True,
                                       epoch=SimpleNamespace(curr=t + 1)))
    return job.mv_rows_now()


def _count_rows_for(job):
    calls = {}
    for _idx, src in job.ingest.sources:
        orig = src.rows_for

        def counted(lo, hi, _o=orig, _n=src.name):
            calls[_n] = calls.get(_n, 0) + 1
            return _o(lo, hi)
        src.rows_for = counted
    return calls


@pytest.mark.parametrize("shape", ["q1a", "q3a"])
def test_host_fed_job_matches_reference_and_device_datagen(monkeypatch,
                                                           shape):
    mv, name, srcs = {"q1a": (Q1_MV, "q1a", [BID_SRC]),
                      "q3a": (Q3_MV, "q3a", [BID_SRC, AUCTION_SRC])}[shape]
    ref_fed, want = _run_ref(monkeypatch, mv, name, srcs, True, 64)
    ref_dev, want_dev = _run_ref(monkeypatch, mv, name, srcs, False, 64)
    assert want == want_dev
    job = port_job(ref_fed, 64)
    assert job.ingest is not None
    assert [type(n).__name__ for n in job.program.nodes] == \
        [type(n).__name__ for n in ref_fed.program.nodes]
    assert [s.live for _i, s in job.ingest.sources] == \
        [s.live for _i, s in ref_fed.ingest.sources]
    calls = _count_rows_for(job)
    got = _drive(job)
    assert got == want
    # the capacity-64 start grows; the replays re-pack retained windows
    # instead of re-deriving them: one rows_for per source and window
    assert job.growth_replays == ref_fed.growth_replays >= 1
    windows = -(-N // (64 * CHUNK))
    assert calls == {s.name: windows for _i, s in job.ingest.sources}
    st = job.ingest.stats()
    assert st["events"] == N and st["windows"] == windows
    assert st["sources"] == ref_fed.ingest.stats()["sources"]
    dev_job = port_job(ref_dev, 64)
    assert dev_job.ingest is None
    assert not any(isinstance(n, PF.IngestNode)
                   for n in dev_job.program.nodes)
    assert _drive(dev_job) == want
    job.ingest.close()
