"""The port's state tiering (on the CPU) against the JAX package's
single-shard tiering arms (`tests/test_tiering.py`): host-fed fused jobs
built by the reference SQL front end with tiering and host ingest armed,
rebuilt node by node for the port (`torch_parity.port_job`), driven
barrier by barrier, and held to the reference's rows (same order), growth
replays, capacities, tiering counters, cold-store dumps and
`tiering_report` rows.

`tests/conftest.py` pins tiering, host ingest, pre-combine and the
telemetry off suite-wide; every reference job here is built with them
set through `monkeypatch`, as `test_tiering.py:_arm` does. The port's
evict and promote cores run their plain versions here (CPU tensors).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from risingwave_tpu.config import DeviceConfig
from risingwave_tpu.sql import Database
import risingwave_tpu_torch.kernels as K
from risingwave_tpu_torch.device.skew_stats import SK_KEY_MASK, hot_key_set
from risingwave_tpu_torch.device.state_io import (cold_from_snapshot,
                                                  states_from_numpy,
                                                  states_to_numpy)
from torch_parity import port_job, ref_to_port, store_dump

BID_SRC = ("CREATE SOURCE bid (auction BIGINT, bidder BIGINT,"
           " price BIGINT, channel VARCHAR, url VARCHAR,"
           " date_time TIMESTAMP, extra VARCHAR) WITH"
           " (connector='nexmark', nexmark.table='bid',"
           " nexmark.max.events='{n}', nexmark.chunk.size='{c}'{kd})")
AUCTION_SRC = ("CREATE SOURCE auction (id BIGINT, item_name VARCHAR,"
               " description VARCHAR, initial_bid BIGINT,"
               " reserve BIGINT, date_time TIMESTAMP, expires TIMESTAMP,"
               " seller BIGINT, category BIGINT, extra VARCHAR) WITH"
               " (connector='nexmark', nexmark.table='auction',"
               " nexmark.max.events='{n}', nexmark.chunk.size='{c}'{kd})")
QA_MV = ("CREATE MATERIALIZED VIEW qa AS SELECT auction,"
         " count(*) AS n, sum(price) AS dol FROM bid GROUP BY auction")
Q3_MV = ("CREATE MATERIALIZED VIEW q3a AS SELECT b.auction, b.price,"
         " a.seller, a.category FROM bid b JOIN auction a"
         " ON b.auction = a.id WHERE b.price > 900")


def _arm(mp, high="0.35", low="0.15", skew="0", tier="1"):
    for k, v in (("RW_STATE_TIERING", tier), ("RW_HOST_INGEST", "1"),
                 ("RW_TIER_HIGH_WATER", high), ("RW_TIER_LOW_WATER", low),
                 ("RW_SKEW_STATS", skew), ("RW_FLOW_STATS", skew),
                 ("RW_AGG_PRECOMBINE", "0")):
        mp.setenv(k, v)


@pytest.fixture(autouse=True)
def touch_modes(monkeypatch):
    """Every touch_stamp call of the port's tiered paths (agg and join
    epoch stamps, the promote cores' carry) gets its new, old and touched
    keys each ascending, EMPTY_KEY only at the tail: the order the CUDA
    kernel merges, which neither version checks. Yields whether each call
    carried promoted stamps (`src_vals` given)."""
    orig, modes = K.touch_stamp, []

    def checked(keys, old_keys, old_touch, src_keys, src_vals, *rest):
        for k in (keys, old_keys, src_keys):
            assert bool(torch.all(k[1:] >= k[:-1])), "touch run unsorted"
        modes.append(src_vals is not None)
        return orig(keys, old_keys, old_touch, src_keys, src_vals, *rest)

    monkeypatch.setattr(K, "touch_stamp", checked)
    yield modes


def barrier(epoch):
    return SimpleNamespace(is_checkpoint=True,
                           epoch=SimpleNamespace(curr=epoch))


def reference_run(mv_sql, name, cap, n, chunk, srcs=(BID_SRC,),
                  hbm_mb=4096, kd="", half=None):
    """The reference job driven to its end as `test_tiering._run` drives
    it (ticks, a sync, one more tick); with `half`, its states and cold
    stores after that many ticks."""
    db = Database(device=DeviceConfig(capacity=cap, mesh_shards=1,
                                      aot_compile=False, compile_buckets=0,
                                      hbm_budget_mb=hbm_mb))
    kdc = f", nexmark.key.dist='{kd}'" if kd else ""
    for s in srcs:
        db.run(s.format(n=n, c=chunk, kd=kdc))
    db.run(mv_sql)
    job = db.catalog.get(name).runtime["fused_job"]
    ticks = n // (64 * chunk) + 3
    mid = None
    for t in range(ticks):
        db.tick()
        if half is not None and t + 1 == half:
            mid = (jax.device_get(job.states), job.counter,
                   job.tiering.snapshot(), store_dump(job.tiering))
    job.sync()
    db.tick()
    return job, job.mv_rows_now(), ticks, mid


def port_run(job, ticks, lo=0):
    for t in range(lo, ticks):
        job.on_barrier(barrier(t + 1))
    job.sync()
    job.on_barrier(barrier(ticks + 1))
    return job.mv_rows_now()


def plan_image(p, at=None):
    """A TierPlan of either package as plain tuples (node indices mapped
    by `at`)."""
    m = (lambda i: i) if at is None else (lambda i: None if i is None
                                          else at[i])
    return (m(p.node_idx), p.kind, m(p.mv_idx),
            [(r.source_ord, r.col_pos,
              [(f.offset, f.stride, f.bits) for f in r.fields])
             for r in p.recipes])


def assert_tier_parity(job, ref_job):
    at = ref_to_port(ref_job, job)
    assert job.tiering.counters == ref_job.tiering.counters
    assert store_dump(job.tiering) == store_dump(ref_job.tiering, at)
    assert job.tiering_report() == [
        (at[r[0]],) + tuple(r[1:]) for r in ref_job.tiering_report()]
    assert [plan_image(p, at) for p in ref_job.tiering.plans] == \
        [plan_image(p) for p in job.tiering.plans]
    for st, ref in zip(states_to_numpy(job.program, job.states),
                       jax.device_get(ref_job.states)):
        got, exp = (jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(ref))
        assert len(got) == len(exp)
        for a, b in zip(got, exp):
            assert a.dtype == np.asarray(b).dtype
            assert np.array_equal(a, np.asarray(b))


def test_agg_demotion_under_clamp_matches_reference(monkeypatch,
                                                    touch_modes):
    """The unbounded-key QA_MV agg under a 512-slot capacity clamp below
    its key count (`test_tiering.py:177-219`): the same rows in key order
    with cold MV rows merged at the pull, no growth replay, the capacity
    unchanged, the same counters, cold stores, report rows and states."""
    _arm(monkeypatch)
    ref_job, want, ticks, _ = reference_run(QA_MV, "qa", 512,
                                            16384, 8, hbm_mb=1)
    job = port_job(ref_job, 512)
    assert job.hbm_budget_mb == 1
    got = port_run(job, ticks)
    assert len(got) == len(want) > 512
    assert got == want
    assert job.growth_replays == ref_job.growth_replays == 0
    agg = [n for n in job.program.nodes if type(n).__name__ == "AggNode"]
    assert [n.capacity for n in agg] == [512]
    c = job.tiering.counters
    assert c["demotions"] > 0 and c["promotions"] > 0 \
        and c["demote_events"] > 0 and c["filter_probes"] > 0
    assert job.tier_walls["promote_h2d"] > 0.0
    assert job.tier_walls["demote_d2h"] > 0.0
    assert set(touch_modes) == {False, True}   # epoch stamps and carries
    assert_tier_parity(job, ref_job)
    # untiered, the same clamp overflows and grows
    monkeypatch.setenv("RW_STATE_TIERING", "0")
    bare_ref, bare_want, _, _ = reference_run(QA_MV, "qa", 512,
                                              16384, 8, hbm_mb=1)
    bare = port_job(bare_ref, 512)
    assert bare.tiering is None
    assert port_run(bare, ticks) == bare_want == want
    assert bare.growth_replays == bare_ref.growth_replays >= 1


def test_join_demotion_growth_replay_matches_reference(monkeypatch,
                                                       touch_modes):
    """The q3a join under tier pressure (`test_tiering.py:246-273`): both
    build sides demote per join key, later bids for a demoted auction
    promote the pair back, and the mid-run growth replay rewinds the cold
    stores with the states."""
    _arm(monkeypatch, high="0.1", low="0.02")
    ref_job, want, ticks, _ = reference_run(
        Q3_MV, "q3a", 4096, 8192, 32,
        srcs=(BID_SRC, AUCTION_SRC))
    job = port_job(ref_job, 4096)
    got = port_run(job, ticks)
    assert len(got) == len(want) > 0
    assert got == want
    assert job.growth_replays == ref_job.growth_replays >= 1
    assert [n.cap_current() for n in job.program.nodes] == \
        [n.cap_current() for n in ref_job.program.nodes]
    c = job.tiering.counters
    assert c["demotions"] > 0 and c["promotions"] > 0
    assert set(touch_modes) == {False, True}
    assert_tier_parity(job, ref_job)


def test_heavy_hitters_never_demoted(monkeypatch):
    """Under zipf:1.5 with the skew telemetry armed
    (`test_tiering.py:325-355`): the heavy hitters of the node's
    telemetry appear in no cold store, tail keys do, and everything
    equals the reference."""
    _arm(monkeypatch, skew="1")
    ref_job, want, ticks, _ = reference_run(QA_MV, "qa", 512,
                                            16384, 32, kd="zipf:1.5")
    job = port_job(ref_job, 512)
    assert port_run(job, ticks) == want
    assert_tier_parity(job, ref_job)
    i = job.tiering.plans[0].node_idx
    hot = hot_key_set(job.program.node_stats(
        i, np.maximum(job._stat_totals, job._last_stats)))
    assert hot
    demoted = {int(k) & SK_KEY_MASK
               for (node, _side), store in job.tiering.stores.items()
               if node == i for d in store.rows for k in d}
    assert demoted and not set(hot) & demoted


def test_state_carry_across_after_demotions(monkeypatch):
    """Take the reference's states and cold stores mid-run, after
    demotions, into the port (states and cold stores back out equal to
    them), finish the port: the reference's rows."""
    _arm(monkeypatch)
    ref_job, want, ticks, mid = reference_run(
        QA_MV, "qa", 512, 16384, 8, hbm_mb=1, half=16)
    np_states, counter, snap, dump = mid
    assert snap[1]["demote_events"] > 0
    job = port_job(ref_job, 512)
    at = ref_to_port(ref_job, job)
    assert at == {i: i for i in at}
    states = states_from_numpy(job.program, np_states, "cpu")
    job.load_states(states, counter, cold=cold_from_snapshot(snap))
    assert store_dump(job.tiering) == dump
    assert job.tiering.counters == snap[1]
    for st, ref in zip(states_to_numpy(job.program, job.states), np_states):
        for a, b in zip(jax.tree_util.tree_leaves(st),
                        jax.tree_util.tree_leaves(ref)):
            assert np.array_equal(a, np.asarray(b))
    assert port_run(job, ticks, lo=16) == want
    assert job.tiering.counters["promotions"] > snap[1]["promotions"]
