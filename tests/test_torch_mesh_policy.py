"""The port's mesh skew policy and serving replicas, piece by piece, beside
the whole-job mirror cases (`test_torch_sql_mirror_mesh_skew.py`):

* the policy's job-table rows (`_persist_policy`) equal the reference's
  for the same policy, generation over generation, and
  `_restore_policy` decodes the newest generation from the
  max-combined rows (bounds persist up to 11 shards, as in the
  reference);
* a decision stages at one checkpoint and adopts at the next, by a
  rebuild-replay that keeps the plan's shape hash and every node
  signature, counts `fused_rebalances_total`, records a `rebalance` in
  the flight recorder, and returns the 1-shard rows;
* a replica column holds its own copy of every shard's state (distinct
  storage, equal values), and successive pulls alternate the columns.
"""
import numpy as np
import pytest
import torch

from risingwave_tpu.config import DeviceConfig as RefConfig
from risingwave_tpu.sql import Database as RefDatabase
from risingwave_tpu_torch.config import DeviceConfig
from risingwave_tpu_torch.device import shard_exec as PSE
from risingwave_tpu_torch.sql import Database

N = 4096
CHUNK = 32
BID_SRC = ("CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,"
           " channel VARCHAR, url VARCHAR, date_time TIMESTAMP,"
           " extra VARCHAR) WITH (connector='nexmark',"
           " nexmark.table='bid', nexmark.max.events='{n}',"
           " nexmark.chunk.size='{c}'{kd})")
AUCTION_SRC = ("CREATE SOURCE auction (id BIGINT, item_name VARCHAR,"
               " description VARCHAR, initial_bid BIGINT, reserve BIGINT,"
               " date_time TIMESTAMP, expires TIMESTAMP, seller BIGINT,"
               " category BIGINT, extra VARCHAR) WITH (connector='nexmark',"
               " nexmark.table='auction', nexmark.max.events='{n}',"
               " nexmark.chunk.size='{c}'{kd})")
Q1_MV = ("CREATE MATERIALIZED VIEW q1a AS SELECT bidder,"
         " count(*) AS n, sum(price) AS dol, max(price) AS top"
         " FROM bid GROUP BY bidder")
Q3_MV = ("CREATE MATERIALIZED VIEW q3a AS SELECT b.auction, b.price,"
         " a.seller, a.category FROM bid b JOIN auction a"
         " ON b.auction = a.id WHERE b.price > 500")


@pytest.fixture
def armed(monkeypatch):
    for k in ("RW_SKEW_STATS", "RW_HOT_KEY_REP", "RW_VNODE_REBALANCE"):
        monkeypatch.setenv(k, "1")
    monkeypatch.setenv("RW_AGG_PRECOMBINE", "0")


def _db(pkg, shards, mv, srcs, kd="", replicas=1, data_dir=None,
        threshold=1.2):
    kdc = f", nexmark.key.dist='{kd}'" if kd else ""
    if pkg == "ref":
        db = RefDatabase(device=RefConfig(
            capacity=2048, mesh_shards=shards, aot_compile=False,
            rebalance_threshold=threshold), data_dir=data_dir)
    else:
        db = Database(device=DeviceConfig(
            capacity=2048, mesh_shards=shards, replicas=replicas,
            rebalance_threshold=threshold), data_dir=data_dir,
            torch_device="cpu")
    for s in srcs:
        db.run(s.format(n=N, c=CHUNK, kd=kdc))
    db.run(mv)
    return db


def _rows(job):
    rows = {}
    for k, v in job.job_state_table.iter_all():
        rows[int(k)] = max(rows.get(int(k), 0), int(v))
    return rows


def _policy_rows(rows):
    from risingwave_tpu_torch.device import fused as PF
    return {k: v for k, v in rows.items()
            if k == PF._JS_POLICY_SEQ or k == PF._JS_REBALANCES
            or PF._JS_VB_BASE <= k < PF._JS_VB_BASE + PF._JS_VB_MAX
            or k >= PF._JS_HOT_BASE}


def _set(job, seq, bounds, hot, side):
    from risingwave_tpu.device.fused import JoinNode as RJoin
    from risingwave_tpu_torch.device.fused import JoinNode as PJoin
    job.program.vnode_bounds = bounds
    for n in job.program.nodes:
        if isinstance(n, (RJoin, PJoin)):
            n.hot_keys, n.hot_rep_side = hot, side
    job._policy_seq = job.rebalances = seq


@pytest.mark.parametrize("shards", [3, 8, 12])
def test_persist_restore_policy_round_trip(shards, armed):
    from risingwave_tpu_torch.parallel.mesh import vnode_block_bounds
    uniform = tuple(int(v) for v in vnode_block_bounds(shards))
    custom = tuple([0] * 2 + sorted({17 * (k + 1) % 250
                                     for k in range(shards - 2)})
                   [:shards - 2] + [256])
    custom = (custom + (256,) * shards)[:shards + 1]
    gens = [(1, custom, (0, 5), 0), (2, None, (7,), 1),
            (3, custom, (), 1)]
    # the reference's mesh needs a device per shard: its eight CPU
    # devices hold 3 and 8 shards; 12 (past the persisted bounds) is the
    # port's alone
    pkgs = ("ref", "port") if shards <= 8 else ("port",)
    jobs = {pkg: _db(pkg, shards, Q3_MV, (BID_SRC, AUCTION_SRC))._fused[
        "q3a"] for pkg in pkgs}
    assert any(n.hotrep for n in jobs["port"].program.nodes)
    for seq, bounds, hot, side in gens:
        for job in jobs.values():
            _set(job, seq, bounds, hot, side)
            job._persist_policy(seq)
        got = _policy_rows(_rows(jobs["port"]))
        if "ref" in jobs:
            assert jobs["ref"].mesh_shards == shards
            assert got == _policy_rows(_rows(jobs["ref"])), seq
        from risingwave_tpu_torch.device import fused as PF
        vb = [k for k in got if PF._JS_VB_BASE <= k < PF._JS_REBALANCES]
        assert len(vb) == (shards - 1 if shards <= 11 else 0)
        fresh = _db("port", shards, Q3_MV,
                    (BID_SRC, AUCTION_SRC))._fused["q3a"]
        fresh._restore_policy(_rows(jobs["port"]))
        want_bounds = bounds if shards <= 11 else None
        if want_bounds == uniform:
            want_bounds = None
        assert fresh.program.vnode_bounds == want_bounds
        joins = [n for n in fresh.program.nodes if n.hotrep]
        assert joins and all(n.hot_keys == hot for n in joins)
        if hot:
            assert all(n.hot_rep_side == side for n in joins)


def test_policy_stages_then_adopts_at_the_next_checkpoint(armed, tmp_path):
    from risingwave_tpu_torch.device.fused import node_shape_key
    from risingwave_tpu_torch.utils.blackbox import RECORDER
    from risingwave_tpu_torch.utils.metrics import REGISTRY
    one = _db("port", 1, Q1_MV, (BID_SRC,), kd="zipf:4")
    for _ in range(N // (64 * CHUNK) + 3):
        one.tick()
    want = one.query("SELECT * FROM q1a")
    db = _db("port", 8, Q1_MV, (BID_SRC,), kd="zipf:4",
             data_dir=str(tmp_path / "d"))
    job = db._fused["q1a"]
    ph = job.plan_hash
    sigs = [node_shape_key(n) for n in job.program.nodes]
    c = REGISTRY.counter("fused_rebalances_total", "", labels=("job",))
    before = c.labels("q1a").value
    staged_at = None
    for t in range(N // (64 * CHUNK) + 3):
        db.tick()
        if job._pending_policy is not None and staged_at is None:
            staged_at = t
            assert job.rebalances == 0 and job._pending_policy[2].is_set()
        if job.rebalances:
            break
    assert staged_at is not None and job.rebalances == 1
    assert t == staged_at + 1                   # the next checkpoint
    assert job.program.vnode_bounds is not None
    assert job.plan_hash == ph
    assert [node_shape_key(n) for n in job.program.nodes] == sigs
    assert c.labels("q1a").value == before + 1
    import json
    with RECORDER._lock:
        ring = [json.loads(line) for line, kind in RECORDER._ring
                if kind == "rebalance"]
    assert any(r["job"] == "q1a" and r["policy_seq"] == 1
               and r["bounds"] == list(job.program.vnode_bounds)
               for r in ring)
    for _ in range(3):
        db.tick()
    assert db.query("SELECT * FROM q1a") == want
    skew = db.query("SELECT * FROM rw_key_skew WHERE job = 'q1a'")
    loads = [r for r in skew if r[3] == "shard_load"]
    assert len(loads) == 8 and any(r[3] == "shard_skew" for r in skew)
    bounds = job.program.vnode_bounds
    del db, job
    db2 = Database(data_dir=str(tmp_path / "d"), torch_device="cpu",
                   device=DeviceConfig(capacity=2048, mesh_shards=8,
                                       rebalance_threshold=1.2))
    job2 = db2._fused["q1a"]
    assert job2.program.vnode_bounds == bounds and job2.rebalances >= 1
    assert db2.query("SELECT * FROM q1a") == want


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def test_replica_columns_copy_every_shard_and_alternate_pulls():
    plain = _db("port", 4, Q1_MV, (BID_SRC,))
    rep = _db("port", 4, Q1_MV, (BID_SRC,), replicas=2)
    for db in (plain, rep):
        for _ in range(N // (64 * CHUNK) + 3):
            db.tick()
    job = rep._fused["q1a"]
    mesh = job.program.mesh
    assert mesh.replicas == 2 and mesh.n == 4 and len(mesh.slots[0]) == 2
    job.sync()
    job.program.refresh_replicas(job.states)
    (col1,) = job.program.replica_states
    n_leaves = 0
    for st, cp in zip(job.states, col1):
        a, b = _leaves(st), _leaves(cp)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
            if x.numel():
                assert x.data_ptr() != y.data_ptr()
                n_leaves += 1
    assert n_leaves > 0
    PSE.reset_pull_stats()
    a = job.mv_rows_now()
    b = job.mv_rows_now()
    c = job.mv_rows_now()
    assert a == b == c == plain._fused["q1a"].mv_rows_now()
    assert PSE.PULL_STATS["device_pulls"] >= 3
    assert set(PSE.PULL_STATS["replica_pulls"]) == {0, 1}
    assert rep.query("SELECT * FROM q1a") == plain.query(
        "SELECT * FROM q1a")
    # a refresh after the epochs refills the same storage
    ptrs = [x.data_ptr() for x in _leaves(col1)]
    job.program.replica_of = None
    job.program.refresh_replicas(job.states)
    assert [x.data_ptr() for x in _leaves(
        job.program.replica_states[0])] == ptrs


def test_chip_smoke_mesh_policy_phase_small(monkeypatch):
    """The smoke's `mesh_policy` phase (chip_smoke.py 4j) end to end on
    the CPU at small sizes, the plain versions launching nothing: each
    job's checks (a rebalance that survives a reopen, the hot join key,
    per-shard feeds, per-shard cold stores, alternating replica pulls)
    pass as on the card."""
    import chip_smoke as C
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    # the card runs every arm as its DeviceConfig says (tests/conftest.py
    # pins these off for the suite's compile budget)
    for k in ("RW_SKEW_STATS", "RW_FLOW_STATS", "RW_AGG_PRECOMBINE",
              "RW_STATE_TIERING"):
        monkeypatch.delenv(k, raising=False)
    for k, v in (("MP_Q1_EVENTS", 1 << 16), ("MP_Q3_EVENTS", 1 << 15),
                 ("MP_FED_EVENTS", 1 << 15), ("MP_QA_EVENTS", 1 << 16),
                 ("MP_Q5_EVENTS", 1 << 14), ("MP_CHUNK", 1 << 7),
                 ("MP_CAPACITY", 1 << 10), ("MP_QA_CLAMP", 1 << 8),
                 ("MP_QA_CHUNK", 1 << 5)):
        monkeypatch.setattr(C, k, v)
    monkeypatch.setattr(C, "MP_KERNELS", {k: () for k in C.MP_KERNELS})
    rep = C.mesh_policy_phase(torch.device("cpu"), "cpu")
    assert rep["q1_reb"]["rebalances"] >= 1
    assert rep["q3_hot"]["hot_keys"] == [0]
    assert rep["q3_hot"]["largest_shard_share_on"] \
        < rep["q3_hot"]["largest_shard_share_off"]
    assert sum(rep["q1_fed8"]["window0_shard_rows"]) > 0
    assert sum(1 for c in rep["qa_tiered8"]["cold_rows_by_shard"] if c) >= 2
    assert set(rep["q5_rep"]["replica_pulls"]) == {0, 1}
