"""The port's fuse planner (`risingwave_tpu_torch/device/fuse_planner.py`,
`try_fuse`) against the JAX package's, through each package's `Database`
(the port's on the CPU): the same SQL must lower to the same fused program
— node classes, input edges, every node's structural signature (types,
expressions, pack plans, agg specs, join and MV dtypes, pre-combine and
the skew / flow / tiering arms), the stat layout, the epoch cadence, the
capacities and the MV pull — and, driven a few epochs, return the same MV
rows in the same order. Also held: the plans both packages refuse, the
plan-shape hash, the DROP + re-CREATE presize, the restart over committed
fused state (replayed to the committed counter, presized), a host-fed
CREATE, the refusal of the mesh skew policy (ROADMAP queue 1 item 5) and
the 2-shard fused q4 and q5 against the 1-shard rows of both packages."""
import re

import pytest

from risingwave_tpu.config import DeviceConfig as RefConfig
from risingwave_tpu.sql import Database as RefDatabase
from risingwave_tpu_torch.config import DeviceConfig as PortConfig
from risingwave_tpu_torch.sql import Database as PortDatabase

N = 4096
CHUNK = 32          # fused epoch = 64 * CHUNK = 2048 events
TICKS = N // (64 * CHUNK) + 3
ARMS = ("RW_SKEW_STATS", "RW_FLOW_STATS", "RW_AGG_PRECOMBINE",
        "RW_STATE_TIERING")

BID_SRC = ("CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,"
           " channel VARCHAR, url VARCHAR, date_time TIMESTAMP,"
           " extra VARCHAR) WITH (connector='nexmark',"
           " nexmark.table='bid', nexmark.max.events='{n}',"
           " nexmark.chunk.size='{c}'{x})")
AUCTION_SRC = ("CREATE SOURCE auction (id BIGINT, item_name VARCHAR,"
               " description VARCHAR, initial_bid BIGINT, reserve BIGINT,"
               " date_time TIMESTAMP, expires TIMESTAMP, seller BIGINT,"
               " category BIGINT, extra VARCHAR) WITH (connector='nexmark',"
               " nexmark.table='auction', nexmark.max.events='{n}',"
               " nexmark.chunk.size='{c}')")
PERSON_SRC = ("CREATE SOURCE person (id BIGINT, name VARCHAR,"
              " email_address VARCHAR, credit_card VARCHAR, city VARCHAR,"
              " state VARCHAR, date_time TIMESTAMP, extra VARCHAR)"
              " WITH (connector='nexmark', nexmark.table='person',"
              " nexmark.max.events='{n}', nexmark.chunk.size='{c}')")
HOP = ("HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND)")
QUERIES = {
    "q4": ((BID_SRC,),
           "SELECT auction, count(*) AS c, sum(price) AS s,"
           " max(price) AS m FROM bid GROUP BY auction"),
    "q1a": ((BID_SRC,),
            "SELECT bidder, count(*) AS n, sum(price) AS dol,"
            " max(price) AS top FROM bid GROUP BY bidder"),
    "q1c": ((BID_SRC,),
            "SELECT bidder, count(*) AS n, sum(price * 908 / 1000) AS dol,"
            " max(price * 908 / 1000) AS top FROM bid GROUP BY bidder"),
    "q2c": ((BID_SRC,),
            "SELECT auction, count(*) AS n, sum(price) AS dol FROM bid"
            " WHERE auction % 123 = 0 GROUP BY auction"),
    "q3a": ((BID_SRC, AUCTION_SRC),
            "SELECT b.auction, b.price, a.seller, a.category FROM bid b"
            " JOIN auction a ON b.auction = a.id WHERE b.price > 500"),
    "q5": ((BID_SRC,),
           "SELECT AuctionBids.auction, AuctionBids.num FROM ("
           " SELECT bid.auction, count(*) AS num, window_start AS starttime"
           f" FROM {HOP} GROUP BY window_start, bid.auction) AS AuctionBids"
           " JOIN (SELECT max(CountBids.num) AS maxn,"
           " CountBids.starttime_c FROM (SELECT count(*) AS num,"
           f" window_start AS starttime_c FROM {HOP}"
           " GROUP BY bid.auction, window_start) AS CountBids"
           " GROUP BY CountBids.starttime_c) AS MaxBids"
           " ON AuctionBids.starttime = MaxBids.starttime_c"
           " AND AuctionBids.num >= MaxBids.maxn"),
    "q7": ((BID_SRC,),
           "SELECT B.auction, B.price, B.bidder, B.date_time FROM bid B"
           " JOIN (SELECT MAX(price) AS maxprice, window_end as date_time"
           " FROM TUMBLE(bid, date_time, INTERVAL '10' SECOND)"
           " GROUP BY window_end) B1 ON B.price = B1.maxprice"
           " WHERE B.date_time BETWEEN B1.date_time - INTERVAL '10' SECOND"
           " AND B1.date_time"),
    "q8": ((PERSON_SRC, AUCTION_SRC),
           "SELECT P.id, P.name, P.starttime FROM (SELECT id, name,"
           " window_start AS starttime, window_end AS endtime"
           " FROM TUMBLE(person, date_time, INTERVAL '10' SECOND)"
           " GROUP BY id, name, window_start, window_end) P JOIN ("
           " SELECT seller, window_start AS starttime, window_end AS endtime"
           " FROM TUMBLE(auction, date_time, INTERVAL '10' SECOND)"
           " GROUP BY seller, window_start, window_end) A"
           " ON P.id = A.seller AND P.starttime = A.starttime"
           " AND P.endtime = A.endtime"),
}


def make(pkg, name, cap=512, n=N, chunk=CHUNK, data_dir=None, x="",
         mv_sql=None, **cfg):
    """A Database of `pkg` ("ref" or "port", the port on the CPU) with
    the query's sources and its MV created under `name`."""
    if pkg == "ref":
        db = RefDatabase(device=RefConfig(capacity=cap, aot_compile=False,
                                          **cfg), data_dir=data_dir)
    else:
        db = PortDatabase(device=PortConfig(capacity=cap, **cfg),
                          data_dir=data_dir, torch_device="cpu")
    srcs, sql = QUERIES[name]
    for s in srcs:
        db.run(s.format(n=n, c=chunk, x=x))
    db.run(f"CREATE MATERIALIZED VIEW {name} AS "
           + (mv_sql if mv_sql is not None else sql))
    return db


def drive(db, ticks=TICKS):
    for _ in range(ticks):
        db.tick()


def _canon(sig) -> str:
    """A node signature's text with each package's spelling of the same
    thing made one: jnp dtypes as torch's, the generator config as its
    tuple of values."""
    s = repr(sig)
    s = re.sub(r"\"<class 'jax\.numpy\.(\w+)'>\"", r"'torch.\1'", s)
    s = re.sub(r"<class 'jax\.numpy\.(\w+)'>", r"torch.\1", s)
    s = re.sub(r"dtype\('(\w+)'\)", r"torch.\1", s)
    return re.sub(r"GenCfg\(seed=(\d+), base_time_usecs=(\d+), "
                  r"inter_event_gap_usecs=(\d+), auction_duration_events="
                  r"(\d+), key_dist=('[^']*')\)", r"(\1, \2, \3, \4, \5)", s)


def plan(job):
    """What the two packages' programs must agree on."""
    prog = job.program
    nodes = []
    for n in prog.nodes:
        nodes.append((type(n).__name__, tuple(n.inputs),
                      [type(m).__name__ for m in getattr(n, "chain", [])],
                      _canon(n._sig()), sorted(n.cap_current().items()),
                      bool(getattr(n, "skew", False)),
                      bool(getattr(n, "flow", False)),
                      bool(getattr(n, "tier", False)),
                      bool(getattr(n, "combined", False)),
                      getattr(n, "emit_out", None)))
    p = job.pull
    pull = (p.kind, p.node_idx, [str(d) for d in p.dtypes],
            repr(p.decoders), p.out_map)
    return (nodes, list(prog.stat_layout), prog.epoch_events, pull,
            job.max_events, job.mv_schema_len, job.persist_every,
            job.hbm_budget_mb, job.state_tiering)


@pytest.mark.parametrize("name", list(QUERIES))
def test_plan_matches_reference_with_every_arm(name, monkeypatch):
    """Every arm at its production default (skew, flow, pre-combine,
    tiering on): the same nodes, signatures, stat layout and pull."""
    for k in ARMS:
        monkeypatch.setenv(k, "1")
    ref = make("ref", name)._fused[name]
    port = make("port", name)._fused[name]
    assert plan(port) == plan(ref)
    # the tier plans: one per keyed node, none with promotion recipes
    # (device datagen has no host lineage)
    assert [(p.node_idx, p.kind, p.recipes, p.mv_idx)
            for p in port.tiering.plans] == \
        [(p.node_idx, p.kind, p.recipes, p.mv_idx)
         for p in ref.tiering.plans]


@pytest.mark.parametrize("name", list(QUERIES))
def test_rows_match_reference(name):
    """Driven to drained at a capacity that forces a growth replay: the
    same rows in the same order, the same plan, counters and replays."""
    dbs = {pkg: make(pkg, name, cap=64) for pkg in ("ref", "port")}
    for db in dbs.values():
        drive(db)
    ref, port = dbs["ref"]._fused[name], dbs["port"]._fused[name]
    assert plan(port) == plan(ref)
    want = dbs["ref"].query(f"SELECT * FROM {name}")
    got = dbs["port"].query(f"SELECT * FROM {name}")
    assert len(got) == len(want) > 0
    assert got == want
    assert (port.counter, port.committed, port.growth_replays,
            port.retraces, port.growths) == \
        (ref.counter, ref.committed, ref.growth_replays, ref.retraces,
         ref.growths)
    assert port.cap_report() == ref.cap_report()
    assert [int(v) for v in port._stat_totals] == \
        [int(v) for v in ref._stat_totals]
    # the MV state table holds the drained MV in both
    mv = {pkg: sorted(db.catalog.get(name).runtime["state_table"]
                      .iter_all()) for pkg, db in dbs.items()}
    assert mv["port"] == mv["ref"] and len(mv["port"]) == len(want)


REJECTS = {
    "avg": ("q4", "SELECT auction, avg(bidder) AS b FROM bid"
                  " GROUP BY auction"),
    "left_join": ("q3a", "SELECT b.auction, a.seller FROM bid b LEFT JOIN"
                         " auction a ON b.auction = a.id"),
    "computed_over_agg": ("q4", "SELECT auction, count(*) + 1 AS c"
                                " FROM bid GROUP BY auction"),
    "stateless": ("q4", "SELECT auction, price FROM bid"),
}


@pytest.mark.parametrize("case", list(REJECTS))
def test_unfusable_plans_fall_back_in_both(case):
    """A plan outside the fused subset lowers per operator in both
    packages, and the virtual source it reads is activated."""
    name, sql = REJECTS[case]
    for pkg in ("ref", "port"):
        db = make(pkg, name, n=2048, mv_sql=sql)
        assert name not in db._fused, pkg
        assert (db.catalog.get(name).runtime or {}).get("fused_job") \
            is None, pkg
        assert "bid" in db._iters, pkg


def test_advanced_source_and_cadence_mismatch_fall_back():
    """A source a per-operator MV already advanced, and two sources
    polled at different cadences, refuse fusion in both packages."""
    for pkg in ("ref", "port"):
        db = make(pkg, "q4", n=8192, mv_sql=REJECTS["avg"][1])
        drive(db, 2)
        db.run("CREATE MATERIALIZED VIEW q4b AS " + QUERIES["q4"][1])
        assert "q4b" not in db._fused, pkg
        if pkg == "ref":
            db = RefDatabase(device=RefConfig(capacity=512,
                                              aot_compile=False))
        else:
            db = PortDatabase(device=PortConfig(capacity=512),
                              torch_device="cpu")
        db.run(BID_SRC.format(n=N, c=32, x=""))
        db.run(AUCTION_SRC.format(n=N, c=64))
        db.run("CREATE MATERIALIZED VIEW q3a AS " + QUERIES["q3a"][1])
        assert "q3a" not in db._fused, pkg


def test_plan_shape_hash_stable_and_shard_aware():
    """The plan hash is structural: the same plan under two names in two
    Databases hashes the same; the 2-shard plan hashes differently."""
    from risingwave_tpu_torch.device.fused import plan_shape_hash
    a = make("port", "q4")._fused["q4"]
    db = PortDatabase(device=PortConfig(capacity=512), torch_device="cpu")
    db.run(BID_SRC.format(n=N, c=CHUNK, x=""))
    db.run("CREATE MATERIALIZED VIEW other AS " + QUERIES["q4"][1])
    b = db._fused["other"]
    assert a.plan_hash == b.plan_hash
    assert a.plan_hash == plan_shape_hash(a.program.nodes,
                                          a.program.epoch_events)
    assert plan_shape_hash(a.program.nodes, a.program.epoch_events, 2) \
        != a.plan_hash
    c = make("port", "q4", mesh_shards=2)._fused["q4"]
    assert c.mesh_shards == 2 and c.plan_hash != a.plan_hash
    # a different plan hashes differently
    d = make("port", "q1a")._fused["q1a"]
    assert d.plan_hash != a.plan_hash


def test_drop_recreate_presizes_and_never_replays():
    """DROP + re-CREATE of the same plan (under another name) starts at
    the dropped job's capacities, from `shape_hints`, and drains with no
    growth replay."""
    db = make("port", "q4", cap=64)
    drive(db)
    job = db._fused["q4"]
    assert job.growth_replays >= 1
    want = db.query("SELECT * FROM q4")
    hints = job.shape_hints()
    caps = [n.cap_current() for n in job.program.nodes]
    db.run("DROP MATERIALIZED VIEW q4")
    assert db._fused_cap_hw[job.plan_hash] == hints
    db.run("CREATE MATERIALIZED VIEW q4c AS " + QUERIES["q4"][1])
    job2 = db._fused["q4c"]
    assert job2.plan_hash == job.plan_hash
    assert [n.cap_current() for n in job2.program.nodes] == caps
    drive(db)
    assert job2.growth_replays == 0
    assert db.query("SELECT * FROM q4c") == want


def test_restart_over_committed_fused_state_raises(tmp_path):
    """A restart over committed fused state replays each package's job to
    its committed counter at the persisted capacities: the reopened
    port's rows, committed counter, growth counters and capacities equal
    the reference's reopen, with zero new growth replays (a job table
    with no committed counter recovers as a no-op)."""
    out = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        db = make(pkg, "q4", cap=64, data_dir=d)
        job = db._fused["q4"]
        job.recover()                        # nothing committed: no-op
        assert job.committed == 0
        drive(db)
        assert job.committed > 0 and job.growth_replays >= 1
        before = (job.committed, job.growth_replays, job.retraces,
                  job.growths, [n.cap_current() for n in job.program.nodes])
        del db, job
        if pkg == "ref":
            db2 = RefDatabase(device=RefConfig(capacity=64,
                                               aot_compile=False),
                              data_dir=d)
        else:
            db2 = PortDatabase(device=PortConfig(capacity=64), data_dir=d,
                               torch_device="cpu")
        job2 = db2._fused["q4"]
        after = (job2.committed, job2.growth_replays, job2.retraces,
                 job2.growths, [n.cap_current() for n in job2.program.nodes])
        assert after == before, pkg          # presized: no new replay
        out[pkg] = (after, db2.query("SELECT * FROM q4"),
                    job2.cap_report())
    assert out["port"] == out["ref"] and len(out["port"][1]) > 0


def test_host_fed_create_and_mesh_skew_policy_arm(monkeypatch):
    """A host-fed fused CREATE (its sources given the overload manager's
    admission buckets) runs and returns the reference's rows; a mesh job
    with skew telemetry on now arms the reference's skew policy: the
    same nodes, the same policy switches, thresholds and hot-key arms
    (a join becomes a hot-key candidate only with both on), and with the
    policy's switches off it runs without one."""
    rows = {}
    for pkg in ("ref", "port"):
        db = make(pkg, "q4", x=", nexmark.ingest='host'")
        job = db._fused["q4"]
        assert job.ingest is not None
        assert job.ingest.buckets["bid"] is db._overload.buckets["bid"]
        drive(db)
        rows[pkg] = (db.query("SELECT * FROM q4"), job.counter,
                     db.query("SELECT * FROM rw_source_admission"))
    assert rows["port"] == rows["ref"] and len(rows["port"][0]) > 0
    monkeypatch.setenv("RW_SKEW_STATS", "1")

    def policy(pkg, name, **cfg):
        job = make(pkg, name, mesh_shards=2, **cfg)._fused[name]
        return (job.rebalance, job.hot_key_rep, job.rebalance_threshold,
                job.hot_key_frac, job.program.vnode_bounds,
                [(type(n).__name__, _canon(n._sig()), n.hotrep,
                  tuple(n.hot_keys), n.hot_rep_side)
                 for n in job.program.nodes])
    for name, cfg in (("q4", {}), ("q3a", {"rebalance_threshold": 1.2}),
                      ("q3a", {"hot_key_rep": False}),
                      ("q4", {"vnode_rebalance": False,
                              "hot_key_rep": False})):
        got = policy("port", name, **cfg)
        assert got == policy("ref", name, **cfg), (name, cfg)
        assert got[0] == cfg.get("vnode_rebalance", True)
        assert any(h for _t, _s, h, _k, _d in got[5]) \
            == (name == "q3a" and cfg.get("hot_key_rep", True))


@pytest.mark.parametrize("name", ["q4", "q5"])
def test_two_shard_rows_equal_one_shard(name, monkeypatch):
    """A 2-shard fused job (skew off) returns the port's own 1-shard rows
    and the reference's 1-shard rows, in the same order."""
    monkeypatch.setenv("RW_SKEW_STATS", "0")
    rows = {}
    for key, pkg, shards in (("ref1", "ref", 1), ("port1", "port", 1),
                             ("port2", "port", 2)):
        db = make(pkg, name, mesh_shards=shards)
        drive(db)
        rows[key] = db.query(f"SELECT * FROM {name}")
        if key == "port2":
            assert db._fused[name].program.mesh.n == 2
    assert len(rows["ref1"]) > 0
    assert rows["port2"] == rows["port1"] == rows["ref1"]
