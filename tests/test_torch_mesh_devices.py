"""The port's meshes over a set of devices (`parallel.mesh.device_set`),
on the CPU alone:

* the device-set rule: a CPU device is its own set; a CUDA device
  expands to every visible card from it, in index order; a sequence is
  kept as given; a set naming a card the host does not have raises;
  shards are dealt round-robin; on one device the layout is unchanged;
* the fused q1a, q3a and q5 at 8 shards over two CPU device names
  (`cpu`, `cpu:0`), with 1 and 2 replica columns, equal the same jobs
  with every shard on `cpu`, to the bit: rows in order, counters, growth
  replays, stats totals and every state leaf of every shard and replica;
* the per-operator sharded engines (`Database(device=8)`) over two CPU
  device names, through a `PARALLELISM` rescale.

Two CPU device names are two devices to the mesh (`Mesh.single_device`
is False, so every exchange takes its per-source form and every
reduction gathers across devices), though every tensor lies on `cpu`.
The reference's own 8-device runs hold the same path in
`test_torch_mesh_devices_ref.py`."""
import numpy as np
import pytest
import torch

from risingwave_tpu_torch.config import DeviceConfig
from risingwave_tpu_torch.ops import DeviceHashAggExecutor
from risingwave_tpu_torch.parallel import mesh as PM
from risingwave_tpu_torch.sql import Database
from risingwave_tpu_torch.sql.database import _walk_executors

torch.set_num_threads(1)

CPU, CPU0 = torch.device("cpu"), torch.device("cpu", 0)
TWO = [CPU, CPU0]
N = 4096
CHUNK = 32                   # a fused epoch: 64 * CHUNK = 2048 events

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
Q5_MV = """CREATE MATERIALIZED VIEW q5 AS
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
# (MV, sources, per-shard start capacity): each job grows at least once
QUERIES = {"q1a": (Q1_MV, (BID_SRC,), 8),
           "q3a": (Q3_MV, (BID_SRC, AUCTION_SRC), 256),
           "q5": (Q5_MV, (BID_SRC,), 256)}


# ---------------------------------------------------------------------------
# the device-set rule
# ---------------------------------------------------------------------------


def _cards(monkeypatch, count):
    """A host with `count` cards, as far as the rule can tell."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


def test_cpu_device_is_its_own_set():
    assert PM.device_set("cpu") == [CPU]
    assert PM.device_set(torch.device("cpu", 3)) == [torch.device("cpu", 3)]
    assert PM.device_set(("cpu", "cpu:0")) == TWO
    with pytest.raises(ValueError):
        PM.device_set([])


def test_cuda_device_expands_to_every_card_from_it(monkeypatch):
    _cards(monkeypatch, 4)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert PM.device_set(None) == cuda
    assert PM.device_set("cuda") == cuda
    assert PM.device_set("cuda:2") == cuda[2:] + cuda[:2]
    # a sequence is kept as given: one card is one card
    assert PM.device_set(["cuda:1"]) == [cuda[1]]
    assert PM.device_set(["cuda:0", "cpu"]) == [cuda[0], CPU]
    m = PM.make_mesh(8)
    assert m.devices == [cuda[s % 4] for s in range(8)]
    assert not m.single_device and m.cuda_devices() == cuda
    # one card: every shard on it, as before the rule
    _cards(monkeypatch, 1)
    assert PM.device_set("cuda") == [cuda[0]]
    m = PM.make_mesh(8)
    assert m.devices == [cuda[0]] * 8 and m.single_device


def test_a_set_naming_a_missing_card_raises(monkeypatch):
    _cards(monkeypatch, 0)
    for devs in (["cpu", "cuda"], ["cuda:0"], "cuda:0", None):
        with pytest.raises(RuntimeError, match="CUDA device"):
            PM.device_set(devs)
    with pytest.raises(RuntimeError, match="CUDA device"):
        PM.make_mesh(2, devices=["cpu", "cuda:1"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        Database(device=DeviceConfig(mesh_shards=2),
                 torch_device=["cpu", "cuda:1"])
    _cards(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="has 2 CUDA device"):
        PM.device_set(["cuda:0", "cuda:2"])


def test_explicit_set_deals_shards_round_robin():
    three = [CPU, CPU0, torch.device("cpu", 1)]
    m = PM.make_mesh(8, devices=three)
    assert m.devices == [three[s % 3] for s in range(8)]
    assert not m.single_device and m.cuda_devices() == []
    assert m.layout() == "3 shards on cpu, 3 shards on cpu:0, 2 shards on " \
                         "cpu:1"
    # replica slots stay in the reference's order over the set
    m = PM.make_mesh(4, devices=TWO, replicas=2)
    assert m.column(0) == [CPU] * 4 and m.column(1) == [CPU0] * 4
    assert m.single_device


def test_one_device_layout_is_unchanged():
    m = PM.make_mesh(8, devices="cpu")
    assert m.devices == [CPU] * 8 and m.single_device
    assert PM.make_mesh(devices="cpu").n == 1
    db = Database(device=DeviceConfig(mesh_shards=8), torch_device="cpu")
    assert db.mesh_devices == [CPU] and db.torch_device == CPU
    db = Database(device=DeviceConfig(mesh_shards=8), torch_device=TWO)
    assert db.mesh_devices == TWO and db.torch_device == CPU
    db = Database(device=4, torch_device=TWO)
    assert db.device.mesh.devices == [CPU, CPU0] * 2
    assert Database(torch_device=TWO).mesh_devices is None


# ---------------------------------------------------------------------------
# the fused jobs over two device names against one device
# ---------------------------------------------------------------------------


def _fused(name, devices, replicas):
    mv, srcs, capacity = QUERIES[name]
    db = Database(device=DeviceConfig(capacity=capacity, mesh_shards=8,
                                      replicas=replicas),
                  torch_device=devices)
    for s in srcs:
        db.run(s.format(n=N, c=CHUNK))
    db.run(mv)
    job = db._fused[name]
    for _ in range(N // (64 * CHUNK) + 3):
        db.tick()
    job.sync()
    return db.query(f"SELECT * FROM {name}"), job


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _bits_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x.reshape(-1).numpy().view(np.uint8),
                              y.reshape(-1).numpy().view(np.uint8))


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_fused_job_over_two_devices_equals_one_device(name):
    want, one = _fused(name, "cpu", 2)
    assert one.program.mesh.devices == [CPU] * 8
    assert one.growth_replays >= 1
    for replicas in (1, 2):
        got, job = _fused(name, TWO, replicas)
        mesh = job.program.mesh
        if replicas == 1:
            # neighbouring shards on different devices
            assert not mesh.single_device
            assert mesh.devices == [CPU, CPU0] * 4
        else:
            # the data shards on `cpu`, the replica column on `cpu:0`
            assert mesh.column(0) == [CPU] * 8
            assert mesh.column(1) == [CPU0] * 8
            _bits_equal(job.program.replica_states,
                        one.program.replica_states)
        assert got == want
        assert (job.counter, job.committed, job.growth_replays) \
            == (one.counter, one.committed, one.growth_replays)
        assert np.array_equal(job._stat_totals, one._stat_totals)
        assert [n.cap_current() for n in job.program.nodes] \
            == [n.cap_current() for n in one.program.nodes]
        _bits_equal(job.states, one.states)


# ---------------------------------------------------------------------------
# the per-operator sharded engines over two device names
# ---------------------------------------------------------------------------

AGG_MV = ("CREATE MATERIALIZED VIEW m AS SELECT k, count(*) AS c,"
          " sum(v) AS s, max(v) AS x FROM t GROUP BY k")
JOIN_MV = ("CREATE MATERIALIZED VIEW j AS SELECT t.k, t.v, u.w FROM t"
           " JOIN u ON t.k = u.k")


def _engines(devices):
    rng = np.random.default_rng(26)
    db = Database(device=8, torch_device=devices)
    db.run("CREATE TABLE t (k BIGINT, v BIGINT)")
    db.run("CREATE TABLE u (k BIGINT, w BIGINT)")
    db.run(AGG_MV)
    db.run(JOIN_MV)
    out = []

    def load(n):
        ks, vs = rng.integers(0, 97, n), rng.integers(-1000, 1000, n)
        db.run("INSERT INTO t VALUES " + ", ".join(
            f"({k}, {v})" for k, v in zip(ks, vs)))
        db.run("INSERT INTO u VALUES " + ", ".join(
            f"({k}, {v})" for k, v in zip(ks[:n // 4], vs[:n // 4])))
        db.run("DELETE FROM t WHERE v < -900")
        out.append((sorted(db.query("SELECT * FROM m")),
                    sorted(db.query("SELECT * FROM j"))))
    load(400)
    assert db.run("ALTER MATERIALIZED VIEW m SET PARALLELISM 3") \
        == ["ALTER_PARALLELISM_1"]
    assert db.run("ALTER MATERIALIZED VIEW j SET PARALLELISM 3")[0] \
        .startswith("ALTER_PARALLELISM_")
    load(300)
    (agg,) = [e for e in _walk_executors(db.catalog.get("m")
                                         .runtime["shared"].upstream)
              if isinstance(e, DeviceHashAggExecutor)]
    return out, agg.mesh


def test_sharded_engines_over_two_devices_through_rescale():
    want, one = _engines("cpu")
    assert one.devices == [CPU] * 3
    got, two = _engines(TWO)
    assert two.devices == [CPU, CPU0, CPU] and not two.single_device
    assert got == want
    assert all(m and j for m, j in got)
