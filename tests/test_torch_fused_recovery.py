"""The port's fused-job recovery (`risingwave_tpu_torch/device/fused.py`
`FusedJob`, on the CPU) against the JAX package's: the bounded epoch log
and its spill file, in-place recovery from each of the four `fused.*`
failpoints on Nexmark q1a and q5 (recoveries, counters, rows and every
state leaf equal to the reference's and to an undisturbed run), the
recovery attempts' bound, what counts as a device fault (a kernel launch
the runtime refused does, an argument check's `ValueError` does not), the
restart to the committed counter with presized capacities, the tiering
journal file line by line with the cold stores it rebuilds, a growth
inside a recovery's replay, and the host-ingest admission buckets
(deferral and throttle, call by call).

Both packages run their SQL `Database`s; the reference's jobs are built
with the compile service off, the port's on the CPU."""
import importlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from risingwave_tpu.config import ROBUSTNESS as REF_ROBUSTNESS
from risingwave_tpu.config import DeviceConfig as RefConfig
from risingwave_tpu.sql import Database as RefDatabase
from risingwave_tpu_torch.config import ROBUSTNESS as PORT_ROBUSTNESS
from risingwave_tpu_torch.config import DeviceConfig as PortConfig
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.device.state_io import states_to_numpy
from risingwave_tpu_torch.kernels import binding
from risingwave_tpu_torch.sql import Database as PortDatabase
from risingwave_tpu.device import fused as JF
from torch_parity import store_dump

REF_FP = importlib.import_module("risingwave_tpu.utils.failpoint")
PORT_FP = importlib.import_module("risingwave_tpu_torch.utils.failpoint")
FPS = {"ref": REF_FP, "port": PORT_FP}

CHUNK = 32                     # fused epoch = 64 * CHUNK = 2048 events
N = 8192                       # four epochs
POINTS = ("fused.dispatch", "fused.device_sync", "fused.checkpoint_commit",
          "fused.growth_replay")

BID_SRC = ("CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,"
           " channel VARCHAR, url VARCHAR, date_time TIMESTAMP,"
           " extra VARCHAR) WITH (connector='nexmark',"
           " nexmark.table='bid', nexmark.max.events='{n}',"
           " nexmark.chunk.size='{c}'{x})")
HOP = "HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND)"
MVS = {
    "q1a": ("SELECT bidder, count(*) AS n, sum(price) AS dol,"
            " max(price) AS top FROM bid GROUP BY bidder"),
    "q4": ("SELECT auction, count(*) AS c, sum(price) AS s,"
           " max(price) AS m FROM bid GROUP BY auction"),
    "q5": ("SELECT AuctionBids.auction, AuctionBids.num FROM ("
           " SELECT bid.auction, count(*) AS num, window_start AS starttime"
           f" FROM {HOP} GROUP BY window_start, bid.auction) AS AuctionBids"
           " JOIN (SELECT max(CountBids.num) AS maxn,"
           " CountBids.starttime_c FROM (SELECT count(*) AS num,"
           f" window_start AS starttime_c FROM {HOP}"
           " GROUP BY bid.auction, window_start) AS CountBids"
           " GROUP BY CountBids.starttime_c) AS MaxBids"
           " ON AuctionBids.starttime = MaxBids.starttime_c"
           " AND AuctionBids.num >= MaxBids.maxn"),
    "qa": ("SELECT auction, count(*) AS n, sum(price) AS dol FROM bid"
           " GROUP BY auction"),
}


@pytest.fixture(autouse=True)
def _clean():
    saved = [(R, R.fused_recovery_attempts, R.fused_epoch_log_bytes)
             for R in (REF_ROBUSTNESS, PORT_ROBUSTNESS)]
    for fp in FPS.values():
        fp.reset()
    yield
    for fp in FPS.values():
        fp.reset()
    for R, a, b in saved:
        R.fused_recovery_attempts, R.fused_epoch_log_bytes = a, b


def make(pkg, name, cap=512, n=N, data_dir=None, x="", chunk=CHUNK,
         **cfg):
    if pkg == "ref":
        db = RefDatabase(device=RefConfig(capacity=cap, aot_compile=False,
                                          compile_buckets=0, **cfg),
                         data_dir=data_dir)
    else:
        db = PortDatabase(device=PortConfig(capacity=cap, **cfg),
                          data_dir=data_dir, torch_device="cpu")
    db.run(BID_SRC.format(n=n, c=chunk, x=x))
    db.run(f"CREATE MATERIALIZED VIEW {name} AS {MVS[name]}")
    assert name in db._fused, pkg
    return db


def ticks_of(n, chunk=CHUNK):
    return n // (64 * chunk) + 3


def job_image(job):
    return (int(job.counter), int(job.committed), int(job.growth_replays),
            int(job.retraces), int(job.growths), int(job.recoveries),
            [sorted(nd.cap_current().items()) for nd in job.program.nodes],
            [int(v) for v in job._stat_totals])


def assert_states(port_job, ref_job):
    got = jax.tree_util.tree_leaves(states_to_numpy(port_job.program,
                                                    port_job.states))
    exp = jax.tree_util.tree_leaves(jax.device_get(ref_job.states))
    assert len(got) == len(exp)
    for i, (a, b) in enumerate(zip(got, exp)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert np.array_equal(a, b), i


# ---------------------------------------------------------------------------
# the epoch log
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap_entries,n", [(8, 30), (8, 8), (20, 90)])
def test_epoch_log_spills_reloads_and_clears(cap_entries, n, tmp_path):
    """The same appends fill, spill and reload both packages' logs the
    same way; the spill files are equal line by line."""
    logs = {}
    for pkg, mod in (("ref", JF), ("port", PF)):
        d = tmp_path / pkg
        d.mkdir()
        log = mod._EpochLog(cap_bytes=cap_entries * 16,
                            dir_of=lambda d=d: str(d))
        for i in range(n):
            log.append(i * 10, 10 + i % 3)
        logs[pkg] = (log, d / mod.EPOCH_LOG_SPILL)
    (p, pf), (r, rf) = logs["port"], logs["ref"]
    assert (p.cap_entries, p.spilled, p.spill_total, p._mem, len(p)) == \
        (r.cap_entries, r.spilled, r.spill_total, r._mem, len(r))
    want = [(i * 10, 10 + i % 3) for i in range(n)]
    assert p.entries() == r.entries() == want
    assert pf.exists() == rf.exists() == (n > cap_entries)
    if pf.exists():
        assert pf.read_text().splitlines() == rf.read_text().splitlines()
    p.clear()
    r.clear()
    assert p.entries() == r.entries() == [] and len(p) == 0
    assert not pf.exists() and not rf.exists()


def test_epoch_log_without_data_dir_stays_in_memory():
    log = PF._EpochLog(cap_bytes=8 * 16, dir_of=lambda: None)
    for i in range(20):
        log.append(i, 1)
    assert log.spilled == 0 and len(log._mem) == 20
    assert log.entries() == [(i, 1) for i in range(20)]


# ---------------------------------------------------------------------------
# in-place recovery at each failpoint
# ---------------------------------------------------------------------------


def drive_armed(pkg, name, point, cap):
    """The job driven to drained with `point` armed to fire once: from
    the start for the growth replay (a small capacity grows at once),
    after the second epoch's tick for the others."""
    db = make(pkg, name, cap=cap)
    job = db._fused[name]
    trace = []
    for k in range(ticks_of(N)):
        if point is not None and k == (0 if point == "fused.growth_replay"
                                       else 2):
            FPS[pkg].arm(point, 1.0, 0, 1)
        db.tick()
        trace.append(job_image(job)[:6])
    FPS[pkg].reset()
    return db, job, trace, db.query(f"SELECT * FROM {name}")


@pytest.mark.parametrize("name,cap", [("q1a", 64), ("q5", 64)])
@pytest.mark.parametrize("point", POINTS)
def test_inplace_recovery_matches_reference(name, cap, point):
    """One fault heals in place in both packages: the same job object, one
    recovery, the same counters tick by tick, and rows, capacities,
    stats totals and every state leaf equal to the reference's and to an
    undisturbed run's."""
    _, _, _, want = drive_armed("port", name, None, cap)
    rdb, ref, rtrace, rrows = drive_armed("ref", name, point, cap)
    pdb, port, ptrace, prows = drive_armed("port", name, point, cap)
    assert port.recoveries == 1 and pdb._fused[name] is port
    assert ptrace == rtrace
    assert prows == rrows == want and len(want) > 0
    assert job_image(port) == job_image(ref)
    assert_states(port, ref)
    if point == "fused.growth_replay":
        assert port.growth_replays >= 1


def test_recovery_attempts_bound_escalates():
    """A fault that fires on every try (a sticky device error) escalates
    past ROBUSTNESS.fused_recovery_attempts with the original error, in
    both packages."""
    for pkg, R in (("ref", REF_ROBUSTNESS), ("port", PORT_ROBUSTNESS)):
        R.fused_recovery_attempts = 2
        db = make(pkg, "q1a")
        job = db._fused["q1a"]
        db.tick()
        FPS[pkg].arm("fused.dispatch", 1.0, 0, None)
        with pytest.raises(FPS[pkg].FailpointError, match="fused.dispatch"):
            db.tick()
        assert job.recoveries == 2 and job._recovery_attempts == 3, pkg


def test_device_fault_classes():
    """What in-place recovery may absorb: a failpoint, a refused kernel
    launch, an out-of-memory or accelerator error; never an argument
    check's ValueError, a packed-key bound RuntimeError or control flow."""
    with pytest.raises(ValueError) as arg:
        binding._check_keys(torch.zeros(4, dtype=torch.int64), "probe")
    assert not PF._is_device_fault(arg.value)
    with pytest.raises(binding.KernelLaunchError) as launch:
        binding._check_rc(3 * binding._SITE_STRIDE + 700, "merge")
    assert isinstance(launch.value, RuntimeError)
    assert "cudaError 700" in str(launch.value)
    assert PF._is_device_fault(launch.value)
    assert PF._is_device_fault(PORT_FP.FailpointError("fused.dispatch"))
    assert PF._is_device_fault(torch.OutOfMemoryError("out of memory"))
    acc = getattr(torch, "AcceleratorError", None)
    if acc is not None:
        assert PF._is_device_fault(acc("illegal memory access"))
    assert not PF._is_device_fault(RuntimeError("packed-key bounds"))
    assert not PF._is_device_fault(KeyboardInterrupt())
    assert not PF._is_device_fault(SystemExit(1))


@pytest.mark.parametrize("exc,heals", [
    (binding.KernelLaunchError("launch of k_merge_tiles failed"), True),
    (ValueError("merge: keys must be a contiguous 1-D int64 CUDA tensor"),
     False)])
def test_step_fault_heals_or_propagates(exc, heals, monkeypatch):
    """A refused launch inside an epoch step recovers in place, with rows
    equal to an undisturbed run's; an argument check's ValueError from
    the same place propagates with no recovery."""
    want = drive_armed("port", "q1a", None, 512)[3]
    db = make("port", "q1a")
    job = db._fused["q1a"]
    db.tick()
    db.tick()
    step = job.program.step
    fired = []

    def failing(*a, **kw):
        if not fired:
            fired.append(1)
            raise exc
        return step(*a, **kw)
    monkeypatch.setattr(job.program, "step", failing)
    if not heals:
        with pytest.raises(ValueError):
            db.tick()
        assert job.recoveries == 0
        return
    for _ in range(ticks_of(N)):
        db.tick()
    assert job.recoveries == 1
    assert db.query("SELECT * FROM q1a") == want


@pytest.mark.parametrize("name", ["q1a", "qa"])
def test_growth_in_recovery_replay_replays_from_empty(name, monkeypatch,
                                                      tmp_path):
    """A recovery whose history replay overflows a capacity (a host-fed
    replay re-cuts its windows, which can need more than the live ones
    did) grows and replays the history again from empty state, the tier
    journal re-enacted: one more growth replay, rows equal an undisturbed
    run's. The overflow is injected into the first sync after the
    recovery's replay."""
    if name == "q1a":
        want = drive_armed("port", "q1a", None, 512)[3]
        db = make("port", "q1a")
        job = db._fused["q1a"]
        ticks = ticks_of(N)
    else:
        db, job = _tiered("port", str(tmp_path / "want"), monkeypatch)
        want = db.query("SELECT * FROM qa")
        db = make("port", "qa", cap=512, n=16384, chunk=8)
        job = db._fused["qa"]
        ticks = ticks_of(16384, 8)
    ai = next(i for i, nd in enumerate(job.program.nodes)
              if type(nd).__name__ == "AggNode")
    agg = job.program.nodes[ai]
    replay = job._replay_history
    state = {"armed": False, "fired": 0}

    def replay_then_overflow(target):
        replay(target)
        state["armed"] = state["fired"] == 0
        if job.tiering is not None:
            state["journal"] = len(job.tiering.events_between(0, target))
    cap_needs = type(agg).cap_needs

    def needs(self, st):
        nd = cap_needs(self, st)
        if self is agg and state["armed"]:
            state["armed"], state["fired"] = False, 1
            slot = sorted(self.cap_current())[0]
            nd = dict(nd, **{slot: self.cap_current()[slot] + 1})
        return nd
    monkeypatch.setattr(job, "_replay_history", replay_then_overflow)
    monkeypatch.setattr(type(agg), "cap_needs", needs)
    for k in range(ticks):
        if k == ticks // 2:
            PORT_FP.arm("fused.dispatch", 1.0, 0, 1)
            replays = job.growth_replays
        db.tick()
    job.sync()
    db.tick()
    assert state["fired"] == 1 and job.recoveries == 1
    assert job.growth_replays == replays + 1
    assert db.query(f"SELECT * FROM {name}") == want
    if name == "qa":               # the replays re-enacted demotions
        assert state["journal"] > 0


def test_recovery_record_metrics_and_log_trim(tmp_path):
    """A recovery leaves its flight-recorder record and metric samples;
    the checkpoint trims the epoch log, and a barrier without checkpoint
    keeps it (the crash window)."""
    from risingwave_tpu_torch.utils.blackbox import RECORDER
    from risingwave_tpu_torch.utils.metrics import REGISTRY
    db = make("port", "q1a", data_dir=str(tmp_path / "d"))
    job = db._fused["q1a"]
    db.tick()
    assert len(job._epoch_log) == 0 and job.committed == 2048
    barrier = SimpleNamespace(is_checkpoint=False,
                              epoch=SimpleNamespace(curr=10 ** 6))
    job.on_barrier(barrier)
    assert job._epoch_log.entries() == [(2048, 2048)]
    PORT_FP.arm("fused.device_sync", 1.0, 0, 1)
    rows = job.mv_rows_now()            # heals inside the serving pull
    assert job.recoveries == 1 and len(rows) > 0
    assert job.counter == 4096 and job.committed == 2048
    rec = [json.loads(ln) for ln, kind in list(RECORDER._ring)
           if kind == "recovery"][-1]
    assert rec["job"] == "q1a" and rec["replayed_epochs"] == 2048
    assert rec["error"] == "FailpointError"
    text = REGISTRY.expose()
    assert "fused_recoveries_total" in text
    assert "fused_recovery_seconds" in text


# ---------------------------------------------------------------------------
# restart to the committed counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["q4", "q5"])
def test_restart_presizes_and_matches_reference(name, tmp_path):
    """A reopened Database replays each package's job to its committed
    counter at the persisted high-water capacities: zero new growth
    replays, and rows, committed counter, growth counters, capacities,
    stats totals and states equal to the reference's reopen."""
    out = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        db = make(pkg, name, cap=64, data_dir=d)
        for _ in range(ticks_of(N)):
            db.tick()
        job = db._fused[name]
        before = (job.committed, job.growth_replays,
                  [nd.cap_current() for nd in job.program.nodes],
                  db.query(f"SELECT * FROM {name}"))
        assert job.growth_replays >= 1
        del db, job
        if pkg == "ref":
            db2 = RefDatabase(device=RefConfig(capacity=64,
                                               aot_compile=False,
                                               compile_buckets=0),
                              data_dir=d)
        else:
            db2 = PortDatabase(device=PortConfig(capacity=64), data_dir=d,
                               torch_device="cpu")
        job2 = db2._fused[name]
        assert (job2.committed, job2.growth_replays,
                [nd.cap_current() for nd in job2.program.nodes]) \
            == before[:3], pkg
        assert db2.query(f"SELECT * FROM {name}") == before[3], pkg
        out[pkg] = (db2, job2)
    (pdb, port), (_, ref) = out["port"], out["ref"]
    assert job_image(port) == job_image(ref)
    assert port._persisted.keys() == ref._persisted.keys()
    assert_states(port, ref)
    assert port._last_persist == ref._last_persist
    # the reopened job carries on: one more tick changes nothing drained
    pdb.tick()
    assert port.growth_replays == ref.growth_replays


def test_restart_with_nothing_committed_clears_stale_log(tmp_path):
    """A job table without a committed counter recovers as a no-op, and a
    predecessor's spilled epoch log is dropped."""
    d = tmp_path / "d"
    db = make("port", "q4", data_dir=str(d))
    job = db._fused["q4"]
    (d / PF.EPOCH_LOG_SPILL).write_text("[0, 2048]\n")
    job._epoch_log.spilled = 1
    job.recover()
    assert job.committed == 0 and not (d / PF.EPOCH_LOG_SPILL).exists()


# ---------------------------------------------------------------------------
# the tiering journal file
# ---------------------------------------------------------------------------


def _tiered(pkg, d, monkeypatch, n=16384):
    for k, v in (("RW_STATE_TIERING", "1"), ("RW_HOST_INGEST", "1"),
                 ("RW_TIER_HIGH_WATER", "0.35"),
                 ("RW_TIER_LOW_WATER", "0.15"), ("RW_SKEW_STATS", "0"),
                 ("RW_AGG_PRECOMBINE", "0")):
        monkeypatch.setenv(k, v)
    db = make(pkg, "qa", cap=512, n=n, data_dir=d, chunk=8)
    job = db._fused["qa"]
    for _ in range(ticks_of(n, 8)):
        db.tick()
    job.sync()
    db.tick()
    return db, job


def test_tier_journal_file_and_restart_match_reference(tmp_path,
                                                       monkeypatch):
    """A host-fed tiered qa writes the same journal file as the
    reference, line by line; a restart over each directory re-enacts it
    into cold stores equal to the pre-restart ones and the reference's,
    and DROP clears it."""
    out = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        db, job = _tiered(pkg, d, monkeypatch)
        assert job.tiering.counters["demote_events"] > 0
        rows = db.query("SELECT * FROM qa")
        dump = store_dump(job.tiering)
        jp = os.path.join(d, "tiering_journal_qa.jsonl")
        with open(jp) as f:
            lines = f.read().splitlines()
        assert len(lines) == job.tiering.counters["demote_events"]
        assert [json.loads(ln)["c"] for ln in lines] == \
            [ev[0] for ev in job.tiering.journal]
        del db, job
        db2 = (RefDatabase(device=RefConfig(capacity=512, mesh_shards=1,
                                            aot_compile=False,
                                            compile_buckets=0),
                           data_dir=d) if pkg == "ref" else
               PortDatabase(device=PortConfig(capacity=512), data_dir=d,
                            torch_device="cpu"))
        job2 = db2._fused["qa"]
        assert job2.tiering is not None and job2.growth_replays == 0
        assert store_dump(job2.tiering) == dump, pkg
        assert db2.query("SELECT * FROM qa") == rows, pkg
        out[pkg] = (lines, rows, dump, db2, job2, jp)
    assert out["port"][:3] == out["ref"][:3]
    assert_states(out["port"][4], out["ref"][4])
    db2, jp = out["port"][3], out["port"][5]
    db2.run("DROP MATERIALIZED VIEW qa")
    assert not os.path.exists(jp)


def test_journal_truncates_torn_tail(tmp_path):
    """load_journal skips a torn line; truncate_journal drops events past
    the committed counter and rewrites the file as the reference does."""
    from risingwave_tpu.device.tiering import TieringManager as RefTM
    from risingwave_tpu_torch.device.tiering import TieringManager as PortTM
    texts = []
    for pkg, cls in (("ref", RefTM), ("port", PortTM)):
        tm = cls([], 1)
        path = str(tmp_path / f"{pkg}.jsonl")
        tm.set_journal_path(path)
        for c in (2048, 4096, 6144):
            tm.record(c, 2, -1, [c + 1, c + 2])
        with open(path, "a") as f:
            f.write('{"c": 8192, "n": 2')           # torn by a crash
        tm.load_journal()
        assert [ev[0] for ev in tm.journal] == [2048, 4096, 6144]
        tm.truncate_journal(4096)
        with open(path) as f:
            texts.append(f.read())
        assert tm.events_between(0, 8192) == [
            (2048, [(2, -1, [2049, 2050])]), (4096, [(2, -1, [4097, 4098])])]
        tm.clear_journal()
        assert tm.journal == [] and not os.path.exists(path)
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# host ingest: admission buckets
# ---------------------------------------------------------------------------


def settle(ingest):
    """Wait out the prefetch thread's staging in flight: the next window
    is cut (its admission decided) before the test reads or changes a
    bucket, in either package."""
    with ingest._cv:
        while ingest._inflight_lo is not None:
            ingest._cv.wait(0.05)


def test_admission_defer_and_throttle_match_reference():
    """A throttled bucket shrinks the windows, a starved one defers them
    (the counter stands still), and a burst of stretched barriers drains
    the backlog: both packages move tick by tick alike (counter, bucket
    counters, windows) and end on the device-datagen rows."""
    want = drive_armed("port", "q1a", None, 512)[3]
    out = {}
    for pkg in ("ref", "port"):
        mod = importlib.import_module(
            "risingwave_tpu.utils.overload" if pkg == "ref"
            else "risingwave_tpu_torch.utils.overload")
        db = make(pkg, "q1a", x=", nexmark.ingest='host'")
        job = db._fused["q1a"]
        wired = job.ingest.buckets["bid"]
        assert wired is db._overload.buckets["bid"]
        bucket = mod.AdmissionBucket("bid")
        job.ingest.buckets["bid"] = bucket
        trace = []

        def tick():
            db.tick()
            settle(job.ingest)
            trace.append((job.counter, job.committed, bucket.row(),
                          list(job.ingest.recent_windows)))
        bucket.factor = 0.25
        for _ in range(3):
            tick()

        class Starved(mod.AdmissionBucket):
            def epoch_refill(self, mult=1):
                self.tokens = 0
        starved = Starved("bid")
        job.ingest.buckets["bid"] = starved
        tick()
        c0 = job.counter
        tick()
        assert job.counter == c0 and starved.deferred >= 1, pkg
        bucket.factor = 1.0
        job.ingest.buckets["bid"] = bucket
        job.cadence_stretch = 10
        for _ in range(ticks_of(N)):
            tick()
        job.cadence_stretch = 1
        tick()
        assert job.drained
        out[pkg] = (trace, starved.row(), job.ingest.stats()["deferred"],
                    db.query("SELECT * FROM q1a"))
    assert out["port"] == out["ref"]
    assert out["port"][3] == want
    assert any(ev < 2048 for _, ev in out["port"][0][0][3])


def test_admission_peeks_every_bucket_before_consuming():
    """A window of two multiplexed sources cuts only when both have a
    token: the willing source's token stays when the other defers."""
    from risingwave_tpu_torch.device.ingest import HostIngest
    from risingwave_tpu_torch.utils.overload import AdmissionBucket
    srcs = [(0, SimpleNamespace(name="bid", n_feed_cols=1)),
            (1, SimpleNamespace(name="auction", n_feed_cols=1))]
    hi = HostIngest(srcs, 2048, device="cpu")
    a, b = AdmissionBucket("bid", 1), AdmissionBucket("auction", 1)
    hi.buckets = {"bid": a, "auction": b}
    hi.epoch_refill(1)
    b.tokens = 0
    a.factor, b.factor = 0.5, 0.25
    assert hi._admit() == (False, 0.25)
    assert a.tokens == 1 and b.deferred == 1
    b.tokens = 1
    assert hi._admit() == (True, 0.25)
    assert a.tokens == 0 and b.tokens == 0
    a.tokens = b.tokens = 1
    assert hi._cut(0) == (0, 512)
    assert hi._cut(512) == (512, 0)          # both spent: deferred
