"""qlj_proc, the card path of worker-process placement, on the CPU: Nexmark
auctions LEFT JOIN bids (no condition, so not device-eligible) spread
over 4 worker processes (`RemoteStatefulSet`, the coordinator keeping
the join's shadows), feeding a device aggregation
(`DeviceHashAggExecutor`, its retractable `max` on the multiset tables)
on the coordinator. The port's `Database(device=DeviceConfig(fuse=False),
torch_device="cpu")` against the reference's `Database(device=
DeviceConfig(fuse=False))` under the same settings (parallelism 4,
process placement, a checkpoint every tick): equal rows, equal plans —
the pre-aggregation projection carries the join's stream key (`_rk`
columns) in both — and equal rows from the port's host-only run. Also:
a fresh process, where the port's worker module and a spawned worker
load neither `jax` nor the JAX package and the worker's argv names the
port's module; EXPLAIN ANALYZE's worker annotations on real sets; and a
device join's output crossing the socket exchange into an agg's
workers."""
import json
import re
import os
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke as cs
from sql_mirror import process_case

ROOT = Path(__file__).resolve().parents[1]
N, CHUNK = 1 << 12, 256


def _db(pkg, device):
    if pkg == "ref":
        from risingwave_tpu.config import DeviceConfig
        from risingwave_tpu.sql import Database
        return Database(device=DeviceConfig(fuse=False) if device else None,
                        checkpoint_frequency=1)
    from risingwave_tpu_torch.config import DeviceConfig
    from risingwave_tpu_torch.sql import Database
    return Database(device=DeviceConfig(fuse=False) if device else None,
                    torch_device="cpu" if device else None,
                    checkpoint_frequency=1)


def _walk(pkg, db, name):
    mod = ("risingwave_tpu" if pkg == "ref" else "risingwave_tpu_torch")
    walk = __import__(f"{mod}.sql.database",
                      fromlist=["_walk_executors"])._walk_executors
    return list(walk(db.catalog.get(name).runtime["shared"].upstream))


def run_qlj(pkg, device=True, placement="process"):
    """(sorted rows, executors, remote sets) of qlj_proc at N events."""
    db = _db(pkg, device)
    for src in (cs.SQL_AUCTION_SRC, cs.SQL_BID_SRC):
        db.run(src.format(n=N, c=CHUNK))
    db.run(f"SET streaming_parallelism = {cs.QLJ_PARALLELISM}")
    db.run(f"SET streaming_placement = '{placement}'")
    db.run(cs.SQL_QLJ_MV)
    execs = _walk(pkg, db, "qlj")
    sets = [r for _n, r in db._remote_sets()]
    try:
        for _ in range(N // (64 * CHUNK) + 4):
            db.tick()
        rows = sorted(db.query("SELECT * FROM qlj"))
    finally:
        for r in sets:
            r.shutdown()
    return rows, execs, sets


def _shape(execs):
    """Each executor's class and output columns (name, type), in walk
    order."""
    return [(type(e).__name__,
             [(f.name, f.dtype.kind.name) for f in e.schema.fields])
            for e in execs if hasattr(e, "schema")]


def test_qlj_proc_rows_and_plan_equal_reference():
    with process_case():
        ref_rows, ref_execs, ref_sets = run_qlj("ref")
        rows, execs, sets = run_qlj("port")
        host_rows, host_execs, host_sets = run_qlj("port", device=False)
    assert len(rows) > 100
    assert rows == ref_rows
    assert host_rows == rows
    classes = [type(e).__name__ for e in execs]
    assert "DeviceHashAggExecutor" in classes
    assert [type(r).__name__ for r in sets] == ["RemoteStatefulSet"]
    (join,) = sets
    assert join.kind == "join" and len(join.workers) == cs.QLJ_PARALLELISM
    (agg,) = [e for e in execs if type(e).__name__ ==
              "DeviceHashAggExecutor"]
    assert len(agg.minput_tables) == 1, "the retractable max's multiset"
    # the plans' executors and their columns, the carried `_rk` stream
    # key of the pre-agg projection included, equal the reference's
    assert _shape(execs) == _shape(ref_execs)
    pre = [e for e in execs if type(e).__name__ == "ProjectExecutor"][-1]
    names = [f.name for f in pre.schema.fields]
    assert [n for n in names if n.startswith("_rk")], names
    assert _shape(host_execs) == _shape(run_qlj_plan_only("ref"))
    assert [type(r).__name__ for r in host_sets] == \
        ["RemoteStatefulSet", "RemoteStatefulSet"]


def run_qlj_plan_only(pkg):
    """The reference's host-only process-placement plan (no drive)."""
    with process_case():
        db = _db(pkg, False)
        for src in (cs.SQL_AUCTION_SRC, cs.SQL_BID_SRC):
            db.run(src.format(n=N, c=CHUNK))
        db.run(f"SET streaming_parallelism = {cs.QLJ_PARALLELISM}")
        db.run("SET streaming_placement = 'process'")
        db.run(cs.SQL_QLJ_MV)
        try:
            return _walk(pkg, db, "qlj")
        finally:
            for _n, r in db._remote_sets():
                r.shutdown()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_local_placement_projection_carries_no_key(pkg):
    """Under local placement no `_rk` column is carried, in both
    packages: the carry is process placement's alone."""
    db = _db(pkg, False)
    for src in (cs.SQL_AUCTION_SRC, cs.SQL_BID_SRC):
        db.run(src.format(n=N, c=CHUNK))
    db.run(cs.SQL_QLJ_MV)
    names = [f.name for e in _walk(pkg, db, "qlj")
             if type(e).__name__ == "ProjectExecutor"
             for f in e.schema.fields]
    assert not [n for n in names if n.startswith("_rk")]


def test_worker_is_the_ports_and_loads_no_jax():
    """A fresh interpreter imports the port's worker module and spawns
    one worker through `_spawn_worker`: the worker's argv names
    `risingwave_tpu_torch.runtime.worker`, and neither process imports
    `jax` or the JAX package (the child's imports are read off
    `PYTHONPROFILEIMPORTTIME` on the inherited stderr)."""
    code = (
        "import sys, json\n"
        "import risingwave_tpu_torch.runtime.worker\n"
        "from risingwave_tpu_torch.runtime import remote_fragments as rf\n"
        "from risingwave_tpu_torch.runtime.exchange_net import "
        "ExchangeServer\n"
        "server = ExchangeServer()\n"
        "plan = {'coord': list(server.addr), 'in_channel': 0,"
        " 'in_schema': [['k', 'bigint']], 'append_only': True,"
        " 'fragment': {'kind': 'partial_hash_agg', 'group_indices': [0],"
        " 'calls': [['count', None]]}}\n"
        "w = rf._spawn_worker(plan)\n"
        "argv = open(f'/proc/{w.proc.pid}/cmdline', 'rb').read()"
        ".split(b'\\0')\n"
        "w.proc.kill(); w.proc.wait(); server.close()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'risingwave_tpu'"
        " or m.startswith('risingwave_tpu.'))\n"
        "print(json.dumps({'argv': [a.decode() for a in argv[:3]],"
        " 'bad': bad, 'pid': w.proc.pid}))\n")
    env = dict(os.environ, PYTHONPROFILEIMPORTTIME="1",
               PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["argv"][1:] == ["-m", "risingwave_tpu_torch.runtime.worker"]
    assert out["bad"] == []
    imported = [ln.rsplit("|", 1)[1].strip()
                for ln in r.stderr.splitlines()
                if ln.startswith("import time:") and "|" in ln]
    assert "risingwave_tpu_torch.runtime.worker" in imported or \
        "risingwave_tpu_torch.runtime.exchange_net" in imported
    # both the parent and the worker (whose stderr is the parent's)
    assert not [m for m in imported
                if m.split(".")[0] in ("jax", "risingwave_tpu")]


_ANALYZE_LIVE = [(re.compile(r"pid=\d+"), "pid=<pid>"),
                 (re.compile(r"epoch=-?\d+"), "epoch=<epoch>"),
                 (re.compile(r"hb_age=-?[0-9.]+s"), "hb_age=<s>")]


def _analyze(pkg):
    """A host-only process-placed qlj after a drive: (EXPLAIN ANALYZE's
    outcome, the worker annotations of each remote set's merge — what
    EXPLAIN ANALYZE prints beside it — with pids, epochs and heartbeat
    ages masked)."""
    mod = ("risingwave_tpu" if pkg == "ref" else "risingwave_tpu_torch")
    cat = __import__(f"{mod}.sql.system_catalog", fromlist=["_label"])
    with process_case():
        db = _db(pkg, False)
        for src in (cs.SQL_AUCTION_SRC, cs.SQL_BID_SRC):
            db.run(src.format(n=1 << 10, c=64))
        db.run(f"SET streaming_parallelism = {cs.QLJ_PARALLELISM}")
        db.run("SET streaming_placement = 'process'")
        db.run(cs.SQL_QLJ_MV)
        try:
            for _ in range(6):
                db.tick()
            try:
                outcome = db.run("EXPLAIN ANALYZE qlj")[0]
            except AttributeError as e:
                outcome = ("AttributeError", str(e))
            bits = [b for e in _walk(pkg, db, "qlj")
                    if getattr(e, "_remote", None) is not None
                    for b in cat._analyze_bits(e)
                    if "queue[" not in b]
        finally:
            for _n, r in db._remote_sets():
                r.shutdown()
    for pat, sub in _ANALYZE_LIVE:
        bits = [pat.sub(sub, b) for b in bits]
    return outcome, bits


def test_explain_analyze_worker_rows():
    """EXPLAIN ANALYZE's annotation of a remote set names each worker
    (its pid, liveness state, last result epoch, heartbeat age), as the
    reference's does, for both sets of the host-only plan. The whole
    statement raises in both packages over a process-placed MV (the
    merge's channels carry no `name` for `_label`: ROADMAP queue 3, a
    hazard of the reference kept)."""
    outcome, bits = _analyze("port")
    assert (outcome, bits) == _analyze("ref")
    assert outcome[0] == "AttributeError"
    assert sorted(bits) == sorted(
        f"{kind}{i}[pid=<pid> ok epoch=<epoch> hb_age=<s>]"
        for kind in ("join", "stateful")
        for i in range(cs.QLJ_PARALLELISM))


DJ_MV = ("CREATE MATERIALIZED VIEW dj AS SELECT a.category,"
         " max(p.name) AS top_name, count(*) AS n"
         " FROM auction a JOIN person p ON a.seller = p.id"
         " GROUP BY a.category")


def _dj(pkg, device, placement):
    """(sorted rows, executor classes, remote sets' kinds) of `DJ_MV`:
    under a device policy the inner join is a device join, and the agg
    (a max over VARCHAR: no device agg) goes to worker processes."""
    db = _db(pkg, device)
    for src in (cs.SQL_AUCTION_SRC, cs.SQL_PERSON_SRC):
        db.run(src.format(n=1 << 12, c=256))
    db.run(f"SET streaming_parallelism = {cs.QLJ_PARALLELISM}")
    db.run(f"SET streaming_placement = '{placement}'")
    db.run(DJ_MV)
    classes = [type(e).__name__ for e in _walk(pkg, db, "dj")]
    sets = [r for _n, r in db._remote_sets()]
    try:
        for _ in range(8):
            db.tick()
        rows = sorted(db.query("SELECT * FROM dj"))
    finally:
        for r in sets:
            r.shutdown()
    return rows, classes, [r.kind for r in sets]


def test_device_join_output_feeds_remote_agg():
    """A device engine's output crosses the socket exchange: the device
    join emits host chunks, which the coordinator shadows, dispatches and
    encodes as K frames for the agg's workers. Rows equal the
    reference's under the same policy and the port's host-only local
    run's."""
    with process_case():
        rows, classes, kinds = _dj("port", True, "process")
        ref_rows, ref_classes, ref_kinds = _dj("ref", True, "process")
        host_rows, _c, host_kinds = _dj("port", False, "local")
    assert "DeviceHashJoinExecutor" in classes
    assert "DeviceHashAggExecutor" not in classes
    # the inner join of two append-only sources is append-only: the
    # 2-phase plan (partial aggs in the workers, the final agg here)
    assert kinds == ["partial"] and host_kinds == []
    assert (rows, classes, kinds) == (ref_rows, ref_classes, ref_kinds)
    assert rows == host_rows and len(rows) > 3
