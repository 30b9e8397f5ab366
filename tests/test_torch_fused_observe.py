"""The observability slice as a whole on the CPU: the port's fused q4 and
q5 jobs, profiled, traced, flight-recorded and freshness-tracked the way
the reference's `Database` wires them, against the reference's own jobs
(built by its SQL front end with `DeviceConfig.profile` on and a data
directory).

Each reference job is driven by `Database.tick`; its barriers are
recorded and replayed, in order, into the port's job, which gets a
`BarrierTracer`, the port's `RECORDER` and a `FreshnessTracker` on a data
directory of its own. Rows and node reports are exact; the epoch
profiles agree in their record count, `seq` / `events` / `shards`
fields and phase names, and their compile events in count and in the
`i:Type` part of each label (the 8-hex part is each package's own hash).
The compile threshold is lifted in both packages so only the flagged
compiles count (an unflagged slow step is a timing, which is compared by
schema only). Freshness commits fall on the same barrier epochs.
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

import risingwave_tpu.config as RC
import risingwave_tpu.utils.export as RE
import risingwave_tpu.utils.profile as RP
from risingwave_tpu.config import DeviceConfig
from risingwave_tpu.sql import Database
from risingwave_tpu_torch.device import fused as PFU
from risingwave_tpu_torch.utils import blackbox as PB
from risingwave_tpu_torch.utils import export as PE
from risingwave_tpu_torch.utils import freshness as PF
from risingwave_tpu_torch.utils import profile as PP
from risingwave_tpu_torch.utils import trace as PT
from torch_parity import port_job

from test_torch_fused_q4 import BID_SRC, Q4
from test_torch_fused_q5 import Q5

CAP = 16
JOBS = {"q4": (Q4, "q4", 5_000, 32, 5),
        "q5": (Q5, "nexmark_q5", 4_096, 32, 4)}
_RUNS = {}


@pytest.fixture(autouse=True)
def _flagged_compiles_only(monkeypatch):
    monkeypatch.setattr(RP, "COMPILE_THRESHOLD_S", float("inf"))
    monkeypatch.setattr(PP, "COMPILE_THRESHOLD_S", float("inf"))


def reference_run(tmp_path_factory, query, stretch=1):
    """The reference job driven by `Database.tick` over a data directory
    (capacity 16: it grows and replays): (job, the barriers it saw, its
    MV rows, its freshness history). With `stretch` > 1, its overload
    ladder is parked on `degraded` so every tick dispatches `stretch`
    epochs."""
    key = (query, stretch)
    if key in _RUNS:
        return _RUNS[key]
    sql, name, n, chunk, extra = JOBS[query]
    d = str(tmp_path_factory.mktemp(f"ref_{query}_{stretch}"))
    rob = RC.ROBUSTNESS
    kept = (rob.overload_stretch, rob.overload_hold_s)
    try:
        if stretch > 1:
            rob.overload_stretch, rob.overload_hold_s = stretch, 1e9
        db = Database(data_dir=d, device=DeviceConfig(
            capacity=CAP, aot_compile=False, profile=True))
        db.run(BID_SRC.format(n=n, c=chunk))
        db.run(sql)
        job = db._fused[name]
        if stretch > 1:
            db._overload.controller(name).force("degraded")
        seen = []
        inner = job.on_barrier

        def record(b):
            seen.append((b.is_checkpoint, b.epoch.curr, b.kind.value))
            inner(b)
        job.on_barrier = record
        ticks = -(-n // (stretch * job.program.epoch_events)) + extra
        for _ in range(ticks):
            db.tick()
        assert job.cadence_stretch == stretch
        rows = job.mv_rows_now()
        hist = db._freshness.history(name)
    finally:
        rob.overload_stretch, rob.overload_hold_s = kept
    _RUNS[key] = (job, seen, rows, hist, d)
    return _RUNS[key]


def port_run(ref_job, barriers, d, profile=True, stretch=1):
    """The port's job, wired the way `Database` wires a fused job, driven
    through the same barriers: each wrapped in inject -> job_start /
    job_end -> commit."""
    job = port_job(ref_job, CAP, profile=profile)
    job.cadence_stretch = stretch
    job.profiler.attach(d)
    job.data_dir = d
    job.freshness = PF.FreshnessTracker()
    tracer = PT.BarrierTracer(d)
    PB.RECORDER.attach(d)
    PB.RECORDER.record("boot", {"device": "cpu", "data_dir": d})
    try:
        for ckpt, epoch, kind in barriers:
            span = tracer.inject(epoch, kind)
            span.job_start(job.name)
            job.on_barrier(SimpleNamespace(
                is_checkpoint=ckpt, epoch=SimpleNamespace(curr=epoch)))
            span.job_end(job.name)
            span.commit()
        rows = job.mv_rows_now()
    finally:
        PB.RECORDER.attach(None)
    return job, rows, tracer


def profile_view(prof):
    recs = list(prof.ring)
    return ([(r["seq"], r["events"], r["shards"]) for r in recs],
            sorted({p for r in recs for p in r["ph_ms"]}),
            [(label.rsplit(":", 1)[0], kind)
             for label, kind, _s in prof.compiles])


@pytest.mark.parametrize("query", ["q4", "q5"])
def test_profiled_job_matches_reference(tmp_path_factory, query):
    ref_job, barriers, want, ref_fresh, ref_dir = reference_run(
        tmp_path_factory, query)
    d = str(tmp_path_factory.mktemp(f"port_{query}"))
    job, got, tracer = port_run(ref_job, barriers, d)
    assert got == want and len(got) > 0
    assert job.growth_replays == ref_job.growth_replays >= 1
    # the epoch profile: one record per dispatching barrier, the same
    # fields and phase names; compiles: one per node, then the retraces
    # of the grown nodes, with the reference's labels
    spans, phases, compiles = profile_view(job.profiler)
    rspans, rphases, rcompiles = profile_view(ref_job.profiler)
    assert spans == rspans and len(spans) >= 2
    assert phases == rphases
    assert {"pack", "dispatch", "device_sync", "commit"} <= set(phases)
    assert compiles == rcompiles
    n = len(job.program.nodes)
    assert [k for _l, k in compiles[:n]] == ["compile"] * n
    assert [label for label, _k in compiles[:n]] == \
        [f"{i}:{type(nd).__name__}"
         for i, nd in enumerate(job.program.nodes)]
    assert any(k == "retrace" for _l, k in compiles)
    for r in job.profiler.ring:
        ph = sum(r["ph_ms"].values())
        assert ph <= r["wall_ms"] * 1.001 + 0.05
        if r["wall_ms"] > 1.0:
            assert ph >= r["wall_ms"] * 0.9
        assert r["ph_ms"].get("h2d", 0.0) == 0.0
        assert r["ph_ms"].get("exchange", 0.0) == 0.0
    # the jsonl mirror holds the records (to its 1e-3 ms rounding) and
    # summarizes alike in both packages; the live totals (to their 0.05
    # ms rounding) hold them and what ran outside any span (the drained
    # job's checkpoints)
    path = os.path.join(d, PP.PROFILE_FILE)
    summ = PP.summarize_file(path)[job.name]
    assert summ == RP.summarize_file(path)[job.name]
    assert summ["epochs"] == job.profiler.summary()["epochs"] == len(spans)
    live = job.profiler.summary()["phase_s"]
    for p, ms in summ["phase_ms"].items():
        in_spans = sum(r["ph_ms"].get(p, 0.0) for r in job.profiler.ring)
        assert abs(ms - in_spans) <= 1e-3, p
        assert live[p] * 1e3 >= ms - 0.051, p
    # node attribution: exact
    assert job.node_report() == ref_job.node_report()
    # freshness: one commit per checkpoint that followed a dispatch, on
    # the reference's epochs, each positive
    fresh = job.freshness.history(job.name)
    assert [h[0] for h in fresh] == [h[0] for h in ref_fresh]
    assert fresh and all(h[3] > 0.0 for h in fresh)
    # trace + flight recorder + export over the port's directory
    assert PT.diagnose(os.path.join(d, PT.TRACE_FILE), stuck_only=True) \
        == "no OPEN epochs (every traced barrier committed)"
    doc = PE.export_chrome(d)
    assert doc["traceEvents"]
    assert PE.validate_chrome(doc) == [] == RE.validate_chrome(doc)
    ring = [json.loads(line) for line in open(os.path.join(d,
                                                           PB.RING_FILE))]
    kinds = [r["kind"] for r in ring]
    assert kinds[0] == "boot"
    assert kinds.count("epoch") == len(spans)
    assert kinds.count("checkpoint") == sum(b[0] for b in barriers)


def test_cadence_stretch_rows(tmp_path_factory):
    """Stretch 2: the reference's rows at stretch 2, the port's at
    stretch 1 and its own at stretch 2 are one answer, with the
    reference's records (half the barriers dispatch twice the events)."""
    ref2, barriers2, want2, _f, _d = reference_run(tmp_path_factory, "q4",
                                                   stretch=2)
    ref1, barriers1, want1, _f, _d = reference_run(tmp_path_factory, "q4")
    assert want2 == want1
    d1 = str(tmp_path_factory.mktemp("port_s1"))
    d2 = str(tmp_path_factory.mktemp("port_s2"))
    job1, rows1, _t = port_run(ref1, barriers1, d1)
    job2, rows2, _t = port_run(ref2, barriers2, d2, stretch=2)
    assert rows2 == want2 == rows1
    spans2 = profile_view(job2.profiler)[0]
    assert spans2 == profile_view(ref2.profiler)[0]
    assert len(spans2) < len(profile_view(job1.profiler)[0])
    assert all(ev == 2 * job2.program.epoch_events
               for _s, ev, _sh in spans2[:-1])


def test_profile_off_keeps_surfaces_empty(tmp_path_factory):
    """With the profiler off: no records, no compile events, no profile
    file; the rows and the node attribution (the stats vector is pulled
    at every sync regardless) are unchanged."""
    ref_job, barriers, want, _f, _d = reference_run(tmp_path_factory, "q4")
    d = str(tmp_path_factory.mktemp("port_off"))
    job, rows, _t = port_run(ref_job, barriers, d, profile=False)
    assert rows == want
    assert job.profiler.rows() == [] and len(job.profiler.compiles) == 0
    assert job.profiler.summary()["epochs"] == 0
    assert not os.path.exists(os.path.join(d, PP.PROFILE_FILE))
    assert job.node_report() == ref_job.node_report()
    agg = next(r for r in job.node_report() if r[1] == "AggNode")
    assert agg[3] > 0 and agg[5] > 0          # rows_in, entries


SLICE_MODULES = ["risingwave_tpu_torch.config",
                 "risingwave_tpu_torch.utils.trace",
                 "risingwave_tpu_torch.utils.blackbox",
                 "risingwave_tpu_torch.utils.profile",
                 "risingwave_tpu_torch.utils.freshness",
                 "risingwave_tpu_torch.utils.export",
                 "risingwave_tpu_torch.utils.overload",
                 "risingwave_tpu_torch.serving.read_cache",
                 "risingwave_tpu_torch.runtime.remote_fragments",
                 "risingwave_tpu_torch.device.fused"]


def test_slice_imports_neither_jax_nor_reference():
    """This slice's modules, imported in a fresh interpreter, leave `jax`
    and `risingwave_tpu` out of `sys.modules`."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'risingwave_tpu' or "
            "m.startswith('risingwave_tpu.'))\n"
            "print(len(bad), bad[:5])\n")
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout
    assert hasattr(PFU.FusedJob, "node_report")


def test_chip_smoke_q5obs_phase_small(monkeypatch):
    """chip_smoke's q5obs phase, its checks (a)-(h) included, on the CPU
    at 2^14 events in epochs of 2^11 from capacity 16 (the card runs it
    at 2^23 in epochs of 2^20): no check fires. On the CPU no kernel
    launches (the plain versions run) and the synchronisations are
    no-ops."""
    import torch

    import chip_smoke as C
    n, e = 1 << 14, 1 << 11
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    orig = C.q5_job
    monkeypatch.setattr(C, "q5_job",
                        lambda dev, **kw: orig(dev, n, e, CAP, **kw))
    monkeypatch.setattr(C, "Q5_EVENTS", n)
    monkeypatch.setattr(C, "EPOCH_EVENTS", e)
    monkeypatch.setattr(C, "Q5_KERNELS", ())
    monkeypatch.setattr(C, "Q5OBS_ROUNDS", 1)
    dev = torch.device("cpu")
    plain = C.q5_job(dev)
    C.run_epochs(plain)
    rows = plain.mv_rows_now()
    rep = C.q5obs_phase(dev, "cpu", rows, C.q5_oracle(dev, n))
    assert rep["rows"] == len(rows) > 0
    assert rep["profile"]["epochs"] == n // e
    assert rep["profile"]["compiles"] == len(plain.program.nodes)
    assert rep["trace"]["records"]["barrier"] == rep["barriers"]
    assert rep["read_cache"]["pulls"] == 2
    assert rep["stretched"]["stretch"][2:] == \
        [2] * (len(rep["stretched"]["stretch"]) - 2)
    assert len(rep["profile_cost"]["on_s"]) == 2
