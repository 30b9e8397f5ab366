"""The port's epoch profiler (`utils/profile.py`) and trace export
(`utils/export.py`) against the JAX package's: the same calls and files
in, the same records, summaries, renderings and Chrome documents out.
Phase durations are fed in explicitly, so they compare exactly; measured
walls (`wall_ms`) and wall-clock stamps (`ts`) compare by schema and
sign only. Clock offsets are exact to 1e-9 s.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

import risingwave_tpu.utils.blackbox as RB
import risingwave_tpu.utils.export as RE
import risingwave_tpu.utils.profile as RP
import risingwave_tpu.utils.trace as RT
import risingwave_tpu_torch.utils.blackbox as PB
import risingwave_tpu_torch.utils.export as PE
import risingwave_tpu_torch.utils.profile as PP
import risingwave_tpu_torch.utils.trace as PT

PKGS = {"ref": (RP, RE, RT, RB), "port": (PP, PE, PT, PB)}


# ---- clock offsets ---------------------------------------------------------


@pytest.mark.parametrize("off,delays", [
    (3.5, [0.080, 0.004, 0.200, 0.0, 0.035]),        # a zero delay: exact
    (-12.25, [0.050, 0.010, 0.030]),                 # worker clock ahead
    (0.0, [0.0]),
])
def test_clock_offset_recovers_known_skew(off, delays):
    samples = [(1000.0 + i, 1000.0 + i + off + d)
               for i, d in enumerate(delays)]
    est = PE.estimate_clock_offset(samples)
    assert est == RE.estimate_clock_offset(samples)
    assert off - 1e-9 <= est <= off + min(delays) + 1e-9


def test_clock_offset_empty():
    assert PE.estimate_clock_offset([]) is None
    assert RE.estimate_clock_offset([]) is None


# ---- the live tail --------------------------------------------------------


def tail_through_rotation(prof_mod, trace_mod, path):
    with open(path, "w") as f:
        for i in range(100):
            f.write(json.dumps({"i": i}) + "\n")
    got = []
    stop = threading.Event()

    def consume():
        for rec in prof_mod.tail_jsonl(path, poll_s=0.02, stop=stop,
                                       from_start=True):
            got.append(rec)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    deadline = time.time() + 5
    while len(got) < 100 and time.time() < deadline:
        time.sleep(0.01)
    assert len(got) == 100
    trace_mod.rotate_tail(path)           # replaces the file (new inode)
    with open(path, "a") as f:
        f.write(json.dumps({"i": "post"}) + "\n")
    while not any(r.get("i") == "post" for r in got) \
            and time.time() < deadline:
        time.sleep(0.01)
    stop.set()
    t.join(timeout=5)
    return [r["i"] for r in got]


def test_tail_jsonl_survives_rotation(tmp_path):
    """Both tails yield every record once, the post-rotation one
    included, and nothing the rotation replayed."""
    seen = {}
    for name, (prof, _e, tr, _b) in PKGS.items():
        seen[name] = tail_through_rotation(prof, tr,
                                           str(tmp_path / f"{name}.jsonl"))
    assert seen["port"] == seen["ref"] == list(range(100)) + ["post"]


def test_profiler_flush_is_single_writer(tmp_path):
    """Concurrent flushes while a third thread appends compile events:
    every line of the port's file parses whole, with the reference's
    record schema."""
    keys = {}
    for name, (prof_mod, _e, _t, _b) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        prof = prof_mod.JobProfiler("j", enabled=True)
        prof.attach(str(d))
        stop = threading.Event()

        def emit():
            i = 0
            while not stop.is_set():
                prof.compile_event("0:AggNode:%08x" % i, 0.001)
                i += 1

        def flusher():
            while not stop.is_set():
                prof.flush()

        threads = [threading.Thread(target=emit, daemon=True)] \
            + [threading.Thread(target=flusher, daemon=True)
               for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=5)
        prof.flush()
        with open(prof.path) as f:
            recs = [json.loads(line) for line in f]
        assert recs
        keys[name] = {tuple(sorted(r)) for r in recs}
    assert keys["port"] == keys["ref"]


# ---- records, schema dispatch, the offline reader ------------------------


def drive_profiler(prof_mod, seed, data_dir=None, enabled=True):
    """One profiler through a seeded run: epochs with explicit phase
    splits (some phases outside any span), compile / retrace events with
    every label kind, a flush at every fourth epoch."""
    rng = np.random.default_rng(seed)
    prof = prof_mod.JobProfiler("q5", enabled=enabled, shards=int(
        rng.integers(1, 9)))
    prof.attach(data_dir)
    for seq in range(12):
        prof.begin_epoch(seq * 1024, 1024)
        for ph in prof_mod.PHASES:
            if rng.random() < 0.6:
                prof.phase(ph, float(rng.integers(1, 5000)) / 1e6)
        if seq % 3 == 0:
            prof.compile_event(f"{seq}:AggNode:{seq:08x}",
                               float(rng.integers(1, 900)) / 1e3,
                               kind="retrace" if seq else "compile",
                               bucket="b12" if seq % 2 else None,
                               aot=bool(seq % 2), cache_hit=seq == 6)
        prof.end_epoch()
        if seq % 4 == 3:
            prof.flush()
    prof.phase("device_sync", 0.002)         # a SELECT between barriers
    prof.flush()
    return prof


def strip(rec):
    return {k: v for k, v in rec.items() if k not in ("ts", "wall_ms")}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_profiler_records_rows_and_summary(tmp_path, seed):
    outs = {}
    for name, (prof_mod, _e, _t, _b) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        prof = drive_profiler(prof_mod, seed, str(d))
        rows = prof.rows()
        assert all(r[-1] >= 0.0 for r in rows)
        summ = prof.summary()
        with open(os.path.join(str(d), prof_mod.PROFILE_FILE)) as f:
            recs = [strip(json.loads(line)) for line in f]
        outs[name] = (
            [r[:-1] for r in rows], summ["epochs"], summ["phase_s"],
            [strip(c) for c in summ["compile_events"]], summ["compile_s"],
            recs, list(prof.compiles), prof_mod.PHASES,
            prof_mod.COMPILE_THRESHOLD_S, prof_mod.PROFILE_SCHEMA)
    assert outs["port"] == outs["ref"]


def test_profile_off_records_nothing(tmp_path):
    for name, (prof_mod, _e, _t, _b) in PKGS.items():
        prof = drive_profiler(prof_mod, 0, str(tmp_path), enabled=False)
        assert prof.path is None           # attach is a no-op when off
        assert not os.path.exists(os.path.join(str(tmp_path),
                                               prof_mod.PROFILE_FILE))


def test_profile_schema_dispatch(tmp_path):
    for a in ({"ph_ms": {"pack": 1.0, "host_pack": 2.0}},
              {"schema": 2, "ph_ms": {"pack": 1.0, "host_pack": 2.0}},
              {"schema": 1, "ph_ms": {"host_pack": 2.0}}, {}):
        assert PP.decode_epoch(a) == RP.decode_epoch(a)
    assert PP.decode_epoch({"ph_ms": {"pack": 1.0, "host_pack": 2.0}}
                           ) == {"pack": 3.0}
    path = str(tmp_path / "epoch_profile.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"ev": "epoch", "job": "j", "seq": 1,
                            "events": 10, "wall_ms": 5.0,
                            "ph_ms": {"pack": 1.0, "host_pack": 2.0,
                                      "dispatch": 1.0}}) + "\n")
        f.write(json.dumps({"ev": "epoch", "schema": 2, "job": "j",
                            "seq": 2, "events": 10, "wall_ms": 4.0,
                            "ph_ms": {"pack": 2.5,
                                      "dispatch": 1.0}}) + "\n")
    out = PP.summarize_file(path)
    assert out == RP.summarize_file(path)
    assert out["j"]["epochs"] == 2
    assert out["j"]["phase_ms"]["pack"] == pytest.approx(5.5)
    assert "host_pack" not in out["j"]["phase_ms"]


@pytest.mark.parametrize("seed", [3, 4])
def test_decode_format_summarize_one_jsonl(tmp_path, seed):
    """One file, written by the reference's profiler (two jobs, a torn
    tail line): every record decodes and renders the same, and the
    offline summaries are equal, per job and filtered."""
    path = os.path.join(str(tmp_path), RP.PROFILE_FILE)
    drive_profiler(RP, seed, str(tmp_path))
    other = RP.JobProfiler("q4", enabled=True)
    other.attach(str(tmp_path))
    other.begin_epoch(0, 2048)
    other.phase("dispatch", 0.001)
    other.end_epoch()
    other.flush()
    with open(path, "a") as f:
        f.write('{"ev": "epoch", "torn')
    with open(path) as f:
        lines = f.readlines()
    for line in lines[:-1]:
        rec = json.loads(line)
        assert PP.format_record(rec) == RP.format_record(rec)
        assert PP.decode_epoch(rec) == RP.decode_epoch(rec)
    assert PP.format_record({"ev": "other"}) is None
    for job in (None, "q5", "q4", "none"):
        for top in (1, 10):
            assert PP.summarize_file(path, job=job, top=top) == \
                RP.summarize_file(path, job=job, top=top)


# ---- the unified Chrome export -------------------------------------------


def write_run(prof_mod, trace_mod, bb_mod, d, seed):
    """One data directory with every log the export reads: barrier spans
    (an open one, worker aligns, heartbeats), profile epochs and compile
    events, and flight-recorder control records."""
    rng = np.random.default_rng(seed)
    tr = trace_mod.BarrierTracer(d)
    rec = bb_mod.FlightRecorder()
    rec.attach(d)
    for e in range(1, 8):
        s = tr.inject(e, "checkpoint" if e % 2 else "barrier")
        s.job_start("q5")
        if e < 7:
            s.job_end("q5")
            tr.worker_align(e, "w0", s.inject_ts + 0.001)
            tr.hb_sample("w0", 100.0 + e, 100.0 + e + float(rng.random()))
            s.commit()
    for kind, payload in (
            ("ladder", {"job": "q5", "prev": "normal",
                        "state": "throttled"}),
            ("shed", {"source": "bid", "rows": 3}),
            ("rebalance", {"job": "q5", "policy_seq": 1}),
            ("recovery", {"job": "q5", "attempt": 1}),
            ("quarantine", {"job": "q5"}),
            ("checkpoint", {"job": "q5", "tiering": {"demote_events": 2}}),
            ("checkpoint", {"job": "q5", "tiering": {"demote_events": 2}}),
            ("checkpoint", {"job": "q5", "tiering": {"demote_events": 5}}),
            ("epoch", {"job": "q5"})):
        rec.record(kind, payload)
    drive_profiler(prof_mod, seed, d)
    rec.attach(None)
    with open(os.path.join(d, prof_mod.PROFILE_FILE), "a") as f:
        f.write(json.dumps({"ev": "epoch", "job": "old", "seq": 0,
                            "wall_ms": 1.0, "ph_ms": {}}) + "\n")


@pytest.mark.parametrize("seed", [5, 6])
def test_export_chrome_same_document(tmp_path, seed):
    """The reference's files exported by both packages give one document;
    the port's own files validate in both packages with no problem."""
    d = str(tmp_path / "ref")
    os.makedirs(d)
    write_run(RP, RT, RB, d, seed)
    doc = PE.export_chrome(d)
    assert doc == RE.export_chrome(d)
    assert doc["otherData"]["skipped_unstamped_records"] == 1
    assert PE.validate_chrome(doc) == [] == RE.validate_chrome(doc)
    p = str(tmp_path / "port")
    os.makedirs(p)
    write_run(PP, PT, PB, p, seed)
    pdoc = PE.export_chrome(p)
    assert PE.validate_chrome(pdoc) == [] == RE.validate_chrome(pdoc)
    # the same events by track; their order within a track follows the
    # measured walls, so it is compared as a multiset
    assert sorted((e["name"], e["ph"], e["pid"], e["tid"])
                  for e in pdoc["traceEvents"]) == \
        sorted((e["name"], e["ph"], e["pid"], e["tid"])
               for e in doc["traceEvents"])


def test_validate_chrome_problems():
    bad = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 5.0, "dur": 1.0, "pid": 1, "tid": 1},
        {"name": "b", "ph": "X", "ts": 4.0, "dur": -1.0, "pid": 1,
         "tid": 1},
        {"ph": "i", "ts": -1, "pid": 1, "tid": 2},
        {"name": "c", "ph": "i", "ts": "x", "pid": 2, "tid": 2}]}
    probs = PE.validate_chrome(bad)
    assert probs == RE.validate_chrome(bad) and len(probs) == 5
