"""The port's barrier tracer (`utils/trace.py`) and flight recorder
(`utils/blackbox.py`) against the JAX package's: the same spans, files
and records in, the same files, rows and bundles out. Wall clocks are
pinned to one fixed value in both modules where the bytes are compared
(a rotation point depends on the line lengths); where they are not,
timings are compared by schema only. Everything else is exact.
"""
import json
import os
import re
import time
import types

import numpy as np
import pytest

import risingwave_tpu.utils.blackbox as RB
import risingwave_tpu.utils.trace as RT
import risingwave_tpu_torch.utils.blackbox as PB
import risingwave_tpu_torch.utils.trace as PT

FIXED_TS = 1_700_000_000.25


def pin_clock(monkeypatch, *mods):
    fake = types.SimpleNamespace(time=lambda: FIXED_TS,
                                 monotonic=time.monotonic,
                                 perf_counter=time.perf_counter)
    for m in mods:
        monkeypatch.setattr(m, "time", fake)


def no_ms(text):
    return re.sub(r"[0-9.]+ ms", "<ms> ms", text)


def spans(tr):
    """The stuck-only case's spans: one committed epoch, one stuck job,
    then committed traffic that pushes the stall out of the tail."""
    s1 = tr.inject(1, "checkpoint")
    s1.job_start("mv_ok")
    s1.job_end("mv_ok")
    s1.commit()
    s2 = tr.inject(2, "barrier")
    s2.job_start("mv_stuck")                  # never ends, never commits
    yield
    for e in range(3, 40):
        s = tr.inject(e, "checkpoint")
        s.commit()


def records(path, drop=("ts",)):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in drop}
                for line in f]


def test_trace_stuck_only(tmp_path):
    outs = {}
    for name, mod in (("ref", RT), ("port", PT)):
        d = tmp_path / name
        d.mkdir()
        tr = mod.BarrierTracer(str(d))
        path = os.path.join(str(d), mod.TRACE_FILE)
        gen = spans(tr)
        next(gen)
        full = mod.diagnose(path, last=10)
        stuck = mod.diagnose(path, last=10, stuck_only=True)
        assert "committed" in full and "OPEN" in full
        assert "mv_stuck" in stuck and "committed" not in stuck
        next(gen, None)
        late_stuck = mod.diagnose(path, last=5, stuck_only=True)
        late = mod.diagnose(path, last=5)
        assert "mv_stuck" in late_stuck and "mv_stuck" not in late
        rows = [r[:4] + (type(r[4]).__name__,) for r in tr.rows()]
        outs[name] = (no_ms(full), stuck, late_stuck, no_ms(late),
                      records(path), rows)
    assert outs["port"] == outs["ref"]
    assert PT.TRACE_FILE == RT.TRACE_FILE


def test_trace_worker_align_and_heartbeats(tmp_path):
    """The cross-worker decomposition rows and the heartbeat samples:
    the same events, the same file records and rows."""
    outs = {}
    for name, mod in (("ref", RT), ("port", PT)):
        d = tmp_path / name
        d.mkdir()
        tr = mod.BarrierTracer(str(d))
        s = tr.inject(5, "barrier")
        s.job_start("j")
        tr.worker_align(5, "w0", s.inject_ts + 0.002)
        tr.worker_align(4, "w1", s.inject_ts + 0.001)  # an older epoch
        tr.hb_sample("w0", 10.0, 10.5)
        s.job_end("j")
        s.commit()
        rows = [(r[0], r[1], r[2], r[3]) for r in tr.rows()]
        outs[name] = (records(os.path.join(str(d), mod.TRACE_FILE)), rows)
    assert outs["port"] == outs["ref"]


@pytest.mark.parametrize("n,pad", [(10_000, 40), (999, 3), (5, 200)])
def test_rotate_tail_is_line_exact(tmp_path, n, pad):
    texts = []
    for name, mod in (("ref", RT), ("port", PT)):
        path = str(tmp_path / f"{name}.jsonl")
        with open(path, "w") as f:
            for e in range(n):
                f.write(json.dumps({"epoch": e, "pad": "x" * pad}) + "\n")
        before = os.path.getsize(path)
        mod.rotate_tail(path)
        assert os.path.getsize(path) <= before // 2 + pad + 64
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        assert recs[-1]["epoch"] == n - 1
        assert [r["epoch"] for r in recs] == list(
            range(recs[0]["epoch"], n))
        texts.append(open(path).read())
    assert texts[0] == texts[1]


def test_tracer_emit_rotates(tmp_path, monkeypatch):
    pin_clock(monkeypatch, RT, PT)
    files = []
    for name, mod in (("ref", RT), ("port", PT)):
        monkeypatch.setattr(mod, "_MAX_FILE_BYTES", 1 << 14)
        d = tmp_path / name
        d.mkdir()
        tr = mod.BarrierTracer(str(d))
        path = os.path.join(str(d), mod.TRACE_FILE)
        prev, shrinks = 0, 0
        for e in range(6_000):
            span = tr.inject(e, "barrier")
            span.commit()
            size = os.path.getsize(path)
            shrinks += size < prev
            prev = size
        assert shrinks >= 1
        recs = records(path, drop=())
        assert recs[-1]["epoch"] == 5_999 and recs[0]["epoch"] > 0
        files.append(open(path).read())
    assert files[0] == files[1]


def test_blackbox_ring_byte_bound_and_rate_limit(tmp_path, monkeypatch):
    pin_clock(monkeypatch, RB, PB)
    rng = np.random.default_rng(7)
    pads = rng.integers(0, 64, 500)
    outs = {}
    for name, mod in (("ref", RB), ("port", PB)):
        d = tmp_path / name
        d.mkdir()
        r = mod.FlightRecorder(max_bytes=2048)
        r.attach(str(d))
        for i, p in enumerate(pads):
            r.record("epoch", {"seq_no": i, "pad": "x" * int(p)})
        st = r.stats()
        assert st["bytes"] <= 2048 and st["dropped"] > 0
        a = r.maybe_dump("wedge_reap")
        assert a is not None
        assert r.maybe_dump("wedge_reap") is None      # coalesced
        b = r.maybe_dump("quarantine")
        assert b is not None
        lone = mod.FlightRecorder()
        lone.record("epoch", {"x": object()})          # unserializable
        assert lone.dump("manual") is None
        assert lone.stats()["records"] == 1
        bundles = [(n[n.index("-") + 1:],
                    {k: v for k, v in m.items() if k != "ts"})
                   for n, m in mod.list_bundles(str(d))]
        outs[name] = (st, r.stats(), bundles,
                      mod.read_bundle(str(d), os.path.basename(a)),
                      records(os.path.join(str(d), mod.RING_FILE), ()),
                      lone._ring[0][0])
    assert outs["port"] == outs["ref"]


def test_blackbox_dump_from_dead_dir_and_pruning(tmp_path, monkeypatch):
    """A dead directory's ring file makes the same bundle; past the kept
    count the oldest bundles go, in both packages."""
    pin_clock(monkeypatch, RB, PB)
    outs = {}
    for name, mod in (("ref", RB), ("port", PB)):
        d = tmp_path / name
        d.mkdir()
        assert mod.dump_from_dir(str(d)) is None       # no ring yet
        r = mod.FlightRecorder()
        r.attach(str(d))
        for i in range(20):
            r.record("checkpoint" if i % 4 == 0 else "epoch",
                     {"job": "q5", "seq": i})
        with open(os.path.join(str(d), mod.RING_FILE), "a") as f:
            f.write('{"seq": 99, "torn')               # a hard kill's tail
        names = [mod.dump_from_dir(str(d), reason="dead process!")
                 for _ in range(mod._KEEP_BUNDLES + 2)]
        listed = mod.list_bundles(str(d))
        assert len(listed) == mod._KEEP_BUNDLES
        last = mod.read_bundle(str(d), os.path.basename(names[-1]))
        outs[name] = ([n[n.index("-") + 1:] for n, _ in listed],
                      [{k: v for k, v in m.items() if k != "ts"}
                       for _, m in listed], last)
    assert outs["port"] == outs["ref"]
    assert len(outs["port"][2]) == 20
