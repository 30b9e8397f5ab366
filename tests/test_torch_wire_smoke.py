"""chip_smoke's `wire` phase at a small size on the CPU: the port's
PgServer over a fused-capable `Database(torch_device="cpu")` on a data
directory; q5 and q7 created, driven by FLUSH and read over the smoke's
raw protocol-v3 client (a suspended portal included); COPY into a table
with a device group-by; every risectl command in a process of its own
(`--torch-device cpu`); a reopen with device="auto" behind a second
server; the .slt files with the device path on. The phase checks the
rows against the numpy oracles and the in-process reads itself; this file
runs it and holds its report. On the CPU no kernel launches, so the
launches per epoch it holds to q5_sql's are all zero here."""
import pytest
import torch

import chip_smoke as C

CPU = torch.device("cpu")
EVENTS, CHUNK = 1 << 16, 1 << 8


@pytest.fixture(scope="module")
def q5_rows():
    """q5's rows from SQL in process at this size (what the wire's must
    equal) and the oracles."""
    mp = pytest.MonkeyPatch()
    mp.setattr(C, "SQL_FUSED_CHUNK", CHUNK)
    db = C.fused_database(CPU, None, capacity=C.SQL_FUSED_CAPACITY)
    db.run(C.SQL_BID_SRC.format(n=EVENTS, c=CHUNK))
    db.run(C.SQL_Q5_MV)
    C.drive_ticks(db, C.fused_job_of(db, "nexmark_q5", "q5"))
    rows = db.query("SELECT * FROM nexmark_q5")
    o5, o7 = C.q5_oracle(CPU, EVENTS), C.q7_oracle(CPU, EVENTS)
    C.check_q5_rows(rows, o5)
    yield rows, o5, o7
    mp.undo()


def _phase(rows, o5, o7, monkeypatch):
    monkeypatch.setattr(C, "SQL_FUSED_CHUNK", CHUNK)
    q5_sql = {"launches": {}, "epochs_dispatched": 1, "drive_s": 0.0,
              "select_s": 0.0}
    return C.wire_phase(CPU, "cpu", q5_sql, rows,
                        lambda r: C.check_q5_rows(r, o5),
                        lambda r: C.check_q7_rows(r, o7), q5_sql,
                        events=EVENTS, kernels=())


def test_wire_phase(q5_rows, monkeypatch):
    # the smoke runs every arm at its default: the skew telemetry (pinned
    # off suite-wide by tests/conftest.py) writes what `risectl skew` reads
    monkeypatch.setenv("RW_SKEW_STATS", "1")
    rep = _phase(*q5_rows, monkeypatch)
    for mv in ("nexmark_q5", "nexmark_q7"):
        r = rep[mv]
        assert r["epochs_dispatched"] >= EVENTS // (64 * CHUNK)
        assert r["select"]["rows"] > 0
        assert r["portal"]["suspended"] >= 1
    assert rep["copy"]["engines"] == ["DeviceHashAggExecutor"]
    assert rep["copy"]["select"]["rows"] == C.WIRE_COPY_KEYS
    assert {" ".join(c[0]) for c in C.WIRE_CTL} <= set(rep["ctl"])
    assert rep["ctl"]["compile-status --offline"]["rc"] == 1
    assert rep["ctl"]["fused-stats"]["committed_events"] == {
        "nexmark_q5": EVENTS, "nexmark_q7": EVENTS}
    assert set(rep["reopen_select_s"]) == {"nexmark_q5", "nexmark_q7",
                                           "wire_copy_agg"}
    assert len(rep["slt"]) == 4


def test_wire_phase_catches_wrong_rows(q5_rows, monkeypatch):
    """The phase compares the wire's q5 with q5_sql's rows: one row off
    fails it."""
    rows, o5, o7 = q5_rows
    bad = [(rows[0][0] + 1,) + tuple(rows[0][1:])] + list(rows[1:])
    with pytest.raises(AssertionError, match="differ from q5_sql"):
        _phase(bad, o5, o7, monkeypatch)
