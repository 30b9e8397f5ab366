"""The rest of the port's `utils/overload.py` against the JAX package's:
the degradation ladder, source admission, the combine of pressure
evidence, the shed log, the SELECT gate and the per-database overload
manager. The same observations reach both packages (each reads its own
`ROBUSTNESS`, set alike here) and every state, row and scalar must be
equal; wall-clock columns compare by schema only. Pressure scalars are
exact (tolerance 0; the combine is a sum and a max).
"""
from types import SimpleNamespace

import numpy as np
import pytest

import risingwave_tpu.config as RC
import risingwave_tpu.utils.overload as RO
import risingwave_tpu_torch.config as PC
import risingwave_tpu_torch.utils.overload as PO
from risingwave_tpu.state import MemoryStateStore as RStore
from risingwave_tpu.state.state_table import StateTable as RTable
from risingwave_tpu_torch.state import MemoryStateStore as PStore
from risingwave_tpu_torch.state.state_table import StateTable as PTable

PKGS = {"ref": (RO, RC.ROBUSTNESS), "port": (PO, PC.ROBUSTNESS)}
_KNOBS = ("overload_ladder", "overload_window_s", "overload_high",
          "overload_low", "overload_hold_s", "overload_stretch",
          "load_shed", "select_concurrency", "select_per_session",
          "sink_spool_rows")


@pytest.fixture(autouse=True)
def _restore_knobs():
    saved = [{k: getattr(rob, k) for k in _KNOBS}
             for _m, rob in PKGS.values()]
    yield
    for (_m, rob), kept in zip(PKGS.values(), saved):
        for k, v in kept.items():
            setattr(rob, k, v)
        _m.PRESSURE.reset()


def set_knobs(**kw):
    for _m, rob in PKGS.values():
        for k, v in kw.items():
            setattr(rob, k, v)


def test_ladder_escalates_holds_and_recovers_with_hysteresis():
    set_knobs(overload_high=0.5, overload_low=0.1, overload_hold_s=1.0,
              overload_ladder=True, load_shed=False)
    ctl = {n: m.OverloadController("j") for n, (m, _r) in PKGS.items()}
    t = 1000.0
    steps = [(0.9, 0.0), (0.9, 0.5), (0.9, 1.1), (0.9, 1.2), (0.9, 2.3),
             (0.9, 3.5), (0.3, 10.0), (0.05, 11.0), (0.05, 12.1),
             (0.05, 13.2)]
    want = ["normal", "normal", "throttled", "throttled", "degraded",
            "degraded", "degraded", "degraded", "throttled", "normal"]
    for (p, dt), w in zip(steps, want):
        got = {n: c.observe(p, t + dt, source="stall:x")
               for n, c in ctl.items()}
        assert got["port"] == got["ref"] == w
        assert ctl["port"].stretch == ctl["ref"].stretch
        assert ctl["port"].admit_factor == ctl["ref"].admit_factor
    set_knobs(load_shed=True)
    for dt, w in ((20.0, "normal"), (21.1, "throttled"),
                  (22.2, "degraded"), (23.3, "shedding")):
        got = {n: c.observe(0.9, t + dt) for n, c in ctl.items()}
        assert got["port"] == got["ref"] == w
    assert ctl["port"].stretch == PC.ROBUSTNESS.overload_stretch
    trans = {n: [tr[:1] + tr[2:] for tr in c.transitions]
             for n, c in ctl.items()}
    assert trans["port"] == trans["ref"]
    assert [tr[3] for tr in ctl["port"].transitions] == [
        "throttled", "degraded", "throttled", "normal", "throttled",
        "degraded", "shedding"]
    rows = {n: c.rows(now=t + 30.0) for n, c in ctl.items()}
    assert rows["port"][0][:6] == rows["ref"][0][:6]
    assert [r[:6] for r in rows["port"][1:]] == \
        [r[:6] for r in rows["ref"][1:]]
    # the ladder knob off walks it straight back to normal
    set_knobs(overload_ladder=False)
    for c in ctl.values():
        assert c.observe(0.9, t + 40.0) == "normal"
    ctl["port"].force("degraded")
    ctl["ref"].force("degraded")
    assert ctl["port"].state == ctl["ref"].state == "degraded"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ladder_seeded_pressure_walk(seed):
    """A seeded pressure walk through both ladders, with hold and
    stretch knobs drawn from the seed: the same rung at every step."""
    rng = np.random.default_rng(seed)
    set_knobs(overload_high=0.5, overload_low=0.1,
              overload_hold_s=float(rng.integers(0, 3)),
              overload_stretch=int(rng.integers(1, 6)),
              overload_ladder=True, load_shed=bool(seed % 2))
    ctl = {n: m.OverloadController("j") for n, (m, _r) in PKGS.items()}
    t = 0.0
    for p in rng.random(200):
        t += float(rng.random())
        got = {n: (c.observe(float(p), t), c.stretch, c.rung)
               for n, c in ctl.items()}
        assert got["port"] == got["ref"]


def test_admission_bucket_defers_then_sheds_only_on_shed_rung():
    outs = {}
    for name, (m, _r) in PKGS.items():
        sheds = []
        b = m.AdmissionBucket("s", capacity=4)
        b.shed_sink = lambda src, ep, rows: sheds.append((src, ep, rows))
        seq = [b.admit() for _ in range(5)]
        assert seq == ["admit"] * 4 + ["defer"] and b.lag == 1
        b.state, b.shed_enabled = "shedding", False
        seq.append(b.admit())               # shedding rung, knob off
        b.shed_enabled = True
        seq.append(b.admit())
        b.factor = 0.5
        b.epoch_refill()
        seq.append(b.tokens)
        b.factor = 0.0
        b.epoch_refill()
        seq.append(b.tokens)                # floor: always trickles
        b.factor = 0.25
        b.epoch_refill(mult=8)
        seq.append(b.tokens)
        b.note_admitted(100)
        b.note_shed(7, 33)
        outs[name] = (seq, b.row(), sheds, b.admitted_rows, b.shed_windows)
    assert outs["port"] == outs["ref"]
    assert outs["port"][0][5:] == ["defer", "shed", 2, 1, 8]


@pytest.mark.parametrize("rows,want", [
    ([("stall", "sink", 0.3), ("stall", "exchange_credit", 0.4),
      ("sink", "snk", 0.2), ("queue", "q:setA", 0.5)], 0.7),
    ([("stall", "a", 0.9), ("stall", "b", 0.8)], 1.0),
    ([], 0.0),
    ([("sink", "s1", 1.0), ("stall", "x", 0.05)], 1.0),
    ([("queue", "a", 0.2), ("queue", "b", 0.2)], 0.2),
])
def test_combine_contributions_math(rows, want):
    assert PO.combine_contributions(rows) == RO.combine_contributions(rows)
    assert abs(PO.combine_contributions(rows) - want) < 1e-12
    assert PO.dominant_contribution(rows) == RO.dominant_contribution(rows)
    assert PO.dominant_contribution(rows[:2]) == \
        RO.dominant_contribution(rows[:2])


def test_shed_log_entries_over_a_state_table():
    """The audit rows ride each package's own memory store; ids continue
    across a reopen of the table; rows are equal with `ts` left out."""
    outs = {}
    for name, m, store, table in (("ref", RO, RStore(), RTable),
                                  ("port", PO, PStore(), PTable)):
        mk = lambda: m.ShedLog(table(store, 9, list(m.ShedLog.DTYPES),
                                     list(m.ShedLog.PK)))
        log = mk()
        ids = [log.record("bid", e, 64 * e, "load_shed", e + 1)
               for e in range(1, 5)]
        ids.append(mk().record("auction", 9, 3, "load_shed", 10))
        outs[name] = (ids, [r[:5] for r in mk().entries()],
                      [r[:5] for r in mk().entries("bid")])
    assert outs["port"] == outs["ref"]
    assert outs["port"][0] == [0, 1, 2, 3, 4]


def test_select_gate_per_session_slice():
    set_knobs(select_concurrency=4, select_per_session=1)
    outs = {}
    for name, (m, _r) in PKGS.items():
        g = m.SelectGate()
        seq = [g.enter(session="a")]
        with pytest.raises(m.AdmissionRejected) as ei:
            g.enter(session="a")
        assert ei.value.sqlstate == "53000"
        seq += [str(ei.value), g.enter(session="b"), g.rejected]
        g.leave(session="a")
        seq.append(g.enter(session="a"))
        g.leave(session="a")
        g.leave(session="b")
        outs[name] = (seq, g.active, g.session_active)
    assert outs["port"] == outs["ref"]
    assert "RW_SELECT_PER_SESSION" in outs["port"][0][1]
    assert outs["port"][1:] == (0, {})


def test_select_gate_global_bound_and_knob_off():
    set_knobs(select_concurrency=1, select_per_session=8)
    gates = {n: m.SelectGate() for n, (m, _r) in PKGS.items()}
    msgs = {}
    for n, g in gates.items():
        assert g.enter(session="a") is True
        with pytest.raises(PKGS[n][0].AdmissionRejected) as ei:
            g.enter(session="b")
        msgs[n] = str(ei.value)
        g.leave(session="a")
    assert msgs["port"] == msgs["ref"]
    assert "RW_SELECT_CONCURRENCY" in msgs["port"]
    set_knobs(select_concurrency=4, select_per_session=0)
    for g in gates.values():
        assert [g.enter(session="a") for _ in range(3)] == [True] * 3
        for _ in range(3):
            g.leave(session="a")
    set_knobs(select_concurrency=0)
    for g in gates.values():
        assert g.enter(session="a") is False and g.enter() is False
        assert g.active == 0


# ---- the manager over a stand-in database --------------------------------


class StubSink:
    def __init__(self, pending, stalled=False):
        self.pending, self.stalled = pending, stalled

    def pending_rows(self):
        return self.pending


class StubDb:
    """What `OverloadManager.tick` reads of a Database: the catalog's
    objects (their runtime dicts: sink executors, fused jobs), the fused
    jobs by name, and the remote worker sets. The same stub serves both
    packages."""

    def __init__(self, pressures):
        self.jobs = {"q5": SimpleNamespace(cadence_stretch=1)}
        self._fused = dict(self.jobs)
        objs = [SimpleNamespace(name="q5", kind="mv",
                                runtime={"fused_job": self.jobs["q5"]}),
                SimpleNamespace(name="s_slow", kind="sink",
                                runtime={"sink_exec": StubSink(0, True)}),
                SimpleNamespace(name="s_ok", kind="sink",
                                runtime={"sink_exec": StubSink(512)}),
                SimpleNamespace(name="host_mv", kind="mv", runtime={}),
                SimpleNamespace(name="t", kind="table", runtime=None)]
        self.catalog = SimpleNamespace(objects={o.name: o for o in objs})
        self.pressures = pressures

    def _remote_sets(self):
        yield "host_mv", SimpleNamespace(
            queue_pressure=lambda: self.pressures["queue"])
        yield "host_mv", SimpleNamespace()          # no depth probe


@pytest.mark.parametrize("slow_sink", [False, True])
def test_overload_manager_tick_on_a_stub_database(slow_sink):
    """Pressure evidence (board stalls, a sink's spool or stall flag, a
    worker set's queue ratio) through `tick` on one stand-in database
    per package: the same attribution, pressure, rungs, bucket rates and
    cadence stretch, tick after tick, and the same surface rows."""
    set_knobs(overload_hold_s=0.0, overload_high=0.5, overload_low=0.1,
              overload_stretch=2, overload_ladder=True, load_shed=False,
              overload_window_s=100.0, sink_spool_rows=1024)
    mgrs, dbs = {}, {}
    for name, (m, _r) in PKGS.items():
        m.PRESSURE.reset()
        mgrs[name] = m.OverloadManager()
        dbs[name] = StubDb({"queue": 0.05})
        mgrs[name].bucket("bid", capacity=16)
        if not slow_sink:
            dbs[name].catalog.objects["s_slow"].runtime["sink_exec"] \
                .stalled = False
    plan = [({"exchange_credit": 10.0}, 0.05), ({"sink": 45.0}, 0.2),
            ({}, 0.9), ({}, 0.9), ({}, 0.0), ({}, 0.0)]
    stretches = []
    for notes, q in plan:
        for name, (m, _r) in PKGS.items():
            for kind, sec in notes.items():
                m.PRESSURE.note(kind, sec)
            dbs[name].pressures["queue"] = q
            mgrs[name].tick(dbs[name])
        got = {n: (mg.last_attribution, mg.last_pressure, mg.last_dominant,
                   {j: c.rung for j, c in mg.controllers.items()},
                   [(b.factor, b.state, b.stretch, b.shed_enabled)
                    for b in mg.buckets.values()],
                   dbs[n].jobs["q5"].cadence_stretch,
                   mg.attribution_rows(), mg.admission_rows())
               for n, mg in mgrs.items()}
        assert got["port"] == got["ref"]
        stretches.append(got["port"][5])
    assert 2 in stretches                   # the degraded rung's stretch
    assert sorted(mgrs["port"].controllers) == ["host_mv", "q5", "s_ok",
                                                "s_slow"]
    rows = {n: [r[:6] for r in mg.rows()] for n, mg in mgrs.items()}
    assert rows["port"] == rows["ref"]
    assert mgrs["port"].pressure_of(dbs["port"]) == \
        mgrs["ref"].pressure_of(dbs["ref"])
    mgrs["port"].forget("q5")
    assert "q5" not in mgrs["port"].controllers
