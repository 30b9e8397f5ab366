"""Overload control plane: pressure sensing, admission, degradation (the
port's own copy of the JAX package's `utils/overload.py`).

The engine's answer to load it cannot absorb. Three layers, each feeding
the next:

* **Pressure sensing** (`PressureBoard` + the callers' depth probes) —
  every data-movement seam that can stall under credit/capacity
  exhaustion reports here (in the port so far, a `ThreadedChannel`
  producer blocked on a full channel, `ops/exchange.py`). The board
  turns those stall seconds into a [0, 1] "fraction of recent wall
  spent starved" signal; the overload manager folds in queue-depth
  ratios and sink stall flags, which need no blocking to be visible.
* **Graceful-degradation ladder** (`OverloadController`, one per
  streaming job) — an explicit state machine
  `normal -> throttled -> degraded -> shedding` that escalates only
  under SUSTAINED pressure (`RW_OVERLOAD_HIGH` held for
  `RW_OVERLOAD_HOLD_S`) and de-escalates with hysteresis
  (`RW_OVERLOAD_LOW` held just as long, one rung at a time). The top
  rung is gated twice: `RW_LOAD_SHED` (default OFF) caps the ladder at
  `degraded`, where the engine only re-times work — bigger epochs
  (cadence stretch: a fused job dispatches `stretch` epochs under one
  barrier), throttled sources — and never changes results.
* **Source admission** (`AdmissionBucket`, one per connector source) —
  a per-epoch token bucket: `capacity * factor` poll tokens per epoch,
  where `factor` follows the worst downstream rung. Exhausted tokens
  DEFER polls (data waits at the connector — backpressure propagated
  all the way to the source) or, on the `shedding` rung only, SHED the
  would-be window: poll it, drop it, and record the gap in the durable
  audited `rw_shed_log` table (`ShedLog`, the `rw_dead_letter`
  pattern). Offered/admitted/deferred/shed counters make the lag
  (offered minus admitted) a first-class per-source surface
  (`rw_source_admission`).

`SelectGate` bounds concurrent pgwire SELECTs: past
`RW_SELECT_CONCURRENCY` in-flight statements a new one gets a clean
SQLSTATE 53000 (`AdmissionRejected`) instead of queueing on the
coordinator lock and wedging the epoch loop.

`OverloadManager.tick(db)` reads the Database's catalog, its fused jobs
and its remote worker sets; the port's `Database` is still to come, so
the port runs it over any object with those three surfaces.

Everything here is knob-gated and inert by default: with no pressure
the ladder sits at `normal`, buckets refill to their full per-epoch
budget, and results are bit-identical to a build without this module.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..config import ROBUSTNESS
from ..core import dtypes as T

# the ladder's rungs, in escalation order; indices are the `rung` values
LADDER: Tuple[str, ...] = ("normal", "throttled", "degraded", "shedding")
# fraction of the full per-epoch source admission budget per rung
ADMIT_FACTOR: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.25)
# cadence stretch engages from this rung upward
_STRETCH_RUNG = 2


class AdmissionRejected(RuntimeError):
    """A front-door statement refused for lack of capacity — pgwire maps
    it to SQLSTATE 53000 (insufficient_resources)."""

    sqlstate = "53000"


# ---------------------------------------------------------------------------
# pressure sensing
# ---------------------------------------------------------------------------


class PressureBoard:
    """Process-global record of credit/capacity stalls. Producers that
    BLOCKED waiting for downstream room call `note(kind, seconds)`;
    `fraction(window_s)` answers "what share of the recent window did
    this process spend starved for credit" in [0, 1] — the overload
    ladder's primary input. Thread-safe; disarmed cost is zero (callers
    only note when they actually waited)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (monotonic ts, kind, seconds) — the kind is KEPT so the board
        # can attribute its fraction to the seam that stalled, not just
        # report that something did
        self._events: deque = deque(maxlen=8192)

    def note(self, kind: str, seconds: float) -> None:
        if seconds <= 0.0:
            return
        with self._lock:
            self._events.append((time.monotonic(), kind, seconds))
        from .metrics import REGISTRY
        REGISTRY.counter(
            "credit_stall_seconds_total",
            "wall seconds producers spent blocked on exchange credit or "
            "queue capacity, by seam", labels=("kind",)
        ).labels(kind).inc(seconds)

    def by_kind(self, window_s: float) -> Dict[str, float]:
        """Stalled seconds per seam kind within the window (pruning the
        deque of far-stale entries as `fraction` always did). The global
        fraction is DEFINED from this breakdown — see `fraction` — so
        the per-kind attribution recombines to the scalar exactly."""
        now = time.monotonic()
        lo = now - max(1e-6, window_s)
        out: Dict[str, float] = {}
        with self._lock:
            # prune far-stale entries so the deque never holds history
            # older than a few windows
            horizon = now - 8 * max(1e-6, window_s)
            while self._events and self._events[0][0] < horizon:
                self._events.popleft()
            for ts, kind, s in self._events:
                if ts >= lo:
                    out[kind] = out.get(kind, 0.0) + s
        return out

    def fraction(self, window_s: float) -> float:
        stalled = sum(self.by_kind(window_s).values())
        return min(1.0, stalled / max(1e-6, window_s))

    def reset(self) -> None:
        with self._lock:
            self._events.clear()


# one board per process: worker processes keep their own (their stall
# counters reach the coordinator via the metrics-plane M frames; the
# coordinator's LADDER only acts on coordinator-side stalls plus the
# queue depths it can read directly)
PRESSURE = PressureBoard()


def combine_contributions(rows: List[Tuple[str, str, float]]) -> float:
    """THE combine: labeled evidence rows -> the overload scalar.

    Stall contributions add (they are disjoint slices of the same wall
    clock, capped at 1.0 — exactly `PressureBoard.fraction`); sink and
    queue ratios are alternative bottleneck indicators, so the worst
    one wins. `OverloadManager.pressure_of` is implemented as
    `combine_contributions(attribution(db))`, which is what makes the
    rw_pressure_attrib rows recombine to `overload_pressure` by
    construction rather than by convention."""
    stall = min(1.0, sum(v for fam, _s, v in rows if fam == "stall"))
    rest = max((v for fam, _s, v in rows if fam != "stall"), default=0.0)
    return max(stall, rest)


def dominant_contribution(rows: List[Tuple[str, str, float]]) -> str:
    """`family:source` of the largest single contribution (ties break
    toward the earlier row; empty string when nothing contributed) —
    the ladder stamps this on every transition."""
    best, label = 0.0, ""
    for fam, src, v in rows:
        if v > best:
            best, label = v, f"{fam}:{src}"
    return label


# ---------------------------------------------------------------------------
# graceful-degradation ladder
# ---------------------------------------------------------------------------


class OverloadController:
    """Per-job overload state machine. `observe(pressure)` once per
    barrier tick; escalation requires the pressure to HOLD above
    `overload_high` for `overload_hold_s` (one rung per hold period),
    de-escalation requires it to hold below `overload_low` just as long
    (hysteresis — a flapping signal parks in the dead band and changes
    nothing). The `shedding` rung exists only when `RW_LOAD_SHED=true`;
    otherwise the ladder caps at `degraded`, whose actions (cadence
    stretch, source throttling) re-time work without changing any
    result."""

    def __init__(self, job: str):
        self.job = job
        self.rung = 0
        self.pressure = 0.0
        self.since = time.time()
        self._above: Optional[float] = None
        self._below: Optional[float] = None
        # transition ring: (seq, ts, prev_state, new_state, pressure,
        # dominant_source) — the source names WHICH evidence drove the
        # pressure at transition time ("stall:exchange_credit",
        # "sink:s1", ...), so rw_overload answers WHY a rung was taken
        self.transitions: deque = deque(maxlen=64)
        self._seq = 0
        self.dominant_source = ""

    @property
    def state(self) -> str:
        return LADDER[self.rung]

    @property
    def stretch(self) -> int:
        if self.rung >= _STRETCH_RUNG:
            return max(1, int(ROBUSTNESS.overload_stretch))
        return 1

    @property
    def admit_factor(self) -> float:
        return ADMIT_FACTOR[self.rung]

    def observe(self, pressure: float, now: Optional[float] = None,
                source: str = "") -> str:
        cfg = ROBUSTNESS
        now = time.time() if now is None else now
        self.pressure = pressure
        self.dominant_source = source
        if not cfg.overload_ladder:
            if self.rung:
                self._move(0, pressure, now)
            return self.state
        if pressure >= cfg.overload_high:
            self._below = None
            if self._above is None:
                self._above = now
            elif now - self._above >= cfg.overload_hold_s:
                cap = len(LADDER) - 1 if cfg.load_shed else _STRETCH_RUNG
                if self.rung < cap:
                    self._move(self.rung + 1, pressure, now)
                self._above = now      # next rung needs its own hold
        elif pressure <= cfg.overload_low:
            self._above = None
            if self.rung > 0:
                if self._below is None:
                    self._below = now
                elif now - self._below >= cfg.overload_hold_s:
                    self._move(self.rung - 1, pressure, now)
                    self._below = now
            else:
                self._below = None
        else:
            # dead band: neither escalate nor recover (the hysteresis gap)
            self._above = self._below = None
        return self.state

    def force(self, state: str) -> None:
        """Jump straight to `state` (tests/operators); same bookkeeping
        as an observed transition."""
        self._move(LADDER.index(state), self.pressure, time.time())

    def _move(self, rung: int, pressure: float, now: float) -> None:
        if rung == self.rung:
            return
        prev = self.state
        self.rung = rung
        self.since = now
        self._seq += 1
        self.transitions.append((self._seq, now, prev, self.state,
                                 pressure, self.dominant_source))
        try:
            from .blackbox import RECORDER
            RECORDER.record("ladder", {
                "job": self.job, "prev": prev, "state": self.state,
                "pressure": round(pressure, 4),
                "source": self.dominant_source})
            if rung > LADDER.index(prev) and rung >= _STRETCH_RUNG:
                # escalation into result-affecting territory: freeze the
                # evidence that led here (rate-limited in the recorder)
                RECORDER.maybe_dump(f"escalation_{self.state}")
        except Exception:
            pass
        from .metrics import REGISTRY
        REGISTRY.counter(
            "overload_transitions_total",
            "graceful-degradation ladder transitions",
            labels=("job", "state")).labels(self.job, self.state).inc()
        REGISTRY.gauge(
            "overload_state",
            "current overload rung per job (0=normal..3=shedding)",
            labels=("job",)).labels(self.job).set(rung)

    def rows(self, now: float) -> List[Tuple]:
        """rw_overload rows for this job: seq=0 is the CURRENT state,
        higher seqs the transition history (newest last). The trailing
        dominant_source column says which evidence drove the pressure
        ("stall:<kind>" / "sink:<name>" / "queue:<set>")."""
        out = [(self.job, 0, self.state, "", self.pressure,
                self.stretch, self.since, now, self.dominant_source)]
        for seq, ts, prev, new, p, src in self.transitions:
            out.append((self.job, seq, new, prev, p,
                        0, ts, ts, src))
        return out


# ---------------------------------------------------------------------------
# source admission
# ---------------------------------------------------------------------------


class AdmissionBucket:
    """Per-source token bucket, refilled per EPOCH by the source itself
    (`epoch_refill` at every barrier pop) and re-rated per TICK by the
    overload manager (`factor`/`state` follow the worst downstream
    rung). `admit()` answers per poll attempt:

    * ``admit`` — a token was available; poll normally.
    * ``defer`` — budget exhausted: skip the poll. The data stays at
      the connector (file offset, generator cursor) — that IS the
      backpressure reaching the source; nothing buffers.
    * ``shed``  — budget exhausted AND the job ladder is on the
      `shedding` rung with `RW_LOAD_SHED=true`: the caller polls the
      window and DROPS it, recording the gap through `shed_sink` into
      the durable `rw_shed_log` (audited data loss, never silent).

    The refill floor is one token per epoch, so a throttled source
    always trickles — throttling delays work, it never deadlocks it."""

    def __init__(self, name: str, capacity: int = 64):
        self.name = name
        self.capacity = max(1, capacity)
        self.tokens = self.capacity
        self.factor = 1.0
        self.state = "normal"
        self.stretch = 1
        self.shed_enabled = False
        # callback(source, epoch, rows) wired to the database's ShedLog
        self.shed_sink: Optional[Callable[[str, int, int], None]] = None
        self.offered = 0          # poll attempts while data was wanted
        self.admitted = 0         # polls granted a token
        self.admitted_rows = 0
        self.deferred = 0         # polls pushed back to the connector
        self.shed_rows = 0
        self.shed_windows = 0

    @property
    def lag(self) -> int:
        """Offered minus admitted — the source's admission debt."""
        return self.offered - self.admitted

    def epoch_refill(self, mult: int = 1) -> None:
        """Refill for one epoch. `mult` carries the epoch-size
        multipliers the source applies to its poll budget — cadence
        stretch (degraded rung: bigger epochs at the throttled RATE,
        fewer per-barrier overheads) and the `overload.burst` chaos
        factor (the flood must actually enter for the ladder to have
        something to defend against; the queue bounds still hard-cap
        it)."""
        self.tokens = max(1, int(self.capacity * self.factor
                                 * max(1, mult)))

    def admit(self) -> str:
        self.offered += 1
        if self.tokens > 0:
            self.tokens -= 1
            self.admitted += 1
            return "admit"
        if self.shed_enabled and self.state == "shedding":
            return "shed"
        self.deferred += 1
        return "defer"

    def note_admitted(self, rows: int) -> None:
        self.admitted_rows += int(rows)

    def note_shed(self, epoch: int, rows: int) -> None:
        self.shed_rows += int(rows)
        self.shed_windows += 1
        from .metrics import REGISTRY
        REGISTRY.counter(
            "source_shed_rows_total",
            "rows shed at the source under RW_LOAD_SHED (audited in "
            "rw_shed_log)", labels=("source",)
        ).labels(self.name).inc(int(rows))
        if self.shed_sink is not None:
            self.shed_sink(self.name, epoch, int(rows))

    def row(self) -> Tuple:
        """rw_source_admission row."""
        return (self.name, self.state, self.factor, self.offered,
                self.admitted, self.deferred, self.shed_rows, self.lag)


# ---------------------------------------------------------------------------
# durable shed audit log (the rw_dead_letter pattern)
# ---------------------------------------------------------------------------


class ShedLog:
    """Durable audit trail of every shed source window — the rows behind
    the `rw_shed_log` system table. One row per shed window:
    (id, source, epoch, rows, reason, ts). Rides the normal state-store
    commit protocol (durable at the next checkpoint, survives
    restarts). Unlike the dead-letter queue it records the GAP, not the
    payload: shed data was never admitted, so there is nothing exact to
    requeue — the log is the audit that the gap was a decision, not a
    bug."""

    DTYPES = (T.INT64, T.VARCHAR, T.INT64, T.INT64, T.VARCHAR, T.FLOAT64)
    PK = (0,)

    def __init__(self, table):
        self.table = table
        self._next_id = 1 + max(
            [int(r[0]) for r in table.iter_all()], default=-1)

    def record(self, source: str, epoch: int, rows: int, reason: str,
               commit_epoch: int) -> int:
        rid = self._next_id
        self.table.insert((rid, source, int(epoch), int(rows), reason,
                           time.time()))
        self._next_id += 1
        self.table.commit(commit_epoch)
        return rid

    def entries(self, source: Optional[str] = None) -> List[Tuple]:
        return sorted(tuple(r) for r in self.table.iter_all()
                      if source is None or r[1] == source)


# ---------------------------------------------------------------------------
# SELECT admission (the pgwire front door)
# ---------------------------------------------------------------------------


class SelectGate:
    """Concurrency bound on front-door SELECTs, with per-session
    fairness. `enter()` raises `AdmissionRejected` (SQLSTATE 53000)
    when `RW_SELECT_CONCURRENCY` statements are already in flight OR
    the calling session already holds `RW_SELECT_PER_SESSION` slots —
    token accounting, so one chatty pgwire session exhausts its own
    slice long before it can starve the shared budget. A clean, immediate
    refusal instead of an unbounded queue on the coordinator lock;
    `enter()` returns True when the caller holds a slot (pair with
    `leave()`) and False when the gate is disabled
    (`RW_SELECT_CONCURRENCY <= 0`, the repo's knob-off convention —
    `RW_SELECT_PER_SESSION <= 0` likewise disables only the per-session
    cap). The embedding process's own `Database.query` API is never
    gated (the operator's local tooling must always work)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.active = 0
        self.rejected = 0
        self.session_active: dict = {}

    def _reject(self, why: str) -> None:
        self.rejected += 1
        from .metrics import REGISTRY
        REGISTRY.counter(
            "select_admission_rejected_total",
            "front-door SELECTs refused at the concurrency "
            "bound (SQLSTATE 53000)").inc()
        raise AdmissionRejected(why)

    def enter(self, session=None) -> bool:
        limit = ROBUSTNESS.select_concurrency
        if limit <= 0:
            return False
        per = ROBUSTNESS.select_per_session
        with self._lock:
            if self.active >= limit:
                self._reject(
                    f"too many concurrent SELECTs "
                    f"(RW_SELECT_CONCURRENCY={limit}); retry when "
                    "in-flight queries drain")
            if session is not None and per > 0 \
                    and self.session_active.get(session, 0) >= per:
                self._reject(
                    f"session holds its full SELECT slice "
                    f"(RW_SELECT_PER_SESSION={per}); retry when this "
                    "session's in-flight queries drain")
            self.active += 1
            if session is not None:
                self.session_active[session] = \
                    self.session_active.get(session, 0) + 1
        return True

    def leave(self, session=None) -> None:
        with self._lock:
            self.active = max(0, self.active - 1)
            if session is not None:
                n = self.session_active.get(session, 0) - 1
                if n > 0:
                    self.session_active[session] = n
                else:
                    self.session_active.pop(session, None)


# ---------------------------------------------------------------------------
# the per-database overload manager (closed loop, runs on the tick)
# ---------------------------------------------------------------------------


class OverloadManager:
    """Owns the ladder controllers and admission buckets of one
    Database and closes the loop once per barrier tick:

    1. read the pressure evidence — stall fraction from the
       `PressureBoard`, exchange queue-depth ratios from every remote
       worker set, sink stall flags and spool ratios;
    2. feed the combined [0, 1] pressure to every job's ladder
       controller (escalate / hold / recover with hysteresis);
    3. act — fused jobs get their cadence stretch, source buckets get
       their admission factor/state from the WORST downstream rung.

    All reads are lock-free snapshots (depth gauges, flags); the tick
    cost is a few dict walks."""

    def __init__(self) -> None:
        self.controllers: Dict[str, OverloadController] = {}
        self.buckets: Dict[str, AdmissionBucket] = {}
        self.last_pressure = 0.0
        # last tick's labeled evidence + its argmax (rw_pressure_attrib)
        self.last_attribution: List[Tuple[str, str, float]] = []
        self.last_dominant = ""

    def controller(self, job: str) -> OverloadController:
        c = self.controllers.get(job)
        if c is None:
            c = self.controllers[job] = OverloadController(job)
        return c

    def bucket(self, source: str, capacity: int = 64) -> AdmissionBucket:
        b = self.buckets.get(source)
        if b is None:
            b = self.buckets[source] = AdmissionBucket(source, capacity)
        return b

    def forget(self, name: str) -> None:
        self.controllers.pop(name, None)
        self.buckets.pop(name, None)

    # ---- evidence -------------------------------------------------------
    # Every input to the overload scalar is collected as a LABELED
    # contribution (family, source, value); `pressure_of` is then
    # DEFINED as `combine_contributions(attribution(db))`, so the
    # attribution recombines to the global pressure by construction —
    # there is no second code path to drift out of agreement.

    def attribution(self, db) -> List[Tuple[str, str, float]]:
        """(family, source, value) contribution rows. Families:

        * ``stall``  — per-seam credit-stall SECONDS over the window,
          as a fraction of the window (uncapped; the cap lands in the
          combine so the per-kind split still sums to the board's
          scalar);
        * ``sink``   — per-sink spool ratio (1.0 when stalled);
        * ``queue``  — per-remote-worker-set exchange queue ratio.
        """
        window = max(1e-6, ROBUSTNESS.overload_window_s)
        rows: List[Tuple[str, str, float]] = [
            ("stall", kind, s / window)
            for kind, s in sorted(PRESSURE.by_kind(window).items())]
        for obj in db.catalog.objects.values():
            rt = obj.runtime if isinstance(obj.runtime, dict) else None
            se = rt.get("sink_exec") if rt else None
            if se is None:
                continue
            if getattr(se, "stalled", False):
                rows.append(("sink", obj.name, 1.0))
            else:
                rows.append(("sink", obj.name,
                             min(1.0, se.pending_rows()
                                 / max(1, ROBUSTNESS.sink_spool_rows))))
        for name, r in db._remote_sets():
            qp = getattr(r, "queue_pressure", None)
            if qp is not None:
                rows.append(("queue", name, qp()))
        return rows

    def pressure_of(self, db) -> float:
        return combine_contributions(self.attribution(db))

    # ---- the closed loop ------------------------------------------------
    def tick(self, db) -> None:
        now = time.time()
        attrib = self.attribution(db)
        p = combine_contributions(attrib)
        dominant = dominant_contribution(attrib)
        self.last_pressure = p
        self.last_attribution = attrib
        self.last_dominant = dominant
        from .metrics import REGISTRY
        REGISTRY.gauge("overload_pressure",
                       "combined credit-starvation pressure in [0,1]"
                       ).set(p)
        if p > 0.0:
            try:
                from .blackbox import RECORDER
                RECORDER.record("pressure", {
                    "p": round(p, 4), "dominant": dominant,
                    "contrib": [[f, s, round(v, 4)]
                                for f, s, v in attrib if v > 0.0]})
            except Exception:
                pass
        # every live streaming job gets a ladder controller
        jobs = set(db._fused)
        for obj in db.catalog.objects.values():
            rt = obj.runtime if isinstance(obj.runtime, dict) else None
            if rt is None:
                continue
            if obj.kind in ("mv", "sink") and rt.get("fused_job") is None:
                jobs.add(obj.name)
        worst = 0
        for j in sorted(jobs):
            ctrl = self.controller(j)
            ctrl.observe(p, now, source=dominant)
            worst = max(worst, ctrl.rung)
            job = db._fused.get(j)
            if job is not None:
                job.cadence_stretch = ctrl.stretch
        for name in list(self.controllers):
            if name not in jobs:
                del self.controllers[name]
        # sources follow the worst downstream rung: the bucket rate is
        # re-set here, the tokens themselves refill per epoch at the
        # source (so idle-loop extra barriers can't mint extra budget)
        state = LADDER[worst]
        factor = ADMIT_FACTOR[worst]
        stretch = (max(1, int(ROBUSTNESS.overload_stretch))
                   if worst >= _STRETCH_RUNG else 1)
        for b in self.buckets.values():
            b.factor = factor
            b.state = state
            b.stretch = stretch
            b.shed_enabled = ROBUSTNESS.load_shed

    # ---- surfaces -------------------------------------------------------
    def rows(self) -> List[Tuple]:
        now = time.time()
        out: List[Tuple] = []
        for _name, ctrl in sorted(self.controllers.items()):
            out.extend(ctrl.rows(now))
        return out

    def admission_rows(self) -> List[Tuple]:
        return [b.row() for _n, b in sorted(self.buckets.items())]

    def attribution_rows(self) -> List[Tuple]:
        """rw_pressure_attrib rows: last tick's labeled contributions
        plus one `combined` row holding the recombined scalar — SQL can
        check the invariant (`combined` == combine of the rest) and the
        `dominant` flag marks the argmax the ladder was stamped with."""
        rows: List[Tuple] = []
        for fam, src, v in self.last_attribution:
            rows.append((fam, src, float(v),
                         f"{fam}:{src}" == self.last_dominant))
        rows.append(("combined", self.last_dominant,
                     float(self.last_pressure), False))
        return rows
