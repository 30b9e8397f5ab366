"""Barrier trace: per-epoch span records for stall introspection (the
port's own copy of the JAX package's `utils/trace.py`).

Analog of the reference's barrier tracing + await-tree surface: every
barrier carries a `TracingContext` so one distributed trace spans an
epoch (`src/common/src/util/tracing.rs:45`,
`BarrierInner.tracing_context`), and MonitorService exposes per-actor
stack trees for "where is this stuck"
(`src/compute/src/rpc/service/monitor_service.rs:82-111`).

Re-hosted: the Database's tick loop records one span tree per barrier —
inject → per-job collect (start/end) → commit — in a memory ring
(queryable as the `rw_barrier_trace` system table) AND as a JSONL file
in the data directory, appended event-by-event so a HANG is diagnosable
from OUTSIDE the wedged process (`risectl trace`): the last record with
no `commit` event names the job that started collecting and never
finished.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

TRACE_FILE = "barrier_trace.jsonl"
_MAX_FILE_BYTES = 1 << 20          # rotate: keep the tail fresh, file small
RING = 128


def rotate_tail(path: str) -> None:
    """Drop the first half of a JSONL file IN CONSTANT MEMORY: seek to the
    midpoint, realign to the next line boundary, and stream the tail into
    a replacement file. (The old rotation read the whole file into a list —
    at the 1 MiB rotation point that is a per-4096-events full-file read
    plus a transient double-size allocation, on the barrier path.)"""
    with open(path, "rb") as src:
        src.seek(0, os.SEEK_END)
        size = src.tell()
        src.seek(size // 2)
        src.readline()                       # align to a line boundary
        with open(path + ".rot", "wb") as dst:
            shutil.copyfileobj(src, dst, 1 << 16)
    os.replace(path + ".rot", path)


class BarrierTracer:
    def __init__(self, data_dir: Optional[str] = None):
        self.ring: deque = deque(maxlen=RING)
        self.path = os.path.join(data_dir, TRACE_FILE) if data_dir else None
        self._f = None
        self._emitted = 0
        if self.path is not None:
            try:
                self._f = open(self.path, "a")
            except OSError:
                self.path = None

    # ---- event emission --------------------------------------------------
    def _emit(self, ev: Dict[str, Any]) -> None:
        if self._f is None:
            return
        try:
            self._f.write(json.dumps(ev) + "\n")
            # flush per event: a hang must leave its last collect_start
            # durable for offline diagnosis
            self._f.flush()
            self._emitted += 1
            if self._emitted % 4096 == 0 \
                    and os.path.getsize(self.path) > _MAX_FILE_BYTES:
                self._f.close()
                rotate_tail(self.path)
                self._f = open(self.path, "a")
        except OSError:
            self._f = None             # tracing must never fail the job

    def inject(self, epoch: int, kind: str) -> "BarrierSpan":
        span = BarrierSpan(self, epoch, kind)
        self.ring.append(span)
        self._emit({"ev": "inject", "epoch": epoch, "kind": kind,
                    "ts": time.time()})
        return span

    # ---- cross-worker decomposition -------------------------------------
    def worker_align(self, epoch: int, worker: str, ts: float) -> None:
        """A remote worker's result barrier for `epoch` reached the
        coordinator at `ts` (coordinator clock): the inject->align
        sub-span of that worker. Attached to the matching ring span (the
        align may belong to an EARLIER epoch than the current one —
        buffered result epochs lag the injector) and logged for offline
        reads + the unified trace export."""
        for span in reversed(self.ring):
            if span.epoch == epoch:
                span.workers[worker] = ts
                break
        self._emit({"ev": "worker_align", "epoch": epoch,
                    "worker": worker, "ts": ts})

    def hb_sample(self, worker: str, sent_ts: float, recv_ts: float) -> None:
        """One heartbeat (sent worker-clock, received coordinator-clock)
        pair — the clock-offset estimation samples `risectl trace
        export` aligns worker timestamps with (utils/export.py)."""
        self._emit({"ev": "hb", "worker": worker, "sent": sent_ts,
                    "recv": recv_ts})

    # ---- queries ---------------------------------------------------------
    def rows(self) -> List[Tuple]:
        """(epoch, kind, job, phase, ms) rows for rw_barrier_trace.
        Worker rows (`worker:<slot>` / "align") carry the inject->align
        wall — the per-worker decomposition of cross-fragment barrier
        latency."""
        out: List[Tuple] = []
        for span in self.ring:
            for job, (t0, t1) in span.jobs.items():
                ms = (t1 - t0) * 1000 if t1 is not None else None
                state = "done" if t1 is not None else "RUNNING"
                out.append((span.epoch, span.kind, job, state, ms))
            for worker, ts in span.workers.items():
                out.append((span.epoch, span.kind, f"worker:{worker}",
                            "align", (ts - span.inject_ts) * 1000))
            total = (span.commit_ts - span.inject_ts) * 1000 \
                if span.commit_ts is not None else None
            state = "committed" if span.commit_ts is not None else "OPEN"
            out.append((span.epoch, span.kind, "<barrier>", state, total))
        return out


class BarrierSpan:
    __slots__ = ("tracer", "epoch", "kind", "inject_ts", "jobs",
                 "commit_ts", "workers")

    def __init__(self, tracer: BarrierTracer, epoch: int, kind: str):
        self.tracer = tracer
        self.epoch = epoch
        self.kind = kind
        self.inject_ts = time.time()
        self.jobs: Dict[str, List[Optional[float]]] = {}
        self.commit_ts: Optional[float] = None
        self.workers: Dict[str, float] = {}

    def job_start(self, name: str) -> None:
        self.jobs[name] = [time.time(), None]
        self.tracer._emit({"ev": "collect_start", "epoch": self.epoch,
                           "job": name, "ts": time.time()})

    def job_end(self, name: str) -> None:
        if name in self.jobs:
            self.jobs[name][1] = time.time()
        self.tracer._emit({"ev": "collect_end", "epoch": self.epoch,
                           "job": name, "ts": time.time()})

    def commit(self) -> None:
        self.commit_ts = time.time()
        self.tracer._emit({"ev": "commit", "epoch": self.epoch,
                           "ts": self.commit_ts})


def diagnose(path: str, last: int = 5, stuck_only: bool = False) -> str:
    """Offline hang localization over a barrier_trace.jsonl (the risectl
    `trace` surface): per-epoch summary; an epoch with no commit event is
    flagged with the job(s) that started and never finished. With
    `stuck_only`, committed epochs are dropped BEFORE the last-N window,
    so the OPEN epochs are findable even when fresh committed traffic has
    pushed them out of the tail."""
    epochs: Dict[int, Dict[str, Any]] = {}
    order: List[int] = []
    with open(path) as f:
        for line in f:
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            e = ev.get("epoch")
            if e not in epochs:
                epochs[e] = {"kind": ev.get("kind"), "jobs": {},
                             "inject": None, "commit": None}
                order.append(e)
            rec = epochs[e]
            if ev["ev"] == "inject":
                rec["inject"] = ev["ts"]
                rec["kind"] = ev.get("kind")
            elif ev["ev"] == "collect_start":
                rec["jobs"][ev["job"]] = [ev["ts"], None]
            elif ev["ev"] == "collect_end":
                if ev["job"] in rec["jobs"]:
                    rec["jobs"][ev["job"]][1] = ev["ts"]
            elif ev["ev"] == "commit":
                rec["commit"] = ev["ts"]
    if stuck_only:
        order = [e for e in order if epochs[e]["commit"] is None]
    lines = []
    for e in order[-last:]:
        rec = epochs[e]
        if rec["commit"] is not None and rec["inject"] is not None:
            ms = (rec["commit"] - rec["inject"]) * 1000
            lines.append(f"epoch {e} [{rec['kind']}] committed in "
                         f"{ms:.1f} ms ({len(rec['jobs'])} jobs)")
            continue
        stuck = [j for j, (t0, t1) in rec["jobs"].items() if t1 is None]
        if stuck:
            lines.append(f"epoch {e} [{rec['kind']}] OPEN — stuck in: "
                         + ", ".join(stuck))
        else:
            done = len(rec["jobs"])
            lines.append(f"epoch {e} [{rec['kind']}] OPEN — {done} jobs "
                         "collected, commit never ran (store/coordinator)")
    if lines:
        return "\n".join(lines)
    return ("no OPEN epochs (every traced barrier committed)" if stuck_only
            else "no barrier trace events")
