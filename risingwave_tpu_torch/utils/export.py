"""Unified trace export: one Perfetto-loadable timeline per data dir (the
port's own copy of the JAX package's `utils/export.py`).

`risectl trace export --format chrome` merges the observability logs a
run leaves behind — `barrier_trace.jsonl` (inject / per-job collect /
per-worker align / commit), `epoch_profile.jsonl` (fused-job epoch
phase splits + compile events), `blackbox_ring.jsonl` (the flight
recorder's control-plane events: ladder transitions, shed windows,
rebalance adoptions, recoveries, demotions), and the heartbeat samples
the coordinator drains record — into Chrome trace-event JSON
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
that opens directly in ui.perfetto.dev or chrome://tracing. A whole
warmup or chaos run becomes ONE picture: barrier cadence on the
coordinator track, each fused job's phase-split epochs stacked below
it, compiles as named slices, per-worker barrier alignment as instants.

Clock alignment: worker M frames carry the sender's wall clock; the
coordinator's drain stamps receipt. `estimate_clock_offset` recovers
the per-worker offset from those (sent, recv) pairs — recv = sent +
offset + one-way delay, delay >= 0 and varying, so the MINIMUM observed
(recv - sent) is the tightest upper bound on the offset and converges
onto it as some heartbeat eventually travels near-instantly (the
classic NTP lower-bound filter). Worker-clock timestamps shift by the
estimate before they land on the shared timeline.

Everything here reads files only — it works against a live, wedged, or
dead data directory, the same contract as `risectl trace`/`profile`.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from .blackbox import RING_FILE
from .profile import PROFILE_FILE, decode_epoch
from .trace import TRACE_FILE

# chrome trace events use MICROSECONDS
_US = 1e6


def estimate_clock_offset(samples: List[Tuple[float, float]]
                          ) -> Optional[float]:
    """Per-worker clock offset from (sent_worker_clock,
    recv_coordinator_clock) heartbeat pairs: min(recv - sent). The
    network delay inflates every sample by a non-negative, varying
    amount, so the minimum is the tightest estimate and is EXACT for
    any sample whose delay was zero; a constant skew between the two
    clocks passes straight through into the estimate (which is the
    point — correcting it is why the estimator exists). None when there
    are no samples."""
    if not samples:
        return None
    return min(recv - sent for sent, recv in samples)


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue                # torn tail line from a crash
    return out


def _complete(name: str, cat: str, ts: float, dur: float, pid: str,
              tid: str, args: Optional[Dict] = None) -> Dict[str, Any]:
    ev = {"name": name, "cat": cat, "ph": "X", "ts": ts * _US,
          "dur": max(0.0, dur) * _US, "pid": pid, "tid": tid}
    if args:
        ev["args"] = args
    return ev


def _instant(name: str, cat: str, ts: float, pid: str, tid: str,
             args: Optional[Dict] = None) -> Dict[str, Any]:
    ev = {"name": name, "cat": cat, "ph": "i", "s": "t", "ts": ts * _US,
          "pid": pid, "tid": tid}
    if args:
        ev["args"] = args
    return ev


# the epoch-profile phase order IS the wall-clock order inside an epoch
# (old-schema records are normalized by profile.decode_epoch before
# this order is applied — version dispatch, not per-field sniffing)
_PHASE_ORDER = ("pack", "h2d", "promote_h2d", "dispatch",
                "exchange", "device_sync", "demote_d2h", "commit")


def export_chrome(data_dir: str) -> Dict[str, Any]:
    """Merge the data dir's observability logs into one Chrome
    trace-event JSON dict (caller serializes). Timestamps are epoch
    wall-clock microseconds on the COORDINATOR clock; worker-clock
    stamps shift by the heartbeat-estimated offset. Events are sorted
    by ts within each (pid, tid) track — Perfetto requires per-track
    monotonicity, and the merged sources interleave arbitrarily."""
    events: List[Dict[str, Any]] = []
    skipped = 0

    # ---- barrier trace: coordinator + per-job + per-worker tracks ------
    trace = _read_jsonl(os.path.join(data_dir, TRACE_FILE))
    hb_samples: Dict[str, List[Tuple[float, float]]] = {}
    epochs: Dict[Any, Dict[str, Any]] = {}
    collects: Dict[Tuple[Any, str], float] = {}
    aligns: List[Tuple[Any, str, float]] = []
    for ev in trace:
        kind = ev.get("ev")
        e = ev.get("epoch")
        if kind == "inject":
            epochs[e] = {"inject": ev["ts"], "kind": ev.get("kind")}
        elif kind == "collect_start":
            collects[(e, ev["job"])] = ev["ts"]
        elif kind == "collect_end":
            t0 = collects.pop((e, ev["job"]), None)
            if t0 is not None:
                events.append(_complete(
                    f"collect {ev['job']}", "barrier", t0, ev["ts"] - t0,
                    "coordinator", f"job:{ev['job']}", {"epoch": e}))
        elif kind == "commit":
            rec = epochs.get(e)
            if rec is not None and rec.get("inject") is not None:
                events.append(_complete(
                    f"epoch {e} [{rec.get('kind')}]", "barrier",
                    rec["inject"], ev["ts"] - rec["inject"],
                    "coordinator", "barrier", {"epoch": e}))
                epochs.pop(e, None)
        elif kind == "worker_align":
            aligns.append((e, ev["worker"], ev["ts"]))
        elif kind == "hb":
            hb_samples.setdefault(ev["worker"], []).append(
                (ev["sent"], ev["recv"]))
    # un-committed (OPEN) epochs still render, as zero-length markers —
    # a hang is visible as the LAST inject with nothing after it
    for e, rec in epochs.items():
        if rec.get("inject") is not None:
            events.append(_instant(f"epoch {e} OPEN", "barrier",
                                   rec["inject"], "coordinator",
                                   "barrier", {"epoch": e}))
    # per-worker clock offsets (coordinator-clock events need none; the
    # estimate is surfaced per worker in metadata and applied to any
    # worker-clock stamp)
    offsets = {w: estimate_clock_offset(s) for w, s in hb_samples.items()}
    for e, worker, ts in aligns:
        # align stamps are coordinator-clock (drain receipt)
        events.append(_instant(f"align {worker}", "barrier", ts,
                               "coordinator", f"worker:{worker}",
                               {"epoch": e}))
    for worker, samples in hb_samples.items():
        off = offsets[worker] or 0.0
        for sent, _recv in samples:
            # worker-clock stamp, shifted onto the coordinator timeline
            events.append(_instant("hb", "liveness", sent + off,
                                   "workers", worker,
                                   {"offset_s": round(off, 6)}))

    # ---- epoch profile: per-fused-job phase-split epochs + compiles ----
    prof = _read_jsonl(os.path.join(data_dir, PROFILE_FILE))
    for rec in prof:
        ts = rec.get("ts")
        if ts is None:
            skipped += 1          # pre-export records carry no wall stamp
            continue
        job = rec.get("job", "?")
        if rec.get("ev") == "epoch":
            wall = rec.get("wall_ms", 0.0) / 1e3
            t0 = ts - wall
            events.append(_complete(
                f"epoch seq={rec.get('seq')}", "fused", t0, wall,
                f"fused:{job}", "epoch",
                {"events": rec.get("events"),
                 "shards": rec.get("shards", 1)}))
            # phase slices stacked on a sibling track, laid out in the
            # in-epoch wall order (splits sum to <= wall by contract)
            cursor = t0
            ph_ms = decode_epoch(rec)
            for ph in _PHASE_ORDER:
                dur = ph_ms.get(ph, 0.0) / 1e3
                if dur <= 0:
                    continue
                events.append(_complete(ph, "phase", cursor, dur,
                                        f"fused:{job}", "phases"))
                cursor += dur
        elif rec.get("ev") == "compile":
            dur = rec.get("s", 0.0)
            events.append(_complete(
                f"{rec.get('kind', 'compile')} {rec.get('label')}",
                "compile", ts - dur, dur, f"fused:{job}", "compiles",
                {k: rec[k] for k in ("bucket", "aot", "cache_hit")
                 if k in rec}))

    # ---- flight recorder ring: control-plane instants ------------------
    # ladder transitions, shed windows, rebalance adoptions, recoveries,
    # supervision events and tiering demotions land as instant markers on
    # a `control` process — overlaying WHY the engine changed behavior on
    # top of WHAT the barriers and epochs were doing at that moment
    tier_seen: Dict[str, int] = {}
    for rec in _read_jsonl(os.path.join(data_dir, RING_FILE)):
        ts = rec.get("ts")
        kind = rec.get("kind")
        if ts is None:
            skipped += 1
            continue
        args = {k: v for k, v in rec.items()
                if k not in ("ts", "seq", "kind")}
        job = rec.get("job", "?")
        if kind == "ladder":
            events.append(_instant(
                f"ladder {rec.get('prev')}->{rec.get('state')} [{job}]",
                "control", ts, "control", "overload", args))
        elif kind == "shed":
            events.append(_instant(
                f"shed {rec.get('source')} rows={rec.get('rows')}",
                "control", ts, "control", "shed", args))
        elif kind == "rebalance":
            events.append(_instant(
                f"rebalance {job} seq={rec.get('policy_seq')}",
                "control", ts, "control", "rebalance", args))
        elif kind == "recovery":
            events.append(_instant(
                f"recovery {job} attempt={rec.get('attempt')}",
                "control", ts, "control", "recovery", args))
        elif kind in ("quarantine", "wedge_reap", "escalation"):
            events.append(_instant(f"{kind} [{job}]", "control", ts,
                                   "control", "supervisor", args))
        elif kind == "checkpoint" and isinstance(rec.get("tiering"),
                                                 dict):
            dem = int(rec["tiering"].get("demote_events", 0))
            if dem > tier_seen.get(job, 0):
                events.append(_instant(
                    f"demotion {job}", "control", ts, "control",
                    "tiering",
                    {"demote_events": dem - tier_seen.get(job, 0)}))
            tier_seen[job] = dem

    # Perfetto needs per-track monotonic timestamps; a global sort is
    # the simplest way to guarantee it for every (pid, tid)
    events.sort(key=lambda ev: (str(ev["pid"]), str(ev["tid"]),
                                ev["ts"]))
    meta = {"clock_offsets_s": {w: (round(o, 6) if o is not None else None)
                                for w, o in offsets.items()},
            "skipped_unstamped_records": skipped}
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": meta}


def validate_chrome(doc: Dict[str, Any]) -> List[str]:
    """Structural validity problems of an exported trace (the test +
    acceptance surface): required keys per event, numeric non-negative
    ts/dur, and per-(pid, tid) monotonic ts."""
    problems: List[str] = []
    last: Dict[Tuple[str, str], float] = {}
    for i, ev in enumerate(doc.get("traceEvents", [])):
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in ev:
                problems.append(f"event {i}: missing {k!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if ev.get("ph") == "X" and ev.get("dur", 0) < 0:
            problems.append(f"event {i}: negative dur")
        key = (str(ev.get("pid")), str(ev.get("tid")))
        if ts < last.get(key, float("-inf")):
            problems.append(f"event {i}: ts regressed on track {key}")
        last[key] = ts
    return problems
