"""Epoch-timeline device profiler for fused jobs (the port's own copy of
the JAX package's `utils/profile.py`).

StreamBox-HBM's lesson (arxiv 1901.01328) is that a streaming engine
whose state lives in device memory is only tunable with continuous
phase/occupancy accounting; this module is that accounting for the
fused execution path. Each epoch of a `FusedJob` is one phase-split
span:

  pack         — building the epoch's host-side inputs: the event cursor
                 for device-datagen jobs; for host-ingest jobs
                 (device/ingest.py) the wall the dispatch thread spends
                 packing poll windows into pinned staging buffers OR
                 blocked on the staging thread doing it (a well-
                 overlapped double buffer drives this toward zero)
  h2d          — the dispatch thread's wait on `HostIngest`'s staging
                 copy (the host-to-device copy of the staged window on
                 the side stream), split disjointly out of `pack` so the
                 ingest pipeline's two costs are separately attributable;
                 0 on device-datagen jobs. The stager's HIDDEN walls
                 (work done on the staging thread while the device
                 computes) are reported through `HostIngest.stats()`,
                 not epoch spans — in-span phases stay on-thread so they
                 keep summing to <= epoch wall
  promote_h2d  — the state tier's touch promotion before the step
                 (device/tiering.py); 0 when nothing is cold
  dispatch     — the per-node launch loop (no device sync)
  exchange     — launching the `bucket_exchange` shuffle of mesh-sharded
                 programs (device/shard_exec.py); 0 on one-shard jobs.
                 Split out of `dispatch` so the exchange stage's cost
                 is attributable per shard count
  device_sync  — `FusedJob.sync()`'s one synchronised pull of the folded
                 stats vector at a checkpoint — it waits for ALL device
                 work launched since the last sync, growth replays
                 included
  demote_d2h   — the state tier's demotion tick at a checkpoint
  commit       — the job's checkpoint bookkeeping (the JAX package also
                 mirrors the MV and writes its job-state rows here)

Every span and row carries the job's `shards` dimension (mesh size; 1 =
one shard) so phase timings from sharded and unsharded runs never
aggregate silently.

Non-checkpoint epochs only carry pack+h2d+dispatch (their device work is
paid for by the next sync — that asymmetry is the async-dispatch design,
and exactly what the profiler exists to make visible). Compile/retrace
events are timed separately and labeled by node signature so warmup time
is decomposable from steady state: in the port a node's first step (its
first kernel launches and first allocations) and a grown node's first
step at its new capacity; the kernels themselves are built once per
process (`kernels/binding.py`), outside any epoch.

Records land in a memory ring (the `rw_epoch_profile` system table) AND —
when a data directory is attached — in `epoch_profile.jsonl`, appended at
checkpoints so `risectl profile` works offline against any data dir, the
same contract as `barrier_trace.jsonl`. Overhead when enabled is a few
`perf_counter` calls per epoch plus two per node; `DeviceConfig.profile=
False` removes even that.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

PROFILE_FILE = "epoch_profile.jsonl"
_MAX_FILE_BYTES = 4 << 20
# record schema version stamped on every epoch record. Readers dispatch
# on it (`decode_epoch`) instead of sniffing individual fields:
#   1 (implicit — records with no `schema` field): pre-pack/h2d-split
#     releases; `host_pack` held the combined staging wall and `shards`
#     may be absent.
#   2: current shape (pack/h2d split, `shards` always present).
PROFILE_SCHEMA = 2
PHASES = ("pack", "h2d", "promote_h2d", "dispatch", "exchange",
          "device_sync", "demote_d2h", "commit")
# a per-node step call slower than this is recorded as a compile/retrace
# even when the profiler did not expect one (catches shape changes that
# arrived through a path growth accounting doesn't flag)
COMPILE_THRESHOLD_S = 0.25
RING = 512


class JobProfiler:
    """Per-FusedJob epoch profiler. All methods are cheap no-ops when
    `enabled` is False; callers guard their own perf_counter reads on
    `enabled` so a disabled profiler costs one attribute load per epoch."""

    def __init__(self, job: str, enabled: bool = True, shards: int = 1):
        self.job = job
        self.enabled = enabled
        # device mesh size of the job's fused program (1 = single chip):
        # a dimension on every span so sharded/unsharded timings are
        # never conflated
        self.shards = shards
        self.ring: deque = deque(maxlen=RING)
        self.compiles: deque = deque(maxlen=256)   # (label, kind, seconds)
        # full compile records incl. bucket/aot/cache_hit labels (the
        # compile-service events; `compiles` keeps the legacy 3-tuples)
        self.compile_info: deque = deque(maxlen=256)
        # events may arrive from compile-service worker threads while the
        # barrier thread flushes — guard the shared buffers
        self._ev_lock = threading.Lock()
        self.path: Optional[str] = None
        self._f = None
        self._buf: List[Dict[str, Any]] = []
        self._cur: Optional[Dict[str, Any]] = None
        self.epochs = 0
        self.totals = {p: 0.0 for p in PHASES}
        # node index -> reason ("compile" | "retrace") whose NEXT step
        # call is expected to trace+compile (cold start, or capacity
        # growth re-traced the node); filled by FusedJob, consumed by
        # FusedProgram.epoch
        self.pending_compile: Dict[int, str] = {}

    # ---- wiring ----------------------------------------------------------
    def attach(self, data_dir: Optional[str]) -> None:
        """Mirror records into <data_dir>/epoch_profile.jsonl (the
        `risectl profile` surface)."""
        if data_dir and self.enabled:
            self.path = os.path.join(data_dir, PROFILE_FILE)

    # ---- epoch spans -----------------------------------------------------
    def begin_epoch(self, seq: int, events: int) -> None:
        self._cur = {"seq": seq, "events": events,
                     "ph": {}, "t0": time.perf_counter()}

    def phase(self, name: str, seconds: float) -> None:
        """Accumulate a phase duration. Sync time from OUTSIDE an epoch
        span (a SELECT pulling the MV between barriers) still lands in the
        totals so warmup decomposition stays honest."""
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        if self._cur is not None:
            ph = self._cur["ph"]
            ph[name] = ph.get(name, 0.0) + seconds

    def end_epoch(self) -> None:
        cur = self._cur
        if cur is None:
            return
        self._cur = None
        wall = time.perf_counter() - cur.pop("t0")
        # "ts" = epoch END wall clock: the unified trace export
        # (utils/export.py) places the span at [ts - wall, ts] on the
        # coordinator timeline
        rec = {"ev": "epoch", "schema": PROFILE_SCHEMA, "job": self.job,
               "seq": cur["seq"], "events": cur["events"],
               "shards": self.shards, "ts": time.time(),
               "wall_ms": wall * 1e3,
               "ph_ms": {k: v * 1e3 for k, v in cur["ph"].items()}}
        self.ring.append(rec)
        with self._ev_lock:
            self._buf.append(rec)
        self.epochs += 1
        try:
            from .blackbox import RECORDER
            RECORDER.record("epoch", {
                "job": self.job, "seq": rec["seq"],
                "events": rec["events"], "shards": self.shards,
                "wall_ms": round(rec["wall_ms"], 3),
                "ph_ms": {k: round(v, 3)
                          for k, v in rec["ph_ms"].items()}})
        except Exception:
            pass             # the flight recorder must never fail an epoch

    # ---- compile / retrace events ---------------------------------------
    def compile_event(self, label: str, seconds: float,
                      kind: str = "compile", bucket: Optional[str] = None,
                      aot: bool = False, cache_hit: bool = False) -> None:
        """Record one compile/retrace. `bucket` names the capacity bucket
        the trace was shaped for, `aot` marks background (compile-service)
        compiles vs inline ones, `cache_hit` marks executables served
        from the persistent cache/manifest — together they decompose
        warmup into named, attributable compiles. Thread-safe: the
        compile service reports from its worker threads."""
        rec = {"ev": "compile", "job": self.job, "label": label,
               "kind": kind, "s": seconds, "ts": time.time()}
        if bucket is not None:
            rec["bucket"] = bucket
        if aot:
            rec["aot"] = True
        if cache_hit:
            rec["cache_hit"] = True
        with self._ev_lock:
            self.compiles.append((label, kind, seconds))
            self.compile_info.append(rec)
            self._buf.append(rec)

    # ---- file sink (flushed at checkpoints) ------------------------------
    def flush(self) -> None:
        """Write buffered records to epoch_profile.jsonl. The WHOLE
        write+rotate runs under the event lock: flush is reachable from
        more than one coordinator thread (the epoch loop at checkpoints,
        a supervisor respawn draining a job mid-recovery), and two
        interleaved writers could tear lines or rotate the file out from
        under each other's handle — `--follow` readers and the offline
        summarizer both assume whole lines."""
        with self._ev_lock:
            buf, self._buf = self._buf, []
            if self.path is None or not buf:
                return                   # unattached: the ring is the record
            try:
                if self._f is None:
                    self._f = open(self.path, "a")
                for rec in buf:
                    self._f.write(json.dumps(rec) + "\n")
                self._f.flush()
                if os.path.getsize(self.path) > _MAX_FILE_BYTES:
                    from .trace import rotate_tail
                    self._f.close()
                    rotate_tail(self.path)
                    self._f = open(self.path, "a")
            except OSError:
                self.path = None         # profiling must never fail the job

    # ---- surfaces --------------------------------------------------------
    def rows(self) -> List[Tuple]:
        """rw_epoch_profile rows: (job, seq, events, shards, pack_ms,
        h2d_ms, promote_h2d_ms, dispatch_ms, exchange_ms,
        device_sync_ms, demote_d2h_ms, commit_ms, wall_ms). Old-schema
        records are normalized by `decode_epoch` (version dispatch, not
        per-field sniffing). promote_h2d / demote_d2h are the state
        tier's surgery phases (device/tiering.py) — zero when tiering
        is off."""
        out = []
        for r in self.ring:
            ph = decode_epoch(r)
            out.append((self.job, r["seq"], r["events"],
                        r.get("shards", 1))
                       + tuple(ph.get(p, 0.0) for p in PHASES)
                       + (r["wall_ms"],))
        return out

    def summary(self, top: int = 5) -> Dict[str, Any]:
        """Compact report for bench detail blocks / risectl."""
        slow = sorted(self.ring, key=lambda r: -r["wall_ms"])[:top]
        with self._ev_lock:              # background compiles may land now
            compiles = list(self.compiles)
            compile_info = list(self.compile_info)
        return {
            "epochs": self.epochs,
            "phase_s": {k: round(v, 4) for k, v in self.totals.items()},
            "compile_events": [
                {k: (round(v, 3) if k == "s" else v)
                 for k, v in rec.items() if k not in ("ev", "job")}
                for rec in compile_info],
            "compile_s": round(sum(s for _, _, s in compiles), 3),
            "top_epochs": [
                {"seq": r["seq"], "wall_ms": round(r["wall_ms"], 3),
                 "ph_ms": {k: round(v, 3) for k, v in r["ph_ms"].items()}}
                for r in slow],
        }


def decode_epoch(rec: Dict[str, Any]) -> Dict[str, float]:
    """Schema-dispatched phase map of one epoch record. Every reader of
    epoch records (rw_epoch_profile, risectl profile, the unified trace
    export) normalizes through here, so a format change is one new
    branch on the VERSION — not a field-presence heuristic copied into
    each reader. Schema 1 (records with no `schema` field): `host_pack`
    was the combined pack+h2d staging wall — folded into `pack` (h2d
    was 0 by construction there; no staged transfers existed)."""
    ph = dict(rec.get("ph_ms", {}))
    if int(rec.get("schema", 1)) < 2:
        if "host_pack" in ph:
            ph["pack"] = ph.get("pack", 0.0) + ph.pop("host_pack")
    return ph


# ---------------------------------------------------------------------------
# live tail (risectl profile --follow)
# ---------------------------------------------------------------------------


def tail_jsonl(path: str, poll_s: float = 0.25, stop=None,
               from_start: bool = False):
    """Yield records appended to a JSONL file as they land — rotation-
    aware: `rotate_tail` replaces the file (new inode, smaller size), so
    the tail re-opens and resumes from the replacement's start instead
    of wedging on a stale handle or a position past EOF. The replacement
    IS the old file's second half, which this tail already yielded — so
    after a rotation, already-seen lines (tracked by a bounded hash ring
    of recent yields) are skipped until the first unseen line, and only
    genuinely new records flow. Partial lines (a writer mid-append) stay
    buffered until their newline arrives. `stop` is an optional
    threading.Event; the generator also exits if the file never appears
    within one poll after `stop` is set."""
    import io
    from collections import deque
    f = None
    ino = None
    buf = b""
    # hashes of the most recent yielded lines: rotate_tail keeps the
    # newest ~512 KiB (a few thousand records) — the ring must cover it
    recent: deque = deque(maxlen=16384)
    recent_set: set = set()
    skipping = False       # replaying a rotation's already-seen prefix
    try:
        while True:
            if f is None:
                try:
                    f = open(path, "rb")
                    st = os.fstat(f.fileno())
                    ino = st.st_ino
                    if not from_start:
                        f.seek(0, io.SEEK_END)
                    elif recent:
                        skipping = True     # rotation replay: dedupe
                    from_start = True       # after a rotation: read all
                    buf = b""
                except OSError:
                    if stop is not None and stop.wait(poll_s):
                        return
                    elif stop is None:
                        time.sleep(poll_s)
                    continue
            chunk = f.read()
            if chunk:
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    h = hash(line)
                    if skipping:
                        if h in recent_set:
                            continue        # already yielded pre-rotation
                        skipping = False    # first unseen: all new now
                    if len(recent) == recent.maxlen:
                        recent_set.discard(recent[0])
                    recent.append(h)
                    recent_set.add(h)
                    try:
                        yield json.loads(line)
                    except ValueError:
                        pass                # torn line from a crash: skip
                continue
            # no new bytes: rotated (inode changed / file shrank)?
            try:
                st = os.stat(path)
                if st.st_ino != ino or st.st_size < f.tell():
                    f.close()
                    f = None
                    continue
            except OSError:
                f.close()
                f = None
                continue
            if stop is not None:
                if stop.wait(poll_s):
                    return
            else:
                time.sleep(poll_s)
    finally:
        if f is not None:
            f.close()


def format_record(rec: Dict[str, Any]) -> Optional[str]:
    """One-line human rendering of a profile record (`--follow`)."""
    if rec.get("ev") == "epoch":
        ph = rec.get("ph_ms", {})
        phs = " ".join(f"{k}={v:.1f}" for k, v in ph.items() if v)
        return (f"[{rec.get('job')}] epoch seq={rec.get('seq')} "
                f"events={rec.get('events')} "
                f"wall={rec.get('wall_ms', 0):.1f}ms " + phs)
    if rec.get("ev") == "compile":
        tags = "".join(
            f" {t}" for t in ("aot", "cache_hit") if rec.get(t))
        b = f" bucket={rec['bucket']}" if "bucket" in rec else ""
        return (f"[{rec.get('job')}] {rec.get('kind', 'compile')} "
                f"{rec.get('label')} {rec.get('s', 0):.2f}s{b}{tags}")
    return None


# ---------------------------------------------------------------------------
# offline reader (risectl profile)
# ---------------------------------------------------------------------------


def summarize_file(path: str, job: Optional[str] = None,
                   top: int = 10) -> Dict[str, Any]:
    """Per-job profile summary from an epoch_profile.jsonl: phase totals,
    compile/retrace events, and the top-N slowest epochs with their phase
    splits — the offline `risectl profile` answer."""
    jobs: Dict[str, Dict[str, Any]] = {}
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            j = rec.get("job", "?")
            if job is not None and j != job:
                continue
            agg = jobs.setdefault(j, {"epochs": 0, "events": 0,
                                      "phase_ms": {p: 0.0 for p in PHASES},
                                      "compiles": [], "_all": []})
            if rec.get("ev") == "epoch":
                agg["epochs"] += 1
                agg["events"] += rec.get("events", 0)
                for k, v in decode_epoch(rec).items():
                    agg["phase_ms"][k] = agg["phase_ms"].get(k, 0.0) + v
                agg["_all"].append(rec)
            elif rec.get("ev") == "compile":
                agg["compiles"].append(
                    {k: rec[k] for k in ("label", "kind", "s", "bucket",
                                         "aot", "cache_hit") if k in rec})
    out = {}
    for j, agg in jobs.items():
        slow = sorted(agg.pop("_all"), key=lambda r: -r["wall_ms"])[:top]
        agg["phase_ms"] = {k: round(v, 3) for k, v in agg["phase_ms"].items()}
        agg["compile_s"] = round(sum(c["s"] or 0 for c in agg["compiles"]), 3)
        agg["slowest_epochs"] = [
            {"seq": r["seq"], "events": r.get("events"),
             "wall_ms": round(r["wall_ms"], 3),
             "ph_ms": {k: round(v, 3)
                       for k, v in decode_epoch(r).items()}}
            for r in slow]
        out[j] = agg
    return out
