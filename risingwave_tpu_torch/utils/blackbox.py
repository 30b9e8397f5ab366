"""Flight recorder: an always-on bounded ring of recent telemetry that
dumps a self-describing postmortem bundle when something goes wrong (the
port's own copy of the JAX package's `utils/blackbox.py`).

The observability surfaces built so far (epoch profiles, the overload
ladder, skew/traffic snapshots, serving-cache stats, tiering counters)
are LIVE surfaces: they answer questions while the process is healthy.
The flight recorder is the complement — the aircraft black box. Every
noteworthy event is appended to a small in-memory ring (byte-bounded,
~4 MB by default, so it is cheap enough to leave armed in production)
and mirrored to an append-only ``blackbox_ring.jsonl`` in the data
directory (flush-per-event, fail-open, half-file rotation — the same
durability contract as the barrier trace, so a CRASHED or WEDGED
process still leaves its last seconds on disk for `risectl blackbox`).

On a trigger — in-place recovery, fragment quarantine, wedge reap,
ladder escalation, or an explicit `risectl blackbox dump` — the ring is
frozen into a bundle directory ``blackbox/<seq>-<reason>/`` holding

* ``records.jsonl`` — the ring contents, oldest first, one JSON object
  per line: ``{"seq", "ts", "kind", ...payload}``;
* ``manifest.json`` — self-describing envelope: schema version, the
  trigger reason, wall-clock range covered, per-kind record counts.

Bundles are retained newest-first (a bounded number — a crash loop
must not fill the disk) and auto-triggers are rate-limited per reason.
Everything here is policy-free evidence: the recorder never acts, it
only remembers.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .trace import rotate_tail

RING_FILE = "blackbox_ring.jsonl"
BUNDLE_DIR = "blackbox"
SCHEMA = 1
# in-memory ring byte budget (sum of encoded record lines)
_DEFAULT_BYTES = 4 << 20
# on-disk ring rotation point (same shape as the barrier trace)
_MAX_FILE_BYTES = 4 << 20
# auto-dump floor: repeated triggers of one reason within this window
# coalesce into the first bundle (a flapping ladder or a quarantine
# storm must not mint a bundle per event)
_MIN_INTERVAL_S = 10.0
# bundles kept per data dir, newest first
_KEEP_BUNDLES = 16


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


class FlightRecorder:
    """Process-wide telemetry ring + postmortem bundle writer. One
    instance per process (`RECORDER`); the Database attaches its data
    directory at startup so the ring mirrors to disk. `record` is the
    hot call — O(1), one json.dumps, one lock — and NEVER raises."""

    def __init__(self, max_bytes: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._ring: deque = deque()        # (encoded line, kind)
        self._bytes = 0
        self.max_bytes = int(max_bytes if max_bytes is not None else
                             _env_float("RW_BLACKBOX_BYTES",
                                        _DEFAULT_BYTES))
        self._seq = 0
        self.data_dir: Optional[str] = None
        self._f = None
        self._emitted = 0
        self._last_dump: Dict[str, float] = {}   # reason -> monotonic ts
        self.dumps = 0
        self.dropped = 0

    # ---- wiring ----------------------------------------------------------
    def attach(self, data_dir: Optional[str]) -> None:
        """Point the on-disk mirror at `data_dir` (idempotent; a fresh
        Database re-attaches — last one wins, matching every other
        process-global surface in the engine)."""
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None
            self.data_dir = data_dir
            if data_dir:
                try:
                    self._f = open(os.path.join(data_dir, RING_FILE), "a")
                except OSError:
                    self._f = None     # recording must never fail the job

    # ---- the hot call ----------------------------------------------------
    def record(self, kind: str, payload: Dict[str, Any]) -> None:
        ts = time.time()
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "ts": ts, "kind": kind}
            rec.update(payload)
            try:
                line = json.dumps(rec)
            except (TypeError, ValueError):
                line = json.dumps({"seq": self._seq, "ts": ts,
                                   "kind": kind, "unserializable": True})
            self._ring.append((line, kind))
            self._bytes += len(line)
            while self._bytes > self.max_bytes and len(self._ring) > 1:
                old, _k = self._ring.popleft()
                self._bytes -= len(old)
                self.dropped += 1
            f = self._f
        if f is not None:
            try:
                f.write(line + "\n")
                f.flush()              # a crash must leave the tail durable
                self._emitted += 1
                if self._emitted % 4096 == 0:
                    path = os.path.join(self.data_dir, RING_FILE)
                    if os.path.getsize(path) > _MAX_FILE_BYTES:
                        with self._lock:
                            self._f.close()
                            rotate_tail(path)
                            self._f = open(path, "a")
            except OSError:
                with self._lock:
                    self._f = None

    # ---- dumping ---------------------------------------------------------
    def maybe_dump(self, reason: str) -> Optional[str]:
        """Auto-trigger entry point: rate-limited per reason so event
        storms coalesce. Returns the bundle path or None."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < _MIN_INTERVAL_S:
                return None
            self._last_dump[reason] = now
        try:
            return self.dump(reason)
        except Exception:
            return None                # evidence capture must never throw

    def dump(self, reason: str) -> Optional[str]:
        """Freeze the in-memory ring into a bundle directory. Returns
        the bundle path, or None when no data dir is attached."""
        if not self.data_dir:
            return None
        with self._lock:
            lines = [ln for ln, _k in self._ring]
            kinds: Dict[str, int] = {}
            for _ln, k in self._ring:
                kinds[k] = kinds.get(k, 0) + 1
            self.dumps += 1
            seq = self.dumps
        return write_bundle(self.data_dir, reason, lines, kinds, seq)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"records": len(self._ring), "bytes": self._bytes,
                    "max_bytes": self.max_bytes, "dropped": self.dropped,
                    "dumps": self.dumps, "attached": self._f is not None}


def _safe_reason(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in reason)[:48] or "manual"


def write_bundle(data_dir: str, reason: str, lines: List[str],
                 kinds: Dict[str, int], seq: int) -> str:
    """Write one postmortem bundle (records + manifest) and prune old
    ones. Separated from the recorder so `risectl blackbox dump` can
    build a bundle from a DEAD directory's ring file with the same
    format."""
    root = os.path.join(data_dir, BUNDLE_DIR)
    name = f"{int(time.time())}-{seq:03d}-{_safe_reason(reason)}"
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "records.jsonl"), "w") as f:
        for ln in lines:
            f.write(ln + "\n")
    ts_lo = ts_hi = None
    for ln in (lines[0], lines[-1]) if lines else ():
        try:
            ts = json.loads(ln).get("ts")
        except ValueError:
            continue
        ts_lo = ts if ts_lo is None else ts_lo
        ts_hi = ts
    manifest = {"schema": SCHEMA, "reason": reason, "ts": time.time(),
                "records": len(lines), "kinds": dict(sorted(kinds.items())),
                "ts_first": ts_lo, "ts_last": ts_hi}
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(path, "manifest.json"))
    _prune_bundles(root)
    return path


def _prune_bundles(root: str) -> None:
    try:
        names = sorted(n for n in os.listdir(root)
                       if os.path.isfile(os.path.join(root, n,
                                                      "manifest.json")))
    except OSError:
        return
    for n in names[:-_KEEP_BUNDLES]:
        d = os.path.join(root, n)
        for fn in ("records.jsonl", "manifest.json"):
            try:
                os.unlink(os.path.join(d, fn))
            except OSError:
                pass
        try:
            os.rmdir(d)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# offline surfaces (risectl blackbox — dead-directory capable)
# ---------------------------------------------------------------------------


def dump_from_dir(data_dir: str,
                  reason: str = "manual") -> Optional[str]:
    """Build a bundle from a directory's ON-DISK ring file — the dead-
    process path: the flush-per-event mirror means the ring file holds
    the final seconds of a crashed or wedged engine even though its
    in-memory ring died with it. None when the directory has no ring."""
    ring = os.path.join(data_dir, RING_FILE)
    if not os.path.exists(ring):
        return None
    lines: List[str] = []
    kinds: Dict[str, int] = {}
    with open(ring) as f:
        for raw in f:
            raw = raw.rstrip("\n")
            if not raw:
                continue
            try:
                rec = json.loads(raw)
            except ValueError:
                continue               # torn tail line from a hard kill
            lines.append(raw)
            k = str(rec.get("kind", "?"))
            kinds[k] = kinds.get(k, 0) + 1
    existing = list_bundles(data_dir)
    return write_bundle(data_dir, reason, lines, kinds, len(existing) + 1)


def list_bundles(data_dir: str) -> List[Tuple[str, Dict[str, Any]]]:
    """(bundle dir name, manifest) pairs, oldest first."""
    root = os.path.join(data_dir, BUNDLE_DIR)
    out: List[Tuple[str, Dict[str, Any]]] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for n in names:
        try:
            with open(os.path.join(root, n, "manifest.json")) as f:
                out.append((n, json.load(f)))
        except (OSError, ValueError):
            continue
    return out


def read_bundle(data_dir: str, name: str) -> List[Dict[str, Any]]:
    """Decoded records of one bundle, oldest first."""
    path = os.path.join(data_dir, BUNDLE_DIR, name, "records.jsonl")
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for raw in f:
            try:
                out.append(json.loads(raw))
            except ValueError:
                continue
    return out


# one recorder per process (workers keep their own; their events reach
# their own data dirs — the coordinator's recorder covers the planes it
# can see: barriers, the ladder, serving, tiering, supervision)
RECORDER = FlightRecorder()
