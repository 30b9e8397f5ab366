"""Deterministic failpoint registry — seeded fault injection (the port's
own copy of the JAX package's `utils/failpoint.py`).

The `fail::fail_point!` analog (the reference gates recovery tests on
failpoints like `collect_commit_epoch` and the madsim simulation tier
kills nodes deterministically, `src/tests/simulation/`): named hooks
compiled into the runtime's failure seams that normally cost one dict
lookup, and under test/chaos configuration fire deterministically from a
per-point seeded RNG.

Arming:

* environment (propagates to spawned worker processes automatically):
      RW_FAILPOINTS="exchange.recv_frame:0.01:42,worker.crash:1:0:1"
  each entry is  name:prob[:seed[:max_fires]]  —
      prob       firing probability per hit in [0, 1] (bare `name`
                 means 1, i.e. always);
      seed       RNG seed (default 0). Same seed => the point fires on
                 exactly the same hit sequence, run after run;
      max_fires  cap on total fires per process (default unlimited).
* programmatically: `arm("name", prob, seed, max_fires)` / `disarm` /
  `reset()` — used by tests to target one process without touching the
  environment of spawned workers.

Call sites do `if failpoint("name"): <inject>` — the injected failure
(raise, drop, `os._exit`) stays at the seam so each site fails the way
real faults there fail. With nothing armed the hook is a dict lookup
returning False; arming is strictly opt-in, so production behavior is
byte-identical unless RW_FAILPOINTS is set.

`declare(name, help)` at the call site's module registers the point for
`risectl failpoints` discovery.

Ledger (exact cross-thread replay):

Seeded firing is deterministic PER POINT, but when several threads race
through the same points the *global interleaving* of fires is only
reproducible in aggregate. The process-global ordinal ledger closes
that gap: every fire appends `(ordinal, point, thread, hit#)` under one
lock, so a chaos run leaves an exact record of what fired and in which
global order. `dump_ledger(path)` (or `RW_FAILPOINT_LEDGER=<file>` with
a not-yet-existing file, dumped at exit) writes it; pointing
`RW_FAILPOINT_LEDGER` at an EXISTING ledger file re-arms every recorded
point in replay mode — each point fires on exactly the recorded hit
ordinals, RNG bypassed — so the second run reproduces the identical
(point, hit#) fire sequence. `risectl failpoints --ledger` prints a
ledger file (or the live in-process ledger) for inspection.
"""
from __future__ import annotations

import json
import os
import random
import threading
from typing import Dict, List, Optional, Tuple

ENV_VAR = "RW_FAILPOINTS"
LEDGER_ENV = "RW_FAILPOINT_LEDGER"
# record|replay, pinned into the env by the first (root) process that
# resolves LEDGER_ENV — descendants inherit the decision instead of
# re-deciding from file existence (which changes mid-run as recorders
# exit)
MODE_ENV = "RW_FAILPOINT_LEDGER_MODE"

# every declared hook site: name -> one-line description (risectl lists)
KNOWN: Dict[str, str] = {}


class FailpointError(RuntimeError):
    """Raised by state-layer failpoints to simulate a crash mid-routine
    (socket-layer points raise ConnectionError instead, so existing
    failure handling exercises its real paths)."""


def declare(name: str, help_: str) -> None:
    KNOWN[name] = help_


# ---------------------------------------------------------------------------
# global ordinal ledger
# ---------------------------------------------------------------------------

# (ordinal, point, thread name, per-point hit ordinal) per FIRE, in global
# order — one lock serializes appends so cross-thread chaos leaves a total
# order, not just per-point sequences
_LEDGER: List[Tuple[int, str, str, int]] = []
_LEDGER_LOCK = threading.Lock()


def _record_fire(point: str, hit: int) -> None:
    with _LEDGER_LOCK:
        _LEDGER.append((len(_LEDGER), point,
                        threading.current_thread().name, hit))


def ledger() -> List[Tuple[int, str, str, int]]:
    """Snapshot of the process-global fire ledger."""
    with _LEDGER_LOCK:
        return list(_LEDGER)


def clear_ledger() -> None:
    with _LEDGER_LOCK:
        _LEDGER.clear()


def dump_ledger(path: str) -> int:
    """Write the ledger as JSON lines; returns the entry count. A chaos
    run under `RW_FAILPOINT_LEDGER=<new file>` does this at exit."""
    entries = ledger()
    with open(path, "w") as f:
        for o, point, thread, hit in entries:
            f.write(json.dumps({"ordinal": o, "point": point,
                                "thread": thread, "hit": hit}) + "\n")
    return len(entries)


def load_ledger(path: str) -> List[Tuple[int, str, str, int]]:
    out = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            d = json.loads(ln)
            out.append((d["ordinal"], d["point"], d.get("thread", "?"),
                        d["hit"]))
    return out


def arm_from_ledger(source) -> List["Point"]:
    """Re-arm every point a recorded ledger fired, in REPLAY mode: each
    point fires on exactly the recorded per-point hit ordinals (the RNG
    is bypassed), so the armed process reproduces the recording run's
    (point, hit#) fire sequence exactly. `source` is a ledger file path
    or a list of ledger entries."""
    entries = load_ledger(source) if isinstance(source, str) else source
    hits_by_point: Dict[str, set] = {}
    for _o, point, _t, hit in entries:
        hits_by_point.setdefault(point, set()).add(hit)
    out = []
    for name, hits in hits_by_point.items():
        p = Point(name, prob=0.0, replay_hits=hits)
        _ARMED[name] = p
        out.append(p)
    return out


class Point:
    """One armed failpoint: seeded RNG, fire count, optional cap; in
    replay mode (`replay_hits`) the RNG is bypassed and the point fires
    on exactly the given per-point hit ordinals."""

    __slots__ = ("name", "prob", "seed", "max_fires", "fires", "hits",
                 "replay_hits", "_rng", "_lock")

    def __init__(self, name: str, prob: float = 1.0, seed: int = 0,
                 max_fires: Optional[int] = None,
                 replay_hits: Optional[set] = None):
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"failpoint {name!r}: prob {prob} not in [0,1]")
        if max_fires is not None and max_fires < 0:
            raise ValueError(f"failpoint {name!r}: negative max_fires")
        self.name = name
        self.prob = prob
        self.seed = seed
        self.max_fires = max_fires
        self.replay_hits = replay_hits
        self.fires = 0
        self.hits = 0
        # per-point independent RNG: each point's firing sequence depends
        # only on (seed, its own hit ordinal), never on other points
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def draw(self) -> bool:
        with self._lock:
            self.hits += 1
            hit = self.hits
            if self.max_fires is not None and self.fires >= self.max_fires:
                return False
            if self.replay_hits is not None:
                fire = hit in self.replay_hits
            else:
                fire = True if self.prob >= 1.0 \
                    else self._rng.random() < self.prob
            if fire:
                self.fires += 1
        if fire:
            # the JAX package also counts the fire in its metrics
            # registry (`failpoint_fires_total`), which the port does
            # not hold yet: the ledger is the record here
            _record_fire(self.name, hit)
        return fire

    def spec(self) -> str:
        s = f"{self.name}:{self.prob:g}:{self.seed}"
        if self.max_fires is not None:
            s += f":{self.max_fires}"
        return s


_ARMED: Dict[str, Point] = {}


def failpoint(name: str) -> bool:
    """True when the (armed) point fires. Disarmed: one dict lookup."""
    p = _ARMED.get(name)
    if p is None:
        return False
    return p.draw()


def arm(name: str, prob: float = 1.0, seed: int = 0,
        max_fires: Optional[int] = None) -> Point:
    p = Point(name, prob, seed, max_fires)
    _ARMED[name] = p
    return p


def disarm(name: str) -> None:
    _ARMED.pop(name, None)


def reset() -> None:
    """Disarm everything (including env-derived points)."""
    _ARMED.clear()


def armed() -> List[Point]:
    return list(_ARMED.values())


def parse_spec(spec: str) -> List[Point]:
    """Parse a RW_FAILPOINTS value into (unarmed) Point objects."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) > 4:
            raise ValueError(f"bad failpoint spec {entry!r} "
                             "(name:prob[:seed[:max_fires]])")
        try:
            prob = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
            seed = int(parts[2]) if len(parts) > 2 and parts[2] else 0
            mx = int(parts[3]) if len(parts) > 3 and parts[3] else None
        except ValueError as e:
            raise ValueError(f"bad failpoint spec {entry!r}: {e}") from None
        out.append(Point(parts[0], prob, seed, mx))
    return out


def load_env() -> None:
    """(Re-)arm from RW_FAILPOINTS; spawned workers inherit the env and
    run this at import, so one setting covers the whole process tree.

    RW_FAILPOINT_LEDGER=<file>:
    * file exists  -> REPLAY: re-arm every recorded point to fire on its
      recorded hit ordinals (overrides RW_FAILPOINTS for those points);
    * file missing -> RECORD: dump the ledger there at process exit
      (a sibling process that raced the path first falls back to
      `<file>.<pid>` so recordings never clobber each other).

    The record/replay decision is made ONCE, by the root process, and
    pinned into the env (RW_FAILPOINT_LEDGER_MODE) so every descendant
    inherits it: without the pin, a sibling exiting mid-recording would
    write the base file and silently flip later-spawned workers (e.g. a
    supervised respawn) into replay mode against a partial ledger.
    """
    for p in parse_spec(os.environ.get(ENV_VAR, "")):
        _ARMED[p.name] = p
    lpath = os.environ.get(LEDGER_ENV)
    if not lpath:
        return
    mode = os.environ.get(MODE_ENV)
    if mode not in ("record", "replay"):
        mode = "replay" if os.path.exists(lpath) else "record"
        os.environ[MODE_ENV] = mode
    if mode == "replay":
        arm_from_ledger(lpath)
        return
    import atexit

    def _dump():
        path = lpath
        if os.path.exists(path):
            path = f"{path}.{os.getpid()}"
        try:
            dump_ledger(path)
        except OSError:
            pass

    atexit.register(_dump)


load_env()
