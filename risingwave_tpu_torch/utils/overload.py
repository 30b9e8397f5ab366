"""Pressure sensing: the process-wide record of credit and capacity
stalls (the port's own copy of `PressureBoard` and `PRESSURE` from the
JAX package's `utils/overload.py`).

Every data-movement seam that can stall under credit or capacity
exhaustion reports here — in the port so far, a `ThreadedChannel`
producer blocked on a full channel (`ops/exchange.py`). The board turns
those stall seconds into a [0, 1] "fraction of recent wall spent
starved" signal, and counts them in the metrics registry
(`credit_stall_seconds_total`, by seam).

The rest of the JAX package's module — the degradation ladder
(`OverloadController`), source admission (`AdmissionBucket`), the shed
log and the SELECT gate — reads its robustness config and belongs to a
later slice of the port.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict


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


# one board per process
PRESSURE = PressureBoard()
