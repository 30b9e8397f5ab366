"""Prometheus-style metrics kernel + the cluster metrics plane (the port's
own copy of the JAX package's `utils/metrics.py`; one process-wide
registry of the port's own).

Analog of the reference's guarded labeled metrics
(`src/common/metrics/src/guarded_metrics.rs` + per-layer metric structs like
`src/stream/src/executor/monitor/streaming_stats.rs`): counters, gauges and
histograms with label sets, a process-wide registry, and text exposition in
the Prometheus format. No external client library — the framework only needs
the data model and the wire format.

Cluster plane: worker processes serialize registry DELTAS (`dump_delta`)
onto their result exchange stream; the coordinator folds them into its
global registry (`merge_remote`) under an extra `worker` label, so one
`expose()` covers the whole deployment. Remote samples are REPLACED, not
accumulated — workers ship cumulative values, so re-delivery after a
respawn or replay is idempotent.

Mutation thread-safety: children are incremented concurrently by exchange
drains, the supervisor and the barrier loop; `+=` on a Python float is
read-modify-write, so every child mutation takes `_VLOCK` (one process-wide
lock — these are counters, not a hot data path).
"""
from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# shared mutation lock for all metric children (see module docstring)
_VLOCK = threading.Lock()


def _esc(v: Any) -> str:
    """Prometheus label-value escaping: backslash FIRST, then quote and
    newline — the exposition format's only three escapes."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _esc_help(h: str) -> str:
    """HELP text escaping (backslash and newline only; quotes are legal)."""
    return h.replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str]):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, *values: str):
        values = tuple(str(v) for v in values)
        assert len(values) == len(self.label_names)
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._make_child())
        return child

    def _make_child(self):
        raise NotImplementedError

    def collect(self) -> List[str]:
        raise NotImplementedError

    def _fmt_labels(self, values: Tuple[str, ...]) -> str:
        if not values:
            return ""
        inner = ",".join(f'{k}="{_esc(v)}"'
                         for k, v in zip(self.label_names, values))
        return "{" + inner + "}"


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, by: float = 1.0) -> None:
        with _VLOCK:
            self.value += by


class Counter(_Metric):
    def _make_child(self):
        return _CounterChild()

    def inc(self, by: float = 1.0) -> None:
        self.labels().inc(by)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {_esc_help(self.help)}",
               f"# TYPE {self.name} counter"]
        with self._lock:
            children = sorted(self._children.items())
        for vals, ch in children:
            out.append(f"{self.name}{self._fmt_labels(vals)} {ch.value:g}")
        return out


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        with _VLOCK:
            self.value = v

    def inc(self, by: float = 1.0) -> None:
        with _VLOCK:
            self.value += by

    def dec(self, by: float = 1.0) -> None:
        with _VLOCK:
            self.value -= by


class Gauge(_Metric):
    def _make_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self.labels().set(v)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {_esc_help(self.help)}",
               f"# TYPE {self.name} gauge"]
        with self._lock:
            children = sorted(self._children.items())
        for vals, ch in children:
            out.append(f"{self.name}{self._fmt_labels(vals)} {ch.value:g}")
        return out


_DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _HistogramChild:
    __slots__ = ("buckets", "counts", "total", "sum")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with _VLOCK:
            if i < len(self.counts):
                self.counts[i] += 1
            self.total += 1
            self.sum += v

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket upper bounds (dashboards)."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self.buckets[i]
        return float("inf")


class Histogram(_Metric):
    def __init__(self, name, help_, label_names=(), buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def time(self):
        return _Timer(self.labels())

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {_esc_help(self.help)}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            children = sorted(self._children.items())
        for vals, ch in children:
            out += _hist_lines(self.name, self.label_names, vals,
                               self.buckets, ch.counts, ch.total, ch.sum)
        return out


def _hist_lines(name: str, label_names: Sequence[str],
                vals: Tuple[str, ...], buckets, counts,
                total: int, sum_: float) -> List[str]:
    out = []
    acc = 0
    base = [f'{k}="{_esc(v)}"' for k, v in zip(label_names, vals)]
    for ub, c in zip(buckets, counts):
        acc += c
        inner = ",".join(base + [f'le="{ub:g}"'])
        out.append(f"{name}_bucket{{{inner}}} {acc}")
    linf = ",".join(base + ['le="+Inf"'])
    out.append(f"{name}_bucket{{{linf}}} {total}")
    lbl = "{" + ",".join(base) + "}" if base else ""
    out.append(f"{name}_sum{lbl} {sum_:g}")
    out.append(f"{name}_count{lbl} {total}")
    return out


class _Timer:
    def __init__(self, child: _HistogramChild):
        self.child = child

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.child.observe(time.perf_counter() - self._t0)
        return False


_TYPE_NAME = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


def _child_state(metric: _Metric, ch) -> Any:
    """Serializable snapshot of one child (JSON-safe; the exchange M-frame
    payload)."""
    if isinstance(metric, Histogram):
        with _VLOCK:
            return {"counts": list(ch.counts), "total": ch.total,
                    "sum": ch.sum, "buckets": list(metric.buckets)}
    return ch.value


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()
        # every label set a name was ever requested with (the naming lint
        # flags names registered with CONFLICTING sets — the silent
        # first-registration-wins behavior of _register hides them)
        self._label_history: Dict[str, set] = {}
        # worker-originated families merged over the exchange: name ->
        # {"type","help","labels","children": {label values: state}}.
        # Kept apart from _metrics because their label sets carry the
        # extra `worker` label the local family doesn't have.
        self._remote: Dict[str, Dict[str, Any]] = {}
        # label sets each WORKER ever shipped for a family: the lint
        # flags divergence — merge_remote's first-dump-wins label names
        # would otherwise silently misalign a straggler worker's samples
        # (a histogram's bucket rows land under the wrong label names)
        self._remote_label_history: Dict[str, Dict[str, set]] = {}

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help_, labels))

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help_, labels))

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_, labels, buckets))

    def _register(self, m: _Metric):
        with self._lock:
            self._label_history.setdefault(m.name, set()).add(m.label_names)
            existing = self._metrics.get(m.name)
            if existing is not None:
                assert type(existing) is type(m), f"metric {m.name} re-typed"
                return existing
            self._metrics[m.name] = m
            return m

    # ---- cluster plane ---------------------------------------------------
    def dump_delta(self, prev: Dict[Tuple[str, ...], Any]
                   ) -> Tuple[Dict[str, Any], Dict[Tuple[str, ...], Any]]:
        """(changed families, new flat state). `prev` is the flat state a
        previous call returned ({(name, *label values): child state}); only
        children whose state changed since are included, so the per-epoch
        piggyback frame stays small. Values are cumulative, not
        differences — the receiving merge replaces, it never adds."""
        out: Dict[str, Any] = {}
        new: Dict[Tuple[str, ...], Any] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for vals, ch in list(m._children.items()):
                state = _child_state(m, ch)
                key = (m.name,) + vals
                new[key] = state
                if prev.get(key) != state:
                    fam = out.setdefault(m.name, {
                        "type": _TYPE_NAME[type(m)], "help": m.help,
                        "labels": list(m.label_names), "samples": []})
                    fam["samples"].append([list(vals), state])
        return out, new

    def merge_remote(self, dump: Dict[str, Any], worker: str) -> None:
        """Fold a worker's `dump_delta` families into this registry under
        an extra `worker` label. Replace semantics (idempotent): the
        worker ships cumulative values."""
        with self._lock:
            for name, fam in dump.items():
                self._remote_label_history.setdefault(
                    name, {}).setdefault(worker, set()).add(
                        tuple(fam.get("labels", ())))
                store = self._remote.get(name)
                if store is None:
                    store = self._remote[name] = {
                        "type": fam.get("type", "counter"),
                        "help": fam.get("help", ""),
                        "labels": tuple(fam.get("labels", ())) + ("worker",),
                        "children": {}}
                for vals, state in fam.get("samples", ()):
                    store["children"][tuple(vals) + (worker,)] = state

    def _collect_remote(self, name: str, store: Dict[str, Any],
                        header: bool) -> List[str]:
        out = []
        if header:
            out += [f"# HELP {name} {_esc_help(store['help'])}",
                    f"# TYPE {name} {store['type']}"]
        label_names = store["labels"]
        for vals, state in sorted(store["children"].items()):
            if store["type"] == "histogram" and isinstance(state, dict):
                out += _hist_lines(name, label_names, vals,
                                   state["buckets"], state["counts"],
                                   state["total"], state["sum"])
            else:
                inner = ",".join(f'{k}="{_esc(v)}"'
                                 for k, v in zip(label_names, vals))
                out.append(f"{name}{{{inner}}} {float(state):g}")
        return out

    def expose(self) -> str:
        """Prometheus text exposition format — local families plus the
        worker-originated samples merged over the exchange (cluster-wide
        view; remote samples of a family print right after its local ones
        so the family stays contiguous). Remote stores are snapshotted
        under the registry lock: drain threads merge concurrently, and a
        scrape must not crash mid-iteration exactly when the cluster is
        busy."""
        with self._lock:
            names = sorted(set(self._metrics) | set(self._remote))
            remote = {name: {**store,
                             "children": dict(store["children"])}
                      for name, store in self._remote.items()}
        lines: List[str] = []
        for name in names:
            m = self._metrics.get(name)
            if m is not None:
                lines += m.collect()
            r = remote.get(name)
            if r is not None:
                lines += self._collect_remote(name, r, header=m is None)
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# naming lint (CI: tests/conftest.py walks the global REGISTRY post-suite)
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def lint_registry(reg: MetricsRegistry) -> List[str]:
    """Prometheus-conformance problems in a registry: invalid metric/label
    names and names registered with conflicting label sets (the silent
    first-wins dedup in `_register` would otherwise hide the mismatch
    until a `labels()` call asserts at runtime)."""
    problems: List[str] = []
    for name, m in sorted(reg._metrics.items()):
        if not _NAME_RE.match(name):
            problems.append(f"metric name {name!r} violates "
                            "[a-zA-Z_:][a-zA-Z0-9_:]*")
        for ln in m.label_names:
            if not _LABEL_RE.match(ln):
                problems.append(f"metric {name}: label name {ln!r} violates "
                                "[a-zA-Z_][a-zA-Z0-9_]*")
    for name, sets in sorted(reg._label_history.items()):
        if len(sets) > 1:
            problems.append(
                f"metric {name}: registered with conflicting label sets "
                f"{sorted(tuple(s) for s in sets)}")
    # cluster plane: the same family shipped with DIFFERENT label sets
    # by different workers (or by one worker across respawns) means
    # merge_remote's first-dump-wins label names misalign someone's
    # samples — a histogram's per-bucket rows would print under wrong
    # label names. Divergence ACROSS workers and WITHIN one worker both
    # flag.
    for name, by_worker in sorted(reg._remote_label_history.items()):
        all_sets = set().union(*by_worker.values())
        if len(all_sets) > 1:
            detail = {w: sorted(s) for w, s in sorted(by_worker.items())}
            problems.append(
                f"remote metric {name}: label sets diverge across "
                f"workers {detail}")
    return problems


def dead_telemetry(reg: MetricsRegistry) -> List[str]:
    """LABELED metrics that never received a single `labels(...)` call:
    the family was registered but no child exists, so it exposes nothing
    and no dashboard can ever see it — usually a label-plumbing refactor
    that left the registration behind. Unlabeled metrics are exempt
    (their single child is created lazily on first inc/set/observe, and
    a legitimately-zero counter is not dead). Advisory, not a failure:
    the CI sessionfinish prints these as warnings — a suite subset
    (`pytest tests/test_foo.py`) legitimately leaves most families
    untouched."""
    dead: List[str] = []
    for name, m in sorted(reg._metrics.items()):
        if m.label_names and not m._children:
            dead.append(f"metric {name}: labeled "
                        f"{list(m.label_names)} but no label set was ever "
                        "instantiated (dead telemetry?)")
    return dead


REGISTRY = MetricsRegistry()
