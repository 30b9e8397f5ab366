"""Compute-worker process: builds one stream fragment from a serialized
plan and runs it against the coordinator's exchange (the port's own copy
of the JAX package's `runtime/worker.py`).

The SQL-driven multi-process deployment seam — the analog of the
reference's worker-side stream manager building actors from a StreamNode
proto received over the control stream
(`src/stream/src/task/stream_manager.rs:610` create_actor,
`src/meta/src/stream/stream_manager.rs:254` job placement,
`proto/stream_service.proto:150`). The plan wire format here is JSON
(fragment kind + schema + agg spec + channel routing) instead of proto,
and transport is the credit-flow exchange (`runtime/exchange_net.py`).

Usage (spawned by `runtime/remote_fragments.py`):
    python -m risingwave_tpu_torch.runtime.worker '<plan json>'

The worker prints one line `ADDR <host> <port>` (its result exchange) to
stdout, then streams: coordinator exchange --RemoteInput--> fragment
executor --> its own ExchangeServer channel 0 --> coordinator.

Real host parallelism lives HERE: fragments in separate OS processes
scale with cores, which Python threads cannot (GIL) — the same reason
the reference runs actors on distributed compute nodes, not one.

A worker is host-only: its fragments are the host executors
(`HashAggExecutor`, `HashJoinExecutor`, `StatelessPartialAggExecutor`)
and it never touches a torch device (it imports torch only because the
package's expression layer does).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from ..config import ROBUSTNESS
from ..core.schema import Field, Schema
from ..expr.agg import AggCall
from ..expr.expression import InputRef
from ..ops import HashAggExecutor
from ..state import MemoryStateStore, StateTable
from ..utils.failpoint import declare, failpoint
from ..utils.metrics import REGISTRY
from .exchange_net import ExchangeServer, MetricsFrame, RemoteInput

declare("worker.crash",
        "hard-kill the worker process mid-stream (os._exit per message)")
declare("overload.slow_worker",
        "slow-consumer chaos: the worker sleeps ~20ms per ingested "
        "message, so its input exchange queue fills and credit "
        "backpressure propagates to the coordinator (the deterministic "
        "slow-worker overload seam)")
declare("worker.poison_pill",
        "content-triggered hard kill: RW_POISON_PILL='<col>:<value>' "
        "kills the worker on any INPUT row whose column <col> stringifies"
        " to <value> — the deterministic poison-pill chaos seam (respawns"
        " inherit the env, so replaying the same window re-kills until "
        "the supervisor quarantines it)")


def _poison_spec() -> Optional[tuple]:
    """Parse RW_POISON_PILL='<col index>:<value>' once per process."""
    spec = os.environ.get("RW_POISON_PILL")
    if not spec:
        return None
    col, _, val = spec.partition(":")
    try:
        return int(col), val
    except ValueError:
        return None


from ..ops.executor import Executor as _Executor


class _SlowGate(_Executor):
    """Input-side shim for the `overload.slow_worker` chaos seam: sleeps
    ~20ms per INGESTED message, so the worker's input exchange queue
    fills and credit backpressure propagates to the coordinator — the
    deterministic slow-consumer scenario the overload ladder must
    absorb. Wrapped only when the point is armed in this process, so
    production ingestion pays nothing."""

    def __init__(self, input):
        super().__init__(input.schema, "SlowGate")
        self.append_only = input.append_only
        self.input = input

    def execute(self):
        for msg in self.input.execute():
            if failpoint("overload.slow_worker"):
                time.sleep(0.02)
            yield msg


class _PoisonGate(_Executor):
    """Input-side shim: hard-kills the process (like a real data-
    dependent crash — a decode bug, a kernel assert) the moment a
    matching row is INGESTED, before the fragment executor ever sees it.
    Wraps the worker's RemoteInput(s); active only when RW_POISON_PILL
    is set, so production ingestion pays nothing."""

    def __init__(self, input, col: int, val: str):
        super().__init__(input.schema, "PoisonGate")
        self.append_only = input.append_only
        self.input = input
        self.col = col
        self.val = val

    def execute(self):
        from ..core.chunk import StreamChunk
        for msg in self.input.execute():
            if isinstance(msg, StreamChunk):
                for _op, row in msg.compact().op_rows():
                    if self.col < len(row) \
                            and str(row[self.col]) == self.val:
                        os._exit(3)     # hard death, like SIGKILL
            yield msg


class HeartbeatTimer:
    """Timer-driven heartbeat fallback: sends a frame whenever no
    heartbeat went out within `period` seconds, from a daemon thread.

    The barrier-piggybacked heartbeats (PR 5) only fire when results
    flow; a coordinator-quiescent period — a long AOT compile on the
    coordinator, a paused injector, a slow upstream — silences them and
    the worker reads as WEDGED in rw_worker_liveness even though it is
    idle and healthy. The timer keeps liveness truthful during quiet
    windows; `mark()` (called on every piggybacked send) holds it off
    while traffic already proves liveness. NetChannel.send is
    lock-protected, so the timer thread and the result stream can share
    the channel."""

    def __init__(self, send: Callable[[Optional[int]], None],
                 period: Optional[float] = None):
        self._send = send
        self.period = period if period is not None \
            else max(0.5, ROBUSTNESS.heartbeat_timeout_s / 4.0)
        self._last = time.monotonic()
        self._epoch: Optional[int] = None
        self._stop = threading.Event()
        # held across a send and by stop(): no send starts after stop()
        # returns (a send in flight is waited out)
        self._send_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rw-heartbeat")

    def mark(self, epoch: Optional[int] = None) -> None:
        """A heartbeat just went out on the result stream: restart the
        quiet-window clock."""
        self._last = time.monotonic()
        if epoch is not None:
            self._epoch = epoch

    def start(self) -> "HeartbeatTimer":
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._send_lock:
            self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(min(self.period / 2.0, 1.0)):
            if time.monotonic() - self._last < self.period:
                continue
            with self._send_lock:
                if self._stop.is_set():
                    return
                try:
                    self._send(self._epoch)
                    self._last = time.monotonic()
                except (ConnectionError, OSError):
                    return               # coordinator gone: main loop exits


def _schema(cols: List[List[str]]) -> Schema:
    from ..sql.planner import type_from_name
    return Schema([Field(n, type_from_name(t)) for n, t in cols])


def build_fragment(plan: Dict[str, Any], upstream, upstream2=None) -> Any:
    frag = plan["fragment"]
    if frag["kind"] == "hash_join":
        # full stateful join over this worker's hash-owned key space
        # (`stream_manager.rs:610` — every fragment type places on
        # compute nodes, joins included)
        from ..ops import HashJoinExecutor, JoinType
        return HashJoinExecutor(
            upstream, upstream2, frag["left_keys"], frag["right_keys"],
            JoinType(frag["join_type"]))
    in_schema = upstream.schema
    calls = []
    for kind, arg in frag["calls"]:
        expr = None
        if arg is not None:
            expr = InputRef(arg, in_schema.fields[arg].dtype)
        calls.append(AggCall(kind, expr))
    if frag["kind"] == "partial_hash_agg":
        # stateless pre-shuffle stage: nothing to persist, nothing to
        # recover — a respawned worker is immediately correct
        from ..ops.agg import StatelessPartialAggExecutor
        return StatelessPartialAggExecutor(upstream,
                                           frag["group_indices"], calls)
    if frag["kind"] != "hash_agg":
        raise ValueError(f"unknown fragment kind {frag['kind']!r}")
    # owned-group FULL agg: the hash dispatch gives this worker exclusive
    # ownership of its groups, so its change stream IS final — exact
    # under retraction (multiset min/max states live here)
    gd = [in_schema.fields[i].dtype for i in frag["group_indices"]]
    from ..core import dtypes as T
    st = StateTable(MemoryStateStore(), 1, gd + [T.BYTEA],
                    list(range(len(gd))))
    return HashAggExecutor(upstream, frag["group_indices"], calls,
                           state_table=st)


def _refresh_chunks(execu) -> Iterator[Any]:
    """Full current output of an owned-group agg fragment, as INSERT
    chunks — the v1 post-respawn reconciliation stream. The
    coordinator's MV applies changes by pk, so re-inserting every owned
    group's row heals whatever the dead predecessor
    emitted-but-never-delivered (duplicate `+` records downstream are
    the price; the sink boundary dedupes them)."""
    from ..core.chunk import Op, StreamChunk
    groups = getattr(execu, "groups", None)
    if groups is None:
        return
    rows = [tuple(k) + tuple(g.output())
            for k, g in groups.items() if g.row_count > 0]
    for lo in range(0, len(rows), 4096):
        yield StreamChunk.from_rows(
            execu.schema.dtypes,
            [(Op.INSERT, r) for r in rows[lo:lo + 4096]])


def _group_snapshot(execu) -> Optional[Dict]:
    """Current owned-group output rows keyed by group — the seed
    snapshot the incremental refresh diffs against."""
    groups = getattr(execu, "groups", None)
    if groups is None:
        return None
    return {tuple(k): tuple(k) + tuple(g.output())
            for k, g in groups.items() if g.row_count > 0}


def _diff_chunks(execu, snapshot: Dict) -> Iterator[Any]:
    """Net change of the agg state vs a prior snapshot, as retractable
    chunks — the INCREMENTAL refresh: only groups whose value differs
    from the snapshot are emitted (changed groups as U-/U+ pairs, new
    groups as inserts, vanished groups as exact retractions), so the
    stream is ⊆ changed groups and the downstream changelog stays
    duplicate-free."""
    from ..core.chunk import Op, StreamChunk
    cur = _group_snapshot(execu) or {}
    pairs = []
    for k, row in cur.items():
        old = snapshot.get(k)
        if old is None:
            pairs.append((Op.INSERT, row))
        elif old != row:
            pairs += [(Op.UPDATE_DELETE, old), (Op.UPDATE_INSERT, row)]
    for k, row in snapshot.items():
        if k not in cur:
            pairs.append((Op.DELETE, row))
    for lo in range(0, len(pairs), 4096):
        yield StreamChunk.from_rows(execu.schema.dtypes,
                                    pairs[lo:lo + 4096])


def main(argv: List[str]) -> int:
    plan = json.loads(argv[0])
    host, port = plan["coord"]
    kind = plan.get("fragment", {}).get("kind", "?")
    # worker-local metric families; the coordinator's drain merges them
    # into its global registry under an extra `worker` label (the cluster
    # metrics plane), so they show up in one cluster-wide expose()
    m_epochs = REGISTRY.counter("worker_epochs_total",
                                "result epochs this worker completed",
                                labels=("fragment",)).labels(kind)
    m_chunks = REGISTRY.counter("worker_chunks_total",
                                "data chunks this worker emitted",
                                labels=("fragment",)).labels(kind)
    upstream = RemoteInput((host, port), plan["in_channel"],
                           _schema(plan["in_schema"]),
                           append_only=plan.get("append_only", False))
    upstream2 = None
    if "in_channel_r" in plan:          # two-input fragments (joins)
        upstream2 = RemoteInput((host, port), plan["in_channel_r"],
                                _schema(plan["in_schema_r"]),
                                append_only=plan.get("append_only_r",
                                                     False))
    from ..utils.failpoint import armed as _armed_points
    if any(p.name == "overload.slow_worker" for p in _armed_points()):
        upstream = _SlowGate(upstream)
        if upstream2 is not None:
            upstream2 = _SlowGate(upstream2)
    pp = _poison_spec()
    if pp is not None:
        # deterministic poison-pill chaos: die on ingestion of the
        # matching row, every respawn, until the supervisor quarantines
        # the window carrying it (fault-tolerance v3)
        upstream = _PoisonGate(upstream, *pp)
        if upstream2 is not None:
            upstream2 = _PoisonGate(upstream2, *pp)
    execu = build_fragment(plan, upstream, upstream2)
    server = ExchangeServer()
    out = server.register(0, execu.schema.dtypes)
    print(f"ADDR {server.addr[0]} {server.addr[1]}", flush=True)
    # metrics plane piggyback: registry DELTAS + a heartbeat frame ride
    # the result stream after every barrier (and once at startup, so
    # liveness covers the backfill/seed window before the first barrier)
    hb_state: Dict = {}
    hb_lock = threading.Lock()           # timer thread shares dump_delta

    def heartbeat(epoch=None):
        nonlocal hb_state
        with hb_lock:
            delta, hb_state = REGISTRY.dump_delta(hb_state)
            out.send(MetricsFrame(os.getpid(), time.time(), epoch, delta))
        hb_timer.mark(epoch)

    # quiet-window fallback: barrier-piggybacked heartbeats go silent
    # whenever the coordinator stops feeding barriers (long AOT compiles,
    # pauses) — the timer keeps liveness frames flowing so an idle worker
    # never reads as wedged
    hb_timer = HeartbeatTimer(heartbeat).start()
    heartbeat()
    # Recovery seeding: the coordinator replays shadowed state rows as
    # the first epoch; they rebuild this worker's fragment state but
    # their OUTPUTS are already in the downstream MV's recovered
    # snapshot, so everything before the first barrier is swallowed.
    suppress = plan.get("suppress_first_epoch", False)
    # Supervised respawn v2: the seed ends at a SYNTHETIC barrier the
    # worker swallows (it never reaches the coordinator — downstream
    # alignment already passed that epoch). At the swallow point an agg
    # fragment snapshots its seed state; the retained crash window then
    # replays, and every real barrier up to `diff_refresh_until` emits
    # the NET DIFF vs the snapshot instead of the suppressed raw deltas
    # — the incremental refresh (⊆ changed groups, retractions exact).
    # Joins skip the diff: their replayed deltas re-derive verbatim.
    seed_barrier = plan.get("seed_barrier", False)
    diff_until = plan.get("diff_refresh_until")
    # v1 fallback: one-shot full refresh right after the first barrier
    # (see _refresh_chunks) — the seed swallow above hides any changes
    # the dead predecessor never delivered, and the refresh re-states
    # them (by-pk reconciliation downstream).
    refresh = plan.get("refresh_after_seed", False)
    # epoch-atomic output (supervised joins): buffer data/watermarks and
    # flush at the barrier, so a crash mid-epoch leaves NOTHING of that
    # epoch on the wire — the same invariant the agg partial flush gives
    # single-input fragments
    epoch_atomic = plan.get("epoch_atomic", False)
    m_refresh = REGISTRY.counter(
        "worker_refresh_rows_total",
        "rows emitted by post-respawn refreshes",
        labels=("fragment", "mode"))
    diff_mode = False
    snapshot: Optional[Dict] = None
    obuf: List[Any] = []
    n_sup = 0
    from ..core.chunk import StreamChunk as _Chunk
    from ..ops.message import Barrier as _B
    try:
        for msg in execu.execute():
            if failpoint("worker.crash"):
                os._exit(3)             # hard death, like SIGKILL
            if suppress:
                if not isinstance(msg, _B):
                    n_sup += 1
                    if n_sup % 64 == 0:
                        # long seed/replay ingestion produces no result
                        # frames; stamp liveness from inside the replay
                        # loop so the wedge reaper never mistakes a big
                        # seed for a stall
                        heartbeat()
                    continue
                suppress = False
                if seed_barrier:
                    # synthetic end-of-seed marker: swallow it; from
                    # here on the stream is the replayed crash window
                    snapshot = _group_snapshot(execu)
                    diff_mode = diff_until is not None \
                        and snapshot is not None
                    heartbeat()
                    continue
                out.send(msg)
                m_epochs.inc()
                heartbeat(msg.epoch.curr)
                if refresh:
                    n = 0
                    for chunk in _refresh_chunks(execu):
                        out.send(chunk)
                        n += int(chunk.cardinality)
                    m_refresh.labels(kind, "full").inc(n)
                    refresh = False
                continue
            if isinstance(msg, _B):
                if diff_mode:
                    n = 0
                    for chunk in _diff_chunks(execu, snapshot):
                        out.send(chunk)
                        n += int(chunk.cardinality)
                        m_chunks.inc()
                    m_refresh.labels(kind, "diff").inc(n)
                    if msg.epoch.curr >= diff_until:
                        diff_mode = False
                    else:
                        snapshot = _group_snapshot(execu)
                elif obuf:
                    for m2 in obuf:     # epoch-atomic flush
                        out.send(m2)
                        if isinstance(m2, _Chunk):
                            m_chunks.inc()
                    obuf = []
                out.send(msg)
                m_epochs.inc()
                heartbeat(msg.epoch.curr)
                continue
            if diff_mode:
                continue     # raw deltas re-derive as the net diff
            if epoch_atomic:
                obuf.append(msg)
                continue
            out.send(msg)
            if isinstance(msg, _Chunk):
                m_chunks.inc()
        for m2 in obuf:                 # clean EOS: flush the tail
            out.send(m2)
    except (ConnectionError, OSError):
        return 2          # coordinator gone: exit quietly, nothing to save
    finally:
        hb_timer.stop()
        out.close()
    ok = server.wait_drained()          # RW_DRAIN_DEADLINE_S-configurable
    server.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
