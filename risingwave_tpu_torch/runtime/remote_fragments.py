"""Coordinator side of SQL-driven multi-process fragments (the port's own
copy of the JAX package's `runtime/remote_fragments.py`; its workers run
`python -m risingwave_tpu_torch.runtime.worker`).

`SET streaming_placement TO process` makes the planner place parallel
HashAgg fragments in worker OS processes (`runtime/worker.py`) instead of
in-process generators: the coordinator keeps the source + hash Dispatch
and the barrier-aligned Merge; each fragment's rows cross two credit-flow
exchange streams (`runtime/exchange_net.py`). This is the analog of the
reference's plan → fragments → actors-on-compute-nodes placement
(`src/meta/src/stream/stream_manager.rs:254`,
`src/stream/src/task/stream_manager.rs:610`), collapsed to one
coordinator because there is no separate meta role here.

Failure handling has two tiers:

* unsupervised (default): a worker that dies mid-stream aborts its
  result channel; the Merge loop surfaces `RemoteWorkerDied` at the next
  poll instead of hanging, and Database-level recovery (DDL replay +
  source rewind) rebuilds the job — the `GlobalBarrierWorker::recovery`
  analog (`src/meta/src/barrier/worker.rs:664`).
* supervised (`SET streaming_supervision TO true`): a
  `FragmentSupervisor` respawns JUST the dead fragment in place —
  stateless partial-agg workers get the retained input epoch(s) replayed
  (their outputs are epoch-atomic, so nothing is lost or double-counted);
  stateful fragments (owned-group aggs AND two-input hash joins) are
  re-seeded from the coordinator shadow table(s) rolled back to the last
  epoch the dead worker DELIVERED (the retained crash-window input is
  un-applied from the live shadow), then the window is replayed: joins
  regenerate their undelivered output deltas exactly; aggs emit a
  per-epoch net diff vs the seed snapshot (the incremental refresh).
  Bounded attempts per slot, then the supervisor escalates to the
  unsupervised `RemoteWorkerDied` path — graceful degradation, never a
  hang. The supervisor also ACTS on wedged workers: a slot whose
  heartbeat age exceeds `RW_HEARTBEAT_TIMEOUT_S * wedge_kill_factor`
  while the process is still alive is SIGKILLed and routed through the
  same respawn path (`supervisor_wedged_reaped_total`, liveness state
  `reaping`).
"""
from __future__ import annotations

import hashlib
import json
import select
import subprocess
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..config import ROBUSTNESS
from ..core import dtypes as T
from ..core.chunk import Op, StreamChunk
from ..core.encoding import encode_row
from ..core.epoch import EpochPair
from ..core.vnode import compute_vnodes
from ..ops import DispatchExecutor, MergeExecutor
from ..ops.exchange import ThreadedChannel
from ..ops.executor import Executor
from ..ops.message import Barrier, BarrierKind
from ..utils.failpoint import declare, failpoint
from ..utils.metrics import REGISTRY
from .exchange_net import ExchangeServer, MetricsFrame, RemoteInput

declare("fragment.spawn",
        "fail one worker spawn attempt (startup retry seam)")
declare("fragment.drain",
        "abort one coordinator-side result drain (connection flap)")


class RemoteWorkerDied(RuntimeError):
    """A worker process of a remote fragment set died (or its supervisor
    escalated): the job recovers by DDL replay."""


# Every reason an `_escalate` call site may cite — the
# `supervisor_escalations_total{reason}` label values, with their
# meanings. The registry makes escalation hygiene TESTABLE:
# tests/test_supervision2.py walks the module's call sites and asserts
# each cites exactly one registered reason and no two sites share one
# ambiguously (a dashboard must be able to tell WHY a fragment fell back
# to full recovery from the label alone).
ESCALATION_REASONS: Dict[str, str] = {
    "stop": "worker died during job stop — nothing to respawn into",
    "respawns_exhausted":
        "one slot kept dying past RW_RESPAWN_ATTEMPTS in-place respawns",
    "unkillable": "dead/wedged worker process would not reap within 10s",
    "drain_stuck": "the old result drain thread would not stop",
    "spawn_failed": "the successor worker failed to spawn",
    "shadow_mismatch":
        "retained input window does not roll back cleanly against the "
        "coordinator shadow (join respawn cannot refresh its way out)",
}


class DeadLetterQueue:
    """Durable poison-pill quarantine store — the rows behind the
    `rw_dead_letter` system table and `risectl dlq`.

    One row per sidelined input record:
        (id, job, slot, side, epoch, fingerprint, sign, row_repr,
         payload, status, ts)
    `payload` is the value-encoded row (exact requeue); `row_repr` is a
    human-readable audit copy; `status` walks quarantined -> requeued
    (or the row is purged). The table rides the normal state-store
    commit protocol, so quarantines are durable at the next checkpoint
    and survive coordinator restarts."""

    DTYPES = (T.INT64, T.VARCHAR, T.INT64, T.INT64, T.INT64, T.VARCHAR,
              T.INT64, T.VARCHAR, T.BYTEA, T.VARCHAR, T.FLOAT64)
    PK = (0,)

    def __init__(self, table):
        self.table = table
        self._next_id = 1 + max(
            [int(r[0]) for r in table.iter_all()], default=-1)

    def quarantine(self, job: str, slot: int, entries,
                   fingerprint: str, commit_epoch: int) -> int:
        """`entries`: (side, epoch, sign, row, payload) per sidelined
        record; returns the count written."""
        n = 0
        for side, epoch, sign, row, payload in entries:
            self.table.insert((self._next_id, job, slot, side, epoch,
                               fingerprint, sign, repr(tuple(row)),
                               payload, "quarantined", time.time()))
            self._next_id += 1
            n += 1
        if n:
            self.table.commit(commit_epoch)
        return n

    def entries(self, job: Optional[str] = None,
                status: Optional[str] = None) -> List[Tuple]:
        return sorted(tuple(r) for r in self.table.iter_all()
                      if (job is None or r[1] == job)
                      and (status is None or r[9] == status))

    def mark(self, ids, status: Optional[str], commit_epoch: int) -> int:
        """Flip entries to `status` (None = purge them outright)."""
        by_id = {int(r[0]): tuple(r) for r in self.table.iter_all()}
        n = 0
        for i in ids:
            r = by_id.get(int(i))
            if r is None:
                continue
            self.table.delete(r)
            if status is not None:
                self.table.insert(r[:9] + (status, r[10]))
            n += 1
        if n:
            self.table.commit(commit_epoch)
        return n


def _plain_column_calls(calls, kinds) -> bool:
    """Shared eligibility core: plain column-arg aggregates of the given
    kinds, no DISTINCT/FILTER/ordered-set shapes (those expressions
    don't serialize to the plan wire)."""
    from ..expr.expression import InputRef
    for c in calls:
        if c.distinct or c.filter is not None \
                or getattr(c, "direct_args", ()):
            return False
        if c.arg is not None and not isinstance(c.arg, InputRef):
            return False
        if c.kind not in kinds:
            return False
    return True


def _serialize_calls(calls):
    """Plan wire encoding of agg calls: [kind, arg column index]."""
    return [[c.kind, c.arg.index if c.arg is not None else None]
            for c in calls]


def serializable_agg(input: "Executor", calls) -> bool:
    """Remote placement = 2-phase aggregation, so it needs (a) an
    append-only input (stateless partials can't retract), (b) plain
    column-arg calls whose partials COMPOSE (no avg — an avg of avgs
    is wrong). Everything else stays on the stateful or local path."""
    return input.append_only and _plain_column_calls(
        calls, ("count", "sum", "min", "max", "bool_and", "bool_or"))


class _WorkerHandle:
    __slots__ = ("proc", "addr", "last_epoch", "drain_thread", "spawn_s")

    def __init__(self, proc: subprocess.Popen, addr, spawn_s: float = 0.0):
        self.proc = proc
        self.addr = addr
        self.last_epoch: Optional[int] = None  # last result barrier drained
        self.drain_thread: Optional[threading.Thread] = None
        # wall seconds from the process's start to its ADDR hello
        self.spawn_s = spawn_s


def _read_hello_line(proc: subprocess.Popen, deadline_s: float) -> bytes:
    """Read one newline-terminated line from the worker's stdout under a
    HARD deadline — select per chunk, never a blocking readline (a
    worker that wedges after a partial write must not hang the
    coordinator)."""
    import os as _os
    fd = proc.stdout.fileno()
    end = time.monotonic() + deadline_s
    buf = b""
    while b"\n" not in buf:
        left = end - time.monotonic()
        if left <= 0:
            return b""
        ready, _, _ = select.select([fd], [], [], left)
        if not ready:
            return b""
        part = _os.read(fd, 4096)
        if not part:                    # EOF: worker died during startup
            return b""
        buf += part
    return buf.split(b"\n", 1)[0]


# the worker entry point this coordinator spawns: the port's own
WORKER_MODULE = "risingwave_tpu_torch.runtime.worker"


def _spawn_worker(plan: Dict) -> _WorkerHandle:
    """Spawn one worker process and complete the ADDR handshake, with a
    startup deadline and bounded retries (transient spawn failures — or
    the `fragment.spawn` failpoint — are absorbed here)."""
    return _spawn_workers([plan])[0]


def _spawn_workers(plans: Sequence[Dict]) -> List[_WorkerHandle]:
    """`_spawn_worker` for a whole set at once: every attempt starts all
    the processes it needs before it reads any ADDR hello, so their
    start-ups (a port worker imports torch: seconds each) overlap and a
    set of k spawns in about one worker's start-up, not k. Each worker
    keeps its own attempt bound, deadline and failpoint draw."""
    attempts = max(1, ROBUSTNESS.spawn_attempts)
    out: List[Optional[_WorkerHandle]] = [None] * len(plans)
    last: List[Any] = [None] * len(plans)
    for attempt in range(attempts):
        todo = [i for i, w in enumerate(out) if w is None]
        if not todo:
            break
        if attempt:
            REGISTRY.counter("worker_spawn_retries_total",
                             "worker spawn attempts after the first"
                             ).inc(len(todo))
            time.sleep(min(1.0, ROBUSTNESS.spawn_backoff_s
                           * (2 ** (attempt - 1))))
        started = []
        for i in todo:
            if failpoint("fragment.spawn"):
                last[i] = "failpoint fragment.spawn"
                continue
            started.append((i, time.monotonic(), subprocess.Popen(
                [sys.executable, "-m", WORKER_MODULE,
                 json.dumps(plans[i])],
                stdout=subprocess.PIPE)))
        for i, t0, proc in started:
            line = _read_hello_line(proc, ROBUSTNESS.spawn_timeout_s).split()
            if not line or line[0] != b"ADDR":
                proc.kill()
                proc.wait()
                last[i] = (f"worker pid={proc.pid} no ADDR hello within "
                           f"{ROBUSTNESS.spawn_timeout_s}s (got: {line!r})")
                continue
            out[i] = _WorkerHandle(proc, (line[1].decode(), int(line[2])),
                                   time.monotonic() - t0)
    failed = [i for i, w in enumerate(out) if w is None]
    if failed:
        for w in out:
            if w is not None:
                w.proc.kill()
                w.proc.wait()
        raise RemoteWorkerDied(
            f"worker spawn failed after {attempts} attempts: "
            f"{last[failed[0]]}")
    return out


class FragmentSupervisor:
    """Self-healing single-worker recovery for a remote fragment set —
    the in-place analog of the reference's per-actor restart inside
    `GlobalBarrierWorker::recovery`, scoped to one fragment so one dead
    worker does not restart the world.

    Detection: the worker's result channel aborted, its process exited
    non-zero before delivering EOS, or — the wedge reaper — the process
    is alive but its heartbeat age blew past
    `heartbeat_timeout_s * wedge_kill_factor` (both the merge idle loop
    and the Database heartbeat sweep land here via `check_alive`; a
    wedged worker is SIGKILLed first, then recovered like a dead one).

    Recovery per fragment kind:
    * stateless `partial_hash_agg` — respawn seed-free and replay the
      input channel's retained epoch(s). Worker output is epoch-atomic
      (partials flush at the barrier; the drain releases results only on
      their barrier), so at the moment of death NOTHING of an
      in-flight epoch was delivered and replaying it is exactly-once.
    * stateful `hash_agg` / two-input `hash_join` — respawn re-seeded
      from the coordinator shadow table(s) ROLLED BACK to the worker's
      last delivered epoch (the retained, undelivered input window is
      un-applied from the live shadow), then the window — data AND
      barriers, on every input side — replays into the fresh worker.
      A synthetic seed barrier separates seed from replay: the worker
      swallows it, snapshots (aggs), and from there regenerates the
      undelivered window exactly — joins as verbatim re-derived deltas,
      aggs as a per-epoch net diff vs the snapshot (the INCREMENTAL
      refresh: only groups whose value changed in the window are
      emitted, retractions included). With
      `ROBUSTNESS.incremental_refresh=False` (or when the retained
      window and the shadow disagree) aggs fall back to the v1 full
      owned-group refresh, and the coordinator diffs its per-worker
      last-delivered output map against the live shadow to emit
      retractions for groups fully retracted inside the crash window.

    Bounded attempts per worker slot with exponential backoff; past the
    bound (or on any non-recoverable shape) it raises `RemoteWorkerDied`
    and stays escalated, handing over to DDL-replay recovery."""

    def __init__(self, rset: "_RemoteSetBase"):
        self.rset = rset
        self.attempts = [0] * len(rset.workers)
        self.respawns = 0
        self.reaped = 0
        self.quarantined = 0
        # per-slot (window fingerprint, consecutive same-window deaths):
        # the poison-pill detector's memory
        self._poison: List[Tuple[Optional[str], int]] = \
            [(None, 0)] * len(rset.workers)
        self._escalated: Optional[RemoteWorkerDied] = None

    def check(self) -> None:
        if self._escalated is not None:
            raise self._escalated
        s = self.rset
        factor = ROBUSTNESS.wedge_kill_factor
        victims: List[int] = []
        for i in range(len(s.workers)):
            ch, w = s.channels[i], s.workers[i]
            rc = w.proc.poll()
            dead = getattr(ch, "aborted", False) \
                or (rc is not None and rc != 0 and not ch.closed)
            wedged = (not dead and rc is None and not ch.closed
                      and factor > 0
                      and not s._backpressured(i)
                      and time.time() - s.heartbeats[i]
                      > ROBUSTNESS.heartbeat_timeout_s * factor)
            if wedged:
                # alive-but-stuck past the kill window: reap it, then
                # recover through the exact same path as a crash (same
                # attempt bound, same escalation)
                s._reaping[i] = True
                self.reaped += 1
                REGISTRY.counter(
                    "supervisor_wedged_reaped_total",
                    "wedged workers SIGKILLed by the supervisor").inc()
                from ..utils.blackbox import RECORDER
                RECORDER.record("wedge_reap", {
                    "job": getattr(s, "job_name", "") or "",
                    "slot": i, "pid": w.proc.pid,
                    "hb_age_s": round(time.time() - s.heartbeats[i], 2)})
                RECORDER.maybe_dump("wedge_reap")
                w.proc.kill()
            if dead or wedged:
                victims.append(i)
        if victims:
            try:
                self._recover_batch(victims)
            finally:
                for i in victims:
                    s._reaping[i] = False

    def _escalate(self, msg: str, reason: str) -> None:
        assert reason in ESCALATION_REASONS, \
            f"unregistered escalation reason {reason!r}"
        REGISTRY.counter("supervisor_escalations_total",
                         "supervised fragments handed to full recovery",
                         labels=("reason",)).labels(reason).inc()
        from ..utils.blackbox import RECORDER
        RECORDER.record("escalation", {
            "job": getattr(self.rset, "job_name", "") or "",
            "reason": reason, "msg": msg})
        RECORDER.maybe_dump(f"escalation_{reason}")
        err = RemoteWorkerDied(
            msg + " (escalating: restart the job — DDL replay rebuilds "
            "and replays the fragments)")
        self._escalated = err
        raise err

    def _recover(self, i: int) -> None:
        self._recover_batch([i])

    def _recover_batch(self, victims: List[int]) -> None:
        """Coordinated respawn of EVERY dead/wedged slot in one pass —
        two (or N) simultaneous worker deaths converge in place instead
        of escalating. Phases:

        1. escalation gates per victim (job stop, attempt bound);
        2. QUIESCE every victim first — kill, reap, join its drain —
           so no victim's stale drain thread can mutate a channel while
           another victim's replay is already in flight;
        3. capture every victim's retained undelivered window (and run
           the poison-pill detector over it — see `_poison_check`);
        4. ONE shared shadow scan per input side (the shared rollback
           horizon): each victim re-seeds from its hash partition of the
           same scan instead of N redundant full-table walks;
        5. re-seed the victims in slot order and swap them in.

        Escalation remains only for genuinely lost state (shadow
        mismatch, unkillable processes, exhausted attempts)."""
        s = self.rset
        n_in = len(s.dispatchers)
        lb = s.dispatchers[0].last_barrier
        if lb is not None and lb.is_stop():
            pids = ",".join(str(s.workers[i].proc.pid) for i in victims)
            self._escalate(
                f"worker pid(s)={pids} died during job stop", "stop")
        for i in victims:
            if self.attempts[i] >= max(1, ROBUSTNESS.respawn_attempts):
                self._escalate(
                    f"worker slot {i} kept dying "
                    f"({self.attempts[i]} respawns exhausted)",
                    "respawns_exhausted")
            self.attempts[i] += 1
        # ---- phase 2: quiesce ALL victims before any reseed ----------
        for i in victims:
            w = s.workers[i]
            if w.proc.poll() is None:
                w.proc.kill()
            try:
                w.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._escalate(f"worker pid={w.proc.pid} is unkillable",
                               "unkillable")
            if w.drain_thread is not None:
                w.drain_thread.join(timeout=10)
                if w.drain_thread.is_alive():
                    self._escalate("old result drain did not stop",
                                   "drain_stuck")
        time.sleep(min(1.0, ROBUSTNESS.respawn_backoff_s
                       * (2 ** (max(self.attempts[i]
                                    for i in victims) - 1))))
        # ---- phase 3: windows + poison-pill detection ----------------
        lasts: Dict[int, int] = {}
        windows: Dict[int, List[List[Any]]] = {}
        for i in victims:
            w = s.workers[i]
            last = -1 if w.last_epoch is None else w.last_epoch
            lasts[i] = last
            replays = [s.in_channels[side][i].replay_for(last)
                       for side in range(n_in)]
            windows[i] = self._poison_check(i, replays)
        # ---- phase 4: one shared shadow scan per side ----------------
        shared: Optional[List[List[Tuple]]] = None
        if s.kind in ("stateful", "join") and s.seed_tables:
            shared = [s._shadow_rows(side) for side in range(n_in)]
        # ---- phase 5: reseed in slot order ---------------------------
        for i in sorted(victims):
            self._reseed(i, lasts[i], windows[i], shared)

    def _reseed(self, i: int, last: int, replays: List[List[Any]],
                shared: Optional[List[List[Tuple]]]) -> None:
        s = self.rset
        w = s.workers[i]
        ch_out = s.channels[i]
        n_in = len(s.dispatchers)
        # fresh input channel(s) under fresh ids: the old ids stay
        # claimed on the server, so a half-dead predecessor can never
        # splice itself into the successor's stream
        old_plan = s.plans[i]
        old_cids = [old_plan["in_channel"]]
        if n_in == 2:
            old_cids.append(old_plan["in_channel_r"])
        old_ins = [s.in_channels[side][i] for side in range(n_in)]
        plan = dict(old_plan)
        for key in ("suppress_first_epoch", "seed_barrier",
                    "refresh_after_seed", "diff_refresh_until"):
            plan.pop(key, None)
        new_ins = []
        for side in range(n_in):
            cid = s.alloc_cid()
            new_ins.append(s.server.register(
                cid, s.in_dtypes[side],
                retain_epochs=old_ins[side].retain_epochs))
            plan["in_channel" if side == 0 else "in_channel_r"] = cid
        nw = None
        seeding = s.kind in ("stateful", "join")
        if not seeding:
            # stateless: seed-free respawn + retained-window replay
            try:
                nw = _spawn_worker(plan)
            except RemoteWorkerDied as e:
                self._escalate(str(e), "spawn_failed")
            for msg in replays[0]:
                new_ins[0].send(msg)
        else:
            nw = self._respawn_stateful(i, plan, new_ins, last, replays,
                                        shared)
        nw.last_epoch = w.last_epoch
        # swap into the live topology (we run on the merge thread, so the
        # dispatchers are quiescent during the swap)
        for side in range(n_in):
            s.dispatchers[side].outputs[i] = new_ins[side]
            s.in_channels[side][i] = new_ins[side]
        s.plans[i] = plan
        for cid in old_cids:
            s.server.unregister(cid)
        # reset the result channel in place: whole delivered epochs in
        # its buffer stay valid (the epoch-atomic drain never leaves a
        # partial tail); the generation bump makes any straggling writes
        # from the old drain harmless
        with ch_out.cv:
            ch_out.gen += 1
            ch_out.aborted = False
            ch_out.closed = False
            ch_out.cv.notify_all()
        s.workers[i] = nw
        s.heartbeats[i] = time.time()    # fresh liveness window
        s._wedged[i] = False
        s._start_drain(i)
        self.respawns += 1
        REGISTRY.counter("supervisor_respawns_total",
                         "in-place worker respawns", labels=("kind",)
                         ).labels(s.kind).inc()

    # ---- poison-pill quarantine -----------------------------------------
    @staticmethod
    def _window_fingerprint(replays: List[List[Any]]) -> str:
        """Stable digest of one retained undelivered window — the
        identity the poison detector compares across consecutive deaths
        of one slot (same window kills the successor too => the INPUT is
        the problem, not the process)."""
        h = hashlib.sha1()
        for side, msgs in enumerate(replays):
            for msg in msgs:
                if isinstance(msg, Barrier):
                    h.update(b"B%d;%d" % (side, msg.epoch.curr))
                elif isinstance(msg, StreamChunk):
                    for op, row in msg.compact().op_rows():
                        h.update(repr((side, op.sign, tuple(row)))
                                 .encode())
        return h.hexdigest()[:16]

    def _poison_check(self, i: int,
                      replays: List[List[Any]]) -> List[List[Any]]:
        """Poison-pill detector: fingerprint slot i's retained window;
        after `RW_POISON_THRESHOLD` consecutive deaths on the SAME
        window, sideline its data into the durable dead-letter queue and
        return a barriers-only window — the respawn re-seeds, re-aligns
        every missed epoch, and the job makes progress past the poison.
        Bounded data loss with a full audit trail (`rw_dead_letter`,
        `risectl dlq` list/requeue/purge) instead of a wedged-forever
        fragment. The quarantined rows are also UN-APPLIED from the live
        shadow tables, so coordinator state, worker state and the
        downstream changelog stay consistent (the window never reached
        downstream — epoch-atomic drains — so nothing there needs
        repair)."""
        s = self.rset
        threshold = ROBUSTNESS.poison_threshold
        has_data = any(isinstance(m, StreamChunk)
                       for msgs in replays for m in msgs)
        if threshold <= 0 or not has_data:
            return replays
        fpmt = self._window_fingerprint(replays)
        prev, count = self._poison[i]
        count = count + 1 if fpmt == prev else 1
        self._poison[i] = (fpmt, count)
        if count < threshold:
            return replays
        # ---- quarantine: record, scrub shadow, scrub window ----------
        lb = s.dispatchers[0].last_barrier
        commit_epoch = lb.epoch.curr if lb is not None else 0
        entries: List[Tuple] = []
        dropped: List[List[Tuple[int, Tuple]]] = []   # per side, in order
        scrubbed: List[List[Any]] = []
        for side, msgs in enumerate(replays):
            keep: List[Any] = []
            side_drop: List[Tuple[int, Tuple]] = []
            pend: List[Tuple[int, Tuple]] = []
            dtypes = s.in_dtypes[side]
            for msg in msgs:
                if isinstance(msg, StreamChunk):
                    for op, row in msg.compact().op_rows():
                        pend.append((op.sign, tuple(row)))
                    continue
                if isinstance(msg, Barrier):
                    for sign, row in pend:
                        entries.append((side, msg.epoch.curr, sign, row,
                                        encode_row(row, dtypes)))
                        side_drop.append((sign, row))
                    pend = []
                    keep.append(msg)
                else:
                    keep.append(msg)      # watermarks ride along
            for sign, row in pend:        # open-epoch tail (no barrier yet)
                entries.append((side, -1, sign, row,
                                encode_row(row, dtypes)))
                side_drop.append((sign, row))
            dropped.append(side_drop)
            scrubbed.append(keep)
        dlq = getattr(s, "dead_letter", None)
        job = getattr(s, "job_name", "") or ""
        if dlq is not None:
            dlq.quarantine(job, i, entries, fpmt, commit_epoch)
        # un-apply the sidelined rows from the live shadows, in reverse
        # (the exact inverse of what TeeState applied), so the next seed
        # — this respawn's AND any later one's — excludes them
        if s.seed_tables:
            for side, side_drop in enumerate(dropped):
                table = s.seed_tables[side] \
                    if side < len(s.seed_tables) else None
                if table is None:
                    continue
                pad = (0,) * (s.seed_strips[side] if s.seed_strips else 0)
                for sign, row in reversed(side_drop):
                    if sign > 0:
                        table.delete(tuple(row) + pad)
                    else:
                        table.insert(tuple(row) + pad)
        n = len(entries)
        self.quarantined += n
        REGISTRY.counter(
            "supervisor_quarantined_total",
            "input records sidelined into rw_dead_letter by the "
            "poison-pill detector", labels=("job",)).labels(job).inc(n)
        from ..utils.blackbox import RECORDER
        RECORDER.record("quarantine", {
            "job": job, "slot": i, "records": n,
            "fingerprint": fpmt, "commit_epoch": int(commit_epoch)})
        RECORDER.maybe_dump("quarantine")
        # quarantine IS progress: the slot starts a fresh respawn budget
        # and a fresh poison history
        self.attempts[i] = 1
        self._poison[i] = (None, 0)
        return scrubbed

    def _respawn_stateful(self, i: int, plan: Dict, new_ins, last: int,
                          replays: List[List[Any]],
                          shared: Optional[List[List[Tuple]]]
                          ) -> _WorkerHandle:
        """Respawn a stateful (owned-group agg or two-input join) worker.

        Incremental (default): seed every input side with the shadow
        rolled back to epoch `last` (un-apply the retained undelivered
        window), mark the end of the seed with a synthetic swallowed
        barrier, then replay the window verbatim — the worker re-derives
        the undelivered deltas exactly (joins), or emits them as
        per-epoch net diffs vs its seed snapshot (aggs).

        Fallback (knob off, or shadow/window mismatch): v1 protocol —
        live-shadow seed, missed barriers only, full owned-group refresh,
        plus coordinator-side retractions for groups that vanished
        entirely inside the crash window (aggs only; a join respawn has
        no refresh to lean on, so a mismatch escalates)."""
        s = self.rset
        n_in = len(s.dispatchers)

        def part(side: int) -> List[Tuple]:
            # victim's hash partition of the shared shadow scan (batch
            # recovery walks each side's table once for ALL victims)
            if shared is not None:
                return s._partition_rows(side, shared[side], i)
            return s.seed_rows(side, i)

        if last < 0:
            # never delivered a barrier: the retained window IS the
            # complete input stream (trims only happen on delivery) —
            # replay it verbatim under the original plan flags, incl.
            # any CREATE-time seed suppression. No shadow roll-back, no
            # refresh: the successor re-derives everything exactly.
            if s.plans[i].get("suppress_first_epoch"):
                plan["suppress_first_epoch"] = True
            try:
                nw = _spawn_worker(plan)
            except RemoteWorkerDied as e:
                self._escalate(str(e), "spawn_failed")
            self._send_window(i, new_ins, replays)
            return nw
        seeds = None
        if ROBUSTNESS.incremental_refresh:
            seeds = []
            for side in range(n_in):
                rows = part(side)
                asof = s.unapply_window(side, rows, replays[side])
                if asof is None:
                    seeds = None
                    break
                seeds.append(asof)
        if seeds is None and s.kind == "join":
            self._escalate(
                f"join worker slot {i}: retained input window does not "
                "roll back cleanly against the shadow tables (duplicate "
                "un-keyed rows?); a join respawn cannot refresh its way "
                "out", "shadow_mismatch")
        plan["suppress_first_epoch"] = True
        if seeds is not None:
            plan["seed_barrier"] = True
            if s.kind == "stateful":
                # the worker diffs vs its seed snapshot at every replayed
                # barrier up to the last retained one; later epochs are
                # fresh data and stream exact deltas natively
                hi = max((m.epoch.curr for m in replays[0]
                          if isinstance(m, Barrier)), default=None)
                if hi is not None:
                    plan["diff_refresh_until"] = hi
        else:
            plan["refresh_after_seed"] = True
        try:
            nw = _spawn_worker(plan)
        except RemoteWorkerDied as e:
            self._escalate(str(e), "spawn_failed")
        if seeds is not None:
            # epoch `last` state, then the end-of-seed marker, then the
            # undelivered window (data + real barriers) — per side
            seed_b = Barrier(EpochPair(max(last, 0), 0),
                             BarrierKind.BARRIER)
            for side in range(n_in):
                for chunk in _chunks_from_rows(s.in_dtypes[side],
                                               seeds[side]):
                    new_ins[side].send(chunk)
                    s.heartbeats[i] = time.time()   # seed replay progress
                new_ins[side].send(seed_b)
            self._send_window(i, new_ins, replays)
        else:
            rows0 = part(0)
            for chunk in _chunks_from_rows(s.in_dtypes[0], rows0):
                new_ins[0].send(chunk)
                s.heartbeats[i] = time.time()
            # every dispatched barrier the dead worker never delivered —
            # possibly SEVERAL: a dead worker's buffered result epochs
            # keep alignment advancing past its death, so the gap is a
            # window, not one barrier. Re-injecting them (in order) lets
            # alignment complete epoch by epoch; the first one also
            # flips the worker's post-seed output suppression off.
            for b in replays[0]:
                if isinstance(b, Barrier):
                    new_ins[0].send(b)
            # full refresh re-INSERTs surviving groups; groups fully
            # retracted inside the crash window have nothing left to
            # refresh, so the coordinator retracts them from its
            # last-delivered output map
            s.retract_vanished(i, seed_rows=rows0)
        return nw

    def _send_window(self, i: int, new_ins, replays) -> None:
        """Replay the retained undelivered window into the fresh
        channels, EPOCH-INTERLEAVED across input sides: a two-input
        worker consumes side 0 up to its barrier before touching side 1,
        so shipping one side's whole multi-epoch window first could fill
        its channel past capacity while the worker waits on the other
        side. Stamps the slot heartbeat as it goes — a big window must
        not read as a wedge."""
        s = self.rset
        iters = [iter(r) for r in replays]
        done = [False] * len(iters)
        while not all(done):
            for side, it in enumerate(iters):
                if done[side]:
                    continue
                for msg in it:
                    new_ins[side].send(msg)
                    s.heartbeats[i] = time.time()
                    if isinstance(msg, Barrier):
                        break
                else:
                    done[side] = True


def _chunks_from_rows(dtypes, rows, op: Op = Op.INSERT,
                      batch: int = 4096) -> Iterator[StreamChunk]:
    for lo in range(0, len(rows), batch):
        yield StreamChunk.from_rows(
            dtypes, [(op, tuple(r)) for r in rows[lo:lo + batch]])


class _RemoteSetBase:
    """Shared coordinator plumbing for a set of worker fragments: the
    exchange server, per-worker plans/handles, epoch-atomic result
    drains, liveness checking, and (optional) supervision.

    Subclass contract: set `kind`, `server`, `workers`, `plans`,
    `dispatchers` (one per input side), `in_channels` (per side, per
    worker), `in_dtypes` (per side), `out_schema`, then call
    `_finish_init(supervise)`."""

    kind = "partial"                   # "partial" | "stateful" | "join"
    frag_kind = "partial_hash_agg"
    seed_tables: Optional[List[Any]] = None
    seed_strips: Sequence[int] = ()
    group_count = 0                    # output group-key width (hash_agg)
    # stamped by the Database after CREATE: the owning streaming job's
    # name and the process's durable dead-letter queue — the poison-pill
    # quarantine's audit/metric identity (empty/None = standalone sets,
    # e.g. unit tests, which quarantine without the durable record)
    job_name: str = ""
    dead_letter: Optional[DeadLetterQueue] = None

    def _finish_init(self, supervise: bool) -> None:
        from collections import deque
        self._next_cid = 1 + max(
            (p.get("in_channel_r", p["in_channel"]) for p in self.plans),
            default=-1)
        # metrics plane: per-slot last-heartbeat wall clock (workers
        # piggyback M frames on their result streams; the drains stamp
        # these) — the substrate of worker_liveness / rw_worker_liveness
        self.heartbeats = [time.time()] * len(self.workers)
        # barrier-decomposition logs the Database tick drains into the
        # BarrierTracer: per-worker result-barrier arrival (the "align"
        # sub-span — inject->align->commit then decomposes by worker)
        # and heartbeat (sent worker-clock, received coordinator-clock)
        # pairs, the clock-offset samples `risectl trace export` uses
        self.align_log: deque = deque(maxlen=4096)
        self.hb_log: deque = deque(maxlen=1024)
        self._wedged = [False] * len(self.workers)
        self._reaping = [False] * len(self.workers)
        # per-slot last-delivered output map (supervised owned-group
        # aggs): group key -> last output row released downstream. The
        # coordinator-side diff surface of the v1 fallback refresh —
        # groups fully retracted inside a crash window are retracted
        # from here, because neither the respawned worker (no seed rows)
        # nor the full refresh (nothing to re-insert) can.
        self.delivered: List[Dict[Tuple, Tuple]] = \
            [dict() for _ in self.workers]
        self.supervisor = FragmentSupervisor(self) if supervise else None
        self._start_drains()

    def alloc_cid(self) -> int:
        cid = self._next_cid
        self._next_cid += 1
        return cid

    # ---- result side ----------------------------------------------------
    def _start_drains(self) -> None:
        self.channels: List[ThreadedChannel] = []
        for i in range(len(self.workers)):
            ch = ThreadedChannel(capacity=256)
            ch.gen = 0                  # respawn generation (supervisor)
            self.channels.append(ch)
            self._start_drain(i)

    def _start_drain(self, i: int) -> None:
        w, ch = self.workers[i], self.channels[i]
        t = threading.Thread(target=self._drain, args=(i, w, ch),
                             daemon=True)
        w.drain_thread = t
        t.start()

    def _drain(self, i: int, w: _WorkerHandle, ch: ThreadedChannel) -> None:
        """Pull one worker's result stream into its merge channel.

        SUPERVISED sets drain EPOCH-ATOMICALLY: messages buffer here
        until their barrier arrives, then release together, so a
        connection that dies mid-epoch contributes nothing of that epoch
        downstream — the invariant that makes in-place replay/re-seed
        exactly-once (a partial tail could be neither retracted nor
        deduplicated). Unsupervised sets forward per message (full
        intra-epoch pipelining + channel backpressure) — their recovery
        is a whole-job rebuild, which needs no epoch atomicity."""
        gen = ch.gen
        atomic = self.supervisor is not None
        buf: List[Any] = []
        try:
            inp = RemoteInput(w.addr, 0, self.out_schema)
            for msg in inp.execute():
                if failpoint("fragment.drain"):
                    raise ConnectionError("failpoint fragment.drain")
                if ch.gen == gen:
                    # ANY frame proves the worker alive — data and
                    # barriers stamp liveness too, so a worker streaming
                    # results between M frames never reads as wedged
                    self.heartbeats[i] = time.time()
                if isinstance(msg, MetricsFrame):
                    # metrics plane piggyback: fold the worker's registry
                    # delta into the coordinator's global registry under a
                    # `worker` label, stamp the heartbeat, and DON'T
                    # forward (observability is not dataflow)
                    if ch.gen == gen:
                        # (sent worker-clock, received coordinator-clock):
                        # the clock-offset estimation sample for the
                        # unified trace export
                        self.hb_log.append((f"{self.kind}{i}", msg.ts,
                                            time.time()))
                        if msg.payload:
                            REGISTRY.merge_remote(
                                msg.payload,
                                worker=f"{self.kind}{i}/{msg.pid}")
                    continue
                if isinstance(msg, Barrier):
                    if ch.gen == gen:
                        # per-worker align sub-span: this worker's part
                        # of the epoch is DONE now; the tracer decomposes
                        # cross-fragment barrier latency from these
                        self.align_log.append((msg.epoch.curr,
                                               f"{self.kind}{i}",
                                               time.time()))
                    if atomic:
                        # one lock-held append, no capacity waits: a
                        # flush blocked on a full channel could never be
                        # joined by the consumer thread during recovery
                        buf.append(msg)
                        ch.send_batch(buf)
                        if self.kind == "stateful" and self.group_count:
                            self._fold_delivered(i, buf)
                        buf = []
                    else:
                        ch.send(msg)
                    w.last_epoch = msg.epoch.curr
                    if atomic:
                        # delivery confirmed: this worker's input epochs
                        # up to here will never need replaying
                        for side in self.in_channels:
                            if side[i].retain_epochs:
                                side[i].trim_retrans(msg.epoch.curr)
                elif atomic:
                    buf.append(msg)
                else:
                    ch.send(msg)
            if buf:                     # clean EOS: deliver the tail
                ch.send_batch(buf)
        except (ConnectionError, OSError):
            if ch.gen == gen:
                ch.aborted = True       # surfaced by merge_executor polling
        finally:
            if ch.gen == gen:
                ch.close()

    # ---- overload evidence ----------------------------------------------
    def queue_pressure(self) -> float:
        """Worst fill ratio across this set's exchange queues — input
        channels (a slow WORKER backs its dispatch queue up) and result
        channels (a slow COORDINATOR backs the drains up). Lock-free
        snapshot in [0, 1]; the overload manager folds it into the
        per-tick pressure signal so queues approaching their bound
        throttle the sources BEFORE the bound blocks the barrier loop."""
        worst = 0.0
        for side in self.in_channels:
            for nc in side:
                cap = getattr(nc, "capacity", 0) or 1
                worst = max(worst, nc._data_len() / cap)
        for ch in getattr(self, "channels", ()):
            cap = getattr(ch, "capacity", 0) or 1
            worst = max(worst, ch._data_len() / cap)
        return min(1.0, worst)

    # ---- liveness -------------------------------------------------------
    def _backpressured(self, i: int) -> bool:
        """Worker i's result channel holds messages the coordinator has
        not consumed: the worker provably produced output and the
        staleness is OURS — an idle coordinator stops draining (the
        drain thread blocks on the full channel behind the socket, so M
        frames stop stamping heartbeats) and must not report — or REAP —
        a healthy worker as wedged."""
        chans = getattr(self, "channels", None)
        return bool(chans and chans[i].buf)

    def liveness_rows(self, job: str) -> List[Tuple]:
        """(job, worker, pid, last_epoch, heartbeat_age_s, state) per
        slot — the rw_worker_liveness rows. `wedged?` = process alive but
        no heartbeat frame within RW_HEARTBEAT_TIMEOUT_S: the
        stuck-not-dead failure mode the spawn/drain deadlines only catch
        much later. Ages are recomputed at READ time against the last
        received frame (any frame, not just M), and a slot whose result
        channel holds undrained output is `ok` regardless of age — the
        idle-coordinator case where the stale party is the reader."""
        now = time.time()
        out = []
        for i, w in enumerate(self.workers):
            age = now - self.heartbeats[i]
            if self._reaping[i]:
                state = "reaping"        # wedge reaper mid-kill/respawn
            elif w.proc.poll() is not None:
                state = "dead"
            elif age > ROBUSTNESS.heartbeat_timeout_s \
                    and not self._backpressured(i):
                state = "wedged?"
            else:
                state = "ok"
            out.append((job, f"{self.kind}{i}", w.proc.pid,
                        -1 if w.last_epoch is None else w.last_epoch,
                        age, state))
        return out

    # ---- barrier decomposition (drained into the BarrierTracer) --------
    def drain_align_log(self) -> List[Tuple[int, str, float]]:
        out = []
        while self.align_log:
            out.append(self.align_log.popleft())
        return out

    def drain_hb_log(self) -> List[Tuple[str, float, float]]:
        out = []
        while self.hb_log:
            out.append(self.hb_log.popleft())
        return out

    def _check_wedged(self) -> None:
        """Count ok->wedged transitions (alive process, stale heartbeat —
        the liveness_rows predicate) so dashboards see the stall even if
        the worker later recovers."""
        for i, row in enumerate(self.liveness_rows("")):
            stale = row[5] == "wedged?"
            if stale and not self._wedged[i]:
                REGISTRY.counter(
                    "worker_wedged_suspect_total",
                    "workers whose heartbeat went stale while the "
                    "process stayed alive").inc()
            self._wedged[i] = stale

    def check_alive(self) -> None:
        """Polled by the merge idle loop and the Database heartbeat
        sweep. Supervised sets self-heal (or escalate); unsupervised
        sets raise so job-level recovery can run. Either way the wedged
        sweep runs first — it observes, it never kills."""
        self._check_wedged()
        if self.supervisor is not None:
            self.supervisor.check()
            return
        for ch, w in zip(self.channels, self.workers):
            if getattr(ch, "aborted", False):
                raise RemoteWorkerDied(
                    f"worker pid={w.proc.pid} aborted its result stream "
                    "(recovery: restart the job — DDL replay rebuilds and "
                    "replays the fragments)")

    # ---- seeds (stateful sets) -----------------------------------------
    def _shadow_rows(self, side: int) -> List[Tuple]:
        """ONE full scan of a side's shadow table, stripped of filler
        columns — batch recovery partitions this single scan for every
        victim instead of re-walking the table per slot."""
        table = self.seed_tables[side] if self.seed_tables else None
        if table is None:
            return []
        strip = self.seed_strips[side] if self.seed_strips else 0
        return [tuple(r)[:-strip] if strip else tuple(r)
                for r in table.iter_all()]

    def _partition_rows(self, side: int, rows: List[Tuple],
                        i: int) -> List[Tuple]:
        """Worker i's hash partition of a side's (already scanned)
        shadow rows — exactly the rows the dispatcher would have routed
        to it (same vnode map, so respawn ownership matches)."""
        disp = self.dispatchers[side]
        dtypes = self.in_dtypes[side]
        out: List[Tuple] = []
        for lo in range(0, len(rows), 4096):
            chunk = StreamChunk.from_rows(
                dtypes, [(Op.INSERT, r) for r in rows[lo:lo + 4096]])
            vn = compute_vnodes(
                [chunk.columns[j] for j in disp.key_indices],
                vnode_count=disp.vnode_count)
            vis = disp.vnode_to_out[vn] == i
            out.extend(r for r, keep in zip(rows[lo:lo + 4096], vis)
                       if keep)
        return out

    def seed_rows(self, side: int, i: int) -> List[Tuple]:
        """Worker i's partition of the coordinator shadow table."""
        return self._partition_rows(side, self._shadow_rows(side), i)

    def requeue_rows(self, side: int, pairs: List[Tuple[int, Tuple]]) -> int:
        """Re-inject previously quarantined input rows (`risectl dlq
        requeue`): re-apply them to the side's shadow (future respawns
        must see them again) and route each row to its key-owning
        worker's input channel — between barriers, exactly like live
        stream data, so the next epoch's output states them exactly
        once. Caller runs on the coordinator thread between ticks (the
        dispatchers are quiescent)."""
        disp = self.dispatchers[side]
        dtypes = self.in_dtypes[side]
        table = self.seed_tables[side] \
            if self.seed_tables and side < len(self.seed_tables) else None
        pad = (0,) * (self.seed_strips[side] if self.seed_strips else 0)
        by_worker: Dict[int, List[Tuple[Any, Tuple]]] = {}
        for lo in range(0, len(pairs), 4096):
            batch = pairs[lo:lo + 4096]
            chunk = StreamChunk.from_rows(
                dtypes, [(Op.INSERT if sgn > 0 else Op.DELETE, tuple(r))
                         for sgn, r in batch])
            vn = compute_vnodes(
                [chunk.columns[j] for j in disp.key_indices],
                vnode_count=disp.vnode_count)
            owners = disp.vnode_to_out[vn]
            for (sgn, row), wi in zip(batch, owners):
                by_worker.setdefault(int(wi), []).append(
                    (Op.INSERT if sgn > 0 else Op.DELETE, tuple(row)))
                if table is not None:
                    if sgn > 0:
                        table.insert(tuple(row) + pad)
                    else:
                        table.delete(tuple(row) + pad)
        n = 0
        for wi, oprows in by_worker.items():
            for lo in range(0, len(oprows), 4096):
                self.in_channels[side][wi].send(StreamChunk.from_rows(
                    dtypes, oprows[lo:lo + 4096]))
            n += len(oprows)
        return n

    def _seed_key(self, side: int):
        """Row-identity key function of a shadow side: the shadow
        table's pk (the carried stream key for aggs; the whole pre-pad
        row for join sides), evaluated on STRIPPED rows."""
        table = self.seed_tables[side]
        pk = list(table.pk_indices)
        return lambda row: tuple(row[j] for j in pk)

    def unapply_window(self, side: int, rows: List[Tuple],
                       window: List[Any]) -> Optional[List[Tuple]]:
        """Roll the live shadow partition back to the state BEFORE the
        retained undelivered window: walk the window's chunks in reverse,
        removing its inserts and restoring its deletes. Returns None when
        the window and the shadow disagree (an insert to un-apply that
        the shadow never had, or a delete whose row is still present) —
        the caller falls back or escalates rather than seeding a worker
        from inconsistent state."""
        key = self._seed_key(side)
        d: Dict[Tuple, Tuple] = {key(r): r for r in rows}
        for msg in reversed(window):
            if not isinstance(msg, StreamChunk):
                continue
            for op, row in reversed(list(msg.compact().op_rows())):
                k = key(row)
                if op.is_insert:
                    if k not in d:
                        return None
                    del d[k]
                else:
                    if k in d:
                        return None
                    d[k] = tuple(row)
        return list(d.values())

    def retract_vanished(self, i: int,
                         seed_rows: Optional[List[Tuple]] = None) -> None:
        """v1 fallback only: groups the dead worker had DELIVERED that
        no longer exist in the live shadow were fully retracted inside
        the crash window — the respawned worker has no seed rows for
        them, the full refresh re-inserts nothing, and the MV would keep
        the stale row forever. The coordinator knows both sides of the
        diff (its last-delivered output map vs the live shadow), so it
        emits the retraction itself, straight into the worker's result
        channel (merge forwards chunks freely; materialize deletes by
        pk). `seed_rows` lets the caller reuse an already-materialized
        partition scan."""
        if self.frag_kind != "hash_agg" or not self.group_count:
            return
        if seed_rows is None:
            seed_rows = self.seed_rows(0, i)
        gidx = self.plans[i]["fragment"]["group_indices"]
        alive = {tuple(r[j] for j in gidx) for r in seed_rows}
        dmap = self.delivered[i]
        gone = [g for g in dmap if g not in alive]
        if not gone:
            return
        rows = [dmap.pop(g) for g in gone]
        ch = self.channels[i]
        for chunk in _chunks_from_rows(
                [f.dtype for f in self.out_schema.fields], rows,
                op=Op.DELETE):
            ch.send_batch([chunk])
        REGISTRY.counter(
            "supervisor_refresh_retractions_total",
            "coordinator-emitted retractions for groups fully retracted "
            "inside a crash window").inc(len(rows))

    def _fold_delivered(self, i: int, batch: List[Any]) -> None:
        """Fold a released (delivered) epoch batch into the per-slot
        last-delivered output map — runs on the drain thread, read by
        the supervisor only after that thread is joined."""
        ng = self.group_count
        dmap = self.delivered[i]
        for msg in batch:
            if not isinstance(msg, StreamChunk):
                continue
            for op, row in msg.compact().op_rows():
                g = tuple(row[:ng])
                if op.is_insert:
                    dmap[g] = tuple(row)
                else:
                    dmap.pop(g, None)

    # ---- lifecycle ------------------------------------------------------
    def shutdown(self) -> None:
        for w in self.workers:
            if w.proc.poll() is None:
                w.proc.kill()
        self.server.close()

    def __del__(self):  # dropped plans must not leak worker processes
        try:
            self.shutdown()
        except Exception:
            pass


class RemoteFragmentSet(_RemoteSetBase):
    """k worker processes running one stateless partial-HashAgg fragment
    each, plus the coordinator-side exchange plumbing. Produces
    (merge_executor, pumps) for the planner."""

    kind = "partial"

    def __init__(self, input: Executor, group_indices: Sequence[int],
                 calls, k: int, supervise: bool = False):
        self.server = ExchangeServer()
        in_dtypes = input.schema.dtypes
        in_cols = [[f.name, f.dtype.kind.value]
                   for f in input.schema.fields]
        # retain_epochs: the supervisor replays a respawned stateless
        # worker's in-flight input epoch(s) from the channel itself
        net_channels = [self.server.register(i, in_dtypes,
                                             retain_epochs=supervise)
                        for i in range(k)]
        self.in_channels = [net_channels]
        self.in_dtypes = [list(in_dtypes)]
        self.workers: List[_WorkerHandle] = []
        self.plans: List[Dict] = []
        for i in range(k):
            self.plans.append({
                "coord": [self.server.addr[0], self.server.addr[1]],
                "in_channel": i,
                "in_schema": in_cols,
                "append_only": True,
                "fragment": {
                    "kind": "partial_hash_agg",
                    "group_indices": list(group_indices),
                    "calls": _serialize_calls(calls),
                },
            })
        self.workers.extend(_spawn_workers(self.plans))
        # result side: one drain thread per worker feeding a ThreadedChannel
        # the barrier-aligned Merge can poll
        self.dispatch = DispatchExecutor(input, net_channels, kind="hash",
                                         key_indices=list(group_indices))
        self.dispatchers = [self.dispatch]
        # output schema: probe from a local twin of the fragment
        from ..runtime.worker import build_fragment

        class _Stub(Executor):
            def __init__(self, schema):
                super().__init__(schema)

        stub = _Stub(input.schema)
        stub.append_only = True
        out_schema = build_fragment(self.plans[0], stub).schema
        self.out_schema = out_schema
        self.group_indices = list(group_indices)
        self.calls = list(calls)
        self._finish_init(supervise)

    def merge_executor(self) -> MergeExecutor:
        merge = MergeExecutor(self.channels, self.out_schema,
                              pumps=[self.dispatch])
        merge.health_check = self.check_alive
        merge._remote = self           # keeps workers alive with the plan
        return merge

    # 2-phase merge stage: the coordinator-side final aggregation over the
    # workers' partial rows (the reference's 2-phase agg rewrite — partial
    # counts merge with sum0, extremes with min/max)
    _FINAL_KIND = {"count": "sum0", "sum": "sum0", "min": "min",
                   "max": "max", "bool_and": "bool_and",
                   "bool_or": "bool_or"}

    def final_calls(self):
        from ..expr.agg import AggCall
        from ..expr.expression import InputRef
        ng = len(self.group_indices)
        out = []
        for i, c in enumerate(self.calls):
            dt = self.out_schema.fields[ng + i].dtype
            out.append(AggCall(self._FINAL_KIND[c.kind],
                               InputRef(ng + i, dt)))
        return out


class RemoteStatefulSet(_RemoteSetBase):
    """Generalized worker placement: hash-dispatch each input by its key
    columns so every worker OWNS a disjoint key space, run a FULL
    stateful fragment (retractable agg, hash join) in each worker, and
    barrier-align-merge the workers' change streams — no second phase.
    This is the reference's actor model (`stream_manager.rs:254`
    placement: every fragment type runs on compute nodes); the 2-phase
    RemoteFragmentSet above remains the cheaper plan for append-only
    composable aggregates.

    Recovery contract: worker state is process-local and ephemeral. A
    death either respawns in place re-seeded from the coordinator shadow
    (supervised single-input fragments) or surfaces as RemoteWorkerDied
    and the job rebuilds from the DDL log + committed source offsets."""

    kind = "stateful"

    def __init__(self, inputs, key_indices_list, fragment: Dict, k: int,
                 suppress_first_epoch: bool = False,
                 supervise: bool = False, seed_tables=None,
                 seed_strips: Sequence[int] = ()):
        self.server = ExchangeServer()
        n_in = len(inputs)
        assert n_in in (1, 2) and len(key_indices_list) == n_in
        self.frag_kind = fragment["kind"]
        self.kind = "join" if self.frag_kind == "hash_join" else "stateful"
        self.group_count = len(fragment.get("group_indices", ()))
        self.seed_tables = list(seed_tables) if seed_tables else None
        self.seed_strips = list(seed_strips) or [0] * n_in
        # channel ids: input 0 -> 0..k-1, input 1 -> k..2k-1.
        # Supervised sets retain undelivered input epochs per channel:
        # the respawn protocol rolls the shadow back by the retained
        # window and replays it, so retention is what makes stateful
        # in-place recovery exactly-once.
        chans = [[self.server.register(i * k + j,
                                       inputs[i].schema.dtypes,
                                       retain_epochs=supervise)
                  for j in range(k)] for i in range(n_in)]
        self.in_channels = chans
        self.in_dtypes = [list(e.schema.dtypes) for e in inputs]
        self.dispatchers = [
            DispatchExecutor(inputs[i], chans[i], kind="hash",
                             key_indices=list(key_indices_list[i]))
            for i in range(n_in)]
        self.plans = []
        for j in range(k):
            p = {
                "coord": [self.server.addr[0], self.server.addr[1]],
                "in_channel": j,
                "in_schema": [[f.name, f.dtype.kind.value]
                              for f in inputs[0].schema.fields],
                "append_only": inputs[0].append_only,
                "fragment": fragment,
            }
            if suppress_first_epoch:
                p["suppress_first_epoch"] = True
            if n_in == 2:
                p["in_channel_r"] = k + j
                p["in_schema_r"] = [[f.name, f.dtype.kind.value]
                                    for f in inputs[1].schema.fields]
                p["append_only_r"] = inputs[1].append_only
            if supervise and self.frag_kind == "hash_join":
                # epoch-atomic join output: the worker buffers emitted
                # rows and flushes them at the barrier (like the partial
                # agg flush), so nothing of an in-flight epoch ever
                # crosses the wire — the invariant the replay/re-seed
                # machinery needs to cover two-input fragments
                p["epoch_atomic"] = True
            self.plans.append(p)
        self.workers: List[_WorkerHandle] = []
        self.workers.extend(_spawn_workers(self.plans))
        # output schema via a local stub twin
        from .worker import build_fragment

        class _Stub(Executor):
            def __init__(self, schema, ao):
                super().__init__(schema)
                self.append_only = ao

        stubs = [_Stub(e.schema, e.append_only) for e in inputs]
        self.out_schema = build_fragment(
            self.plans[0], stubs[0], stubs[1] if n_in == 2 else None).schema
        self._finish_init(supervise)

    def merge_executor(self) -> MergeExecutor:
        merge = MergeExecutor(self.channels, self.out_schema,
                              pumps=self.dispatchers)
        merge.health_check = self.check_alive
        merge._remote = self
        return merge


class TeeStateExecutor(Executor):
    """Pass-through that shadows a stream's live rows into a coordinator
    state table (committed at checkpoint barriers). The shadow is what
    re-seeds respawned stateful workers — the coordinator-side stand-in
    for the reference's shared-storage (Hummock) join state."""

    def __init__(self, input: Executor, state_table, pad: int = 0):
        super().__init__(input.schema, "TeeState")
        self.append_only = input.append_only
        self.input = input
        self.state_table = state_table
        self.pad = (0,) * pad     # trailing filler columns (join degree)

    def execute(self):
        from ..core.chunk import StreamChunk
        from ..ops.message import Barrier
        for msg in self.input.execute():
            if isinstance(msg, StreamChunk):
                for op, row in msg.compact().op_rows():
                    if op.is_insert:
                        self.state_table.insert(tuple(row) + self.pad)
                    else:
                        self.state_table.delete(tuple(row) + self.pad)
            elif isinstance(msg, Barrier) and msg.is_checkpoint:
                self.state_table.commit(msg.epoch.curr)
            yield msg


class _SeedPrepend(Executor):
    """Emit recovered shadow rows as one leading insert batch, then the
    live stream. Workers ingest the seeds as state (their outputs are
    suppressed until the first barrier — worker.py)."""

    def __init__(self, input: Executor, rows):
        super().__init__(input.schema, "SeedPrepend")
        self.append_only = input.append_only
        self.input = input
        self.rows = list(rows)

    def execute(self):
        from ..core.chunk import Op, StreamChunk
        for i in range(0, len(self.rows), 4096):
            yield StreamChunk.from_rows(
                self.schema.dtypes,
                [(Op.INSERT, tuple(r)) for r in self.rows[i:i + 4096]])
        self.rows = []      # consumed once; don't pin the copy for the
        yield from self.input.execute()   # lifetime of the job


def make_remote_join(lexec: Executor, rexec: Executor, lkeys, rkeys,
                     join_type, k: int, left_state, right_state,
                     supervise: bool = False) -> "RemoteStatefulSet":
    """Hash join across k worker processes: both inputs hash-dispatch on
    the join key, each worker owns its key space and runs the FULL
    stateful HashJoinExecutor; the coordinator shadows both sides and
    seeds fresh workers on recovery. Supervised join workers respawn IN
    PLACE: output is epoch-atomic (worker-side barrier flush), so the
    supervisor can seed a successor from both-side shadows rolled back
    to the last delivered epoch and replay the retained window on both
    dispatchers — the undelivered join deltas re-derive exactly
    (`FragmentSupervisor` docstring)."""
    # shadow tables reuse the join-state layout (row + degree column);
    # the tee pads the degree, seeds strip it
    lseed = [tuple(r)[:-1] for r in left_state.iter_all()] \
        if left_state is not None else []
    rseed = [tuple(r)[:-1] for r in right_state.iter_all()] \
        if right_state is not None else []
    seeding = bool(lseed or rseed)
    lt = TeeStateExecutor(lexec, left_state, pad=1) \
        if left_state is not None else lexec
    rt = TeeStateExecutor(rexec, right_state, pad=1) \
        if right_state is not None else rexec
    lin = _SeedPrepend(lt, lseed) if seeding else lt
    rin = _SeedPrepend(rt, rseed) if seeding else rt
    fragment = {"kind": "hash_join", "left_keys": list(lkeys),
                "right_keys": list(rkeys), "join_type": join_type.value}
    return RemoteStatefulSet([lin, rin], [list(lkeys), list(rkeys)],
                             fragment, k, suppress_first_epoch=seeding,
                             supervise=supervise,
                             seed_tables=[left_state, right_state],
                             seed_strips=[1, 1])


def remotable_calls(calls) -> bool:
    """Owned-group remote agg covers plain column aggregates — exact
    under retraction because each WORKER keeps the full stateful agg
    (multiset min/max), so avg is fine too."""
    return _plain_column_calls(
        calls, ("count", "sum", "min", "max", "avg",
                "bool_and", "bool_or"))


def make_remote_agg(input: Executor, group_indices, calls, k: int,
                    shadow_table, supervise: bool = False
                    ) -> "RemoteStatefulSet":
    """Retractable aggregation across k worker processes: the input
    (which must carry a unique row identity — the planner appends the
    upstream stream key) hash-dispatches on the group key; each worker
    owns its groups and runs the FULL stateful HashAggExecutor (multiset
    min/max — exact under retraction). The coordinator shadows the LIVE
    input rows and re-seeds respawned workers with them: agg state is a
    pure function of the live input multiset, so replaying the shadow
    (outputs suppressed) rebuilds it exactly."""
    seed = [tuple(r) for r in shadow_table.iter_all()] \
        if shadow_table is not None else []
    seeding = bool(seed)
    src = TeeStateExecutor(input, shadow_table) \
        if shadow_table is not None else input
    if seeding:
        src = _SeedPrepend(src, seed)
    fragment = {"kind": "hash_agg",
                "group_indices": list(group_indices),
                "calls": _serialize_calls(calls)}
    return RemoteStatefulSet([src], [list(group_indices)], fragment, k,
                             suppress_first_epoch=seeding,
                             supervise=supervise,
                             seed_tables=[shadow_table])
