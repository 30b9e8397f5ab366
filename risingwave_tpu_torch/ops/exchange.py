"""Exchange layer: dispatch, merge, permit channels (the port's own copy
of the JAX package's `ops/exchange.py`).

Reference: `src/stream/src/executor/dispatch.rs` (HashDataDispatcher `:777`,
vis-bitmap building + U-pair fixing `:843-930`; Broadcast/Simple/RoundRobin
`:509,690,969`), `merge.rs:235` (barrier-aligned merge), and
`exchange/permit.rs:35` (credit-based backpressure channel).

On the device the exchange is one `bucket_exchange` call per epoch
step (`parallel/sharded_agg.py`, `kernels/exchange.py`); these HOST
executors exist
for multi-fragment host pipelines (different operators at different
parallelism) and for the multi-host DCN path, where chunks move between
processes — the same two-tier split the reference has between in-process
channels and gRPC streams.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.chunk import Op, StreamChunk
from ..core.schema import Schema
from ..core.vnode import VNODE_COUNT, compute_vnodes
from .executor import Executor
from .message import Barrier, Message, Watermark


class Channel:
    """Bounded in-process channel with permit accounting
    (`exchange/permit.rs:35`): data messages consume permits, barriers are
    exempt (they must never be blocked by backpressure)."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self.buf: Deque[Message] = deque()
        self.closed = False          # producer done: recv drains then ends

    def try_send(self, msg: Message) -> bool:
        if isinstance(msg, StreamChunk) and self._data_len() >= self.capacity:
            return False
        self.buf.append(msg)
        return True

    def send(self, msg: Message) -> None:
        # single-threaded runtime: the consumer drains between sends, so a
        # full channel here means a missing consumer — surface it
        if not self.try_send(msg):
            raise RuntimeError("channel full: downstream not consuming "
                               "(permit backpressure would block here)")

    def close(self) -> None:
        self.closed = True

    def _data_len(self) -> int:
        return sum(1 for m in self.buf if isinstance(m, StreamChunk))

    def recv(self) -> Optional[Message]:
        return self.buf.popleft() if self.buf else None

    def __len__(self) -> int:
        return len(self.buf)


class ThreadedChannel(Channel):
    """Channel with real blocking semantics for producer/consumer threads
    or background socket drains: send blocks on capacity, recv stays
    non-blocking (MergeExecutor polls), and a shared condition lets a
    consumer sleep until ANY of its inputs has data (`wait`)."""

    def __init__(self, capacity: int = 64, cond=None):
        import threading
        super().__init__(capacity)
        self.cv = cond or threading.Condition()

    def try_send(self, msg: Message) -> bool:
        with self.cv:
            if not super().try_send(msg):
                return False
            self.cv.notify_all()
            return True

    def send(self, msg: Message) -> None:
        import time
        with self.cv:
            t0 = None
            while isinstance(msg, StreamChunk) \
                    and self._data_len() >= self.capacity and not self.closed:
                if t0 is None:
                    t0 = time.monotonic()
                self.cv.wait(1.0)
            if t0 is not None:
                # a result drain stalled on a full merge channel — the
                # coordinator is the slow party; feed the overload ladder
                from ..utils.overload import PRESSURE
                PRESSURE.note("result_channel", time.monotonic() - t0)
            if self.closed and isinstance(msg, StreamChunk):
                return               # consumer gone; chunks are droppable
            self.buf.append(msg)
            self.cv.notify_all()

    def close(self) -> None:
        with self.cv:
            self.closed = True
            self.cv.notify_all()

    def send_batch(self, msgs: Sequence[Message]) -> None:
        """Append a pre-assembled batch atomically, WITHOUT capacity
        waits: the producer already holds the whole batch in memory, so
        blocking it here gains nothing and can deadlock a producer the
        consumer thread must later join (the supervised drain's
        epoch-atomic release)."""
        with self.cv:
            self.buf.extend(msgs)
            self.cv.notify_all()

    def recv(self) -> Optional[Message]:
        with self.cv:
            msg = self.buf.popleft() if self.buf else None
            if msg is not None:
                self.cv.notify_all()    # wake a send() blocked on capacity
            return msg

    def wait(self, timeout: float = 0.05) -> None:
        with self.cv:
            if not self.buf and not self.closed:
                self.cv.wait(timeout)


class DispatchExecutor:
    """Output side of an exchange: consumes one upstream, feeds N channels.

    Not an `Executor` (it terminates a fragment); `pump_until_barrier`
    drives it. Dispatch kinds: hash (vnode), broadcast, simple, round-robin
    (`DispatcherImpl`, dispatch.rs:509).
    """

    def __init__(self, input: Executor, outputs: Sequence[Channel],
                 kind: str = "hash", key_indices: Sequence[int] = (),
                 vnode_count: int = VNODE_COUNT):
        assert kind in ("hash", "broadcast", "simple", "round_robin")
        if kind == "simple":
            assert len(outputs) == 1
        self.input = input
        self.outputs = list(outputs)
        self.kind = kind
        self.key_indices = list(key_indices)
        self.vnode_count = vnode_count
        n = len(outputs)
        # contiguous vnode blocks — THE map (parallel/mesh.py), not an
        # inlined copy: host exchange and device shard planes must agree
        # on block boundaries even when n doesn't divide vnode_count
        from ..parallel.mesh import shard_of_vnode
        self.vnode_to_out = shard_of_vnode(
            np.arange(vnode_count, dtype=np.int64), n,
            vnode_count).astype(np.int32)
        self._rr = 0
        self._iter: Optional[Iterator[Message]] = None
        # last barrier fanned out + an optional observer: the
        # FragmentSupervisor logs dispatched barriers so a respawned
        # worker can be fed every barrier its predecessor never delivered
        self.last_barrier: Optional[Barrier] = None
        self.on_barrier = None

    def _dispatch_chunk(self, chunk: StreamChunk) -> None:
        if self.kind == "broadcast":
            for ch in self.outputs:
                ch.send(chunk)
            return
        if self.kind == "simple":
            self.outputs[0].send(chunk)
            return
        if self.kind == "round_robin":
            self.outputs[self._rr].send(chunk)
            self._rr = (self._rr + 1) % len(self.outputs)
            return
        # hash: vnode per row -> per-output visibility bitmaps
        # (dispatch.rs:843-930)
        chunk = chunk.compact()
        n = chunk.capacity
        if n == 0:
            return
        vnodes = compute_vnodes([chunk.columns[i] for i in self.key_indices],
                                vnode_count=self.vnode_count)
        out_of_row = self.vnode_to_out[vnodes]
        ops = chunk.ops
        # U-pair fixing: when the two halves of an update pair land on
        # different outputs, degrade them to Delete + Insert so each side
        # sees a self-consistent chunk (dispatch.rs:891-909). Vectorized:
        # hits are (U-, U+) adjacencies split across outputs — they cannot
        # overlap (a row can't be both U- and U+), so a bulk write is safe.
        # Append-only streams skip this entirely.
        if (ops >= Op.UPDATE_DELETE).any():
            ops = ops.copy()
            split = np.flatnonzero(
                (ops[:-1] == Op.UPDATE_DELETE)
                & (ops[1:] == Op.UPDATE_INSERT)
                & (out_of_row[:-1] != out_of_row[1:]))
            ops[split] = Op.DELETE
            ops[split + 1] = Op.INSERT
        for oi, ch in enumerate(self.outputs):
            vis = out_of_row == oi
            if not vis.any():
                continue
            ch.send(StreamChunk(ops, chunk.columns, vis))

    def pump_until_barrier(self) -> Optional[Barrier]:
        """Forward messages until a barrier; the barrier goes to EVERY
        output (Chandy-Lamport marker fan-out). Exhaustion closes the
        outputs so consumers (local fragments or remote workers) see EOS."""
        if self._iter is None:
            self._iter = self.input.execute()
        for msg in self._iter:
            if isinstance(msg, Barrier):
                self.last_barrier = msg
                if self.on_barrier is not None:
                    self.on_barrier(msg)
                for ch in self.outputs:
                    ch.send(msg)
                return msg
            if isinstance(msg, StreamChunk):
                if msg.cardinality:
                    self._dispatch_chunk(msg)
            elif isinstance(msg, Watermark):
                for ch in self.outputs:
                    ch.send(msg)
        for ch in self.outputs:
            close = getattr(ch, "close", None)
            if close:
                close()
        return None


class ChannelSource(Executor):
    """Fragment input boundary: reads one exchange channel; when empty,
    drives the upstream dispatcher (`exchange/input.rs` LocalInput — the
    pull side of a permit channel)."""

    def __init__(self, chan: Channel, schema: Schema,
                 pump: "DispatchExecutor"):
        super().__init__(schema, "ChannelSource")
        self.chan = chan
        self.pump = pump
        self.append_only = pump.input.append_only

    def execute(self) -> Iterator[Message]:
        while True:
            msg = self.chan.recv()
            if msg is None:
                if self.pump.pump_until_barrier() is None:
                    return
                continue
            yield msg
            if isinstance(msg, Barrier) and msg.is_stop():
                return


class FragmentPump:
    """Drives one executor chain into an exchange channel until its next
    barrier — the per-fragment actor loop (`actor.rs:157`) flattened into
    the cooperative single-thread runtime. Duck-typed like
    DispatchExecutor for MergeExecutor's pump list."""

    def __init__(self, execu: Executor, out: Channel):
        self.execu = execu
        self.out = out
        self._iter: Optional[Iterator[Message]] = None

    def pump_until_barrier(self) -> Optional[Barrier]:
        if self._iter is None:
            self._iter = self.execu.execute()
        for msg in self._iter:
            self.out.send(msg)
            if isinstance(msg, Barrier):
                return msg
        self.out.close()
        return None


class MergeExecutor(Executor):
    """Input side: merge N upstream channels with barrier alignment
    (`merge.rs:235,403-480`): chunks flow through freely; when one upstream
    yields a barrier, that input is blocked (its messages buffered) until
    every other input yields the same barrier, then ONE barrier is emitted.

    Watermarks: per-upstream watermark tracked, min across inputs emitted
    (`executor/watermark/`-style min alignment)."""

    def __init__(self, inputs: Sequence[Channel], schema: Schema,
                 pumps: Sequence[DispatchExecutor] = ()):
        super().__init__(schema, "Merge")
        self.inputs = list(inputs)
        self.pumps = list(pumps)   # upstream dispatchers to drive on demand
        self._wm: List[Optional[int]] = [None] * len(inputs)
        self._wm_emitted: Optional[int] = None
        # hook polled while idle-waiting: remote deployments raise here
        # when a worker died, instead of spinning on a barrier that will
        # never align (the failure-detection seam)
        self.health_check = lambda: None

    def execute(self) -> Iterator[Message]:
        n = len(self.inputs)
        pending_barrier: List[Optional[Barrier]] = [None] * n
        # epoch of a pumped-but-not-yet-aligned barrier: while set, the
        # pumps are NOT driven again, so at most ONE barrier is ever in
        # flight beyond the last alignment. Without this, a self-ticking
        # source injects a barrier per pump while async workers are
        # still responding — unbounded queues on a loaded host, and the
        # supervisor's single-barrier re-injection / two-epoch
        # retransmit retention would miss skipped epochs (barrier skew).
        awaiting: Optional[int] = None
        while True:
            progressed = False
            for i, ch in enumerate(self.inputs):
                if pending_barrier[i] is not None:
                    continue   # blocked until alignment completes
                msg = ch.recv()
                if msg is None:
                    continue
                progressed = True
                if isinstance(msg, Barrier):
                    pending_barrier[i] = msg
                elif isinstance(msg, Watermark):
                    self._wm[i] = msg.value
                    if all(w is not None for w in self._wm):
                        low = min(self._wm)
                        if self._wm_emitted is None or low > self._wm_emitted:
                            self._wm_emitted = low
                            yield Watermark(msg.col_idx, msg.dtype, low)
                else:
                    yield msg
            if all(b is not None for b in pending_barrier):
                b = pending_barrier[0]
                assert all(x.epoch.curr == b.epoch.curr
                           for x in pending_barrier[1:]), \
                    ("barrier skew",
                     [x.epoch.curr for x in pending_barrier])
                awaiting = None
                yield b.with_trace(self.name)
                if b.is_stop():
                    return
                pending_barrier = [None] * n
                continue
            if not progressed:
                self.health_check()
                # An in-flight barrier (`awaiting` pumped, or some input
                # delivered it already): EVERY input received it via the
                # pump fan-out, so stragglers need no further input —
                # wait for one instead of pumping (its send() notifies,
                # so the wait cuts short on arrival). Plain in-process
                # channels can't be waited on; for them pumping IS how
                # stragglers progress, so fall through to the pumps.
                if awaiting is not None \
                        or any(b is not None for b in pending_barrier):
                    straggler = next(
                        (ch for i, ch in enumerate(self.inputs)
                         if pending_barrier[i] is None
                         and hasattr(ch, "wait") and not ch.closed
                         and len(ch) == 0), None)
                    if straggler is not None:
                        straggler.wait(0.005)
                        continue
                # all unblocked channels empty: drive the upstream pumps
                done = True
                for p in self.pumps:
                    b = p.pump_until_barrier()
                    if b is not None:
                        done = False
                        if awaiting is None or b.epoch.curr > awaiting:
                            awaiting = b.epoch.curr
                if not done:
                    continue
                # pumps exhausted. Inputs backed by threads/processes may
                # still be computing: drain until every channel is closed.
                if all(ch.closed and len(ch) == 0 for ch in self.inputs):
                    return
                waiter = next((ch for ch in self.inputs
                               if hasattr(ch, "wait")
                               and not (ch.closed and len(ch) == 0)), None)
                if waiter is None:
                    return     # plain channels: nothing will ever arrive
                waiter.wait(0.05)
