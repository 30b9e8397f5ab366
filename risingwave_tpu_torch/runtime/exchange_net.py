"""Cross-process exchange: chunk/barrier wire protocol + socket transport
with permit-based credit flow control (the port's own copy of the JAX
package's `runtime/exchange_net.py`: the frames are the same bytes — but
for a K frame's pickled Interval scalars, which name their package's
class — so a port process and a JAX-package process exchange streams
either way).

The reference's remote exchange stack re-hosted for this runtime:

* wire contract — the `ExchangeService::GetStream` analog
  (`proto/task_service.proto:149`, `src/compute/src/rpc/service/
  exchange_service.rs:77`): one TCP stream per (job, channel), framed
  messages, rows in the column-aware value encoding (`core/encoding.py`)
  so the bytes that cross processes are the same bytes the state tables
  persist;
* credit flow control — the permit channel analog
  (`src/stream/src/executor/exchange/permit.rs:35`): DATA frames consume
  permits granted by the receiver (`AddPermits` frames back); barriers
  and watermarks are exempt, so backpressure can never block a
  checkpoint;
* `RemoteInput` — the consumer-side executor
  (`exchange/input.rs:167` RemoteInput): yields Chunk/Barrier/Watermark
  from the socket and returns permits as it consumes.

Frames: u32 big-endian length, 1 tag byte, body.
  C chunk      u16 nrows, nrows x (u8 op, u32 len, value-encoded row)
  B barrier    u64 curr, u64 prev, u8 kind, u8 mutation
  W watermark  u16 col_idx, u8 type_kind, u32 len, value-encoded datum
  M metrics    JSON {pid, ts, epoch, m: registry delta} — the cluster
               metrics plane: workers piggyback registry deltas and a
               heartbeat on their result stream; permit-exempt like
               barriers (observability must not be backpressured away)
  P permits    u32 n                (receiver -> sender)
  H hello      u16 channel_id       (receiver -> sender, once)
  E eos
"""
from __future__ import annotations

import io
import json
import pickle
import socket
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Deque, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from ..config import ROBUSTNESS
from ..core.chunk import Column, Op, StreamChunk, StreamChunkBuilder
from ..core.dtypes import DataType, TypeKind
from ..core.encoding import decode_value_datum, encode_row
from ..core.epoch import EpochPair
from ..core.schema import Schema
from ..ops.executor import Executor
from ..ops.message import (Barrier, BarrierKind, Message, Mutation,
                           MutationKind, Watermark)
from ..utils.failpoint import declare, failpoint
from ..utils.overload import PRESSURE

# initial credit per connection (in chunks) — the compiled-in default;
# RW_EXCHANGE_CREDITS (RobustnessConfig.exchange_credits) overrides it
# per process at channel/stream creation time
DEFAULT_PERMITS = 256


def _credits() -> int:
    return max(1, ROBUSTNESS.exchange_credits)

declare("exchange.connect",
        "refuse one exchange connect attempt (retry/backoff seam)")
declare("exchange.send_frame",
        "drop the connection on a frame send (mid-stream write fault)")
declare("exchange.recv_frame",
        "drop the connection on a frame receive (mid-stream read fault)")

@dataclass
class MetricsFrame:
    """Worker -> coordinator metrics/heartbeat piggyback (M frame). Not a
    dataflow Message: the coordinator's result drain consumes it (registry
    merge + heartbeat timestamp) and never forwards it downstream. An
    empty payload is still a valid heartbeat."""
    pid: int
    ts: float                               # sender wall clock
    epoch: Optional[int] = None             # last completed result epoch
    payload: Dict[str, Any] = field(default_factory=dict)


# stable wire ids for the string-valued enums
_MUT = {None: 0, MutationKind.STOP: 1, MutationKind.PAUSE: 2,
        MutationKind.RESUME: 3}
_MUT_INV = {v: k for k, v in _MUT.items()}
_BKIND = {BarrierKind.INITIAL: 0, BarrierKind.BARRIER: 1,
          BarrierKind.CHECKPOINT: 2}
_BKIND_INV = {v: k for k, v in _BKIND.items()}
_TKIND = {k: i for i, k in enumerate(TypeKind)}
_TKIND_INV = {v: k for k, v in _TKIND.items()}


def _decode_row(buf: bytes, dtypes: Sequence[DataType]) -> Tuple:
    out = []
    pos = 0
    for dt in dtypes:
        v, pos = decode_value_datum(buf, pos, dt)
        out.append(v)
    return tuple(out)


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def _send_frame(sock: socket.socket, tag: bytes, body: bytes = b"") -> None:
    if failpoint("exchange.send_frame"):
        raise ConnectionError("failpoint exchange.send_frame")
    sock.sendall(struct.pack(">I", len(body) + 1) + tag + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("exchange peer closed")
        buf += part
    return buf


def _recv_frame(sock: socket.socket) -> Tuple[bytes, bytes]:
    if failpoint("exchange.recv_frame"):
        raise ConnectionError("failpoint exchange.recv_frame")
    (ln,) = struct.unpack(">I", _recv_exact(sock, 4))
    body = _recv_exact(sock, ln)
    return body[:1], body[1:]


MAX_FRAME_ROWS = 0xFFFF        # u16 row count per C frame


def encode_chunk_frames(chunk: StreamChunk, dtypes: Sequence[DataType]
                        ) -> List[bytes]:
    """One or more C-frame bodies (chunks larger than the u16 row bound
    split). A U-/U+ pair straddling a split boundary is degraded to
    DELETE + INSERT — same-row semantics, frame-local validity — the same
    fix the reference's hash dispatcher applies when a pair lands on two
    actors (`src/stream/src/executor/dispatch.rs:891-909`)."""
    chunk = chunk.compact()
    rows = [[int(chunk.ops[i]), encode_row(chunk.row_at(i), dtypes)]
            for i in range(chunk.capacity)]
    step = MAX_FRAME_ROWS
    for lo in range(step, len(rows), step):
        if rows[lo - 1][0] == int(Op.UPDATE_DELETE) \
                and rows[lo][0] == int(Op.UPDATE_INSERT):
            rows[lo - 1][0] = int(Op.DELETE)
            rows[lo][0] = int(Op.INSERT)
    out = []
    for lo in range(0, len(rows), step) or [0]:
        part = rows[lo:lo + step]
        frame = [struct.pack(">H", len(part))]
        for op, row in part:
            frame.append(struct.pack(">BI", op, len(row)))
            frame.append(row)
        out.append(b"".join(frame))
    return out or [struct.pack(">H", 0)]


def encode_chunk_columnar(chunk: StreamChunk,
                          dtypes: Sequence[DataType]) -> bytes:
    """K-frame body: one whole chunk, COLUMNAR — ops as raw int8, per
    column a packed validity bitmap plus either the raw fixed-width value
    buffer (little-endian numpy) or a pickled scalar list for
    object-dtype columns (varchar/decimal/interval). Vectorized at
    numpy/pickle speed, ~100x cheaper than the per-row value encoding —
    the C frame remains as the row-exact format shared with state-table
    bytes; data-plane chunks ride K. Frames never split (u32 row count),
    so U-pairs stay intact. Pickle is acceptable here for the same reason
    the reference trusts its intra-cluster gRPC peers: both stream ends
    are this framework's own processes."""
    chunk = chunk.compact()
    n = chunk.capacity
    parts = [struct.pack(">I", n), chunk.ops.astype(np.int8).tobytes()]
    for col in chunk.columns:
        vb = np.packbits(col.validity).tobytes()
        if col.dtype.np_dtype == np.dtype(object):
            payload = pickle.dumps(col.values.tolist(), protocol=5)
            tag = 1
        else:
            payload = col.values.tobytes()
            tag = 0
        parts.append(struct.pack(">BI", tag, len(vb)))
        parts.append(vb)
        parts.append(struct.pack(">I", len(payload)))
        parts.append(payload)
    return b"".join(parts)


# the JAX package's module prefix and the port's: an object column's
# pickled scalars name their package's class (`core.dtypes.Interval`),
# so a K frame from a JAX-package process names the JAX package's
_REF_PKG, _PORT_PKG = "risingwave_tpu", "risingwave_tpu_torch"


class _PortUnpickler(pickle.Unpickler):
    """`pickle.loads` that resolves the JAX package's classes to the
    port's: a port process reads a JAX-package sender's K frames without
    importing that package (the K frame is the one place where the two
    packages' bytes differ: a pickled Interval names its module)."""

    def find_class(self, module, name):
        if module == _REF_PKG or module.startswith(_REF_PKG + "."):
            module = _PORT_PKG + module[len(_REF_PKG):]
        return super().find_class(module, name)


def decode_chunk_columnar(body: bytes, dtypes: Sequence[DataType]
                          ) -> Optional[StreamChunk]:
    (n,) = struct.unpack(">I", body[:4])
    pos = 4
    ops = np.frombuffer(body[pos:pos + n], dtype=np.int8)
    pos += n
    cols = []
    for dt in dtypes:
        tag, vlen = struct.unpack(">BI", body[pos:pos + 5])
        pos += 5
        validity = np.unpackbits(
            np.frombuffer(body[pos:pos + vlen], dtype=np.uint8),
            count=n).astype(np.bool_)
        pos += vlen
        (plen,) = struct.unpack(">I", body[pos:pos + 4])
        pos += 4
        payload = body[pos:pos + plen]
        pos += plen
        if tag == 1:
            values = np.empty(n, dtype=object)
            values[:] = _PortUnpickler(io.BytesIO(payload)).load()
        else:
            values = np.frombuffer(payload, dtype=dt.np_dtype)
        cols.append(Column(dt, values, validity))
    if n == 0:
        return None
    return StreamChunk(ops, cols)


def decode_chunk(body: bytes, dtypes: Sequence[DataType]
                 ) -> Optional[StreamChunk]:
    (n,) = struct.unpack(">H", body[:2])
    pos = 2
    # one frame = one chunk: the builder bound must exceed the u16 frame
    # row bound or frames over 1024 rows would silently truncate
    builder = StreamChunkBuilder(list(dtypes),
                                 max_chunk_size=MAX_FRAME_ROWS + 1)
    for _ in range(n):
        op, ln = struct.unpack(">BI", body[pos:pos + 5])
        pos += 5
        row = _decode_row(body[pos:pos + ln], dtypes)
        pos += ln
        builder.append_row(Op(op), row)
    chunks = builder.drain()
    return chunks[0] if chunks else None


def encode_message(msg: Message, dtypes: Sequence[DataType]
                   ) -> Tuple[bytes, bytes]:
    if isinstance(msg, StreamChunk):
        frames = encode_chunk_frames(msg, dtypes)
        assert len(frames) == 1, "use encode_chunk_frames for large chunks"
        return b"C", frames[0]
    if isinstance(msg, Barrier):
        # unsupported mutation kinds (scale/backfill control) must fail
        # loudly, not silently arrive as plain barriers
        mut = _MUT[msg.mutation.kind if msg.mutation else None]
        return b"B", struct.pack(">QQBB", msg.epoch.curr, msg.epoch.prev,
                                 _BKIND[msg.kind], mut)
    if isinstance(msg, Watermark):
        from ..core.encoding import encode_value_datum
        datum = encode_value_datum(msg.value, msg.dtype)
        return b"W", struct.pack(">HBI", msg.col_idx,
                                 _TKIND[msg.dtype.kind], len(datum)) + datum
    if isinstance(msg, MetricsFrame):
        return b"M", json.dumps({"pid": msg.pid, "ts": msg.ts,
                                 "epoch": msg.epoch,
                                 "m": msg.payload}).encode()
    raise TypeError(f"cannot encode {type(msg).__name__}")


def decode_message(tag: bytes, body: bytes, dtypes: Sequence[DataType]
                   ) -> Optional[Message]:
    if tag == b"C":
        return decode_chunk(body, dtypes)
    if tag == b"K":
        return decode_chunk_columnar(body, dtypes)
    if tag == b"B":
        curr, prev, kind, mut = struct.unpack(">QQBB", body)
        mutation = (Mutation(_MUT_INV[mut]) if mut else None)
        return Barrier(EpochPair(curr, prev), _BKIND_INV[kind], mutation)
    if tag == b"W":
        col_idx, kind, ln = struct.unpack(">HBI", body[:7])
        dt = DataType(_TKIND_INV[kind])
        v, _ = decode_value_datum(body[7:7 + ln], 0, dt)
        return Watermark(col_idx, dt, v)
    if tag == b"M":
        d = json.loads(body.decode())
        return MetricsFrame(d.get("pid", 0), d.get("ts", 0.0),
                            d.get("epoch"), d.get("m") or {})
    raise ValueError(f"unknown frame {tag!r}")


# ---------------------------------------------------------------------------
# sender side (the fragment OUTPUT boundary)
# ---------------------------------------------------------------------------


class NetChannel:
    """Producer-side queue for one downstream consumer. A writer thread
    drains it to the socket, spending permits on DATA frames and blocking
    (backpressure) when credit runs out — barriers pass regardless. The
    queue itself is bounded for DATA, so a slow consumer backpressures
    the producer's pump instead of buffering the whole stream."""

    def __init__(self, dtypes: Sequence[DataType],
                 capacity: Optional[int] = None,
                 retain_epochs: bool = False):
        self.dtypes = list(dtypes)
        self.capacity = capacity if capacity is not None else 4 * _credits()
        self.buf: Deque[Message] = deque()
        self.cv = threading.Condition()
        self.closed = False
        self.aborted = False                # writer died mid-stream
        self.done = threading.Event()       # writer finished (EOS or abort)
        # epoch retransmit buffer (retain_epochs=True): every data/
        # watermark message of the CURRENT epoch plus every completed
        # epoch the consumer has NOT yet confirmed delivered (the drain
        # trims on each result barrier) is retained, so a supervisor can
        # replay exactly what a dead stateless worker had not yet turned
        # into delivered output. Recording continues while aborted —
        # messages dispatched between death and detection are precisely
        # the ones a respawn must not lose. A dead worker's buffered
        # result epochs can keep alignment advancing past its death, so
        # the undelivered window may span several epochs.
        self.retain_epochs = retain_epochs
        self.retrans: List[Message] = []
        self.retrans_done: List[Tuple[int, List[Message]]] = []

    def _data_len(self) -> int:
        return sum(1 for m in self.buf if isinstance(m, StreamChunk))

    def _retain(self, msg: Message) -> None:
        if isinstance(msg, Barrier):
            self.retrans.append(msg)
            self.retrans_done.append((msg.epoch.curr, self.retrans))
            self.retrans = []
        else:
            self.retrans.append(msg)

    def trim_retrans(self, delivered_epoch: int) -> None:
        """Drop retained epochs the consumer delivered results for."""
        with self.cv:
            self.retrans_done = [e for e in self.retrans_done
                                 if e[0] > delivered_epoch]

    def replay_for(self, last_delivered_epoch: int) -> List[Message]:
        """Messages a respawned worker must re-ingest, given the last
        barrier epoch its predecessor DELIVERED results for."""
        out: List[Message] = []
        for epoch, msgs in self.retrans_done:
            if epoch > last_delivered_epoch:
                out += msgs
        out += self.retrans
        return out

    # Channel-compatible surface for DispatchExecutor
    def send(self, msg: Message) -> None:
        with self.cv:
            if self.retain_epochs:
                self._retain(msg)
            if self.aborted:
                return                      # consumer gone: drop, don't block
            if isinstance(msg, StreamChunk):
                t0 = None
                while self._data_len() >= self.capacity \
                        and not (self.closed or self.aborted):
                    if t0 is None:
                        t0 = time.monotonic()
                    self.cv.wait()
                if t0 is not None:
                    # the producer stalled on a full exchange queue: the
                    # credit-starvation evidence the overload ladder acts on
                    PRESSURE.note("exchange_queue",
                                  time.monotonic() - t0)
                if self.aborted:
                    return
            self.buf.append(msg)
            self.cv.notify_all()

    def abort(self) -> None:
        """Writer-side: the connection died. Unblock any producer stuck in
        send() and mark the stream as NOT fully delivered."""
        with self.cv:
            self.aborted = True
            self.buf.clear()
            self.cv.notify_all()

    def close(self) -> None:
        with self.cv:
            self.closed = True
            self.cv.notify_all()


class ExchangeServer:
    """Accepts one connection per registered channel and streams it.

    `register` returns the NetChannel the producer writes into (via
    DispatchExecutor). The server owns the listener + per-connection
    writer/permit threads; `close()` after all channels saw EOS."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(64)
        self.addr = self._lsock.getsockname()
        self.channels: Dict[int, NetChannel] = {}
        self._claimed: set = set()
        self._claim_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def register(self, channel_id: int, dtypes: Sequence[DataType],
                 capacity: Optional[int] = None,
                 retain_epochs: bool = False) -> NetChannel:
        ch = NetChannel(dtypes, capacity, retain_epochs=retain_epochs)
        self.channels[channel_id] = ch
        return ch

    def unregister(self, channel_id: int) -> None:
        """Forget a dead worker's channel (its writer thread, if any, has
        already aborted); the id stays claimed so a late reconnect to it
        is refused rather than spliced into a fresh stream."""
        ch = self.channels.pop(channel_id, None)
        if ch is not None:
            ch.close()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._lsock.accept()
                # barriers/permits are tiny frames on the critical path:
                # Nagle+delayed-ACK would add ~40ms per epoch round trip
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                return                      # listener closed
            # handshake off-thread with a deadline: a stalled or garbage
            # client (health checks, port scanners) must never block the
            # accept loop or the other streams
            t = threading.Thread(target=self._handshake, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _handshake(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(30.0)
            tag, body = _recv_frame(conn)
            if tag != b"H" or len(body) != 2:
                conn.close()
                return
            (cid,) = struct.unpack(">H", body)
            with self._claim_lock:
                ch = self.channels.get(cid)
                if ch is None or cid in self._claimed:
                    # unknown or already-streamed channel: refuse loudly
                    # rather than split one stream across two consumers
                    conn.close()
                    return
                self._claimed.add(cid)
            conn.settimeout(None)
        except (ConnectionError, OSError, struct.error):
            try:
                conn.close()
            except OSError:
                pass
            return
        self._writer(conn, ch)

    def _writer(self, conn: socket.socket, ch: NetChannel) -> None:
        permits = [_credits()]
        pcv = threading.Condition()

        def permit_reader():
            try:
                while True:
                    tag, body = _recv_frame(conn)
                    if tag == b"P":
                        with pcv:
                            permits[0] += struct.unpack(">I", body)[0]
                            pcv.notify_all()
            except (ConnectionError, OSError):
                with pcv:
                    permits[0] = 1 << 30     # unblock a dying writer
                    pcv.notify_all()

        preader = threading.Thread(target=permit_reader, daemon=True)
        preader.start()
        delivered = False
        try:
            while True:
                with ch.cv:
                    while not ch.buf and not ch.closed:
                        ch.cv.wait()
                    if not ch.buf and ch.closed:
                        _send_frame(conn, b"E")
                        delivered = True
                        break
                    # drain a batch per wakeup: one cv round trip per
                    # MESSAGE starves the pipeline on GIL handoffs
                    batch = list(ch.buf)
                    ch.buf.clear()
                    ch.cv.notify_all()      # wake a blocked send()
                for msg in batch:
                    if isinstance(msg, StreamChunk):
                        # credit: block until the receiver granted room
                        t0 = None
                        with pcv:
                            while permits[0] <= 0:
                                if t0 is None:
                                    t0 = time.monotonic()
                                pcv.wait()
                            permits[0] -= 1
                        if t0 is not None:
                            PRESSURE.note("exchange_credit",
                                          time.monotonic() - t0)
                        _send_frame(conn, b"K",
                                    encode_chunk_columnar(msg, ch.dtypes))
                        continue
                    tag, body = encode_message(msg, ch.dtypes)
                    _send_frame(conn, tag, body)
        except (ConnectionError, OSError):
            pass
        finally:
            if not delivered:
                ch.abort()              # unblock producers; mark undelivered
            # Linger until the consumer hangs up: exiting the process with
            # permit frames still in flight would RST the connection and
            # destroy undelivered data on it (and on sibling streams).
            try:
                conn.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            preader.join(timeout=60)
            try:
                conn.close()
            except OSError:
                pass
            ch.done.set()

    _CONFIG_DEADLINE = object()      # sentinel: use ROBUSTNESS default

    def wait_drained(self, timeout=_CONFIG_DEADLINE) -> bool:
        """Block until every channel's writer finished; True only if every
        stream actually delivered EOS (an aborted connection is False, not
        'drained' — the consumer did NOT get the full stream). The default
        deadline comes from RW_DRAIN_DEADLINE_S (RobustnessConfig) and is
        SHARED across channels, not per-channel; pass None to wait
        forever."""
        if timeout is ExchangeServer._CONFIG_DEADLINE:
            timeout = ROBUSTNESS.drain_deadline_s
        end = None if timeout is None else time.monotonic() + timeout
        ok = True
        for ch in self.channels.values():
            left = None if end is None else max(0.0, end - time.monotonic())
            ok = ch.done.wait(left) and not ch.aborted and ok
        return ok

    def close(self) -> None:
        try:
            self._lsock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# receiver side (the fragment INPUT boundary)
# ---------------------------------------------------------------------------


class RemoteInput(Executor):
    """Executor over a remote exchange stream (`exchange/input.rs:167`):
    connects, then yields the peer's messages; every consumed chunk
    returns one permit so the sender's credit stays topped up."""

    def __init__(self, addr: Tuple[str, int], channel_id: int,
                 schema: Schema, append_only: bool = False):
        super().__init__(schema, f"RemoteInput[{channel_id}]")
        self.append_only = append_only
        self.addr = addr
        self.channel_id = channel_id

    def _connect(self) -> socket.socket:
        """Bounded exponential-backoff connect: worker startup can race
        the peer's listener, and transient faults (or the
        `exchange.connect` failpoint) must not kill a whole fragment when
        no stream state exists yet — before the H handshake a retry is
        always safe."""
        attempts = max(1, ROBUSTNESS.connect_attempts)
        last: Optional[Exception] = None
        for attempt in range(attempts):
            if attempt:
                from ..utils.metrics import REGISTRY
                REGISTRY.counter("exchange_connect_retries_total",
                                 "exchange connect attempts after the "
                                 "first").inc()
                time.sleep(min(1.0, ROBUSTNESS.connect_backoff_s
                               * (2 ** (attempt - 1))))
            try:
                if failpoint("exchange.connect"):
                    raise ConnectionRefusedError(
                        "failpoint exchange.connect")
                sock = socket.create_connection(
                    self.addr, timeout=ROBUSTNESS.connect_timeout_s)
                sock.settimeout(None)
                return sock
            except OSError as e:
                last = e
        raise ConnectionError(
            f"exchange connect to {self.addr} failed after "
            f"{attempts} attempts: {last}") from last

    def execute(self) -> Iterator[Message]:
        sock = self._connect()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            _send_frame(sock, b"H", struct.pack(">H", self.channel_id))
            dtypes = self.schema.dtypes
            while True:
                tag, body = _recv_frame(sock)
                if tag == b"E":
                    return
                msg = decode_message(tag, body, dtypes)
                if tag in (b"C", b"K"):
                    # refund one permit per C frame received — including
                    # frames that decode to zero rows, or the sender's
                    # credit would leak away one empty chunk at a time
                    _send_frame(sock, b"P", struct.pack(">I", 1))
                if msg is None:
                    continue
                yield msg
                if isinstance(msg, Barrier) and msg.is_stop():
                    return
        finally:
            try:
                sock.close()
            except OSError:
                pass
