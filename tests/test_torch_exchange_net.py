"""The port's socket exchange (`risingwave_tpu_torch/runtime/exchange_net.py`)
against the JAX package's: the same message gives the same frame bytes
in both packages (chunks of every type, with NULLs and all four ops, a
U-/U+ pair straddling a row-frame split, barriers of every kind and
mutation, watermarks, metrics frames, permit and hello frames), each
package decodes the other's frames, and each package's `RemoteInput`
reads the other's `ExchangeServer` over loopback. The columnar K frame
pickles an object column's scalars, so an INTERVAL column's bytes name
each package's `Interval` class: there the two frames are compared
structurally, everything but the pickled class path byte for byte.
Last, the port's two-process Nexmark q4 (`runtime/exchange_demo.py`
in a subprocess feeding `RemoteInput`s here) against the port's SQL q4.
The reference's own three cases run against the port in
`test_torch_sql_mirror_misc.py` (its `test_advice_fixes.py` cases) and
here (`test_exchange_net.py`, port mode)."""
import io
import os
import pickle
import socket
import struct
import subprocess
import sys
import time
from decimal import Decimal
from pathlib import Path

import pytest

from host_parity import PKGS, REF, PORT
from sql_mirror import cases, run_case

ROOT = Path(__file__).resolve().parents[1]


def net(P):
    return P.mod("runtime.exchange_net")


def dtype(P, kind_name):
    T = P.core.dtypes
    return T.DataType(getattr(T.TypeKind, kind_name))


def value(P, kind_name, i):
    """A non-NULL value of the type, different per row `i`."""
    T = P.core.dtypes
    return {
        "BOOLEAN": bool(i % 2), "INT16": -3 + i, "INT32": 70_000 * i - 5,
        "INT64": (1 << 40) * i - 7, "FLOAT32": 1.5 * i - 0.25,
        "FLOAT64": -2.125 * i + 1e-300, "DECIMAL": Decimal(f"{i}.25"),
        "DATE": 19_000 + i, "TIME": 3_600_000_000 + i,
        "TIMESTAMP": 1_700_000_000_000_000 + i,
        "TIMESTAMPTZ": 1_700_000_000_000_001 + i,
        "INTERVAL": T.Interval(i, -i, 1_000 * i),
        "VARCHAR": f"v{i}''xé", "BYTEA": bytes([i, 0, 255]),
        "STRUCT": (i, f"s{i}"), "LIST": [i, i + 1],
        "MAP": {f"k{i}": i}, "JSONB": '{"a": %d}' % i,
        "SERIAL": 11 * i, "INT256": (1 << 200) + i,
    }[kind_name]


KINDS = [k.name for k in REF.core.dtypes.TypeKind]
# the row value encoding (C frames, state-table bytes) covers these; the
# rest raise NotImplementedError in both packages
VALUE_ENCODED = {"BOOLEAN", "INT16", "INT32", "INT64", "FLOAT32", "FLOAT64",
                 "DECIMAL", "DATE", "TIME", "TIMESTAMP", "TIMESTAMPTZ",
                 "INTERVAL", "VARCHAR", "BYTEA", "JSONB", "SERIAL"}


def chunk(P, kinds, ops=(0, 1, 2, 3), null_row=1):
    """One row per op (insert, delete, U-, U+), a second INT64 column as
    row id; row `null_row` NULL in every typed column."""
    C = P.mod("core.chunk")
    dts = [dtype(P, k) for k in kinds] + [P.core.dtypes.INT64]
    rows = []
    for i, op in enumerate(ops):
        vals = [None if i == null_row else value(P, k, i) for k in kinds]
        rows.append((C.Op(op), tuple(vals) + (i,)))
    return C.StreamChunk.from_rows(dts, rows), dts


def both(fn):
    return [fn(P) for P in PKGS]


def rows_of(ch):
    return [(int(op), tuple(r)) for op, r in ch.compact().op_rows()]


def same_value(a, b):
    """Equal values across packages: an Interval by its fields."""
    if hasattr(a, "months"):
        return (a.months, a.days, a.usecs) == (b.months, b.days, b.usecs)
    return a == b


def same_rows(a, b):
    return len(a) == len(b) and all(
        oa == ob and len(ra) == len(rb)
        and all(same_value(x, y) for x, y in zip(ra, rb))
        for (oa, ra), (ob, rb) in zip(a, b))


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_frames_equal_bytes(kind):
    (rc, rdt), (pc, pdt) = both(lambda P: chunk(P, [kind]))
    if kind in VALUE_ENCODED:
        rt, rb = net(REF).encode_message(rc, rdt)
        pt, pb = net(PORT).encode_message(pc, pdt)
        assert (pt, pb) == (rt, rb)
        # each package decodes the other's C frame
        assert same_rows(rows_of(net(PORT).decode_message(rt, rb, pdt)),
                         rows_of(pc))
        assert same_rows(rows_of(net(REF).decode_message(pt, pb, rdt)),
                         rows_of(rc))
    else:
        for P, c, d in ((REF, rc, rdt), (PORT, pc, pdt)):
            with pytest.raises(NotImplementedError):
                net(P).encode_message(c, d)
    rk = net(REF).encode_chunk_columnar(rc, rdt)
    pk = net(PORT).encode_chunk_columnar(pc, pdt)
    if kind == "INTERVAL":
        assert _k_parts(pk, pdt, PORT) == _k_parts(rk, rdt, REF)
    else:
        assert pk == rk
    # the port reads the reference's K frame (an Interval as the port's
    # class), and the reference the port's for every stdlib-typed column
    got = net(PORT).decode_message(b"K", rk, pdt)
    assert same_rows(rows_of(got), rows_of(pc))
    if kind == "INTERVAL":
        assert type(got.columns[0].values[0]) is PORT.core.dtypes.Interval
    else:
        assert same_rows(rows_of(net(REF).decode_message(b"K", pk, rdt)),
                         rows_of(rc))


def _k_parts(body, dts, P):
    """A K frame split into its fields, each object column's pickled
    scalars unpickled (an Interval as its fields, the pickle's class path
    checked to be the package's own)."""
    (n,) = struct.unpack(">I", body[:4])
    out = [n, body[4:4 + n]]
    pos = 4 + n
    for dt in dts:
        tag, vlen = struct.unpack(">BI", body[pos:pos + 5])
        pos += 5
        vb = body[pos:pos + vlen]
        pos += vlen
        (plen,) = struct.unpack(">I", body[pos:pos + 4])
        payload = body[pos + 4:pos + 4 + plen]
        pos += 4 + plen
        if tag == 1:
            assert (P.root + ".core.dtypes").encode() in payload \
                or b"Interval" not in payload
            payload = [(v.months, v.days, v.usecs) if hasattr(v, "months")
                       else v for v in pickle.loads(payload)]
        out.append((tag, vb, payload))
    assert pos == len(body)
    return out


def test_every_type_in_one_chunk_equal_bytes():
    kinds = sorted(VALUE_ENCODED)
    (rc, rdt), (pc, pdt) = both(lambda P: chunk(P, kinds, null_row=2))
    assert net(PORT).encode_message(pc, pdt) == \
        net(REF).encode_message(rc, rdt)


def test_update_pair_straddling_frame_split_equal_bytes():
    """65,536 rows with a U-/U+ pair across the u16 frame bound: both
    packages degrade it to DELETE + INSERT at the same place."""
    def frames(P):
        C = P.mod("core.chunk")
        n = net(P).MAX_FRAME_ROWS + 1
        ops = [C.Op.INSERT] * n
        ops[n - 2], ops[n - 1] = C.Op.UPDATE_DELETE, C.Op.UPDATE_INSERT
        dts = [P.core.dtypes.INT64]
        ch = C.StreamChunk.from_rows(dts, [(op, (i,))
                                           for i, op in enumerate(ops)])
        return net(P).encode_chunk_frames(ch, dts), dts
    (rf, rdt), (pf, pdt) = both(frames)
    assert len(pf) == 2 and pf == rf
    # the port decodes the reference's two frames to DELETE, INSERT
    tail = net(PORT).decode_chunk(rf[1], pdt)
    first = net(PORT).decode_chunk(rf[0], pdt)
    assert int(first.ops[-1]) == 1 and int(tail.ops[0]) == 0


def barriers(P):
    M = P.mod("ops.message")
    E = P.mod("core.epoch")
    out = []
    for kind in M.BarrierKind:
        for mut in (None, M.MutationKind.STOP, M.MutationKind.PAUSE,
                    M.MutationKind.RESUME):
            out.append(M.Barrier(E.EpochPair(7 << 16, 6 << 16), kind,
                                 M.Mutation(mut) if mut else None))
    return out


def test_barrier_frames_equal_bytes():
    rb, pb = both(barriers)
    for r, p in zip(rb, pb):
        rt = net(REF).encode_message(r, [])
        assert net(PORT).encode_message(p, []) == rt
        back = net(PORT).decode_message(*rt, [])
        assert (back.epoch.curr, back.epoch.prev, back.kind.name,
                back.mutation.kind.name if back.mutation else None) == \
            (p.epoch.curr, p.epoch.prev, p.kind.name,
             p.mutation.kind.name if p.mutation else None)


def test_unsupported_mutations_fail_loudly_in_both():
    for P in PKGS:
        M = P.mod("ops.message")
        E = P.mod("core.epoch")
        for mut in (M.MutationKind.ADD, M.MutationKind.UPDATE,
                    M.MutationKind.SOURCE_CHANGE_SPLIT,
                    M.MutationKind.THROTTLE):
            b = M.Barrier(E.EpochPair(2, 1), M.BarrierKind.BARRIER,
                          M.Mutation(mut))
            with pytest.raises(KeyError):
                net(P).encode_message(b, [])


@pytest.mark.parametrize("kind", sorted(VALUE_ENCODED))
def test_watermark_frames_equal_bytes(kind):
    def wm(P):
        M = P.mod("ops.message")
        return M.Watermark(3, dtype(P, kind), value(P, kind, 5))
    r, p = both(wm)
    rt = net(REF).encode_message(r, [])
    assert net(PORT).encode_message(p, []) == rt
    back = net(PORT).decode_message(*rt, [])
    assert back.col_idx == 3 and back.dtype.kind.name == kind
    assert same_value(back.value, p.value)
    back = net(REF).decode_message(*net(PORT).encode_message(p, []), [])
    assert same_value(back.value, r.value)


def test_metrics_frames_equal_bytes():
    payload = {"worker_epochs_total": {"type": "counter",
                                       "series": [[["q4"], 3.0]]}}
    r, p = both(lambda P: net(P).MetricsFrame(4242, 1_700_000_000.25, 77,
                                              payload))
    rt = net(REF).encode_message(r, [])
    assert net(PORT).encode_message(p, []) == rt
    back = net(PORT).decode_message(*rt, [])
    assert (back.pid, back.ts, back.epoch, back.payload) == \
        (4242, 1_700_000_000.25, 77, payload)
    # an empty heartbeat
    e = both(lambda P: net(P).encode_message(net(P).MetricsFrame(1, 2.0),
                                             []))
    assert e[0] == e[1]


class _Wire:
    """A socket stand-in recording what `_send_frame` writes."""

    def __init__(self):
        self.out = io.BytesIO()

    def sendall(self, b):
        self.out.write(b)


def test_permit_hello_eos_frames_equal_bytes():
    def frames(P):
        w = _Wire()
        send = net(P)._send_frame
        send(w, b"P", struct.pack(">I", 1))
        send(w, b"P", struct.pack(">I", 1000))
        send(w, b"H", struct.pack(">H", 65_535))
        send(w, b"E")
        return w.out.getvalue()
    r, p = both(frames)
    assert p == r


# ---------------------------------------------------------------------------
# loopback: each package's RemoteInput reads the other's ExchangeServer
# ---------------------------------------------------------------------------


def _stream(P, kinds):
    """Messages of one stream: chunks of every value-encoded type, a
    watermark, a metrics frame, barriers, ending in a stop barrier."""
    M = P.mod("ops.message")
    E = P.mod("core.epoch")
    c, dts = chunk(P, kinds)
    msgs = [c, M.Barrier(E.EpochPair(2 << 16, 1 << 16),
                         M.BarrierKind.CHECKPOINT),
            M.Watermark(0, dts[-1], 3),
            c.compact(),
            net(P).MetricsFrame(99, 5.5, 2, {}),
            M.Barrier(E.EpochPair(3 << 16, 2 << 16), M.BarrierKind.BARRIER,
                      M.Mutation(M.MutationKind.STOP))]
    return msgs, dts


def _describe(msgs):
    out = []
    for m in msgs:
        name = type(m).__name__
        if name == "StreamChunk":
            out.append(("chunk", [(o, tuple((v.months, v.days, v.usecs)
                                            if hasattr(v, "months") else v
                                            for v in r))
                                  for o, r in rows_of(m)]))
        elif name == "Barrier":
            out.append(("barrier", m.epoch.curr, m.kind.name,
                        m.mutation.kind.name if m.mutation else None))
        elif name == "Watermark":
            out.append(("watermark", m.col_idx, m.value))
        else:
            out.append((name,))
    return out


@pytest.mark.parametrize("server_pkg,input_pkg",
                         [("port", "ref"), ("ref", "port")])
def test_remote_input_reads_the_other_packages_server(server_pkg, input_pkg):
    S = PORT if server_pkg == "port" else REF
    R = PORT if input_pkg == "port" else REF
    kinds = sorted(VALUE_ENCODED)
    msgs, sdts = _stream(S, kinds)
    _rmsgs, rdts = _stream(R, kinds)
    server = net(S).ExchangeServer()
    try:
        ch = server.register(5, sdts)
        for m in msgs:
            if not isinstance(m, net(S).MetricsFrame):
                ch.send(m)
        ch.close()
        schema = R.mod("core.schema").Schema(
            [R.mod("core.schema").Field(f"c{i}", d)
             for i, d in enumerate(rdts)])
        got = list(net(R).RemoteInput(server.addr, 5, schema).execute())
        assert server.wait_drained(30)
    finally:
        server.close()
    want = [m for m in msgs if not isinstance(m, net(S).MetricsFrame)]
    assert _describe(got) == _describe(want)


def test_port_drain_reads_reference_metrics_frames():
    """A MetricsFrame from a reference sender reaches the port's reader
    (the coordinator's drain consumes it) with its payload intact."""
    server = net(REF).ExchangeServer()
    try:
        dts = [REF.core.dtypes.INT64]
        ch = server.register(0, dts)
        ch.send(net(REF).MetricsFrame(7, 1.25, 3, {"x": 1}))
        ch.close()
        schema = PORT.mod("core.schema").Schema(
            [PORT.mod("core.schema").Field("k", PORT.core.dtypes.INT64)])
        got = list(net(PORT).RemoteInput(server.addr, 0, schema).execute())
    finally:
        server.close()
    assert len(got) == 1 and isinstance(got[0], net(PORT).MetricsFrame)
    assert (got[0].pid, got[0].ts, got[0].epoch, got[0].payload) == \
        (7, 1.25, 3, {"x": 1})


# ---------------------------------------------------------------------------
# the port's two-process Nexmark q4 (runtime/exchange_demo.py)
# ---------------------------------------------------------------------------


N_EVENTS, CHUNK, K = 20_000, 256, 3


def test_port_two_process_nexmark_q4_parity():
    """Process A: the port's exchange_demo producer (source + hash
    dispatch + ExchangeServer) in a subprocess; process B (here): the
    port's RemoteInputs -> HashAgg fragments -> aligned Merge. The MV
    equals the port's single-process SQL q4."""
    from risingwave_tpu_torch.core import dtypes as T
    from risingwave_tpu_torch.core.chunk import StreamChunk
    from risingwave_tpu_torch.expr.agg import AggCall
    from risingwave_tpu_torch.expr.expression import InputRef
    from risingwave_tpu_torch.ops import (Barrier, Channel, HashAggExecutor,
                                          MergeExecutor, ProjectExecutor)
    from risingwave_tpu_torch.ops.exchange import FragmentPump
    from risingwave_tpu_torch.runtime.exchange_demo import BID_SCHEMA
    from risingwave_tpu_torch.runtime.exchange_net import RemoteInput
    from risingwave_tpu_torch.sql import Database

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "risingwave_tpu_torch.runtime.exchange_demo",
         "producer", str(port), str(N_EVENTS), str(K), str(CHUNK)],
        cwd=str(ROOT), env=env)
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=0.2).close()
                break
            except OSError:
                time.sleep(0.2)
        pumps, outs = [], []
        for i in range(K):
            remote = RemoteInput(("127.0.0.1", port), i, BID_SCHEMA,
                                 append_only=True)
            proj = ProjectExecutor(remote, [InputRef(0, T.INT64),
                                            InputRef(2, T.INT64)],
                                   ["auction", "price"])
            price = InputRef(1, T.INT64)
            agg = HashAggExecutor(proj, [0], [AggCall("count"),
                                              AggCall("sum", price),
                                              AggCall("max", price)])
            out = Channel(capacity=1 << 20)
            pumps.append(FragmentPump(agg, out))
            outs.append(out)
        merge = MergeExecutor(outs, pumps[0].execu.schema, pumps=pumps)
        mv = {}
        for msg in merge.execute():
            if isinstance(msg, StreamChunk):
                for op, r in msg.compact().op_rows():
                    if op.is_insert:
                        mv[r[0]] = r[1:]
                    elif mv.get(r[0]) == r[1:]:
                        del mv[r[0]]
            elif isinstance(msg, Barrier) and msg.is_stop():
                break
    finally:
        # the producer lingers until its consumers hang up (the writer's
        # permit reader), as in the reference's case
        proc.terminate()
        proc.wait(timeout=30)
    db = Database()
    db.run("CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,"
           " channel VARCHAR, url VARCHAR, date_time TIMESTAMP,"
           " extra VARCHAR) WITH (connector='nexmark',"
           f" nexmark.table='bid', nexmark.max.events='{N_EVENTS}',"
           f" nexmark.chunk.size='{CHUNK}')")
    db.run("CREATE MATERIALIZED VIEW q4 AS SELECT auction, count(*) AS c,"
           " sum(price) AS s, max(price) AS m FROM bid GROUP BY auction")
    for _ in range(N_EVENTS // (64 * CHUNK) + 3):
        db.tick()
    want = {r[0]: tuple(r[1:]) for r in db.query("SELECT * FROM q4")}
    assert len(mv) == len(want) > 50
    assert mv == want


# the reference's own cases, against the port: all three in port mode
# (the q4 case's SQL oracle builds a `Database`, which would make it a
# mirror case; its exchange is what is held here). Its producer runs the
# reference's `exchange_demo` by module name, so that case also holds
# the port's `RemoteInput` to a reference sender.
REF_CASES = [(cid if cid.endswith("@port") else cid + "@port", f, q, kw,
              "port")
             for cid, f, q, kw, _mode in cases("test_exchange_net.py")]


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0])
                                  for c in REF_CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch)
