"""The port's Postgres wire server (`risingwave_tpu_torch/pgwire/`) held
to the JAX package's byte for byte.

Every case of the JAX package's `tests/test_pgwire.py`, and its three
wire cases elsewhere (`test_advice_fixes.py`: the embedded-UDF gate and a
completed portal's re-Execute tag; `test_overload.py`: the SELECT
admission gate's SQLSTATE 53000), runs twice in one test: once as the
reference file is (its `PgServer` and `Database`), once with every import
of the JAX package bound to the port's (`sql_mirror.load(..., "port")`:
the port's server over the port's `Database` on the CPU). Each package
reads its own fake clock from the same instant (`pin_clocks`), and each
run gets a data directory of its own.

Every byte a client socket receives is recorded, per connection in the
order the connections open, and split into protocol messages. The two
runs' messages must be equal, exactly, but for BackendKeyData's process
id and secret key (masked). The case's own asserts hold each run too."""
import socket
import struct
import time

import pytest

from sql_mirror import pin_clocks, run_case

CASES = ([("test_pgwire.py", name) for name in (
    "test_startup_and_simple_query", "test_error_keeps_connection_usable",
    "test_streaming_ddl_over_the_wire", "test_ssl_request_declined_then_plain",
    "test_extended_protocol", "test_show_and_explain_return_rows",
    "test_empty_query_response",
    "test_multi_statement_ddl_log_replays_once",
    "test_two_concurrent_connections", "test_describe_statement_vs_portal",
    "test_extended_error_discards_until_sync",
    "test_describe_unknown_table_sends_error_not_disconnect",
    "test_extended_query_with_parameters",
    "test_prepared_statement_plan_once_execute_many",
    "test_binary_parameters", "test_portal_row_limit_and_suspend",
    "test_copy_from_stdin_text_and_csv",
    "test_copy_unsupported_format_sqlstate_0a000",
    "test_copy_fail_and_bad_rows", "test_copy_rides_the_admission_gate",
    "test_copy_defer_waits_outside_session_lock",
    "test_copy_escapes_and_quoting_edge_cases")]
    + [("test_advice_fixes.py", "test_pgwire_rejects_embedded_udf_by_default"),
       ("test_advice_fixes.py",
        "test_completed_portal_reexecute_keeps_statement_tag"),
       ("test_overload.py",
        "test_pgwire_select_admission_rejects_with_sqlstate_53000")])


class _Recording:
    """A client socket that keeps every byte it receives."""

    def __init__(self, sock, log):
        self._sock, self._log = sock, log

    def recv(self, n, *a):
        got = self._sock.recv(n, *a)
        self._log.append(got)
        return got

    def __getattr__(self, name):
        return getattr(self._sock, name)


def messages(stream: bytes):
    """A connection's received bytes as (tag, body) messages; a tail that
    is no whole message (the SSLRequest's one-byte answer) stays raw.
    BackendKeyData's process id and secret are masked."""
    out, pos = [], 0
    while len(stream) - pos >= 5:
        tag = stream[pos:pos + 1]
        (ln,) = struct.unpack(">I", stream[pos + 1:pos + 5])
        if ln < 4 or pos + 1 + ln > len(stream):
            break
        body = stream[pos + 5:pos + 1 + ln]
        out.append((tag, b"<pid, secret>" if tag == b"K" else body))
        pos += 1 + ln
    if pos < len(stream):
        out.append(("raw", stream[pos:]))
    return out


def _recorded(ref_file, qual, mode, base_ms, tmp_path, monkeypatch):
    conns = []
    real = socket.create_connection

    def create_connection(*a, **kw):
        log = []
        conns.append(log)
        return _Recording(real(*a, **kw), log)
    d = tmp_path / mode
    d.mkdir()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(socket, "create_connection", create_connection)
        pin_clocks(m, base_ms)
        run_case(ref_file, qual, {}, mode, d, monkeypatch)
    return [messages(b"".join(log)) for log in conns]


@pytest.mark.parametrize("ref_file,qual", CASES,
                         ids=[f"{f[:-3]}::{q}" for f, q in CASES])
def test_wire_bytes_equal(ref_file, qual, tmp_path, monkeypatch):
    base_ms = int(time.time() * 1000)
    ref = _recorded(ref_file, qual, "ref", base_ms, tmp_path, monkeypatch)
    port = _recorded(ref_file, qual, "port", base_ms, tmp_path, monkeypatch)
    assert len(port) == len(ref), (len(port), len(ref))
    assert any(ref), "the case received nothing"
    for i, (a, b) in enumerate(zip(ref, port)):
        for j, (ma, mb) in enumerate(zip(a, b)):
            assert ma == mb, (f"connection {i}, message {j}:\n"
                              f"ref:  {ma!r:.2000}\nport: {mb!r:.2000}")
        assert len(a) == len(b), (f"connection {i}: {len(a)} messages "
                                  f"from the reference, {len(b)} from the "
                                  f"port")


# ---------------------------------------------------------------------------
# fused MVs over the wire: q5 and q7 (a TIMESTAMP column), a portal,
# COPY into a device-path MV
# ---------------------------------------------------------------------------

FUSED_EVENTS, FUSED_CHUNK = 1 << 14, 1 << 6     # 4 fused epochs of 4096


def _fused_session(mode, d):
    """CREATE SOURCE / q5 / q7 over the wire into fused jobs, FLUSH until
    both drain, `SELECT *` of each, a one-parameter portal over q7 under
    a row limit of 2, and COPY (csv) into a table with a device group-by
    over it, read back — through the smoke's own client (`PgClient`)."""
    from chip_smoke import (SQL_BID_SRC, SQL_Q5_MV, SQL_Q7_MV, PgClient,
                            wire_rows)
    if mode == "ref":
        from risingwave_tpu.config import DeviceConfig
        from risingwave_tpu.pgwire import PgServer
        from risingwave_tpu.sql import Database
        db = Database(data_dir=d, checkpoint_frequency=1,
                      device=DeviceConfig(capacity=1 << 10,
                                          aot_compile=False))
    else:
        from risingwave_tpu_torch.config import DeviceConfig
        from risingwave_tpu_torch.pgwire import PgServer
        from risingwave_tpu_torch.sql import Database
        db = Database(data_dir=d, checkpoint_frequency=1,
                      device=DeviceConfig(capacity=1 << 10),
                      torch_device="cpu")
    srv = PgServer(db).start()
    try:
        c = PgClient(srv.host, srv.port)
        c.startup()
        c.query(SQL_BID_SRC.format(n=FUSED_EVENTS, c=FUSED_CHUNK))
        c.query(SQL_Q5_MV)
        c.query(SQL_Q7_MV)
        jobs = [db._fused["nexmark_q5"], db._fused["nexmark_q7"]]
        while not all(j.drained for j in jobs):
            c.query("FLUSH")
        c.query("FLUSH")
        q5 = wire_rows(c.query("SELECT * FROM nexmark_q5"))
        q7 = wire_rows(c.query("SELECT * FROM nexmark_q7"))
        # q7's date_time, a TIMESTAMP, decodes to the engine's microseconds
        assert q5 and q7 and all(isinstance(r[3], int) for r in q7)
        msgs, suspended = c.portal(
            "SELECT * FROM nexmark_q7 WHERE price >= $1", (20,), (b"0",), 2)
        assert wire_rows(msgs) == q7 and suspended >= 1
        c.query("CREATE TABLE cp (k BIGINT, v BIGINT)")
        c.query("CREATE MATERIALIZED VIEW cpa AS SELECT k, count(*) AS c,"
                " sum(v) AS s FROM cp GROUP BY k")
        c.copy("COPY cp FROM STDIN WITH (FORMAT csv)",
               ["".join(f"{i % 7},{i * 3 - 50}\n"
                        for i in range(500)).encode()])
        assert len(wire_rows(c.query("SELECT * FROM cpa"))) == 7
        c.close()
    finally:
        srv.stop()


def test_fused_mvs_over_the_wire_bytes_equal(tmp_path):
    """q5 and q7 created, driven and read over each package's server,
    the port's on the CPU: every message equal (BackendKeyData masked)."""
    base_ms = int(time.time() * 1000)
    runs = {}
    for mode in ("ref", "port"):
        conns = []
        real = socket.create_connection

        def create_connection(*a, conns=conns, real=real, **kw):
            log = []
            conns.append(log)
            return _Recording(real(*a, **kw), log)
        d = tmp_path / mode
        d.mkdir()
        with pytest.MonkeyPatch.context() as m:
            m.setattr(socket, "create_connection", create_connection)
            pin_clocks(m, base_ms)
            _fused_session(mode, str(d))
        runs[mode] = [messages(b"".join(log)) for log in conns]
    ref, port = runs["ref"], runs["port"]
    assert len(ref) == len(port) == 1
    for j, (ma, mb) in enumerate(zip(ref[0], port[0])):
        assert ma == mb, (f"message {j}:\nref:  {ma!r:.2000}\n"
                          f"port: {mb!r:.2000}")
    assert len(ref[0]) == len(port[0])
