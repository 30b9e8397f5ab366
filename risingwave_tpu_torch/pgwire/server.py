"""Postgres wire protocol v3 frontend.

Re-design of the reference's pgwire crate (`src/utils/pgwire/src/
pg_server.rs:46` server loop, `pg_protocol.rs` message handling): any
Postgres client (psql, psycopg, JDBC) can speak to the engine. Scope:

* startup: SSLRequest politely declined ('N'), cleartext-free trust auth
  (AuthenticationOk immediately), ParameterStatus + BackendKeyData +
  ReadyForQuery;
* simple query protocol ('Q'): multi-statement SQL, RowDescription with
  real type OIDs, text-format DataRows, per-statement CommandComplete;
* extended protocol (Parse/Bind/Describe/Execute/Sync) for the
  no-parameter statements drivers send by default; Close/Flush handled;
* errors -> ErrorResponse with SQLSTATE, connection stays usable.

The runtime is single-process: one Database behind a lock, each
connection a thread (the reference runs a session per connection over
tokio; the serialization point there is the meta/catalog too).

The port's copy of the JAX package's `pgwire/server.py`: the same bytes
on the wire for the same statements, over the port's `Database` (its
fused MVs on the card; the rows it serves carry the same Python types).
"""
from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from typing import Any, List, Optional, Tuple

from ..core.dtypes import TypeKind

# dtype kind -> (type OID, type size)
_OID = {
    TypeKind.BOOLEAN: (16, 1),
    TypeKind.INT16: (21, 2),
    TypeKind.INT32: (23, 4),
    TypeKind.INT64: (20, 8),
    TypeKind.SERIAL: (20, 8),
    TypeKind.FLOAT32: (700, 4),
    TypeKind.FLOAT64: (701, 8),
    TypeKind.DECIMAL: (1700, -1),
    TypeKind.VARCHAR: (25, -1),
    TypeKind.BYTEA: (17, -1),
    TypeKind.DATE: (1082, 4),
    TypeKind.TIME: (1083, 8),
    TypeKind.TIMESTAMP: (1114, 8),
    TypeKind.TIMESTAMPTZ: (1184, 8),
    TypeKind.INTERVAL: (1186, 16),
}


def _text(v: Any, kind: Optional[TypeKind] = None) -> Optional[bytes]:
    if v is None:
        return None
    if isinstance(v, bool):
        return b"t" if v else b"f"
    if kind == TypeKind.TIMESTAMP and isinstance(v, int):
        from datetime import datetime, timezone
        dt = datetime.fromtimestamp(v / 1_000_000, tz=timezone.utc)
        return dt.strftime("%Y-%m-%d %H:%M:%S.%f").encode()
    return str(v).encode("utf-8")


# OIDs whose text values are numeric/bool literals — substituted unquoted
_UNQUOTED_OIDS = {16, 20, 21, 23, 700, 701, 1700}

_PG_EPOCH_USECS = 946_684_800_000_000      # 2000-01-01 relative to 1970
_PG_EPOCH_DAYS = 10_957


def _decode_binary_param(raw: bytes, oid: int) -> Any:
    """Binary-format Bind value -> Python value (`pg_extended.rs` binary
    param decoding). Timestamps/dates arrive relative to 2000-01-01."""
    if oid == 16:
        return raw != b"\x00"
    if oid in (21, 23, 20):
        return int.from_bytes(raw, "big", signed=True)
    if oid == 700:
        return struct.unpack(">f", raw)[0]
    if oid == 701:
        return struct.unpack(">d", raw)[0]
    if oid == 1114:          # timestamp: usecs since 2000-01-01
        usecs = int.from_bytes(raw, "big", signed=True) + _PG_EPOCH_USECS
        return _text(usecs, TypeKind.TIMESTAMP).decode()
    if oid == 1082:          # date: days since 2000-01-01
        days = int.from_bytes(raw, "big", signed=True) + _PG_EPOCH_DAYS
        from datetime import date, timedelta
        return (date(1970, 1, 1) + timedelta(days=days)).isoformat()
    if oid in (25, 1043, 0):
        return raw.decode("utf-8")
    raise ValueError(f"binary parameter format for OID {oid} is not "
                     "supported")


def _typed_text_param(s: str, oid: int) -> Any:
    """Text-format Bind value -> Python value for AST substitution; the
    binder's implicit casts coerce strings, so unknown OIDs stay str."""
    import re
    if oid in (21, 23, 20):
        return int(s)
    if oid in (700, 701):
        return float(s)
    if oid == 16:
        return s.strip().lower() in ("t", "true", "1", "on")
    if oid == 0 and re.fullmatch(r"-?\d+", s):
        return int(s)
    if oid == 0 and re.fullmatch(r"-?\d+\.\d+([eE][+-]?\d+)?", s):
        return float(s)
    return s


def _sql_segments(sql: str):
    """(text, is_literal) segments — a $n inside a '...' or $$...$$
    string, a -- comment, or a /* */ comment is literal text, never a
    parameter placeholder (mirrors the lexer's _TOKEN_RE)."""
    out = []
    i = 0
    n = len(sql)
    plain_from = 0

    def flush(upto):
        if upto > plain_from:
            out.append((sql[plain_from:upto], False))

    while i < n:
        c = sql[i]
        if c == "'":
            j = i + 1
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    j += 2
                    continue
                if sql[j] == "'":
                    break
                j += 1
            flush(i)
            out.append((sql[i:j + 1], True))
            i = plain_from = j + 1
        elif c == "$" and i + 1 < n and sql[i + 1] == "$":
            end = sql.find("$$", i + 2)
            end = n if end == -1 else end + 2
            flush(i)
            out.append((sql[i:end], True))
            i = plain_from = end
        elif c == "-" and i + 1 < n and sql[i + 1] == "-":
            end = sql.find("\n", i)
            end = n if end == -1 else end + 1
            flush(i)
            out.append((sql[i:end], True))
            i = plain_from = end
        elif c == "/" and i + 1 < n and sql[i + 1] == "*":
            end = sql.find("*/", i + 2)
            end = n if end == -1 else end + 2
            flush(i)
            out.append((sql[i:end], True))
            i = plain_from = end
        else:
            i += 1
    flush(n)
    return out


def _count_params(sql: str) -> int:
    import re
    n = 0
    for seg, lit in _sql_segments(sql):
        if not lit:
            for m in re.finditer(r"\$(\d+)", seg):
                n = max(n, int(m.group(1)))
    return n


def _substitute_params(sql: str, values, param_oids=()) -> str:
    """Inline $n placeholders as SQL literals (text-format Bind values).
    The reference binds parameters into the bound statement's datums
    (`pg_extended.rs`); a lite frontend reaches the same semantics by
    substitution before planning. Quoting: numeric/bool OIDs (and
    numeric-looking values of unknown OID) go bare; everything else as a
    quoted string, which the binder's casts coerce."""
    import re

    def repl(m):
        i = int(m.group(1)) - 1
        if i >= len(values):
            raise ValueError(f"no value for placeholder ${i + 1}")
        v = values[i]
        if v is None:
            return "NULL"
        oid = param_oids[i] if i < len(param_oids) else 0
        if oid in _UNQUOTED_OIDS or (oid == 0 and re.fullmatch(
                r"-?\d+(\.\d+)?([eE][+-]?\d+)?", v)):
            return v
        return "'" + v.replace("'", "''") + "'"

    out = []
    for seg, lit in _sql_segments(sql):
        out.append(seg if lit else re.sub(r"\$(\d+)", repl, seg))
    return "".join(out)


class _Conn:
    def __init__(self, sock: socket.socket, db, lock: threading.Lock):
        self.sock = sock
        self.db = db
        self.lock = lock
        self._buf = b""
        self._portals: dict = {}

    # ---- raw IO ---------------------------------------------------------
    def _recv(self, n: int) -> bytes:
        while len(self._buf) < n:
            got = self.sock.recv(65536)
            if not got:
                raise ConnectionError("client closed")
            self._buf += got
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _send(self, tag: bytes, payload: bytes = b"") -> None:
        self.sock.sendall(tag + struct.pack(">I", len(payload) + 4) + payload)

    # ---- startup --------------------------------------------------------
    def startup(self) -> bool:
        while True:
            (ln,) = struct.unpack(">I", self._recv(4))
            body = self._recv(ln - 4)
            (code,) = struct.unpack(">I", body[:4])
            if code == 80877103:           # SSLRequest
                self.sock.sendall(b"N")
                continue
            if code == 80877102:           # CancelRequest: ignore politely
                return False
            break
        self._send(b"R", struct.pack(">I", 0))          # AuthenticationOk
        for k, v in (("server_version", "9.5.0"),
                     ("server_encoding", "UTF8"),
                     ("client_encoding", "UTF8"),
                     ("DateStyle", "ISO, MDY"),
                     ("standard_conforming_strings", "on")):
            self._send(b"S", k.encode() + b"\0" + v.encode() + b"\0")
        self._send(b"K", struct.pack(">II", 0, 0))      # BackendKeyData
        self._ready()
        return True

    def _ready(self) -> None:
        self._send(b"Z", b"I")

    def _error(self, msg: str, code: str = "XX000") -> None:
        fields = b"SERROR\0" + b"C" + code.encode() + b"\0" \
            + b"M" + msg.encode("utf-8", "replace") + b"\0\0"
        self._send(b"E", fields)

    # ---- query execution ------------------------------------------------
    def _row_description(self, desc: List[Tuple[str, Any]]) -> None:
        out = struct.pack(">H", len(desc))
        for name, dtype in desc:
            oid, size = _OID.get(dtype.kind, (25, -1))
            out += name.encode() + b"\0" + struct.pack(
                ">IHIhih", 0, 0, oid, size, -1, 0)
        self._send(b"T", out)

    def _data_rows(self, rows: List[Tuple], kinds: List[TypeKind]) -> None:
        for r in rows:
            out = struct.pack(">H", len(r))
            for v, k in zip(r, kinds):
                t = _text(v, k)
                out += struct.pack(">i", -1) if t is None \
                    else struct.pack(">I", len(t)) + t
            self._send(b"D", out)

    def _tag(self, result: Any, nrows: int) -> str:
        if isinstance(result, str):
            if result.startswith("INSERT_"):
                return f"INSERT 0 {result.split('_')[1]}"
            if result.startswith(("DELETE_", "UPDATE_")):
                kind, n = result.split("_", 1)
                return f"{kind} {n}"
            return result.replace("_", " ")
        return f"SELECT {nrows}"

    def _emit_text_rows(self, name: str, rows: List[Tuple],
                        suppress_desc: bool) -> None:
        from ..core import dtypes as T
        if not suppress_desc:
            self._row_description([(name, T.VARCHAR)] if not rows or
                                  len(rows[0]) == 1 else
                                  [(f"{name}{i}", T.VARCHAR)
                                   for i in range(len(rows[0]))])
        kinds = [TypeKind.VARCHAR] * (len(rows[0]) if rows else 1)
        self._data_rows(rows, kinds)
        self._send(b"C", f"SELECT {len(rows)}".encode() + b"\0")

    # ---- COPY <table> FROM STDIN ---------------------------------------
    _COPY_RE = None

    @classmethod
    def _match_copy(cls, sql: str):
        """(table, options text) for a COPY ... FROM STDIN statement, or
        None. COPY is a wire-protocol feature (CopyInResponse + CopyData
        framing), so it is recognized here rather than in the SQL
        parser — the reference routes it the same way
        (pg_protocol.rs copy-in handling)."""
        import re
        if cls._COPY_RE is None:
            cls._COPY_RE = re.compile(
                r"^\s*COPY\s+(\"?[A-Za-z_][A-Za-z0-9_]*\"?)\s+FROM\s+"
                r"STDIN\s*(.*?);?\s*$", re.IGNORECASE | re.DOTALL)
        m = cls._COPY_RE.match(sql)
        if m is None:
            return None
        opts = (m.group(2) or "").strip().rstrip(";").strip()
        if ";" in opts:
            # 'COPY t FROM STDIN; SELECT 1' — the tail is a second
            # statement, not COPY options; refuse CLEARLY instead of a
            # baffling option error (copy-in owns the whole message)
            e = ValueError("COPY FROM STDIN must be the only statement "
                           "in its message")
            e.sqlstate = "0A000"
            raise e
        return m.group(1).strip('"'), opts

    @staticmethod
    def _copy_format(opts: str) -> Tuple[str, str]:
        """(format, delimiter) from the COPY options tail; raises
        ValueError with .sqlstate = 0A000 on anything unsupported
        (BINARY, PROGRAM, unknown format names) — a clean refusal
        BEFORE CopyInResponse, so the client never starts streaming."""
        import re
        fmt, delim = "text", None
        t = opts.strip()
        if t:
            m = re.fullmatch(
                r"(?:WITH\s*)?\(\s*(.*?)\s*\)", t,
                re.IGNORECASE | re.DOTALL)
            body = m.group(1) if m else t
            for part in re.split(r",", body):
                part = part.strip()
                if not part:
                    continue
                kv = re.fullmatch(
                    r"(FORMAT|DELIMITER)\s+'?([^']*)'?", part,
                    re.IGNORECASE)
                if kv is None and part.upper() in ("CSV", "TEXT",
                                                   "BINARY"):
                    kv_k, kv_v = "FORMAT", part
                elif kv is None:
                    e = ValueError(f"COPY option {part!r} is not "
                                   "supported")
                    e.sqlstate = "0A000"
                    raise e
                else:
                    kv_k, kv_v = kv.group(1), kv.group(2)
                if kv_k.upper() == "FORMAT":
                    fmt = kv_v.strip().lower()
                else:
                    delim = kv_v
        if fmt not in ("text", "csv"):
            e = ValueError(
                f"COPY format {fmt!r} is not supported (text, csv only)")
            e.sqlstate = "0A000"
            raise e
        return fmt, delim if delim is not None \
            else ("\t" if fmt == "text" else ",")

    def _copy_push(self, table: str, chunk: str, fmt: str,
                   delim: str) -> int:
        """Admission-gated push of one framed COPY chunk. A `defer`
        verdict waits OUTSIDE the session lock — other sessions'
        queries (and the epoch ticks that refill the admission bucket)
        keep flowing while this producer is held at the wire — then
        re-acquires to retry. Past the bounded deadline the push is
        forced so COPY can never deadlock on a quiescent barrier
        clock (same contract as Database.copy_rows, minus the
        lock-held sleep)."""
        deadline = time.monotonic() + 1.0
        while True:
            with self.lock:
                verdict, n = self.db.copy_chunk(
                    table, chunk, fmt, delim,
                    force=time.monotonic() >= deadline)
            if verdict != "defer":
                return n if verdict == "admit" else 0
            time.sleep(0.01)

    def _copy_in(self, table: str, opts: str) -> None:
        """Copy-in sub-protocol: CopyInResponse, then CopyData frames
        parsed in batches through the Database's admission-gated bulk
        path (`copy_rows`) — the firehose entry point. Batches flow as
        they arrive (a producer streaming forever still makes progress);
        the final flush rides CopyDone."""
        import struct as _struct
        fmt, delim = self._copy_format(opts)
        with self.lock:
            ncols = self.db.copy_describe(table)
        self._send(b"G", b"\x00" + _struct.pack(">H", ncols)
                   + _struct.pack(">H", 0) * ncols)
        buf = b""
        rows = 0
        failed: Optional[str] = None
        while True:
            tag, body = self._recv(1), None
            (ln,) = _struct.unpack(">I", self._recv(4))
            body = self._recv(ln - 4)
            if tag == b"d":                      # CopyData
                if failed is not None:
                    continue
                buf += body
                # frame on the last newline: a CopyData boundary may
                # split a row in half. For csv the newline must also be
                # OUTSIDE quotes (even quote count before it) — quoted
                # fields may legally contain newlines
                cut = buf.rfind(b"\n")
                if fmt == "csv":
                    while cut >= 0 and buf.count(b'"', 0, cut) % 2 == 1:
                        cut = buf.rfind(b"\n", 0, cut)
                    if cut < 0 and len(buf) > (8 << 20):
                        # quote parity never evens out: a stray quote in
                        # an unquoted field (data _csv_rows accepts as
                        # literal) would otherwise buffer the stream
                        # unboundedly. Fall back to plain newline
                        # framing past the bound — which also means a
                        # WELL-FORMED quoted field larger than 8 MiB
                        # gets torn (documented limit; PG's own COPY
                        # has a 1 GiB field ceiling for the same class
                        # of reason)
                        cut = buf.rfind(b"\n")
                if cut >= 0:
                    chunk, buf = buf[:cut + 1], buf[cut + 1:]
                    try:
                        rows += self._copy_push(
                            table, chunk.decode("utf-8"), fmt, delim)
                    except Exception as e:  # noqa: BLE001
                        failed = f"{type(e).__name__}: {e}"
            elif tag == b"c":                    # CopyDone
                if failed is None and buf.strip():
                    try:
                        rows += self._copy_push(
                            table, buf.decode("utf-8"), fmt, delim)
                    except Exception as e:  # noqa: BLE001
                        failed = f"{type(e).__name__}: {e}"
                if failed is not None:
                    self._error(failed, "22P04")
                else:
                    with self.lock:
                        self.db.flush()
                    self._send(b"C", f"COPY {rows}".encode() + b"\0")
                return
            elif tag == b"f":                    # CopyFail
                self._error("COPY aborted by client: "
                            + body.rstrip(b"\0").decode("utf-8",
                                                        "replace"),
                            "57014")
                return
            elif tag == b"X":
                raise ConnectionError("client terminated during COPY")
            # Flush/Sync mid-copy: ignore, per protocol

    def _run_one(self, sql: str, suppress_desc: bool = False) -> bool:
        """Execute every statement in `sql`; returns False for an empty
        query (caller sends EmptyQueryResponse)."""
        from ..sql import ast as A
        from ..sql.parser import parse_sql_with_text
        cp = self._match_copy(sql)
        if cp is not None:
            self._copy_in(*cp)
            return True
        pairs = parse_sql_with_text(sql)
        if not pairs:
            return False
        for stmt, text in pairs:
            if isinstance(stmt, (A.Select, A.SetOp)):
                # SELECT admission: past RW_SELECT_CONCURRENCY in-flight
                # front-door SELECTs, enter() raises AdmissionRejected
                # (SQLSTATE 53000) — a clean refusal instead of an
                # unbounded queue on the coordinator lock wedging the
                # epoch loop. Counted BEFORE the lock so queued waiters
                # consume admission slots too.
                gate = getattr(self.db, "select_gate", None)
                sid = id(self)
                held = gate.enter(session=sid) if gate is not None \
                    else False
                try:
                    with self.lock:
                        # serving=True: a SELECT that reads only fused
                        # MVs skips the per-statement flush and serves
                        # from the epoch-versioned read cache
                        rows = self.db._run_batch_select(stmt,
                                                         serving=True)
                        desc = getattr(self.db, "last_description", [])
                finally:
                    if held:
                        gate.leave(session=sid)
                if not suppress_desc:
                    self._row_description(desc)
                self._data_rows(rows, [d.kind for _, d in desc])
                self._send(b"C", f"SELECT {len(rows)}".encode() + b"\0")
                continue
            with self.lock:
                result = self.db._execute(stmt)
                if isinstance(stmt, (A.CreateTable,
                                     A.CreateMaterializedView,
                                     A.CreateSink, A.DropObject,
                                     A.CreateIndex, A.CreateFunction,
                                     A.AlterParallelism)) \
                        or (isinstance(stmt, A.SetVar) and stmt.system):
                    # per-statement text, like Database.run — logging the
                    # whole multi-statement string would replay extras
                    if isinstance(stmt, A.CreateMaterializedView):
                        k = int(self.db.session_vars.get(
                            "streaming_parallelism") or 0)
                        self.db._log_ddl(f"SET streaming_parallelism TO {k}")
                    self.db._log_ddl(text)
                # statements that answer with data, not just a tag
                if isinstance(stmt, (A.Explain, A.ExplainAnalyze)):
                    self._emit_text_rows(
                        "QUERY PLAN", [(ln,) for ln in str(result).split("\n")],
                        suppress_desc)
                elif isinstance(stmt, A.ShowObjects):
                    self._emit_text_rows("Name", [(n,) for n in result],
                                         suppress_desc)
                elif isinstance(stmt, A.ShowVar):
                    if isinstance(result, list):   # SHOW ALL / PARAMETERS
                        self._emit_text_rows(
                            "setting",
                            [(str(k), str(v)) for k, v in result],
                            suppress_desc)
                    else:
                        self._emit_text_rows(stmt.name or "setting",
                                             [(str(result),)], suppress_desc)
                else:
                    self._send(b"C", self._tag(result, 0).encode() + b"\0")
        return True

    def _describe_sql(self, sql: Optional[str], statement: bool,
                      param_oids: Tuple[int, ...] = ()) -> None:
        """Describe: RowDescription for a SELECT, NoData otherwise —
        drivers bind result handling off this answer. Statement-describe
        additionally answers ParameterDescription first (pgjdbc sends
        Parse -> Describe('S') -> Bind -> Execute)."""
        from ..sql import ast as A
        from ..sql.parser import parse_sql
        if statement:
            n = max(len(param_oids), _count_params(sql or ""))
            oids = list(param_oids) + [0] * (n - len(param_oids))
            self._send(b"t", struct.pack(">H", n)
                       + b"".join(struct.pack(">I", o) for o in oids))
        # No parameters: describe the statement as-is; a planning error is
        # deterministic (it will fail at Execute too) and must surface as
        # ErrorResponse, not NoData.
        n_params = _count_params(sql or "")
        if n_params == 0:
            try:
                stmts = parse_sql(sql or "")
            except Exception:  # noqa: BLE001 — surfaces at Execute
                self._send(b"n")
                return
            if len(stmts) == 1 and isinstance(stmts[0], (A.Select, A.SetOp)):
                with self.lock:
                    desc = self.db.describe_select(stmts[0])
                self._row_description(desc)
            else:
                self._send(b"n")
            return
        # Parameterized: probe with NULL first (plans against any column
        # type, where a literal '0' would fail e.g. $1 = varchar_col),
        # falling back to '0' for grammar positions that need a numeric
        # literal (LIMIT $1). A probe failure is an artifact of the fill
        # value, so only after both fills fail is NoData answered.
        for fill in (None, "0"):
            probe = _substitute_params(sql or "", [fill] * n_params,
                                       param_oids)
            try:
                stmts = parse_sql(probe or "")
                if len(stmts) == 1 and isinstance(stmts[0],
                                                  (A.Select, A.SetOp)):
                    with self.lock:
                        desc = self.db.describe_select(stmts[0])
                    self._row_description(desc)
                    return
                break              # parsed as a non-SELECT — NoData
            except Exception:  # noqa: BLE001 — try the other fill
                continue
        self._send(b"n")

    def _bind(self, body: bytes, parse_sql_by_name) -> Tuple[bytes, dict]:
        """Bind: build a PORTAL from a prepared statement + parameter
        values (`pg_extended.rs`). The statement was parsed ONCE at
        Parse; binding substitutes literal nodes into the cached tree —
        no re-lex/re-parse per Execute. Text- and binary-format values
        accepted (ints, floats, bool, text, date/timestamp binaries)."""
        portal_name, rest = body.split(b"\0", 1)
        stmt_name, rest = rest.split(b"\0", 1)
        if stmt_name not in parse_sql_by_name:
            raise KeyError("prepared statement does not exist")
        prep = parse_sql_by_name[stmt_name]
        sql, oids = prep["sql"], prep["oids"]
        (nfmt,) = struct.unpack(">H", rest[:2])
        fmts = struct.unpack(f">{nfmt}H", rest[2:2 + 2 * nfmt])
        pos = 2 + 2 * nfmt
        (nvals,) = struct.unpack(">H", rest[pos:pos + 2])
        pos += 2
        text_vals: List[Optional[str]] = []
        typed_vals: List[Any] = []
        for i in range(nvals):
            (ln,) = struct.unpack(">i", rest[pos:pos + 4])
            pos += 4
            fmt = fmts[i] if i < len(fmts) else (fmts[0] if fmts else 0)
            oid = oids[i] if i < len(oids) else 0
            if ln < 0:
                text_vals.append(None)
                typed_vals.append(None)
                continue
            raw = rest[pos:pos + ln]
            pos += ln
            if fmt == 1:
                v = _decode_binary_param(raw, oid)
                typed_vals.append(v)
                text_vals.append(_text(v).decode()
                                 if v is not None else None)
            else:
                s = raw.decode("utf-8")
                text_vals.append(s)
                typed_vals.append(_typed_text_param(s, oid))
        need = prep["n_params"]
        if nvals < need:
            raise ValueError(f"bind supplies {nvals} parameters, "
                             f"statement needs {need}")
        from ..sql import ast as A
        stmts = None
        if prep["stmts"] is not None:
            lits = [A.Lit(v) for v in typed_vals]
            stmts = [A.bind_params(st, lits) for st in prep["stmts"]]
        portal = {
            "stmts": stmts,
            # DDL still runs through the text path (the DDL log records
            # statement text); bound text is kept for it
            "sql": _substitute_params(sql, text_vals, oids),
            "rows": None, "desc": None, "pos": 0, "done": False,
            # zero-row CommandComplete tag for re-Executing a completed
            # portal (PG yields no further rows but tags by statement
            # kind, not a blanket SELECT 0)
            "tag0": self._zero_tag(stmts, sql),
        }
        return portal_name, portal

    @staticmethod
    def _zero_tag(stmts, sql: str) -> str:
        from ..sql import ast as A
        if stmts and len(stmts) == 1:
            s = stmts[0]
            if isinstance(s, A.Insert):
                return "INSERT 0 0"
            if isinstance(s, A.Update):
                return "UPDATE 0"
            if isinstance(s, A.Delete):
                return "DELETE 0"
        kw = (sql.split() or ["SELECT"])[0].upper()
        return {"INSERT": "INSERT 0 0", "UPDATE": "UPDATE 0",
                "DELETE": "DELETE 0"}.get(kw, "SELECT 0")

    def _execute_portal(self, portal: dict, max_rows: int) -> None:
        """Run (or resume) a portal; honors the Execute row limit with
        PortalSuspended so clients can fetch incrementally
        (`pg_protocol.rs` portal execution)."""
        from ..sql import ast as A
        if portal["rows"] is None:
            stmts = portal["stmts"]
            if stmts is None or len(stmts) != 1 \
                    or not isinstance(stmts[0],
                                      (A.Select, A.SetOp, A.Insert,
                                       A.Delete, A.Update)):
                # DDL / multi-statement / unparsed: text path, no limits
                if not self._run_one(portal["sql"], suppress_desc=True):
                    self._send(b"I")
                portal["done"] = True
                return
            stmt = stmts[0]
            if isinstance(stmt, (A.Select, A.SetOp)):
                gate = getattr(self.db, "select_gate", None)
                sid = id(self)
                # SQLSTATE 53000 past the bound; False = gate disabled
                held = gate.enter(session=sid) if gate is not None \
                    else False
                try:
                    with self.lock:
                        portal["rows"] = self.db._run_batch_select(
                            stmt, serving=True)
                        portal["desc"] = getattr(self.db,
                                                 "last_description", [])
                finally:
                    if held:
                        gate.leave(session=sid)
            else:
                with self.lock:
                    result = self.db._execute(stmt)
                self._send(b"C", self._tag(result, 0).encode() + b"\0")
                portal["done"] = True
                return
        rows, pos = portal["rows"], portal["pos"]
        kinds = [d.kind for _, d in portal["desc"]]
        end = len(rows) if max_rows <= 0 else min(len(rows),
                                                  pos + max_rows)
        self._data_rows(rows[pos:end], kinds)
        portal["pos"] = end
        if end < len(rows):
            self._send(b"s")                       # PortalSuspended
        else:
            self._send(b"C", f"SELECT {len(rows)}".encode() + b"\0")
            portal["done"] = True

    # ---- protocol loop --------------------------------------------------
    def serve(self) -> None:
        if not self.startup():
            return
        parse_sql_by_name = {}
        # After an extended-protocol error, Postgres requires discarding
        # all messages until Sync (a pipelining client would otherwise get
        # statements executed after a failed step).
        skip_until_sync = False
        while True:
            tag = self._recv(1)
            (ln,) = struct.unpack(">I", self._recv(4))
            body = self._recv(ln - 4)
            if tag == b"X":                              # Terminate
                return
            if skip_until_sync and tag != b"S":
                continue                 # spec: discard everything incl. 'Q'
            if tag == b"Q":                              # simple query
                sql = body.rstrip(b"\0").decode("utf-8")
                try:
                    if not self._run_one(sql):
                        self._send(b"I")                 # EmptyQueryResponse
                except Exception as e:  # noqa: BLE001 — wire must stay up
                    # exceptions that carry their SQLSTATE (e.g. the
                    # SELECT admission gate's 53000) surface it verbatim
                    self._error(f"{type(e).__name__}: {e}",
                                getattr(e, "sqlstate", "XX000"))
                self._ready()
            elif tag == b"P":                            # Parse
                name, rest = body.split(b"\0", 1)
                sql, rest = rest.split(b"\0", 1)
                (nparams,) = struct.unpack(">H", rest[:2])
                oids = struct.unpack(f">{nparams}I", rest[2:2 + 4 * nparams])
                sql = sql.decode("utf-8")
                # parse ONCE here; Bind/Execute reuse the trees
                from ..sql import ast as A
                from ..sql.parser import parse_sql
                stmts = None
                n_params = _count_params(sql)
                try:
                    stmts = parse_sql(sql)
                    n_params = max([n_params]
                                   + [A.max_param(s) for s in stmts])
                except Exception:  # noqa: BLE001 — surfaces at Execute
                    pass           # text fallback keeps pre-parse behavior
                parse_sql_by_name[name] = {
                    "sql": sql, "oids": oids, "stmts": stmts,
                    "n_params": n_params}
                self._send(b"1")
            elif tag == b"B":                            # Bind
                try:
                    pname, portal = self._bind(body, parse_sql_by_name)
                    self._portals[pname] = portal
                    self._send(b"2")
                except Exception as e:  # noqa: BLE001
                    self._error(f"{type(e).__name__}: {e}", "08P01")
                    skip_until_sync = True
            elif tag == b"D":                            # Describe
                kind, name = body[:1], body[1:].split(b"\0", 1)[0]
                try:
                    if kind == b"S":
                        if name not in parse_sql_by_name:
                            raise KeyError("prepared statement does not "
                                           "exist")
                        prep = parse_sql_by_name[name]
                        self._describe_sql(prep["sql"], statement=True,
                                           param_oids=prep["oids"])
                    else:
                        portal = self._portals.get(name)
                        self._describe_sql(
                            portal["sql"] if portal else None,
                            statement=False)
                except Exception as e:  # noqa: BLE001 — e.g. unknown table
                    self._error(f"{type(e).__name__}: {e}", "42P01")
                    skip_until_sync = True
            elif tag == b"E":                            # Execute
                name, rest = body.split(b"\0", 1)
                (max_rows,) = struct.unpack(">I", rest[:4])
                portal = self._portals.get(name)
                try:
                    if portal is None:
                        self._error("portal does not exist", "34000")
                        skip_until_sync = True
                    elif portal["done"]:
                        # PG: a completed portal yields no further rows;
                        # the tag matches the statement kind
                        self._send(b"C", portal.get(
                            "tag0", "SELECT 0").encode() + b"\0")
                    else:
                        self._execute_portal(portal, max_rows)
                except Exception as e:  # noqa: BLE001
                    self._error(f"{type(e).__name__}: {e}",
                                getattr(e, "sqlstate", "XX000"))
                    skip_until_sync = True
            elif tag == b"C":                            # Close
                kind, name = body[:1], body[1:].split(b"\0", 1)[0]
                if kind == b"S":
                    parse_sql_by_name.pop(name, None)
                else:
                    self._portals.pop(name, None)
                self._send(b"3")
            elif tag == b"H":                            # Flush
                pass
            elif tag == b"S":                            # Sync
                skip_until_sync = False
                self._ready()
            else:
                self._error(f"unsupported message {tag!r}", "0A000")
                self._ready()


class PgServer:
    """TCP server: every Postgres client connection gets a session thread
    over the shared Database."""

    def __init__(self, db, host: str = "127.0.0.1", port: int = 0,
                 enable_embedded_udf: bool = False):
        self.db = db
        # network-reachable sessions exec() UDF bodies in-process; off by
        # default, operator opt-in only (the reference gates embedded UDFs
        # the same way). The gate rides the WIRE_SESSION thread-local of
        # THIS server's handler threads — the embedding process's own
        # Database API is never affected, and two servers sharing one db
        # (e.g. a public port and an opted-in admin port) keep independent
        # gates.
        self.enable_embedded_udf = enable_embedded_udf
        self.lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                from ..sql.database import WIRE_SESSION
                WIRE_SESSION.active = True
                WIRE_SESSION.udf_allowed = outer.enable_embedded_udf
                conn = _Conn(self.request, outer.db, outer.lock)
                try:
                    conn.serve()
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PgServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
