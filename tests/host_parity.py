"""Shared harness of the host-executor parity tests: one graph built in
each package, driven barrier by barrier, and a trace of what it emitted
and what its stores held after every barrier.

`HostPkg` gathers one package's executor-level names (the reference's or
the port's). `drive_job` runs a `StreamJob` over per-barrier feeds and
`drive_exec` runs a scripted executor to its end; both return a trace:
per barrier, the barrier, the chunks (ops, visibility, and per column its
type, validity and values) and watermarks emitted since the one before,
and every non-empty table of every store given, row by row. Values are
normalized so the two packages' traces compare with `==`: floats by their
exact bits (`float.hex`), Decimals by their digits, enums by name, and
pickled bytes — a host agg's group state, whose pickle names the module
that made it — by the fields of the object they unpickle to.

Barrier epochs come from the wall clock; `fixed_epochs` makes both
packages' injectors count instead (one millisecond of epoch a barrier),
and `fixed_row_ids` pins `RowIdGenExecutor`'s clock."""
from __future__ import annotations

import enum
import importlib
import pickle
from decimal import Decimal

import numpy as np
import pytest

EPOCH_STEP = 1 << 16                    # one millisecond of epoch


class HostPkg:
    """One package's host-executor names."""

    def __init__(self, root: str, **exec_kw):
        self.root = root
        self.core = self.mod("core")
        self.T = self.core.dtypes
        self.Op, self.StreamChunk, self.Schema, self.Column = (
            self.core.Op, self.core.StreamChunk, self.core.Schema,
            self.core.Column)
        self.ops = self.mod("ops")
        self.msg = self.mod("ops.message")
        self.expr = self.mod("expr")
        self.state = self.mod("state")
        self.hummock = self.mod("state.hummock")
        self.conn = self.mod("connectors")
        self.ListReader = self.mod("connectors.datagen").ListReader
        self.StreamJob = self.mod("runtime").StreamJob
        self.epoch = self.mod("core.epoch")
        self.vnode = self.mod("core.vnode")
        self.exec_kw = exec_kw            # device="cpu" for the port

    def mod(self, name):
        return importlib.import_module(f"{self.root}.{name}")

    def dt(self, name):
        return getattr(self.T, name)

    def schema(self, kinds, names=None):
        names = names or [f"c{i}" for i in range(len(kinds))]
        return self.Schema.of(*[(n, self.dt(k))
                                for n, k in zip(names, kinds)])

    def chunk(self, kinds, op_rows):
        """StreamChunk of (op, row) pairs; an op is an `Op` value."""
        return self.StreamChunk.from_rows([self.dt(k) for k in kinds],
                                          [(self.Op(o), r)
                                           for o, r in op_rows])

    def ref(self, i, kind):
        return self.expr.InputRef(i, self.dt(kind))

    def lit(self, v, kind):
        return self.expr.Literal(v, self.dt(kind))

    def func(self, name, *args):
        return self.expr.build_func(name, list(args))

    def agg(self, kind, arg=None, kind_t="INT64", **kw):
        return self.expr.AggCall(kind, None if arg is None
                                 else self.ref(arg, kind_t), **kw)

    def barrier(self, e, checkpoint=True):
        kind = (self.msg.BarrierKind.CHECKPOINT if checkpoint
                else self.msg.BarrierKind.BARRIER)
        return self.msg.Barrier(self.msg.EpochPair(e, e - 1), kind=kind)

    def watermark(self, col, v, kind="INT64"):
        return self.msg.Watermark(col, self.dt(kind), v)

    def feed(self, kinds, msgs, append_only=False):
        """A scripted executor yielding `msgs` (chunks, watermarks,
        barriers) — the reference tests' `MessageList` / `Feed`."""
        ops = self.ops

        class Feed(ops.Executor):
            def __init__(self, schema, msgs):
                super().__init__(schema, "Feed")
                self.msgs = msgs

            def execute(self):
                yield from self.msgs
        f = Feed(self.schema(kinds), msgs)
        f.append_only = append_only
        return f


REF = HostPkg("risingwave_tpu")
PORT = HostPkg("risingwave_tpu_torch", device="cpu")
PKGS = (REF, PORT)
I, D, UD, UI = 0, 1, 2, 3               # Op values: insert, delete, U-, U+


@pytest.fixture
def fixed_epochs(monkeypatch):
    """Both packages' barrier injectors count epochs instead of reading
    the wall clock (the first epoch is one millisecond)."""
    for P in PKGS:
        monkeypatch.setattr(P.mod("ops.source"), "now_epoch",
                            lambda prev=0: prev + EPOCH_STEP)


@pytest.fixture
def fixed_row_ids(monkeypatch):
    """`RowIdGenExecutor` reads the same clock value in both packages."""
    for P in PKGS:
        monkeypatch.setattr(P.mod("ops.simple").RowIdGenExecutor,
                            "_now_ms", lambda self: 1_700_000_000_000)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def norm(v, depth=0):
    """A value as nested tuples that compare equal across packages."""
    if depth > 64:
        raise ValueError("norm: nesting too deep")
    d = depth + 1
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return ("b", bool(v))
    if isinstance(v, enum.Enum):
        return ("enum", type(v).__name__, v.name)
    if isinstance(v, (int, np.integer)):
        return ("i", int(v))
    if isinstance(v, (float, np.floating)):
        return ("f", float(v).hex())
    if isinstance(v, str):
        return ("s", v)
    if isinstance(v, Decimal):
        return ("d", str(v))
    if isinstance(v, (bytes, bytearray)):
        if v[:1] == b"\x80":
            try:
                obj = pickle.loads(v)
            except Exception:           # noqa: BLE001 — plain bytes
                pass
            else:
                return ("pickle", norm(obj, d))
        return ("y", bytes(v))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [norm(x, d) for x in v])
    if isinstance(v, dict):
        return ("dict", sorted(((norm(k, d), norm(x, d))
                                for k, x in v.items()), key=repr))
    attrs = {}
    for cls in type(v).__mro__:
        for s in getattr(cls, "__slots__", ()):
            if hasattr(v, s):
                attrs[s] = getattr(v, s)
    attrs.update(getattr(v, "__dict__", {}))
    if not attrs:
        raise TypeError(f"norm: no rule for {type(v).__name__}")
    return ("obj", type(v).__name__,
            sorted((k, norm(x, d)) for k, x in attrs.items()))


def norm_chunk(c):
    """ops, visibility, and per column (type, validity, values where
    valid) of every row, visible or not."""
    cols = []
    for col in c.columns:
        valid = col.validity.tolist()
        vals = col.values
        cols.append((repr(col.dtype), valid,
                     [norm(vals[i]) if ok else None
                      for i, ok in enumerate(valid)]))
    return ("chunk", c.ops.tolist(), c.vis_mask().tolist(), cols)


def norm_msg(P, m):
    if isinstance(m, P.StreamChunk):
        return norm_chunk(m)
    if isinstance(m, P.msg.Barrier):
        mut = None if m.mutation is None else m.mutation.kind.name
        return ("barrier", m.epoch.curr, m.epoch.prev, m.kind.name, mut)
    if isinstance(m, P.msg.Watermark):
        return ("wm", m.col_idx, repr(m.dtype), norm(m.value))
    raise TypeError(f"unknown message {type(m).__name__}")


def store_tables(store):
    """Table ids a store holds rows of (memory or spill)."""
    if hasattr(store, "tables"):
        return sorted(store.tables)
    tids = {int(t) for t in store._manifest["tables"]}
    tids |= {t for _, t in store._deltas}
    return sorted(tids)


def dump_store(store):
    """Every non-empty table: (table id, [(key bytes, row)...])."""
    out = []
    for tid in store_tables(store):
        rows = [(k, norm(v)) for k, v in store.iter_range(tid, None, None)]
        if rows:
            out.append((tid, rows))
    return out


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def drive_job(P, top, injector, stores, readers=(), feeds=None,
              max_barriers=500):
    """Run `StreamJob(top)` barrier by barrier. `feeds[b][i]` are the
    chunks pushed to `readers[i]` before barrier b + 1 (the initial
    barrier comes first); then (or with no feeds) barriers run until two
    in a row see no chunk, as `run_until_idle` does. Returns the trace."""
    stores = list(stores)
    job = P.StreamJob(top, injector, stores[0])
    job.collect_output = True
    trace = []

    def step():
        n0 = job.chunks_seen
        b = job.run_until_barrier()
        trace.append((None if b is None else norm_msg(P, b),
                      [norm_chunk(c) for c in job.output_chunks],
                      [dump_store(s) for s in stores]))
        job.output_chunks.clear()
        return b is not None, job.chunks_seen != n0

    step()                                   # the initial barrier
    for per_reader in feeds or ():
        for reader, chunks in zip(readers, per_reader):
            for c in chunks:
                reader.push(c)
        alive, _ = step()
        assert alive, "the stream ended before its feeds"
    quiet = 0
    for _ in range(max_barriers):
        if job.stopped:
            break
        alive, moved = step()
        if not alive:
            break
        quiet = 0 if moved else quiet + 1
        if quiet >= 2:
            break
    return trace


def drive_exec(P, top, stores=(), limit=100_000):
    """Run an executor's `execute()` to its end: every message, with
    the stores' tables after each barrier."""
    trace = []
    for i, m in enumerate(top.execute()):
        assert i < limit, "executor did not end"
        trace.append(norm_msg(P, m))
        if isinstance(m, P.msg.Barrier):
            trace.append(("stores", [dump_store(s) for s in stores]))
    return trace


def assert_same(ref, port, what="trace"):
    """Equal traces, failing at the first entry that differs."""
    assert len(ref) > 0, f"{what}: empty"
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"{what}: entry {i} differs\nref:  {a!r:.2000}\n" \
                       f"port: {b!r:.2000}"
    assert len(ref) == len(port), f"{what}: {len(ref)} vs {len(port)} entries"


def sources(P, injector, specs, append_only=False):
    """ListReader-fed sources: specs = [kinds...] -> (readers, execs)."""
    readers, execs = [], []
    for kinds in specs:
        r = P.ListReader([])
        readers.append(r)
        execs.append(P.ops.SourceExecutor(P.schema(kinds), r, injector,
                                          append_only=append_only))
    return readers, execs


def epoch_feeds(P, specs, op_rows_lists, per_barrier):
    """Per-barrier feeds for sources of kinds `specs`: op_rows_lists[i] is
    source i's list of chunks, each a list of (op, row). With
    `per_barrier` each chunk gets a barrier of its own (source by source,
    chunk k of every source before barrier k + 1); else every chunk comes
    in the first epoch, as a ListReader given all of them would."""
    chunks = [[P.chunk(kinds, orl) for orl in lists]
              for kinds, lists in zip(specs, op_rows_lists)]
    if not per_barrier:
        return [chunks]
    n = max(len(c) for c in chunks)
    return [[c[k:k + 1] for c in chunks] for k in range(n)]
