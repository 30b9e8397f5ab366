"""Database: the single-process control plane + session surface (the
port's own copy of the JAX package's `sql/database.py`).

Plays the combined role of the reference's frontend session
(`src/frontend/src/session.rs`), meta DDL controller
(`src/meta/src/rpc/ddl_controller.rs:295`) and barrier worker
(`src/meta/src/barrier/worker.rs:380`): executes statements, owns the
catalog, spawns streaming jobs, ticks barriers through ALL jobs, and
commits epochs to the state store.

Dataflow topology: every table/source/MV materializes into a state table
and exposes its change stream through a `SharedStream`; downstream MVs tap
a port and prepend a backfill snapshot (the `backfill/` executor analog —
consistent because DDL happens between barriers, so a new port sees exactly
the changes after the snapshot).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..connectors import ListReader
from ..connectors.nexmark import NexmarkReader
from ..connectors.datagen import DatagenReader
from ..core import dtypes as T
from ..core.chunk import Column, Op, StreamChunk
from ..core.dtypes import DataType
from ..core.schema import Field, Schema
from ..ops import (Barrier, BarrierInjector, BatchScan, ConflictBehavior,
                   MaterializeExecutor, RowIdGenExecutor, SourceExecutor,
                   WatermarkFilterExecutor)
from ..ops.executor import Executor, SharedStream
from ..ops.message import Message, Watermark
from ..state import MemoryStateStore, SpillStateStore, StateStore, StateTable
from . import ast as A
from .catalog import Catalog, CatalogObject
from .parser import parse_sql
from .planner import Binder, Namespace, Planner, type_from_name

ROWID = "_row_id"
# DDL log layout (shared with the JAX package's `ctl`): table id 0 holds
# (seq, sql) rows keyed by seq
import threading

# Set (active=True) by pgwire handler threads: statements arriving over the
# network carry this marker so security-sensitive DDL (embedded UDFs) can be
# gated per-connection without touching the embedding process's local API.
WIRE_SESSION = threading.local()

DDL_LOG_TABLE_ID = 0
DDL_LOG_DTYPES = (T.INT64, T.VARCHAR)
DDL_LOG_PK = (0,)
# durable poison-pill dead-letter queue (fault-tolerance v3): a reserved
# table id far above anything the catalog allocates, shared by every job
# in the directory (rows carry the job name) and readable standalone by
# `risectl dlq` without a Database
DLQ_TABLE_ID = 0x7EAD
# durable shed-window audit log (overload control plane): same reserved-
# id pattern as the dead-letter queue — one row per source window shed
# under RW_LOAD_SHED, readable standalone (rw_shed_log)
SHED_TABLE_ID = 0x5EED


class _Backfill(Executor):
    """Yield the upstream snapshot in bounded chunks, then the live
    change stream (`arrangement_backfill.rs` analog — snapshot is
    consistent because DDL runs between barriers). Progress (rows
    emitted / total) is tracked per executor and surfaced through
    `rw_ddl_progress` (the meta `barrier/progress.rs` reporting)."""

    CHUNK = 1024

    def __init__(self, snapshot: Optional[StreamChunk], port: Executor,
                 upstream_name: str = ""):
        super().__init__(port.schema, "Backfill")
        self.append_only = port.append_only
        self.snapshot = snapshot
        self.port = port
        self.upstream_name = upstream_name
        self.total = snapshot.capacity if snapshot is not None else 0
        self.emitted = 0
        self.done = self.total == 0

    @property
    def progress(self) -> float:
        return 1.0 if self.done else self.emitted / max(1, self.total)

    def execute(self) -> Iterator[Message]:
        if self.snapshot is not None and self.snapshot.capacity:
            cols = self.snapshot.columns
            n = self.snapshot.capacity
            for lo in range(0, n, self.CHUNK):
                hi = min(n, lo + self.CHUNK)
                idx = np.arange(lo, hi)
                yield StreamChunk(self.snapshot.ops[lo:hi],
                                  [c.take(idx) for c in cols])
                self.emitted = hi
        self.done = True
        yield from self.port.execute()


def _walk_executors(root) -> Iterator[Any]:
    """Walk an executor tree through the common child attributes.
    `pumps` descends through a Merge's upstream dispatchers into NESTED
    remote fragment sets (an agg set fed by a join set) — without it the
    liveness sweep, EXPLAIN ANALYZE and the dead-letter wiring only saw
    the topmost set of a multi-set topology."""
    stack = [root]
    seen = set()
    while stack:
        e = stack.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        yield e
        for attr in ("input", "left_exec", "right_exec", "port",
                     "inputs", "pumps"):
            v = getattr(e, attr, None)
            if isinstance(v, list):
                stack.extend(v)
            elif v is not None:
                stack.append(v)


class Database:
    def __init__(self, store: Optional[StateStore] = None,
                 data_dir: Optional[str] = None,
                 checkpoint_frequency: Optional[int] = None,
                 device=None, config=None, torch_device=None):
        # node config tier: explicit ctor args override the config file
        from ..config import NodeConfig, SystemParams, default_session_vars
        if isinstance(config, str):
            config = NodeConfig.from_toml(config)
        self.config = config or NodeConfig()
        if data_dir is None:
            data_dir = self.config.storage.data_dir
        if device is None:
            device = self.config.device
        if checkpoint_frequency is None:
            checkpoint_frequency = self.config.streaming.checkpoint_frequency
        if store is None:
            store = (SpillStateStore(data_dir) if data_dir
                     else MemoryStateStore())
        self.store = store
        # system-param + session-var tiers
        self.system_params = SystemParams()
        self.system_params.values["checkpoint_frequency"] = \
            checkpoint_frequency
        self.session_vars = default_session_vars()
        # SQL->device dispatch policy (config.resolve_device): None = host-only.
        # Must match the value used when this data directory was created —
        # device-path state tables persist raw payload columns, host-path
        # tables persist pickled AggGroups — so the policy is recorded next
        # to the durable store and validated on reopen (fail fast instead of
        # corrupting recovered state).
        from ..config import resolve_device
        # device="auto": adopt whatever policy the data directory was
        # created with (inspection tools — risectl — must be able to open
        # any directory without knowing its policy, and must not stamp a
        # marker onto one that has none)
        self._marker_readonly = device == "auto"
        # `torch_device` (the port's own argument) names the devices of
        # the device path: one device, or a sequence of them. Every mesh
        # this Database makes (a fused job's, the int form's, a
        # PARALLELISM rescale's) lays its shards over its `device_set` —
        # every visible card from a CUDA device, the CPU alone, or the
        # sequence as given — kept as `mesh_devices`; its first entry,
        # `self.torch_device`, is shard 0's and the planner's device
        # executors'. None resolves to `cuda:0` and raises with no GPU; a
        # host-only Database never resolves it.
        if device == "auto":
            device = self._device_from_marker(data_dir, torch_device)
        from ..parallel import device_set, make_mesh
        if isinstance(device, int) and not isinstance(device, bool):
            from ..config import DeviceConfig
            device = DeviceConfig(mesh=make_mesh(device,
                                                 devices=torch_device))
        self.device = resolve_device(device)
        self.mesh_devices = (None if self.device is None
                             else device_set(torch_device))
        self.torch_device = (None if self.device is None
                             else self.mesh_devices[0])
        self._check_device_marker()
        self.catalog = Catalog()
        # per-barrier span tree (inject -> per-job collect -> commit),
        # ring-buffered for rw_barrier_trace and file-logged in the data
        # dir for offline hang diagnosis (risectl trace)
        from ..utils.trace import BarrierTracer
        self.tracer = BarrierTracer(data_dir)
        # flight recorder (utils/blackbox.py): point the process-wide
        # telemetry ring's on-disk mirror at this data dir so a crash or
        # wedge leaves its last seconds readable by `risectl blackbox`
        from ..utils.blackbox import RECORDER
        RECORDER.attach(data_dir)
        RECORDER.record("boot", {"device": repr(device),
                                 "data_dir": data_dir})
        # source->MV freshness (utils/freshness.py): every MV commit
        # records ingest->commit wall; surfaced as rw_mv_freshness + the
        # mv_freshness_seconds histogram
        from ..utils.freshness import FreshnessTracker
        self._freshness = FreshnessTracker()
        # oldest ingest stamp of the barriers in the CURRENT checkpoint
        # window (host MVs commit whole windows at once; freshness must
        # anchor on the window's oldest event, not the sealing barrier's)
        self._window_ingest: Optional[float] = None
        # fused jobs mirror epoch-profile records here (risectl profile)
        self._data_dir = data_dir
        self.injector = BarrierInjector(checkpoint_frequency)
        self.sinks: List[Tuple[str, Iterator[Message]]] = []   # job pumps
        self._iters: Dict[str, Iterator[Message]] = {}
        # fused device jobs (whole-fragment epoch programs, device/fused.py)
        self._fused: Dict[str, Any] = {}
        # capacity high-water of DROPPED fused jobs, keyed by PLAN-SHAPE
        # HASH -> {node shape key -> caps}: a re-created MV with the same
        # plan shape — under any name — presizes from its predecessor
        # instead of re-climbing the growth ladder (try_fuse
        # cap_registry). Structural keys survive planner refactors; they
        # are the same keys the AOT compile manifest uses.
        self._fused_cap_hw: Dict[str, Dict[str, Dict[str, int]]] = {}
        self.sink_results: Dict[str, List[Tuple]] = {}
        self.epoch_committed = 0
        self._nexmark_gen = None
        # upstream (SharedStream, port) pairs captured while planning the
        # statement currently being executed; moved onto the created object
        self._pending_subs: List[Tuple[SharedStream, Any]] = []
        # DDL log (catalog persistence): table id 0 holds (seq, sql) rows;
        # replayed on open so a restarted process rebuilds its dataflows
        # (the meta catalog + recovery analog, `worker.rs:664`)
        self._functions: set = set()      # this session's UDF names
        self._ddl_log = StateTable(self.store, DDL_LOG_TABLE_ID,
                                   list(DDL_LOG_DTYPES), list(DDL_LOG_PK))
        self._ddl_seq = 0
        # poison-pill dead-letter queue (rw_dead_letter / risectl dlq):
        # durable through the same store as everything else, created
        # BEFORE catalog recovery so replayed jobs wire into it
        from ..runtime.remote_fragments import DeadLetterQueue
        self._dlq = DeadLetterQueue(StateTable(
            self.store, DLQ_TABLE_ID, list(DeadLetterQueue.DTYPES),
            list(DeadLetterQueue.PK)))
        # overload control plane (utils/overload.py): the per-job
        # degradation ladder + per-source admission buckets close the
        # loop from credit-starvation evidence to action once per tick;
        # the shed log audits every window dropped under RW_LOAD_SHED;
        # the select gate bounds concurrent pgwire SELECTs. Created
        # BEFORE catalog recovery so replayed sources wire their buckets.
        from ..utils.overload import OverloadManager, SelectGate, ShedLog
        self._shed_log = ShedLog(StateTable(
            self.store, SHED_TABLE_ID, list(ShedLog.DTYPES),
            list(ShedLog.PK)))
        self._overload = OverloadManager()
        self.select_gate = SelectGate()
        # serving tier (serving/read_cache.py): host-side epoch-versioned
        # MV snapshots — pgwire SELECTs over fused MVs serve from here,
        # one device pull per (MV, epoch) no matter how many readers.
        # Starts cold (restart/recovery included): the first read after
        # any commit repopulates.
        from ..serving import MVReadCache
        self.read_cache = MVReadCache()
        self._replaying = False
        self._recover_catalog()

    def _device_mode_str(self) -> str:
        if self.device is None:
            return "off"
        # the same strings as the JAX package's marker (its mesh counts
        # `devices.size`; the port's `Mesh` counts shards as `n`), so a data
        # directory's device_mode.json reads the same in both packages
        mode = ("mesh:%d" % self.device.mesh.n
                if self.device.mesh is not None else "single")
        ms = getattr(self.device, "mesh_shards", 1) or 1
        if self.device.mesh is None and ms > 1:
            # mesh-sharded FUSED programs: state layouts are per-shard,
            # so a reopen must shard identically. Replicas MIRROR state
            # (layouts unchanged) but the marker still records them —
            # reopen policy checks must be exact, not merely compatible.
            mode += ":fshard%d" % ms
            reps = getattr(self.device, "replicas", 1) or 1
            if reps > 1:
                mode += ":rep%d" % reps
        return mode + (":minmax" if self.device.minmax else "")

    @staticmethod
    def _device_from_marker(data_dir: Optional[str], torch_device=None):
        """Reconstruct the device argument a data directory was created
        with (its device_mode.json marker); "off" when unmarked. A mesh
        lies on `device_set(torch_device)`."""
        import json
        import os
        if not data_dir:
            return "off"
        path = os.path.join(data_dir, "device_mode.json")
        if not os.path.exists(path):
            return "off"
        with open(path) as f:
            mode = json.load(f)["mode"]
        if mode == "off":
            return "off"
        from ..config import DeviceConfig
        parts = mode.split(":")
        minmax = parts[-1] == "minmax"
        if minmax:
            parts = parts[:-1]
        if parts[0] == "single":
            ms = 1
            reps = 1
            if len(parts) > 1 and parts[1].startswith("fshard"):
                ms = int(parts[1][len("fshard"):])
            if len(parts) > 2 and parts[2].startswith("rep"):
                reps = int(parts[2][len("rep"):])
            return DeviceConfig(minmax=minmax, mesh_shards=ms,
                                replicas=reps)
        from ..parallel import make_mesh
        return DeviceConfig(mesh=make_mesh(int(parts[1]),
                                           devices=torch_device),
                            minmax=minmax)

    def _check_device_marker(self) -> None:
        """Durable stores record the dispatch policy that shaped their state
        tables; a reopen under a different policy fails fast."""
        import json
        import os
        d = getattr(self.store, "dir", None)
        if d is None:
            return
        path = os.path.join(d, "device_mode.json")
        mode = self._device_mode_str()
        if os.path.exists(path):
            with open(path) as f:
                saved = json.load(f)["mode"]
            if saved != mode:
                raise ValueError(
                    f"data directory was created with device={saved!r} but "
                    f"reopened with device={mode!r}; state-table layouts "
                    "differ between dispatch policies")
        elif not self._marker_readonly:
            with open(path, "w") as f:
                json.dump({"mode": mode}, f)

    def _recover_catalog(self) -> None:
        entries = sorted(self._ddl_log.iter_all())
        if not entries:
            return
        self._replaying = True
        saved_vars = dict(self.session_vars)
        try:
            for seq, sql in entries:
                self._ddl_seq = max(self._ddl_seq, seq + 1)
                for stmt in parse_sql(sql):
                    self._execute(stmt)
        finally:
            self._replaying = False
            # replayed SET pins (plan-shape determinism) must not leak into
            # the fresh session
            self.session_vars = saved_vars

    def _log_ddl(self, sql: str) -> None:
        if self._replaying:
            return
        self._ddl_log.insert((self._ddl_seq, sql))
        self._ddl_seq += 1
        self._ddl_log.commit(self.injector.epoch.curr)
        self.store.commit_epoch(self.injector.epoch.curr)

    # ------------------------------------------------------------------
    # statement surface
    # ------------------------------------------------------------------
    def run(self, sql: str) -> List[Any]:
        from .parser import parse_sql_with_text
        out = []
        for stmt, text in parse_sql_with_text(sql):
            result = self._execute(stmt)
            if isinstance(stmt, (A.CreateTable, A.CreateMaterializedView,
                                 A.CreateSink, A.DropObject, A.CreateIndex,
                                 A.AlterParallelism, A.CreateFunction)) \
                    or (isinstance(stmt, A.SetVar) and stmt.system):
                if isinstance(stmt, A.CreateMaterializedView):
                    # plan shape depends on these session vars; pin them in
                    # the log so replay replans the same fragment topology
                    k = int(self.session_vars.get("streaming_parallelism")
                            or 0)
                    self._log_ddl(f"SET streaming_parallelism TO {k}")
                    pl = self.session_vars.get("streaming_placement")
                    if pl and pl != "local":
                        self._log_ddl(f"SET streaming_placement TO {pl}")
                    sv = bool(self.session_vars.get(
                        "streaming_supervision"))
                    self._log_ddl("SET streaming_supervision TO "
                                  + ("true" if sv else "false"))
                    dj = bool(self.session_vars.get(
                        "streaming_enable_delta_join"))
                    self._log_ddl("SET streaming_enable_delta_join TO "
                                  + ("true" if dj else "false"))
                self._log_ddl(text)
            out.append(result)
        return out

    def query(self, sql: str) -> List[Tuple]:
        """Run a single SELECT and return rows."""
        stmts = parse_sql(sql)
        assert len(stmts) == 1 and isinstance(stmts[0], (A.Select, A.SetOp))
        return self._run_batch_select(stmts[0])

    def _execute(self, stmt: Any) -> Any:
        if isinstance(stmt, A.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, A.CreateMaterializedView):
            return self._create_mv(stmt)
        if isinstance(stmt, A.CreateFunction):
            return self._create_function(stmt)
        if isinstance(stmt, A.CreateSink):
            return self._create_sink(stmt)
        if isinstance(stmt, A.CreateIndex):
            return self._create_index(stmt)
        if isinstance(stmt, A.DropObject):
            return self._drop(stmt)
        if isinstance(stmt, A.Insert):
            return self._insert(stmt)
        if isinstance(stmt, A.Delete):
            return self._delete(stmt)
        if isinstance(stmt, A.Update):
            return self._update(stmt)
        if isinstance(stmt, A.Flush):
            return self.flush()
        if isinstance(stmt, (A.Select, A.SetOp)):
            return self._run_batch_select(stmt)
        if isinstance(stmt, A.ShowObjects):
            kind = {"tables": "table", "sources": "source",
                    "materialized views": "mv", "sinks": "sink"}[stmt.kind]
            return self.catalog.list(kind)
        if isinstance(stmt, A.Explain):
            return self._explain(stmt.stmt)
        if isinstance(stmt, A.ExplainAnalyze):
            return self._explain_analyze(stmt.target)
        if isinstance(stmt, A.AlterParallelism):
            return self._alter_parallelism(stmt)
        if isinstance(stmt, A.SetVar):
            return self._set_var(stmt)
        if isinstance(stmt, A.ShowVar):
            return self._show_var(stmt)
        raise ValueError(f"unsupported statement {stmt!r}")

    # ------------------------------------------------------------------
    # DDL
    # ------------------------------------------------------------------
    def _create_table(self, stmt: A.CreateTable) -> str:
        fields = [Field(c.name, type_from_name(c.type_name))
                  for c in stmt.columns]
        has_pk = bool(stmt.primary_key)
        if not has_pk:
            fields.append(Field(ROWID, T.INT64))
        schema = Schema(fields)
        pk = [schema.index_of(n) for n in stmt.primary_key] if has_pk \
            else [len(fields) - 1]
        tid = self.catalog.alloc_table_id()
        obj = CatalogObject(stmt.name, "source" if stmt.is_source else "table",
                            schema, pk, tid, stmt.append_only,
                            stmt.with_options)
        connector = stmt.with_options.get("connector", "dml")
        reader = self._make_reader(connector, stmt, schema)
        # split offsets persist for real connectors only: a DML buffer is
        # transient, and restoring its offset would skip freshly pushed rows
        split_st = None if connector == "dml" else StateTable(
            self.store, self.catalog.alloc_table_id(),
            [T.VARCHAR, T.VARCHAR], [0])
        src: Executor = SourceExecutor(schema, reader, self.injector,
                                       split_state_table=split_st,
                                       name=f"Source({stmt.name})",
                                       append_only=(connector != "dml"
                                                    or stmt.append_only))
        if connector != "dml":
            # source admission control: a per-epoch token bucket rated by
            # the downstream overload ladder; sheds (RW_LOAD_SHED only)
            # audit into the durable rw_shed_log. DML buffers stay
            # ungated — their pushes are synchronous client calls.
            bucket = self._overload.bucket(stmt.name)
            bucket.shed_sink = self._shed_record
            src.admission = bucket
        if not has_pk:
            src = RowIdGenExecutor(src, row_id_index=len(fields) - 1,
                                   shard=tid & 0x3FF)
        if stmt.watermark is not None:
            col, delay_expr = stmt.watermark
            ns = Namespace.of_schema(schema, stmt.name)
            ti = ns.resolve(col)
            bound = Binder(ns).bind(delay_expr)
            delay = _extract_delay(bound, ti)
            wm_st = StateTable(self.store, self.catalog.alloc_table_id(),
                               [T.INT64, schema.fields[ti].dtype], [0])
            src = WatermarkFilterExecutor(src, ti, delay, wm_st)
            obj.watermark_col = ti
        if stmt.is_source and connector != "dml":
            # SOURCES are passive pipes, not tables (`source_executor.rs`:
            # the reference never persists a source's stream; an MV on a
            # source starts from its creation point). Skipping the
            # per-row materialization is also the host path's single
            # biggest per-event cost.
            mv_table = None
            shared = SharedStream(src)
        else:
            mv_table = StateTable(self.store, tid, schema.dtypes, pk)
            # minted rowids never collide, so the conflict scan is pure
            # overhead there — and NO_CHECK is what lets Materialize keep
            # the append-only property for the device agg specialization
            mat = MaterializeExecutor(src, mv_table,
                                      ConflictBehavior.NO_CHECK if not has_pk
                                      else ConflictBehavior.OVERWRITE)
            shared = SharedStream(mat)
        obj.runtime = {"reader": reader if connector == "dml" else None,
                       "state_table": mv_table, "shared": shared,
                       "port": shared.subscribe()}
        # Virtual source (fused device path): a nexmark source under a
        # single-chip device policy does NOT start a host datagen job —
        # fused MVs regenerate events on device. The host chain is built
        # (for planning and as the fallback) but activates lazily, only if
        # a non-fusable consumer appears (_activate_source). Matches the
        # reference, where a SOURCE runs no dataflow until consumed
        # (`create_source.rs` — sources are passive until subscribed).
        obj.runtime["virtual"] = (stmt.is_source and connector == "nexmark"
                                  and self.device is not None
                                  and self.device.fuse
                                  and self.device.mesh is None)
        self.catalog.create(obj)
        if not obj.runtime["virtual"]:
            self._iters[stmt.name] = obj.runtime["port"].execute()
        return f"CREATE_{'SOURCE' if stmt.is_source else 'TABLE'}"

    def _activate_source(self, name: str) -> None:
        obj = self.catalog.get(name)
        rt = obj.runtime or {}
        if rt.get("virtual"):
            rt["virtual"] = False
            self._iters[name] = rt["port"].execute()

    def _make_reader(self, connector: str, stmt: A.CreateTable,
                     schema: Schema):
        if connector == "dml":
            return ListReader([])
        if connector == "nexmark":
            from ..connectors.nexmark import NexmarkConfig, NexmarkGenerator
            table = stmt.with_options.get("nexmark.table", "bid").lower()
            maxe = stmt.with_options.get("nexmark.max.events")
            per = int(stmt.with_options.get("nexmark.chunk.size", "8192"))
            kd = stmt.with_options.get("nexmark.key.dist", "")
            if self._nexmark_gen is None:
                # key_dist (e.g. 'zipf:1.5') reshapes the bid
                # auction/bidder picks into a power-law — reproducible
                # skewed workloads for tests and bench. The generator is
                # shared across this database's nexmark sources (one
                # event clock), so the FIRST nexmark source pins it.
                self._nexmark_gen = NexmarkGenerator(
                    NexmarkConfig(key_dist=kd) if kd else None)
            elif kd and self._nexmark_gen.cfg.key_dist != kd:
                raise ValueError(
                    "nexmark sources share one generator; key.dist "
                    f"{kd!r} conflicts with "
                    f"{self._nexmark_gen.cfg.key_dist!r}")
            cols = [c.name for c in stmt.columns]
            reader = NexmarkReader(table, self._nexmark_gen,
                                   events_per_poll=per,
                                   max_events=int(maxe) if maxe else None,
                                   columns=cols)
            # per-source host-ingest opt-in (fused jobs feed this source
            # through the staging pipeline instead of device datagen)
            ing = stmt.with_options.get("nexmark.ingest", "").lower()
            if ing and ing not in ("host", "device"):
                raise ValueError(
                    f"nexmark.ingest={ing!r} (supported: host, device)")
            reader.ingest_mode = "" if ing == "device" else ing
            return reader
        if connector == "datagen":
            from ..connectors.datagen import FieldGen
            per = int(float(stmt.with_options.get("rows.per.poll", "1024")))
            maxr = stmt.with_options.get("datagen.max.rows")
            # fields.<col>.kind = 'sequence' | 'random' | 'zipf:<s>'
            # (+ fields.<col>.start/end/seed) — the reference's datagen
            # field options; zipf makes skewed keys reproducible
            fields: Dict[str, FieldGen] = {}
            for k, v in stmt.with_options.items():
                if not k.startswith("fields.") or not k.endswith(".kind"):
                    continue
                col = k[len("fields."):-len(".kind")]
                opts = stmt.with_options
                kind, s = str(v), 1.5
                if kind.startswith("zipf"):
                    kind, _, sv = kind.partition(":")
                    s = float(sv) if sv else 1.5
                    kind = "zipf"
                fields[col] = FieldGen(
                    kind=kind,
                    start=int(opts.get(f"fields.{col}.start", "0")),
                    end=int(opts.get(f"fields.{col}.end", str(2**31))),
                    seed=int(opts.get(f"fields.{col}.seed", "0")),
                    s=s)
            return DatagenReader(schema, fields=fields or None,
                                 rows_per_chunk=per,
                                 max_rows=int(maxr) if maxr else None)
        if connector in ("fs", "filesystem", "posix_fs"):
            from ..connectors.base import SplitSourceReader, make_parser
            from ..connectors.filesystem import DirEnumerator, LineFileReader
            opts = stmt.with_options
            path = opts.get("fs.path")
            if not path:
                raise ValueError("fs connector requires fs.path")
            fmt = opts.get("format", opts.get("fs.format", "json"))
            return SplitSourceReader(
                DirEnumerator(path, opts.get("fs.pattern", "*")),
                LineFileReader(),
                make_parser(fmt, schema, opts),
                records_per_poll=int(opts.get("fs.records.per.poll",
                                              "4096")))
        raise ValueError(f"unknown connector {connector!r}")

    def _subscribe(self, name: str) -> Tuple[Executor, Schema]:
        obj = self.catalog.get(name)
        rt = obj.runtime
        snap = None
        if not self._replaying and rt["state_table"] is not None:
            # DDL-log replay: downstream recovered state already includes
            # the snapshot — re-backfilling would double-count. Sources
            # have no table (passive pipes): MVs start from now.
            snapshot_rows = list(rt["state_table"].iter_all())
            if snapshot_rows:
                snap = StreamChunk.from_rows(
                    obj.schema.dtypes,
                    [(Op.INSERT, r) for r in snapshot_rows])
        port = rt["shared"].subscribe()
        self._pending_subs.append((rt["shared"], port))
        return _Backfill(snap, port, name), obj.schema, obj.pk

    def _make_state(self, dtypes, pk):
        return StateTable(self.store, self.catalog.alloc_table_id(),
                          list(dtypes), list(pk))

    def _watermark_of(self, name: str) -> Optional[int]:
        obj = self.catalog.objects.get(name)
        return getattr(obj, "watermark_col", None) if obj else None

    def _barrier_source(self):
        from ..ops import BarrierSource
        return BarrierSource(self.injector)

    def _make_planner(self, subscribe, inj: Optional[BarrierInjector] = None,
                      **kw) -> Planner:
        """Planner wired to this Database's NOW()/watermark context; `inj`
        scopes barrier feeds to a one-shot batch injector."""
        from ..ops import BarrierSource
        bs = (lambda: BarrierSource(inj)) if inj is not None \
            else self._barrier_source
        return Planner(subscribe, barrier_source=bs,
                       watermark_of=self._watermark_of,
                       state_table_of=self._state_table_of,
                       torch_device=self.torch_device, **kw)

    def _state_table_of(self, name: str, keycols=None):
        """The object's arrangement whose pk prefix covers `keycols` —
        its own state table, or any index on it (create_index.rs)."""
        obj = self.catalog.objects.get(name)
        if obj is None or not isinstance(obj.runtime, dict):
            return None
        if keycols is None:
            return obj.runtime.get("state_table")
        cands = [obj] + [o for o in self.catalog.objects.values()
                         if getattr(o, "index_on", None) == name]
        k = len(keycols)
        for o in cands:
            st = (o.runtime or {}).get("state_table") \
                if isinstance(o.runtime, dict) else None
            if st is not None \
                    and sorted(st.pk_indices[:k]) == sorted(keycols):
                return st
        return None

    def _create_index(self, stmt: A.CreateIndex) -> str:
        """CREATE INDEX i ON t (cols): an auto-maintained arrangement of
        the table with pk = (index cols, table pk) — exactly how the
        reference models indexes (an index IS a materialized view with a
        reordered pk, `frontend/src/handler/create_index.rs`); lookup/
        delta joins probe it when the join key matches its pk prefix."""
        src = self.catalog.get(stmt.table)
        if src.kind not in ("table", "mv"):
            raise ValueError("CREATE INDEX requires a table or "
                             "materialized view")
        name_to_pos = {f.name: i for i, f in enumerate(src.schema.fields)}
        try:
            idx_cols = [name_to_pos[c] for c in stmt.columns]
        except KeyError as e:
            raise ValueError(f"index column {e.args[0]!r} does not exist")
        pk = idx_cols + [i for i in src.pk if i not in idx_cols]
        self._pending_subs = []
        execu, schema, _ = self._subscribe(stmt.table)
        tid = self.catalog.alloc_table_id()
        # distribute by the INDEX columns: all rows of one key land in one
        # vnode, so a prefix probe reads a single vnode range (the
        # reference distributes arrangements by their join/index key)
        table = StateTable(self.store, tid, schema.dtypes, pk,
                           dist_key_indices=idx_cols)
        mat = MaterializeExecutor(execu, table, ConflictBehavior.NO_CHECK)
        shared = SharedStream(mat)
        obj = CatalogObject(stmt.name, "index", schema, pk, tid)
        obj.runtime = {"state_table": table, "shared": shared,
                       "port": shared.subscribe(), "reader": None,
                       "upstream_subs": self._pending_subs}
        obj.index_on = stmt.table
        self._pending_subs = []
        self.catalog.create(obj)
        self._iters[stmt.name] = obj.runtime["port"].execute()
        return "CREATE_INDEX"

    def _create_mv(self, stmt: A.CreateMaterializedView) -> str:
        planner = self._make_planner(self._subscribe,
                                     make_state=self._make_state,
                                     device=self.device)
        # SET streaming_parallelism > 1 plans host HashAgg through the
        # Dispatch/Merge exchange (0 = default single fragment); persisted
        # per CREATE in the DDL log so recovery replans identically
        planner.parallelism = max(
            1, int(self.session_vars.get("streaming_parallelism") or 0))
        # 'process' places parallel fragments in worker OS processes
        # (runtime/remote_fragments.py) — real host concurrency; Python
        # threads cannot provide it (GIL)
        planner.placement = self.session_vars.get("streaming_placement",
                                                  "local")
        # supervised placement: a FragmentSupervisor respawns single dead
        # workers in place instead of tearing the job down
        planner.supervise = bool(self.session_vars.get(
            "streaming_supervision"))
        planner.delta_join = bool(self.session_vars.get(
            "streaming_enable_delta_join"))
        self._pending_subs = []
        execu, ns = planner.plan_query(stmt.query)
        schema = ns.schema()
        # MV pk = the derived stream key (hidden columns appended by the
        # planner when the select list drops them) — preserves duplicate-row
        # multiplicity exactly like the reference's StreamMaterialize pk
        pk = list(ns.stream_key)
        tid = self.catalog.alloc_table_id()
        mv_table = StateTable(self.store, tid, schema.dtypes, pk)
        # whole-fragment fusion (device/fuse_planner.py): an eligible plan
        # over replayable sources becomes ONE epoch program with
        # device-resident state; the per-operator host DAG is dropped
        if self.device is not None and self.device.fuse:
            from ..device.fuse_planner import try_fuse
            job = try_fuse(execu, ns, self.device, stmt.name,
                           mv_state_table=mv_table,
                           make_state=self._make_state,
                           cap_registry=self._fused_cap_hw,
                           device=self.mesh_devices)
            if job is not None:
                for shared, port in self._pending_subs:
                    shared.unsubscribe(port)
                self._pending_subs = []
                obj = CatalogObject(stmt.name, "mv", schema, pk, tid)
                obj.n_visible = ns.n_visible
                obj.runtime = {"state_table": mv_table, "shared": None,
                               "port": None, "reader": None,
                               "upstream_subs": [], "fused_job": job}
                self.catalog.create(obj)
                self._fused[stmt.name] = job
                if getattr(job, "ingest", None) is not None:
                    # each multiplexed source gets the overload manager's
                    # admission bucket, as a host source executor would
                    # (rw_source_admission rows, the ladder's factor, the
                    # deferral lag): an unadmitted window stays at the
                    # connector
                    for sname in job.ingest.source_names():
                        b = self._overload.bucket(sname)
                        b.shed_sink = self._shed_record
                        job.ingest.buckets[sname] = b
                job.profiler.attach(self._data_dir)
                job.data_dir = self._data_dir
                job.freshness = self._freshness
                # a reopened store holding a committed counter: replay
                # the job to it (no-op for a new job)
                job.recover()
                return "CREATE_MATERIALIZED_VIEW"
            # fallback: the plan stayed on the host/per-operator path, so
            # any virtual (never-started) sources it reads must activate
            for sname in _source_names(stmt.query):
                o = self.catalog.objects.get(sname)
                if o is not None and (o.runtime or {}).get("virtual"):
                    self._activate_source(sname)
        # operator change streams are exact (retractions carry full rows,
        # updates arrive as U-/U+ pairs on the stream key), so the MV needs
        # no conflict scan — NoCheck, like the reference's StreamMaterialize
        # for non-DML inputs (materialize.rs handle_conflict gating)
        mat = MaterializeExecutor(execu, mv_table, ConflictBehavior.NO_CHECK)
        shared = SharedStream(mat)
        obj = CatalogObject(stmt.name, "mv", schema, pk, tid)
        obj.n_visible = ns.n_visible
        obj.runtime = {"state_table": mv_table, "shared": shared,
                       "port": shared.subscribe(), "reader": None,
                       "upstream_subs": self._pending_subs}
        self._pending_subs = []
        self.catalog.create(obj)
        self._iters[stmt.name] = obj.runtime["port"].execute()
        # stamp every remote worker set in the plan with its owning job
        # name + this process's dead-letter queue: the poison-pill
        # quarantine's audit identity (rw_dead_letter rows, the
        # supervisor_quarantined_total{job} label, risectl dlq routing)
        for e in _walk_executors(shared.upstream):
            r = getattr(e, "_remote", None)
            if r is not None:
                r.job_name = stmt.name
                r.dead_letter = self._dlq
        return "CREATE_MATERIALIZED_VIEW"

    def _explain(self, inner: Any) -> str:
        """EXPLAIN renders the physical plan this runtime would execute —
        the executor tree the planner lowers to (the AST lowers straight
        to executors; there is one plan shape). No state tables are
        allocated and no subscriptions are taken."""
        from .system_catalog import render_plan
        if isinstance(inner, A.CreateMaterializedView):
            q = inner.query
        elif isinstance(inner, (A.Select, A.SetOp)):
            q = inner
        else:
            return repr(inner)
        execu, _ns = self._make_planner(
            self._peek_subscribe(), inj=BarrierInjector(),
            device=self.device).plan_query(q)
        out = render_plan(execu)
        rules = getattr(q, "applied_rules", None)
        if rules:
            out += "\n-- rewrites: " + ", ".join(rules)
        return out

    def _explain_analyze(self, name: str) -> str:
        """EXPLAIN ANALYZE <mv>: live per-operator tree of a RUNNING
        streaming job — eps in/out, row amplification, occupancy vs
        capacity, device memory, per-phase time share, skew ratios (fused), or
        worker liveness + exchange backpressure (host/process
        placement). Numbers come from the same checkpoint-fresh
        surfaces as the rw_* system tables; rendering performs no
        device sync and no statement re-execution."""
        from .system_catalog import (explain_analyze_fused,
                                     explain_analyze_host)
        obj = self.catalog.get(name)
        if obj.kind not in ("mv", "sink", "index", "table"):
            raise ValueError(
                f"EXPLAIN ANALYZE needs a running streaming job; "
                f"{name!r} is a {obj.kind}")
        job = (obj.runtime or {}).get("fused_job") \
            if isinstance(obj.runtime, dict) else None
        if job is not None:
            return explain_analyze_fused(name, job)
        return explain_analyze_host(name, obj)

    def _peek_subscribe(self):
        """Schema-only subscribe: plans without taking subscriptions or
        allocating state (EXPLAIN / pgwire Describe)."""
        inj = BarrierInjector()

        def peek(name: str):
            from .system_catalog import SYSTEM_TABLES
            if name in SYSTEM_TABLES and name not in self.catalog.objects:
                schema, _builder = SYSTEM_TABLES[name]
                src = SourceExecutor(schema, ListReader([]), inj,
                                     name=f"SysScan({name})")
                return src, schema, list(range(len(schema)))
            obj = self.catalog.get(name)
            src = SourceExecutor(obj.schema, ListReader([]), inj,
                                 name=f"Scan({name})")
            rt = obj.runtime or {}
            shared = rt.get("shared")
            if shared is not None:
                src.append_only = shared.upstream.append_only
            return src, obj.schema, obj.pk

        return peek

    def describe_select(self, q):
        """Row description of a SELECT without executing it (the pgwire
        Describe answer)."""
        if isinstance(q, A.Select) and q.from_ is None:
            row = tuple(_eval_const(i.expr, None) for i in q.items)
            return [(it.alias or "?column?", _const_dtype(v))
                    for it, v in zip(q.items, row)]
        _execu, ns = self._make_planner(
            self._peek_subscribe(), inj=BarrierInjector()).plan_query(q)
        n_vis = ns.n_visible or len(ns.cols)
        return [(c.name, c.dtype) for c in ns.cols[:n_vis]]

    def _set_var(self, stmt: A.SetVar) -> str:
        """SET (session tier) / ALTER SYSTEM SET (cluster tier,
        DDL-logged so restarts replay it). System params take effect
        immediately where the runtime consumes them."""
        if stmt.system:
            v = self.system_params.set(stmt.name, stmt.value)
            if stmt.name == "checkpoint_frequency":
                self.injector.checkpoint_frequency = max(1, int(v))
            return f"ALTER_SYSTEM_{stmt.name}"
        from ..config import SESSION_VAR_DEFAULTS
        if stmt.name not in SESSION_VAR_DEFAULTS:
            raise ValueError(
                f"unrecognized configuration parameter {stmt.name!r}")
        want = type(SESSION_VAR_DEFAULTS[stmt.name])
        v = stmt.value
        if want is bool and isinstance(v, str):
            v = v.strip().lower() in ("t", "true", "1", "on")
        elif not isinstance(v, want):
            v = want(v)
        self.session_vars[stmt.name] = v
        return f"SET_{stmt.name}"

    def _show_var(self, stmt: A.ShowVar):
        if stmt.name is None:                      # SHOW ALL
            return sorted(self.session_vars.items())
        if stmt.name == "parameters":              # SHOW PARAMETERS
            return sorted(self.system_params.values.items())
        if stmt.name in self.session_vars:
            return self.session_vars[stmt.name]
        return self.system_params.get(stmt.name)

    def _alter_parallelism(self, stmt: A.AlterParallelism) -> str:
        """Elastic scale-out/in of one job's device-sharded operators
        (`src/meta/src/stream/scale.rs:2329` reschedule analog).

        Runs at a barrier boundary: `flush()` completes the in-flight
        barrier on every job first (all epoch buffers empty, state
        committed), then each device engine re-shards its vnode-mapped
        state onto an n-device mesh (`parallel/rescale.py`). Logged to the
        DDL log, so recovery replays the same topology — engines that
        recover AFTER the replayed rescale load their rows straight onto
        the new mesh."""
        obj = self.catalog.get(stmt.name)
        if obj.kind != "mv":
            raise ValueError(f"{stmt.name!r} is not a materialized view")
        if (obj.runtime or {}).get("fused_job") is not None:
            raise ValueError(
                f"{stmt.name!r} runs as a fused single-chip device job; "
                "create the database with a device mesh to shard it")
        n = stmt.parallelism
        if n < 1:
            raise ValueError("PARALLELISM must be >= 1")
        if not self._replaying:
            # barrier boundary; during DDL-log replay the dataflow is
            # half-rebuilt and ticking it would feed sources into only the
            # already-replayed jobs (buffers are empty anyway on replay)
            self.flush()
        from ..parallel import make_mesh
        # a host-only Database has no device engine to re-shard, and no
        # device set to lay a mesh on
        mesh = (make_mesh(n, devices=self.mesh_devices)
                if n > 1 and self.mesh_devices is not None else None)
        rescaled = 0
        stack = [obj.runtime["shared"].upstream]
        seen = set()
        while stack:
            e = stack.pop()
            if id(e) in seen:
                continue
            seen.add(id(e))
            if hasattr(e, "rescale_mesh"):
                e.rescale_mesh(mesh)
                rescaled += 1
            for attr in ("input", "port", "left_exec", "right_exec",
                         "barrier_source"):
                c = getattr(e, attr, None)
                if c is not None:
                    stack.append(c)
            stack.extend(getattr(e, "inputs", ()))   # Union/Merge children
        obj.parallelism = n
        return f"ALTER_PARALLELISM_{rescaled}"

    def _create_function(self, stmt: A.CreateFunction) -> str:
        """CREATE FUNCTION ... LANGUAGE python (`udf/python.rs` analog):
        the body executes in-process and registers a scalar function.
        DDL-logged, so recovery re-registers it before dependent MVs
        replay."""
        if stmt.language.lower() != "python":
            raise ValueError(f"LANGUAGE {stmt.language} not supported "
                             "(python only)")
        # embedded UDFs exec() arbitrary code in the server process; pgwire
        # sessions (detected via the WIRE_SESSION thread-local their handler
        # threads set) are refused unless the operator opted in (the
        # reference gates embedded UDFs the same way). The embedding
        # process's own local API is never gated, and DDL replay is exempt:
        # the statement was authorized when it was first accepted.
        via_wire = getattr(WIRE_SESSION, "active", False)
        if via_wire and not getattr(WIRE_SESSION, "udf_allowed", False) \
                and not self._replaying:
            raise ValueError(
                "embedded Python UDFs are disabled for network clients "
                "(start the server with enable_embedded_udf=True)")
        if stmt.name.lower() in self._functions and not stmt.or_replace \
                and not self._replaying:
            raise ValueError(f"function {stmt.name!r} already exists")
        from ..expr.functions import register_python_udf
        # the registry is process-global (build_func has no session scope);
        # duplicate detection is per-Database, last registration wins
        register_python_udf(
            stmt.name, stmt.body,
            [type_from_name(t) for t in stmt.arg_types],
            type_from_name(stmt.return_type), replace=True)
        self._functions.add(stmt.name.lower())
        return "CREATE_FUNCTION"

    def _create_sink(self, stmt: A.CreateSink) -> str:
        self._pending_subs = []
        sink_pk = None
        if stmt.from_name is not None:
            execu, schema, sink_pk = self._subscribe(stmt.from_name)
        else:
            execu, ns = self._make_planner(
                self._subscribe, make_state=self._make_state,
                device=self.device).plan_query(stmt.query)
            schema = ns.schema()
        obj = CatalogObject(stmt.name, "sink", schema, [], 0,
                            with_options=stmt.with_options)
        connector = stmt.with_options.get("connector", "collect")
        if connector in ("fs", "filesystem", "posix_fs"):
            from ..connectors.sink import FileSink, SinkExecutor
            path = stmt.with_options.get("fs.path")
            if not path:
                raise ValueError("fs sink requires fs.path")
            sink = FileSink(path, schema,
                            fmt=stmt.with_options.get("format", "jsonl"),
                            append_only=execu.append_only)
            # durable delivery log (the log-store analog): commits in the
            # same store epoch as the source offsets, closing the crash
            # window between external delivery and checkpoint
            log_table = StateTable(
                self.store, self.catalog.alloc_table_id(),
                [T.INT64, T.INT64, T.INT64, T.BYTEA], [0, 1])
            # upstream pk (when sinking FROM a materialized object)
            # arms the sink-boundary dedupe: post-respawn refreshes may
            # re-state rows the changelog already carries, and the MV's
            # by-pk reconciliation doesn't reach external files
            # durable per-pk mirror journal (fault-tolerance v3): the
            # delivered mirror persists through this table with epoch-
            # fenced commits, so a coordinator restart rebuilds it and a
            # refresh racing the crash cannot duplicate into the file
            mirror_table = StateTable(
                self.store, self.catalog.alloc_table_id(),
                [T.BYTEA, T.INT64, T.BYTEA], [0]) if sink_pk else None
            sink_exec = SinkExecutor(execu, sink, log_table=log_table,
                                     pk_indices=sink_pk,
                                     mirror_table=mirror_table)
            obj.runtime = {"sink": sink, "sink_exec": sink_exec,
                           "collect": None,
                           "state_table": None, "shared": None,
                           "reader": None,
                           "upstream_subs": self._pending_subs}
            self._pending_subs = []
            self.catalog.create(obj)
            self._iters[stmt.name] = sink_exec.execute()
            return "CREATE_SINK"
        rows: List[Tuple] = []
        self.sink_results[stmt.name] = rows
        obj.runtime = {"collect": rows, "state_table": None, "shared": None,
                       "reader": None, "upstream_subs": self._pending_subs}
        self._pending_subs = []
        self.catalog.create(obj)
        self._iters[stmt.name] = self._sink_pump(execu, rows)
        return "CREATE_SINK"

    @staticmethod
    def _sink_pump(execu: Executor, rows: List[Tuple]) -> Iterator[Message]:
        for msg in execu.execute():
            if isinstance(msg, StreamChunk):
                for op, r in msg.compact().op_rows():
                    rows.append((op, r))
            yield msg

    def _drop(self, stmt: A.DropObject) -> str:
        if stmt.name in self.catalog.objects:
            dep = self._dependent_of(stmt.name)
            if dep is not None:
                # the reference refuses to drop relations with dependent
                # streaming jobs (catalog ensure_*_not_referenced)
                raise ValueError(
                    f"cannot drop {stmt.name!r}: streaming job {dep!r} "
                    "depends on it (drop that first)")
        try:
            obj = self.catalog.drop(stmt.name)
        except KeyError:
            if stmt.if_exists:
                return "DROP_SKIPPED"
            raise
        self._iters.pop(stmt.name, None)
        self._freshness.forget(stmt.name)
        self._overload.forget(stmt.name)
        self.read_cache.invalidate(stmt.name)
        dropped_job = self._fused.pop(stmt.name, None)
        if dropped_job is not None:
            if getattr(dropped_job, "ingest", None) is not None:
                dropped_job.ingest.close()    # join the staging thread
            if getattr(dropped_job, "tiering", None) is not None:
                # a re-created MV under the same name starts with no
                # demotion history — a stale journal would replay
                # evictions against state that never saw them
                dropped_job.tiering.clear_journal()
            # remember where its capacities topped out, keyed by plan
            # shape — a re-created MV with the same plan (any name)
            # starts there (zero growth replays); structurally identical
            # entries merge by max
            reg = self._fused_cap_hw.setdefault(dropped_job.plan_hash, {})
            for k, caps in dropped_job.shape_hints().items():
                prev = reg.setdefault(k, {})
                for s, c in caps.items():
                    prev[s] = max(prev.get(s, 0), c)
        # release upstream taps, or their buffers grow forever
        for shared, port in (obj.runtime or {}).get("upstream_subs", []):
            shared.unsubscribe(port)
        return "DROP"

    def _dependent_of(self, name: str) -> Optional[str]:
        """A streaming job that reads `name`'s arrangement, if any: an
        index ON it, or an MV whose lookup join probes its state table."""
        target = self.catalog.objects[name]
        st = (target.runtime or {}).get("state_table") \
            if isinstance(target.runtime, dict) else None
        tables = {id(st)} if st is not None else set()
        # an index's own table is probed under the indexed table's NAME
        for o in self.catalog.objects.values():
            if getattr(o, "index_on", None) == name \
                    and isinstance(o.runtime, dict):
                ist = o.runtime.get("state_table")
                if ist is not None:
                    tables.add(id(ist))
                return o.name        # index depends on its base directly
        from ..ops.lookup_join import LookupJoinExecutor
        for o in self.catalog.objects.values():
            if o.name == name or not isinstance(o.runtime, dict):
                continue
            shared = o.runtime.get("shared")
            if shared is None:
                continue
            for e in _walk_executors(shared.upstream):
                if isinstance(e, LookupJoinExecutor) \
                        and (id(e.larr.table) in tables
                             or id(e.rarr.table) in tables):
                    return o.name
        return None

    # ------------------------------------------------------------------
    # DML
    # ------------------------------------------------------------------
    def _insert(self, stmt: A.Insert) -> str:
        obj = self.catalog.get(stmt.table)
        reader: ListReader = obj.runtime["reader"]
        assert reader is not None, f"{stmt.table} is not DML-writable"
        schema = obj.schema
        data_cols = [f.name for f in schema.fields if f.name != ROWID]
        target = stmt.columns or data_cols
        rows = []
        for r in stmt.rows:
            vals = {c: _eval_const(e, _dtype(schema, c))
                    for c, e in zip(target, r)}
            # full schema row; _row_id stays NULL for RowIdGen to mint
            rows.append(tuple(vals.get(f.name) for f in schema.fields))
        reader.push(StreamChunk.from_rows(
            schema.dtypes, [(Op.INSERT, r) for r in rows]))
        self.flush()
        return f"INSERT_{len(rows)}"

    # ------------------------------------------------------------------
    # COPY FROM STDIN (pgwire firehose entry point)
    # ------------------------------------------------------------------
    def copy_describe(self, table: str) -> int:
        """Validate a COPY target and return its data-column count (the
        CopyInResponse column count — hidden _row_id excluded)."""
        obj = self.catalog.get(table)
        rt = obj.runtime if isinstance(obj.runtime, dict) else None
        if rt is None or rt.get("reader") is None:
            raise ValueError(f"{table} is not COPY-writable (DML tables "
                             "only — sources pull from their connector)")
        return sum(1 for f in obj.schema.fields if f.name != ROWID)

    def _copy_bucket(self, table: str):
        """The COPY firehose rides the same per-source admission buckets
        as connector sources (PR 14): re-rated by the overload ladder,
        refilled once per epoch. COPY refills its own bucket on epoch
        change — a DML table has no SourceExecutor to do it."""
        b = self._overload.bucket(table)
        if b.shed_sink is None:
            b.shed_sink = self._shed_record   # audited drops -> rw_shed_log
        cur = self.injector.epoch.curr
        if getattr(b, "_copy_epoch", None) != cur:
            b._copy_epoch = cur
            b.epoch_refill(max(1, b.stretch))
        return b

    def copy_chunk(self, table: str, text: str, fmt: str = "text",
                   delim: str = "\t",
                   force: bool = False) -> Tuple[str, int]:
        """One admission-gated COPY batch: parse `text` (newline-framed
        rows in the given format) and push through the table's DML
        reader. Returns (verdict, rows): `defer` pushed nothing — the
        caller holds the wire (TCP backpressure to the producer) and
        retries; `shed` dropped the batch with a durable rw_shed_log
        audit row (shedding rung + RW_LOAD_SHED only); `admit` pushed.
        `force` bypasses a defer after the caller's bounded wait so a
        COPY can never deadlock on a quiescent barrier clock."""
        obj = self.catalog.get(table)
        reader = (obj.runtime or {}).get("reader")
        assert reader is not None, f"{table} is not COPY-writable"
        b = self._copy_bucket(table)
        verdict = b.admit()
        if verdict == "defer" and not force:
            return "defer", 0
        rows = self._parse_copy(obj.schema, text, fmt, delim)
        if not rows:
            return "admit", 0
        if verdict == "shed":
            b.note_shed(self.injector.epoch.curr, len(rows))
            return "shed", len(rows)
        b.note_admitted(len(rows))
        reader.push(StreamChunk.from_rows(
            obj.schema.dtypes, [(Op.INSERT, r) for r in rows]))
        return "admit", len(rows)

    def copy_rows(self, table: str, text: str, fmt: str = "text",
                  delim: str = "\t") -> int:
        """Admission-gated COPY with a bounded defer wait (the embedded
        API / pgwire convenience wrapper around copy_chunk)."""
        import time as _time
        deadline = _time.monotonic() + 1.0
        while True:
            verdict, n = self.copy_chunk(
                table, text, fmt, delim,
                force=_time.monotonic() >= deadline)
            if verdict != "defer":
                return n if verdict == "admit" else 0
            _time.sleep(0.01)

    @staticmethod
    def _parse_copy(schema: Schema, text: str, fmt: str,
                    delim: str) -> List[Tuple]:
        """COPY text/csv lines -> full-schema host rows (the minimal PG
        subset: text format with \\N NULLs and backslash escapes, csv
        with RFC-4180 quoting — embedded delimiters/newlines/doubled
        quotes inside quoted fields — where an empty UNQUOTED field is
        NULL and a quoted empty field is the empty string)."""
        from ..connectors.base import _coerce
        fields = [f for f in schema.fields if f.name != ROWID]
        has_rowid = len(fields) != len(schema.fields)
        rows: List[Tuple] = []

        def build(vals: List[Optional[str]]) -> None:
            if len(vals) != len(fields):
                raise ValueError(
                    f"COPY row has {len(vals)} columns, table expects "
                    f"{len(fields)}")
            r = [None if v is None else _coerce(v, f.dtype)
                 for v, f in zip(vals, fields)]
            rows.append(tuple(r) + ((None,) if has_rowid else ()))

        if fmt == "csv":
            for parts in _csv_rows(text, delim):
                if parts == ["\\."]:     # end-of-data marker (PG
                    continue             # recognizes it in csv too)
                build(parts)
        else:
            import re
            # single-pass unescape: sequential str.replace would let an
            # escaped backslash's second byte re-match as '\\t' etc.
            unesc = {"t": "\t", "n": "\n", "r": "\r", "\\": "\\"}
            pat = re.compile(r"\\(.)")
            for ln in text.split("\n"):
                ln = ln.rstrip("\r")
                if not ln or ln == "\\.":
                    continue
                vals: List[Optional[str]] = []
                for p in ln.split(delim):
                    if p == "\\N":
                        vals.append(None)
                    else:
                        vals.append(pat.sub(
                            lambda m: unesc.get(m.group(1), m.group(1)),
                            p))
                build(vals)
        return rows

    def _delete(self, stmt: A.Delete) -> str:
        obj = self.catalog.get(stmt.table)
        if obj.append_only:
            raise ValueError(
                f"table {stmt.table!r} is APPEND ONLY: DELETE is not "
                "allowed (the plan property is load-bearing downstream)")
        reader: ListReader = obj.runtime["reader"]
        assert reader is not None
        # bind predicate against the table, evaluate over the current MV
        rows = list(obj.runtime["state_table"].iter_all())
        if not rows:
            return "DELETE_0"
        chunk = StreamChunk.from_rows(obj.schema.dtypes,
                                      [(Op.DELETE, r) for r in rows])
        if stmt.where is not None:
            ns = Namespace.of_schema(obj.schema, stmt.table)
            pred = Binder(ns).bind(stmt.where)
            col = pred.eval(chunk)
            keep = np.asarray(col.values, dtype=object)
            mask = np.array([bool(v) and bool(ok)
                             for v, ok in zip(keep, col.validity)])
            chunk = chunk.with_visibility(chunk.vis_mask() & mask)
        chunk = chunk.compact()
        if chunk.capacity == 0:
            return "DELETE_0"
        # deletes flow through the source so downstream MVs retract; rows
        # already carry their _row_id (RowIdGen preserves non-NULL ids)
        reader.push(chunk)
        n = chunk.capacity
        self.flush()
        return f"DELETE_{n}"

    def _update(self, stmt: A.Update) -> str:
        """UPDATE = U-/U+ pairs through the source (row ids preserved, so
        downstream retraction works like the reference's DML update path)."""
        obj = self.catalog.get(stmt.table)
        if obj.append_only:
            raise ValueError(
                f"table {stmt.table!r} is APPEND ONLY: UPDATE is not "
                "allowed (the plan property is load-bearing downstream)")
        reader: ListReader = obj.runtime["reader"]
        assert reader is not None, f"{stmt.table} is not DML-writable"
        rows = list(obj.runtime["state_table"].iter_all())
        if not rows:
            return "UPDATE_0"
        ns = Namespace.of_schema(obj.schema, stmt.table)
        b = Binder(ns)
        scan = StreamChunk.from_rows(obj.schema.dtypes,
                                     [(Op.INSERT, r) for r in rows])
        if stmt.where is not None:
            col = b.bind(stmt.where).eval(scan)
            keep = [bool(v) and bool(ok)
                    for v, ok in zip(col.values, col.validity)]
        else:
            keep = [True] * len(rows)
        assigns = [(obj.schema.index_of(c), b.bind(e))
                   for c, e in stmt.assignments]
        new_cols = {i: e.eval(scan) for i, e in assigns}
        pairs = []
        n = 0
        for ri, row in enumerate(rows):
            if not keep[ri]:
                continue
            new_row = list(row)
            for i, _ in assigns:
                c = new_cols[i]
                new_row[i] = c.get(ri)
            if tuple(new_row) == row:
                continue
            pairs += [(Op.UPDATE_DELETE, row),
                      (Op.UPDATE_INSERT, tuple(new_row))]
            n += 1
        if not pairs:
            return "UPDATE_0"
        reader.push(StreamChunk.from_rows(obj.schema.dtypes, pairs))
        self.flush()
        return f"UPDATE_{n}"

    # ------------------------------------------------------------------
    # barrier loop (GlobalBarrierWorker tick)
    # ------------------------------------------------------------------
    def tick(self) -> None:
        """Inject one barrier and drive every job until it passes."""
        import time as _time
        from ..utils.metrics import REGISTRY
        t0 = _time.perf_counter()
        self._heartbeat_workers()
        # overload control plane: fold this instant's credit-starvation
        # evidence (stall fractions, queue depths, sink stalls) into the
        # per-job degradation ladders and re-rate source admission —
        # BEFORE the barrier goes out, so this tick's dispatch already
        # runs under the decided state (cadence stretch, throttling)
        self._overload.tick(self)
        b = self.injector.inject()
        span = self.tracer.inject(b.epoch.curr, b.kind.value)
        # fused device jobs first: their epoch dispatch is ASYNC (no device
        # sync), so host executors below overlap with device compute
        for jname, job in self._fused.items():
            span.job_start(jname)
            job.on_barrier(b)
            span.job_end(jname)
        for name, it in list(self._iters.items()):
            span.job_start(name)
            for msg in it:
                if isinstance(msg, Barrier) and msg.epoch.curr == b.epoch.curr:
                    break
            span.job_end(name)
        # fold this barrier's ingest stamp (sources noted it while the
        # jobs drove) into the checkpoint window's oldest
        b_ing = b.best_ingest_ts()
        if b_ing is not None:
            self._window_ingest = b_ing if self._window_ingest is None \
                else min(self._window_ingest, b_ing)
        if b.is_checkpoint:
            self.store.commit_epoch(b.epoch.curr)
            self.epoch_committed = b.epoch.curr
            # post-checkpoint sink-committer step: the epoch's log entries
            # are durable now, so external delivery can go out
            for obj in self.catalog.objects.values():
                se = (obj.runtime or {}).get("sink_exec") \
                    if isinstance(obj.runtime, dict) else None
                if se is not None:
                    se.deliver_durable()
            # source->MV freshness: this commit durably reflects every
            # barrier since the LAST checkpoint; anchor = the oldest
            # source-stamped chunk wall across the whole window (the
            # per-barrier stamps folded below — with checkpoint_frequency
            # > 1 the sealing barrier's own stamp would under-report
            # staleness by up to a window). Fused jobs record their own
            # commits (their ingest is the device dispatch, not a host
            # chunk).
            ingest = self._window_ingest
            self._window_ingest = None
            if ingest is not None:
                commit_wall = _time.time()
                for obj in self.catalog.objects.values():
                    rt = obj.runtime if isinstance(obj.runtime, dict) \
                        else None
                    if obj.kind == "mv" and rt \
                            and rt.get("fused_job") is None:
                        self._freshness.commit(obj.name, b.epoch.curr,
                                               ingest, commit_wall)
        # per-worker barrier decomposition + clock-offset samples from
        # the remote result drains, folded into the tracer before the
        # commit event so the jsonl stays ordered within the epoch
        for _name, r in self._remote_sets():
            for epoch, worker, ts in r.drain_align_log():
                self.tracer.worker_align(epoch, worker, ts)
            for worker, sent, recv in r.drain_hb_log():
                self.tracer.hb_sample(worker, sent, recv)
        span.commit()   # barrier fully collected (checkpoint or not)
        # barrier latency + epoch progress (streaming_stats.rs analog)
        REGISTRY.histogram("barrier_latency_seconds",
                           "inject-to-collect barrier latency"
                           ).observe(_time.perf_counter() - t0)
        REGISTRY.counter("barrier_count", "barriers completed").inc()
        REGISTRY.gauge("committed_epoch", "last committed epoch"
                       ).set(self.epoch_committed)
        REGISTRY.gauge("streaming_jobs", "running dataflows"
                       ).set(len(self._iters))

    def _remote_sets(self) -> Iterator[Tuple[str, Any]]:
        """(job name, remote worker set) pairs across all live jobs — the
        shared walk behind the liveness sweep, the worker_liveness gauge
        and the rw_worker_liveness system table."""
        for obj in self.catalog.objects.values():
            rt = obj.runtime if isinstance(obj.runtime, dict) else None
            shared = rt.get("shared") if rt else None
            if shared is None:
                continue
            for e in _walk_executors(shared.upstream):
                r = getattr(e, "_remote", None)
                if r is not None:
                    yield obj.name, r

    def _worker_liveness_rows(self) -> List[Tuple]:
        """rw_worker_liveness rows: per-worker heartbeat age + state (ok /
        wedged? / dead) from the metrics-plane heartbeat frames, plus one
        row per file sink (worker='sink') whose state flips to `stalled`
        while external delivery is deferred — slow-sink isolation's
        liveness surface."""
        import os as _os
        import time as _time
        rows = [row for name, r in self._remote_sets()
                for row in r.liveness_rows(name)]
        now = _time.time()
        for obj in self.catalog.objects.values():
            rt = obj.runtime if isinstance(obj.runtime, dict) else None
            se = rt.get("sink_exec") if rt else None
            if se is not None:
                rows.append((obj.name, "sink", _os.getpid(),
                             se.sink.committed_epoch,
                             now - se.last_delivery_ts,
                             "stalled" if se.stalled else "ok"))
        return rows

    def _shed_record(self, source: str, epoch: int, rows: int) -> None:
        """AdmissionBucket shed sink: audit one shed source window into
        the durable rw_shed_log (committed at the current epoch, durable
        at the next checkpoint — the rw_dead_letter pattern)."""
        self._shed_log.record(source, epoch, rows, "admission",
                              self.injector.epoch.curr)
        from ..utils.blackbox import RECORDER
        RECORDER.record("shed", {"source": source, "epoch": int(epoch),
                                 "rows": int(rows)})

    def _heartbeat_workers(self) -> None:
        """Proactive worker liveness sweep, once per barrier tick (the
        meta heartbeat/expire analog, `src/meta/src/manager/cluster.rs`):
        a worker that dies while its job is QUIESCENT surfaces at the
        next tick instead of whenever traffic next touches its stream,
        and a WEDGED worker (alive, heartbeat frames gone stale) shows in
        the worker_liveness gauge before any spawn/drain deadline."""
        from ..runtime.remote_fragments import RemoteWorkerDied
        from ..utils.metrics import REGISTRY
        liveness = REGISTRY.gauge(
            "worker_liveness",
            "seconds since a worker's last metrics-plane heartbeat",
            labels=("job", "worker"))
        for name, r in self._remote_sets():
            for job, wname, _pid, _ep, age, _state in r.liveness_rows(name):
                liveness.labels(job, wname).set(age)
            if getattr(r, "supervisor", None) is not None:
                # supervised sets self-heal (or escalate) in place —
                # the sweep is just an extra detection path for
                # deaths while the job is quiescent
                r.check_alive()
                continue
            r._check_wedged()
            for w in r.workers:
                if w.proc.poll() is not None:
                    REGISTRY.counter(
                        "worker_heartbeat_failures",
                        "dead workers caught by the heartbeat sweep"
                        ).inc()
                    raise RemoteWorkerDied(
                        f"worker pid={w.proc.pid} of job "
                        f"{name!r} exited rc="
                        f"{w.proc.returncode} (heartbeat sweep; "
                        "restart the job — DDL replay rebuilds it)")

    # ------------------------------------------------------------------
    # dead-letter queue (poison-pill quarantine surface)
    # ------------------------------------------------------------------
    def dlq_requeue(self, job: str, ids: Optional[Sequence[int]] = None
                    ) -> int:
        """Re-inject quarantined input rows of `job` back into its live
        remote worker sets (risectl `dlq --requeue`): decode each
        payload, re-apply it to the shadow, route it to its key-owning
        worker, and flip the entry to status='requeued'. Returns the row
        count. Call between ticks; the next barrier states the rows
        downstream exactly once."""
        from ..core.encoding import decode_row
        rset = None
        for name, r in self._remote_sets():
            if name == job:
                rset = r
                break
        if rset is None:
            # resolve the worker set BEFORE filtering entries: a requeue
            # against a job that cannot consume one must fail with the
            # reason, not report "requeued 0 rows"
            obj = self.catalog.objects.get(job)
            if obj is not None and isinstance(obj.runtime, dict) \
                    and obj.runtime.get("fused_job") is not None:
                raise ValueError(
                    f"cannot requeue into {job!r}: it is a FUSED device "
                    "job — its input regenerates deterministically on "
                    "device and there is no remote worker set to consume "
                    "a requeue. Quarantined rows of a fused job can only "
                    "be listed or purged (`risectl dlq " + job +
                    " --purge ...`); see README 'Dead-letter queue'.")
            if obj is None:
                raise ValueError(f"cannot requeue into {job!r}: no such "
                                 "job in the catalog")
            raise ValueError(
                f"cannot requeue into {job!r}: the job has no live "
                "remote worker set (local placement). Only process-"
                "placement jobs (SET streaming_placement TO process) "
                "have dead-letter consumers.")
        ents = self._dlq.entries(job=job, status="quarantined")
        if ids is not None:
            idset = {int(x) for x in ids}
            ents = [e for e in ents if int(e[0]) in idset]
        if not ents:
            return 0
        n = 0
        by_side: Dict[int, List[Tuple[int, Tuple]]] = {}
        for e in ents:
            side = int(e[3])
            row = decode_row(e[8], list(rset.in_dtypes[side]))
            by_side.setdefault(side, []).append((int(e[6]), tuple(row)))
        for side, pairs in by_side.items():
            n += rset.requeue_rows(side, pairs)
        self._dlq.mark([e[0] for e in ents], "requeued",
                       self.injector.epoch.curr)
        return n

    def dlq_purge(self, job: str, ids: Optional[Sequence[int]] = None
                  ) -> int:
        """Drop dead-letter entries of `job` outright (audit closed,
        data loss accepted)."""
        ents = self._dlq.entries(job=job)
        if ids is not None:
            idset = {int(x) for x in ids}
            ents = [e for e in ents if int(e[0]) in idset]
        return self._dlq.mark([e[0] for e in ents], None,
                              self.injector.epoch.curr)

    def metrics(self) -> str:
        """Prometheus text exposition (MonitorService analog)."""
        from ..utils.metrics import REGISTRY
        return REGISTRY.expose()

    def flush(self, ticks: int = 2) -> str:
        for _ in range(ticks):
            self.tick()
        return "FLUSH"

    # ------------------------------------------------------------------
    # batch SELECT
    # ------------------------------------------------------------------
    def _batch_subscribe(self, inj: BarrierInjector):
        def subscribe(name: str):
            from .system_catalog import SYSTEM_TABLES
            if name in SYSTEM_TABLES and name not in self.catalog.objects:
                schema, builder = SYSTEM_TABLES[name]
                rows = builder(self)
                chunks = ([StreamChunk.from_rows(
                    schema.dtypes, [(Op.INSERT, r) for r in rows])]
                    if rows else [])
                src = SourceExecutor(schema, ListReader(chunks), inj,
                                     name=f"SysScan({name})")
                return src, schema, list(range(len(schema)))
            obj = self.catalog.get(name)
            job = (obj.runtime or {}).get("fused_job")
            if job is not None:
                # sync + pull the CURRENT device MV, through the serving
                # cache (a fresh snapshot is a host-memory hit; misses
                # coalesce onto one device pull)
                rows = self._serve_mv_rows(name, job)
            elif obj.runtime.get("state_table") is None:
                raise ValueError(
                    f"source {name!r} is not directly queryable (sources "
                    "are unmaterialized streams — create a MATERIALIZED "
                    "VIEW over it)")
            else:
                rows = list(obj.runtime["state_table"].iter_all())
            chunks = []
            if rows:
                chunks.append(StreamChunk.from_rows(
                    obj.schema.dtypes, [(Op.INSERT, r) for r in rows]))
            src = SourceExecutor(obj.schema, ListReader(chunks), inj,
                                 name=f"Scan({name})")
            return src, obj.schema, obj.pk

        return subscribe

    def _run_batch_setop(self, q: A.SetOp) -> List[Tuple]:
        """One-shot UNION [ALL] over snapshots (stream-replay path)."""
        self.flush(1)
        inj = BarrierInjector()
        # plan without the trailing order/limit; applied host-side below
        plan_q = A.SetOp(q.op, q.all, q.left, q.right)
        execu, ns = self._make_planner(self._batch_subscribe(inj),
                                       inj=inj).plan_query(plan_q)
        n_vis = ns.n_visible or len(ns.cols)
        self.last_description = [(c.name, c.dtype)
                                 for c in ns.cols[:n_vis]]
        state: Dict[Tuple, int] = {}
        it = execu.execute()
        inj.inject()
        inj.inject_stop()
        for msg in it:
            if isinstance(msg, StreamChunk):
                for op, r in msg.compact().op_rows():
                    state[r] = state.get(r, 0) + (1 if op.is_insert else -1)
        out = [r for r, n in state.items() for _ in range(n)]
        if q.order_by:
            name_of = {c.name: i for i, c in
                       reversed(list(enumerate(ns.cols[:n_vis])))}
            for e, desc in reversed(q.order_by):
                if not isinstance(e, A.Col) or e.name not in name_of:
                    raise ValueError("ORDER BY after UNION must reference "
                                     "output columns")
                i = name_of[e.name]
                out.sort(key=lambda r: _sort_key(r[i]), reverse=desc)
        if q.offset:
            out = out[q.offset:]
        if q.limit is not None:
            out = out[: q.limit]
        return [r[:n_vis] for r in out]

    def _serve_mv_rows(self, name: str, job) -> List[Tuple]:
        """Fused-MV rows through the serving cache: a snapshot stamped
        at the job's current epoch counter is a host-memory hit;
        misses fill through `mv_rows_versioned` (torn-pull-safe) with
        concurrent readers coalesced onto the single device pull."""
        from ..config import ROBUSTNESS
        if not ROBUSTNESS.serving_cache:
            return job.mv_rows_now()
        # the version stamp (`job.counter`) is an EVENT count; the knob
        # is in fused epochs — convert so `rw_serving_staleness_epochs=2`
        # tolerates two dispatched epochs, whatever their event budget
        staleness = max(0, int(ROBUSTNESS.serving_staleness_epochs)) \
            * max(1, int(getattr(job.program, "epoch_events", 1) or 1))
        served_epoch, rows = self.read_cache.get(
            name, int(job.counter), staleness, job.mv_rows_versioned)
        # SERVED staleness: when the cache answered from an older epoch
        # (within the staleness bound), rw_mv_freshness must report the
        # lag the reader actually experienced, not the store's head
        self._freshness.note_served(name, int(served_epoch),
                                    int(job.counter),
                                    self.read_cache.fill_time(name))
        return rows

    def _serving_mvs(self, ref) -> Optional[List[str]]:
        """Names of the fused MVs a FROM tree reads, or None when any
        base relation is NOT a fused MV (host tables, sources, system
        tables, table functions: all ineligible for cache serving)."""
        if isinstance(ref, A.NamedTable):
            obj = self.catalog.objects.get(ref.name)
            rt = obj.runtime if obj is not None else None
            job = rt.get("fused_job") if isinstance(rt, dict) else None
            return [ref.name] if job is not None else None
        if isinstance(ref, A.Join):
            left = self._serving_mvs(ref.left)
            right = self._serving_mvs(ref.right)
            return left + right \
                if left is not None and right is not None else None
        if isinstance(ref, (A.WindowTable, A.TemporalTable)):
            return self._serving_mvs(ref.inner)
        if isinstance(ref, A.SubqueryTable):
            return self._serving_mvs(ref.query.from_) \
                if ref.query.from_ is not None else None
        return None

    def _serving_skip_flush(self, q, serving: bool) -> bool:
        """Whether a pgwire SELECT may skip the per-statement flush and
        serve from the read cache. Only the serving front door opts in
        (`serving=True`); embedded `Database.query` keeps the flush so
        its SELECT-advances-the-stream semantics are untouched. The
        SELECT must read only fused MVs, and at least one checkpoint
        must have committed (a cold engine still flushes once)."""
        from ..config import ROBUSTNESS
        if not serving or not ROBUSTNESS.serving_cache:
            return False
        if getattr(q, "from_", None) is None:
            return False
        return self.epoch_committed > 0 \
            and self._serving_mvs(q.from_) is not None

    def _run_batch_select(self, q, serving: bool = False) -> List[Tuple]:
        # SELECT without FROM: evaluate constant expressions
        if isinstance(q, A.SetOp):
            return self._run_batch_setop(q)
        if q.from_ is None:
            row = tuple(_eval_const(i.expr, None) for i in q.items)
            self.last_description = [
                (it.alias or "?column?", _const_dtype(v))
                for it, v in zip(q.items, row)]
            return [row]
        if not self._serving_skip_flush(q, serving):
            self.flush(1)
        inj = BarrierInjector()
        subscribe = self._batch_subscribe(inj)
        # plan without limit/order; ORDER BY columns ride along as hidden
        # trailing items (PG allows ordering by non-output expressions)
        items = list(q.items) + [A.SelectItem(e, f"__ord{i}")
                                 for i, (e, _) in enumerate(q.order_by)]
        plan_q = A.Select(items, q.from_, q.where, q.group_by, q.having,
                         [], None, None, q.distinct)
        execu, ns = self._make_planner(subscribe,
                                       inj=inj).plan_select(plan_q)
        # visible = user items (stars expanded) — minus hidden ORDER BY
        # helpers and planner-appended stream-key columns
        n_vis = (ns.n_visible or len(ns.cols)) - len(q.order_by)
        # row description for wire-protocol frontends (pgwire RowDescription)
        self.last_description = [(c.name, c.dtype)
                                 for c in ns.cols[:n_vis]]
        # preferred path: convert to batch executors (vectorized one-shot
        # pipeline, src/batch analog). Plans with no batch form yet replay
        # as a bounded stream (the pre-batch-engine behavior).
        from ..batch import SeqScan, translate_stream_plan

        def scan_of(src):
            return SeqScan(src.schema, [c.data_chunk()
                                        for c in src.reader.chunks],
                           name=src.name)

        batch = translate_stream_plan(execu, scan_of)
        if batch is not None:
            out = batch.rows()
        else:
            state: Dict[Tuple, int] = {}
            it = execu.execute()
            inj.inject()
            inj.inject_stop()
            for msg in it:
                if isinstance(msg, StreamChunk):
                    for op, r in msg.compact().op_rows():
                        if op.is_insert:
                            state[r] = state.get(r, 0) + 1
                        else:
                            state[r] = state.get(r, 0) - 1
            out = [r for r, n in state.items() for _ in range(n)]
        for i in range(len(q.order_by) - 1, -1, -1):
            desc = q.order_by[i][1]
            out.sort(key=lambda r: _sort_key(r[n_vis + i]), reverse=desc)
        if q.offset:
            out = out[q.offset:]
        if q.limit is not None:
            out = out[: q.limit]
        return [r[:n_vis] for r in out]


def _csv_rows(text: str, delim: str) -> List[List[Optional[str]]]:
    """RFC-4180 row splitter for COPY csv: quoted fields may hold the
    delimiter, newlines, and doubled quotes; an UNQUOTED empty field is
    NULL (None) while a quoted empty field is ''. A hand state machine
    because csv.reader both discards quoted-ness (collapsing '\"\"' and
    '' to the same value) and needs pre-split lines (tearing embedded
    newlines)."""
    rows: List[List[Optional[str]]] = []
    field: List[str] = []
    row: List[Optional[str]] = []
    quoted = False      # current field was opened with a quote
    in_q = False        # currently inside the quotes
    i, n = 0, len(text)

    def end_field():
        nonlocal quoted
        v = "".join(field)
        row.append(v if quoted or v != "" else None)
        field.clear()
        quoted = False

    while i < n:
        c = text[i]
        if in_q:
            if c == '"':
                if i + 1 < n and text[i + 1] == '"':
                    field.append('"')
                    i += 1
                else:
                    in_q = False
            else:
                field.append(c)
        elif c == '"' and not field:
            quoted = True
            in_q = True
        elif c == delim:
            end_field()
        elif c == "\n" or c == "\r":
            if c == "\r" and i + 1 < n and text[i + 1] == "\n":
                i += 1
            if field or quoted or row:
                end_field()
                rows.append(list(row))
                row.clear()
        else:
            field.append(c)
        i += 1
    if field or quoted or row:
        end_field()
        rows.append(list(row))
    return rows


def _const_dtype(v) -> DataType:
    """Best-effort output type of a constant expression (pgwire needs a
    RowDescription even for SELECT-without-FROM)."""
    if isinstance(v, bool):
        return T.BOOLEAN
    if isinstance(v, int):
        return T.INT64
    if isinstance(v, float):
        return T.FLOAT64
    return T.VARCHAR


def _sort_key(v):
    return (v is None, v)


def _dtype(schema: Schema, col: str) -> DataType:
    return schema.fields[schema.index_of(col)].dtype


def _coerce(v, dtype: DataType):
    if v is None:
        return None
    return dtype.coerce(v) if hasattr(dtype, "coerce") else v


def _eval_const(e: A.ExprNode, dtype: Optional[DataType]):
    from .planner import eval_const
    return eval_const(e, dtype)


def _extract_delay(bound, time_idx: int) -> int:
    """WATERMARK FOR c AS c - INTERVAL '...' -> delay usecs."""
    from ..expr.expression import FunctionCall, InputRef, Literal
    if isinstance(bound, FunctionCall) and "subtract" in bound.name:
        a, b = bound.args
        if isinstance(b, Literal):
            iv = b.value
            return iv.total_usecs_approx() if hasattr(
                iv, "total_usecs_approx") else int(iv)
    if isinstance(bound, InputRef):
        return 0
    raise ValueError("WATERMARK expression must be `col - INTERVAL '...'`")


def _source_names(q: A.Select) -> List[str]:
    """Every NamedTable under a Select's FROM tree (subqueries included)."""
    out: List[str] = []

    def walk_ref(r):
        if isinstance(r, A.NamedTable):
            out.append(r.name)
        elif isinstance(r, A.SubqueryTable):
            walk(r.query)
        elif isinstance(r, A.ChangelogTable):
            out.append(r.inner)
        elif isinstance(r, A.WindowTable):
            walk_ref(r.inner)
        elif isinstance(r, A.Join):
            walk_ref(r.left)
            walk_ref(r.right)

    def walk(s):
        if isinstance(s, A.SetOp):
            walk(s.left)
            walk(s.right)
        elif s.from_ is not None:
            walk_ref(s.from_)

    walk(q)
    return out
