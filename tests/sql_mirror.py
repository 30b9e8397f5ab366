"""Mirror harness of the SQL parity tests: the JAX package's own SQL test
functions, run with their `Database` bound to a `MirrorDatabase`, which
drives one reference `Database` and one port `Database` (on the CPU)
through the same calls and holds the port's answers to the reference's
call by call.

`MirrorDatabase` builds both databases from the reference test's
arguments: the port gets `torch_device="cpu"` (or the device set a runner
passes as `run_case(..., devices=[...])`, e.g. the eight CPU device names
`cpu:0` .. `cpu:7`, one shard a device as in the reference's layout), its
own data directory (`<dir>_port`), and the port's counterparts of a
`DeviceConfig` or mesh, laid over that set.
By default the device policy "on" becomes `DeviceConfig(fuse=False)` in
both packages (the runners that hold the per-operator plans), and an
int n becomes that with an n-shard mesh: the reference's `make_mesh(n)`
over its eight CPU devices, the port's `make_mesh(n, devices=[cpu])`.
A runner that calls `run_case(..., fuse=True)` keeps fusion as the
reference test asks for it: "on" and every `DeviceConfig` pass through
unchanged (a mesh still mapped), so both packages lower the MV through
`try_fuse`. On every `run`, `query`, `tick`, `flush`,
`copy_rows`, `metrics` and `describe_select` it calls both, asserts equal
normalized results (`host_parity.norm`) — or the same exception class and
message — and returns the reference's (or raises the reference's
exception). After each call it also asserts that the two catalogs agree
(`digest`: every object's kind, schema, pk, table id and options, the
rendered executor tree of each streaming job, the session variables,
system parameters, checkpoint frequency and collected sink rows, and of
each fused job its event counter, committed counter, growth replays,
in-place recoveries, tiering counters, node classes with their
capacities and its stats totals), so a test that reaches the reference's internals
(`db.catalog...`, `db._fused[...]`) is held on the port's side as well.
What such a test sets on a reference fused job before a call reaches the
port's job of the same name too (`_sync_knobs`): its `cadence_stretch`,
and an admission bucket it wires into `job.ingest.buckets` (a bucket the
test built from the twinned `AdmissionBucket` class carries its port
twin). A reference test that runs `risectl` (`ctl.main`) runs both
packages' command, each against the data directory its own package
wrote (`<dir>_port` for the port, on the CPU), and their outputs must be
equal, wall-clock fields masked (`ctl_twin`).

A file sink writes beside the reference's, at `<path>.port`: before a
statement that names one runs, a file the reference's path already holds
(and its manifest) is copied there, so both packages start from the same
file; after every call the two files' bytes must be equal wherever both
exist.

`load(ref_file, mode)` executes a reference test module's source in a
fresh namespace whose imports go through a hook: in "mirror" mode
`from risingwave_tpu.sql import Database` gives the mirror; in "port"
mode every `risingwave_tpu` import gives the port's module of the same
name and `Database` is the port's with `torch_device="cpu"` (and
`ctl.main` the port's with `--torch-device cpu`); in "ref" mode every
import is the reference's own, unchanged. The
reference file is read, never edited. `cases(ref_file)` lists its test
functions (class methods and `parametrize` arms expanded) with the mode
each runs in: "mirror" where it builds a `Database`, "port" where it
only calls library functions (the parser, the optimizer, a connector),
which then run against the port directly.
"""
from __future__ import annotations

import builtins
import contextlib
import dataclasses
import inspect
import io
import os
import re
import shutil
import sys
import types
from pathlib import Path

import pytest
import torch

from host_parity import norm

REF_ROOT, PORT_ROOT = "risingwave_tpu", "risingwave_tpu_torch"
TESTS = Path(__file__).resolve().parent
CPU = torch.device("cpu")

import risingwave_tpu.sql as _ref_sql                     # noqa: E402
import risingwave_tpu.sql.system_catalog                  # noqa: E402,F401
import risingwave_tpu_torch.sql as _port_sql              # noqa: E402
import risingwave_tpu_torch.sql.system_catalog            # noqa: E402,F401
from risingwave_tpu import config as _ref_config          # noqa: E402
from risingwave_tpu_torch import config as _port_config   # noqa: E402

RefDatabase = _ref_sql.Database
PortDatabase = _port_sql.Database

# sink files of the running test: (reference path, port path)
SINK_PATHS: list = []


# ---------------------------------------------------------------------------
# argument mapping
# ---------------------------------------------------------------------------


def port_devices():
    """The port's device set of the running case (`run_case`'s
    `devices`, by default the CPU alone)."""
    return PORT_DEVICES[0] or [CPU]


def _port_mesh(mesh):
    from risingwave_tpu_torch.parallel import make_mesh
    return make_mesh(int(mesh.devices.size), devices=port_devices())


# set by `run_case(..., fuse=True)` for the duration of one case
KEEP_FUSE = [False]
# set by `run_case(..., twins=...)`: the TWINS names act on both packages
TWINS_ON = [False]
# set by `run_case(..., unordered=True)`: query results compare as
# multisets (process placement: see `run_case`)
UNORDERED = [False]
# set by `run_case(..., devices=[...])`: the port's device set
PORT_DEVICES = [None]


def map_device(device):
    """The reference test's device argument -> (reference's, port's)."""
    keep = KEEP_FUSE[0]
    if device is None or isinstance(device, str) and device in ("off",
                                                                "auto"):
        return device, device
    if isinstance(device, str) and device in ("on", "single"):
        if keep:
            return device, device
        return (_ref_config.DeviceConfig(fuse=False),
                _port_config.DeviceConfig(fuse=False))
    if isinstance(device, int) and not isinstance(device, bool):
        from risingwave_tpu.parallel import make_mesh
        from risingwave_tpu_torch.parallel import make_mesh as port_mesh
        return (_ref_config.DeviceConfig(fuse=False,
                                         mesh=make_mesh(device)),
                _port_config.DeviceConfig(
                    fuse=False, mesh=port_mesh(device,
                                               devices=port_devices())))
    if isinstance(device, _ref_config.DeviceConfig):
        kw = {f.name: getattr(device, f.name)
              for f in dataclasses.fields(device)}
        if not keep:
            kw["fuse"] = False
        ref = _ref_config.DeviceConfig(**kw)
        if kw["mesh"] is not None:
            kw["mesh"] = _port_mesh(kw["mesh"])
        return ref, _port_config.DeviceConfig(**kw)
    raise TypeError(f"mirror: no mapping for device={device!r}")


def port_dir(d):
    return None if d is None else str(d) + "_port"


def port_sql(sql: str) -> str:
    """The port's text of a statement: a CREATE SINK's `fs.path` moves to
    `<path>.port`, after whatever the reference's path holds is copied
    there."""
    if not re.search(r"\bCREATE\s+SINK\b", sql, re.I):
        return sql

    def move(m):
        ref = m.group(2)
        port = ref + ".port"
        for suffix in ("", ".manifest"):
            if os.path.exists(ref + suffix) \
                    and not os.path.exists(port + suffix):
                shutil.copyfile(ref + suffix, port + suffix)
        if (ref, port) not in SINK_PATHS:
            SINK_PATHS.append((ref, port))
        return m.group(1) + port + m.group(3)
    return re.sub(r"(fs\.path\s*=\s*')([^']*)(')", move, sql)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def _tree(cat, e, seen):
    """A live executor tree as nested (label, children): the package's
    EXPLAIN label (`system_catalog._label`) of every node that has one
    — a channel between fragments has only its class name."""
    if id(e) in seen:
        return ("<seen>", type(e).__name__)
    seen.add(id(e))
    label = cat._label(e) if hasattr(e, "name") else type(e).__name__
    return (label, [_tree(cat, c, seen) for c in cat._plan_children(e)])


def _plan(pkg_sql, obj):
    rt = obj.runtime if isinstance(obj.runtime, dict) else {}
    shared = rt.get("shared")
    if shared is None:
        return None
    return _tree(pkg_sql.system_catalog, shared.upstream, set())


def digest(db, pkg_sql):
    """What the two catalogs must agree on after every call."""
    objs = []
    for name, o in sorted(db.catalog.objects.items()):
        opts = {k: (v[:-len(".port")] if k == "fs.path"
                    and v.endswith(".port") else v)
                for k, v in sorted(o.with_options.items())}
        objs.append((name, o.kind,
                     [(f.name, repr(f.dtype)) for f in o.schema.fields],
                     list(o.pk), o.table_id, o.append_only, opts,
                     o.watermark_col, o.watermark_delay_usecs, o.n_visible,
                     o.parallelism, o.index_on, _plan(pkg_sql, o)))
    return (objs, db.catalog._next_table_id,
            norm(sorted(db.session_vars.items())),
            norm(sorted(db.system_params.values.items())),
            db.injector.checkpoint_frequency,
            norm(db.sink_results),
            [_fused_state(name, job)
             for name, job in sorted(db._fused.items())])


def _fused_state(name, job):
    """What a fused job of either package must agree on: its counters,
    its growth replays, its in-place recoveries, its tiering counters,
    its adopted skew policies (switch count, vnode bounds, each node's
    hot-key arm, keys and broadcast side), its nodes' classes and
    capacities and the job-lifetime stats totals (in the stat layout's
    order)."""
    bounds = job.program.vnode_bounds
    return (name, int(job.counter), int(job.committed),
            int(job.growth_replays),
            int(job.recoveries),
            sorted(job.tiering.counters.items())
            if job.tiering is not None else None,
            int(job.rebalances),
            None if bounds is None else [int(b) for b in bounds],
            [(type(n).__name__, sorted(n.cap_current().items()),
              bool(n.hotrep), [int(k) for k in n.hot_keys],
              int(n.hot_rep_side))
             for n in job.program.nodes],
            [int(v) for v in job._stat_totals])


def _sync_knobs(ref_db, port_db):
    """What a test set on the reference's fused jobs, on the port's: the
    cadence stretch, and the port twins of the admission buckets it wired
    (their throttle factor with them)."""
    for name, rjob in ref_db._fused.items():
        pjob = port_db._fused.get(name)
        if pjob is None:
            continue
        pjob.cadence_stretch = rjob.cadence_stretch
        ring = getattr(rjob, "ingest", None)
        ping = getattr(pjob, "ingest", None)
        if ring is None or ping is None:
            continue
        for sname, b in ring.buckets.items():
            pb = getattr(b, "_port_twin", None)
            if pb is not None:
                ping.buckets[sname] = pb
                pb.factor = b.factor


def _hold_stage(job):
    """The port job's policy stages start not ready: the harness, not the
    stage, says when a staged policy may adopt (`_sync_policy`)."""
    if "_stage_policy" in vars(job):
        return
    stage = job._stage_policy

    def held(bounds, hot_map):
        stage(bounds, hot_map)
        job._pending_policy[2].clear()
    job._stage_policy = held


def _sync_policy(ref_db, port_db):
    """A mesh skew policy adopts in the port at the checkpoint where the
    reference adopted it. The reference adopts at the first checkpoint
    that finds its background exchange pre-warm finished — a wall-clock
    race — the port at the checkpoint after the stage (it has nothing to
    warm). Before each port call, a staged policy of the port's job is
    let adopt exactly when the reference's job adopted as many policies
    during the same call; the routing, and so every stat and capacity,
    then moves at the same epoch in both."""
    for name, rjob in ref_db._fused.items():
        pjob = port_db._fused.get(name)
        if pjob is None or not hasattr(pjob, "_pending_policy"):
            continue
        _hold_stage(pjob)
        if pjob._pending_policy is None:
            continue
        ready = pjob._pending_policy[2]
        if getattr(rjob, "_policy_seq", 0) > pjob._policy_seq:
            ready.set()
        else:
            ready.clear()


def _sinks_equal():
    for ref, port in SINK_PATHS:
        if os.path.exists(ref) and os.path.exists(port):
            with open(ref, "rb") as a, open(port, "rb") as b:
                ra, rb = a.read(), b.read()
            assert ra == rb, (f"sink file {ref}: reference {ra[:500]!r} "
                              f"vs port {rb[:500]!r}")


def _unport(msg: str) -> str:
    """A port message with the port's own paths put back to the
    reference's."""
    for ref, port in SINK_PATHS:
        msg = msg.replace(port, ref)
    return msg


def _call(what, ref_fn, port_fn, result_norm=norm):
    """Both calls; equal results or equal exceptions; the reference's."""
    try:
        ref = ref_fn()
    except Exception as e:              # noqa: BLE001 — compared below
        try:
            port = port_fn()
        except Exception as pe:         # noqa: BLE001
            assert (type(pe).__name__, _unport(str(pe))) == \
                (type(e).__name__, str(e)), \
                f"{what}: the port raised {pe!r}, the reference {e!r}"
        else:
            raise AssertionError(
                f"{what}: the reference raised {e!r}, the port returned "
                f"{port!r:.500}") from e
        raise
    try:
        port = port_fn()
    except Exception as pe:             # noqa: BLE001
        raise AssertionError(
            f"{what}: the port raised {pe!r}, the reference returned "
            f"{ref!r:.500}") from pe
    a, b = result_norm(ref), result_norm(port)
    assert a == b, f"{what}:\nref:  {ref!r:.2000}\nport: {port!r:.2000}"
    return ref


class MirrorDatabase:
    """One reference and one port `Database`, driven call by call."""

    def __init__(self, store=None, data_dir=None, checkpoint_frequency=None,
                 device=None, config=None):
        if store is not None:
            raise TypeError("mirror: pass data_dir, not a store object")
        ref_dev, port_dev = map_device(device)
        pdir = port_dir(data_dir)
        if data_dir is None and isinstance(config, str):
            cfg_dir = _port_config.NodeConfig.from_toml(
                config).storage.data_dir
            pdir = port_dir(cfg_dir) if cfg_dir else None
        ref_kw = dict(data_dir=data_dir,
                      checkpoint_frequency=checkpoint_frequency,
                      device=ref_dev, config=config)
        port_kw = dict(data_dir=pdir,
                       checkpoint_frequency=checkpoint_frequency,
                       device=port_dev, config=config,
                       torch_device=port_devices())
        box = {}

        def make(cls, kw, key):
            box[key] = cls(**kw)
            return None
        _call("Database()", lambda: make(RefDatabase, ref_kw, "ref"),
              lambda: make(PortDatabase, port_kw, "port"))
        self._ref, self._port = box["ref"], box["port"]
        self._check("Database()")

    def _check(self, what):
        a = digest(self._ref, _ref_sql)
        b = digest(self._port, _port_sql)
        assert a == b, f"{what}: catalogs differ\nref:  {a!r:.3000}\n" \
                       f"port: {b!r:.3000}"
        _sinks_equal()

    def _mirror(self, name, *args, result_norm=norm, **kw):
        what = f"{name}{args!r:.300}"
        _sync_knobs(self._ref, self._port)
        pargs = tuple(port_sql(a) if isinstance(a, str) and name == "run"
                      else a for a in args)
        def port_call():
            _sync_policy(self._ref, self._port)
            return getattr(self._port, name)(*pargs, **kw)
        try:
            return _call(what, lambda: getattr(self._ref, name)(*args, **kw),
                         port_call, result_norm)
        finally:
            self._check(what)

    def run(self, sql):
        return self._mirror("run", sql, result_norm=_result_norm(sql))

    def query(self, sql):
        return self._mirror("query", sql, result_norm=_result_norm(sql))

    def tick(self):
        return self._mirror("tick")

    def flush(self, ticks: int = 2):
        return self._mirror("flush", ticks)

    def copy_rows(self, *args, **kw):
        return self._mirror("copy_rows", *args, **kw)

    def describe_select(self, q):
        # the statement is an AST of one package: each parses its own
        text = q if isinstance(q, str) else None
        if text is None:
            raise TypeError("mirror: describe_select takes SQL text")
        return _call(f"describe_select({text!r:.300})",
                     lambda: self._ref.describe_select(
                         _ref_sql.parse_sql(text)[0]),
                     lambda: self._port.describe_select(
                         _port_sql.parse_sql(text)[0]))

    def metrics(self):
        # each package has its own process-wide registry, filled by
        # whatever ran before in this process: the texts are not
        # compared, only that the port's is an exposition
        ref = self._ref.metrics()
        port = self._port.metrics()
        assert isinstance(port, str) and isinstance(ref, str)
        return ref

    @property
    def store(self):
        return _MirrorStore(self._ref.store, self._port.store)

    def __getattr__(self, name):
        # internals (db.catalog, db.session_vars, ...) are the
        # reference's; `_check` holds the port's to them after each call
        return getattr(self._ref, name)


class _MirrorStore:
    """The reference's store, whose `backup(path)` backs the port's up
    too, to `<path>_port` (where a mirror opened on `path` looks)."""

    def __init__(self, ref, port):
        self._ref, self._port = ref, port

    def backup(self, path):
        out = self._ref.backup(path)
        self._port.backup(port_dir(path))
        return out

    def close(self):
        self._port.close()
        return self._ref.close()

    def __getattr__(self, name):
        return getattr(self._ref, name)


# system tables whose float columns are wall-clock readings taken in each
# package (a barrier's elapsed ms, an epoch's phase walls, a commit's
# freshness): compared by presence and type only
WALL_CLOCK_TABLES = ("rw_barrier_trace", "rw_epoch_profile",
                     "rw_mv_freshness")
# the wall-derived fields of a fused EXPLAIN ANALYZE (elapsed time, event
# rates, phase shares, compile walls): masked, the rest compared verbatim
_ANALYZE_WALLS = (
    (re.compile(r"\b(elapsed=)[0-9.]+s"), r"\1<wall>s"),
    (re.compile(r"\b(eps(?:_in|_out)?=)[0-9]+"), r"\1<wall>"),
    (re.compile(r"\b(compile_s=)[0-9.]+"), r"\1<wall>"),
    (re.compile(r"^phase share: .*$", re.M), "phase share: <walls>"),
)


def _analyze_masked(v):
    if isinstance(v, str):
        for pat, rep in _ANALYZE_WALLS:
            v = pat.sub(rep, v)
        return v
    if isinstance(v, (list, tuple)):
        return type(v)(_analyze_masked(x) for x in v)
    return v


def _wall_masked(v):
    if isinstance(v, float):
        return "<wall-clock float>"
    if isinstance(v, (list, tuple)):
        return type(v)(_wall_masked(x) for x in v)
    return v


def _result_norm(sql):
    if re.match(r"\s*EXPLAIN\s+ANALYZE\b", sql, re.I):
        return lambda r: norm(_analyze_masked(r))
    if any(re.search(rf"\b{t}\b", sql) for t in WALL_CLOCK_TABLES):
        return lambda r: norm(_wall_masked(r))
    if UNORDERED[0]:
        return _multiset
    return norm


def _multiset(r):
    if isinstance(r, list):
        return norm(sorted(r, key=lambda row: repr(norm(row))))
    return norm(r)


class PortTestDatabase(PortDatabase):
    """The port's `Database` as a port-mode test builds it: on the CPU,
    with the reference test's device argument mapped."""

    def __init__(self, store=None, data_dir=None, checkpoint_frequency=None,
                 device=None, config=None, torch_device=CPU):
        _ref_dev, port_dev = map_device(device) if not isinstance(
            device, _port_config.DeviceConfig) else (None, device)
        super().__init__(store=store, data_dir=data_dir,
                         checkpoint_frequency=checkpoint_frequency,
                         device=port_dev, config=config,
                         torch_device=torch_device)


# ---------------------------------------------------------------------------
# loading a reference test module
# ---------------------------------------------------------------------------


def _proxy(mod, **names):
    p = types.ModuleType(mod.__name__)
    p.__dict__.update(mod.__dict__)
    p.__dict__.update(names)
    return p


def _on_cpu(cls):
    """A port-mode stand-in for a device executor class the test builds
    itself: the same class with `device="cpu"` as its default."""
    def __init__(self, *args, device=CPU, **kw):
        cls.__init__(self, *args, device=device, **kw)
    return type(cls.__name__, (cls,), {"__init__": __init__,
                                       "__module__": cls.__module__})


CPU_DEFAULT = ("DeviceHashAggExecutor", "DeviceHashJoinExecutor")


# process-wide knobs, switches and counters a reference test sets or
# resets on the reference's module: in mirror mode the name it imports acts
# on both packages' (a knob object's attributes are set in both and read
# from the reference's, its methods run in both; a function runs in both;
# a class builds the reference's instance with its port twin beside it).
# The failpoints: a point armed by a test fires in both packages, each at
# the same hit of its own registry.
TWINS = {"config": ("ROBUSTNESS",),
         "ctl": ("main",),
         "device.shard_exec": ("reset_pull_stats",),
         "utils.failpoint": ("arm", "disarm", "reset"),
         "utils.overload": ("AdmissionBucket", "PRESSURE")}


# modules whose attributes a reference test patches (`monkeypatch.setattr(
# module, name, value)`, a knob the planner or the capacity lifecycle
# reads at CREATE): in mirror mode a `from ... import module` gives a
# proxy that sets the attribute in both packages' module
TWIN_MODULES = ("device.capacity", "device.fuse_planner")


class _TwinModule:
    """Attribute reads are the reference module's; a write lands in both
    modules, and writing back the reference's original value (what
    `monkeypatch` does on undo) restores each module's own original."""

    def __init__(self, ref, port):
        object.__setattr__(self, "_pair", (ref, port))
        object.__setattr__(self, "_orig", {})

    def __getattr__(self, name):
        return getattr(self._pair[0], name)

    def __setattr__(self, name, value):
        ref, port = self._pair
        if name not in self._orig:
            self._orig[name] = (getattr(ref, name), getattr(port, name))
        r0, p0 = self._orig[name]
        setattr(ref, name, value)
        setattr(port, name, p0 if value is r0 else value)


class _TwinObject:
    def __init__(self, ref, port):
        object.__setattr__(self, "_pair", (ref, port))

    def __getattr__(self, name):
        val = getattr(self._pair[0], name)
        if inspect.ismethod(val):
            return _twin(val, getattr(self._pair[1], name))
        return val

    def __setattr__(self, name, value):
        for o in self._pair:
            setattr(o, name, value)


def _twin_class(ref_cls, port_cls):
    """The reference's class, whose instances carry a port twin built
    from the same arguments (`_port_twin`). The methods a test's subclass
    defines are the port twin's too."""
    def __init__(self, *a, **kw):
        ref_cls.__init__(self, *a, **kw)
        mro = type(self).__mro__
        own = {}
        for klass in reversed(mro[:mro.index(twin)]):
            own.update({k: v for k, v in vars(klass).items()
                        if inspect.isfunction(v)})
        pcls = type(type(self).__name__, (port_cls,), own) if own \
            else port_cls
        self._port_twin = pcls(*a, **kw)
    twin = type(ref_cls.__name__, (ref_cls,),
                {"__init__": __init__, "__module__": ref_cls.__module__})
    return twin


def _twin(ref, port):
    if getattr(ref, "__module__", None) == f"{REF_ROOT}.ctl":
        return ctl_twin(ref, port)
    if inspect.isfunction(ref) or inspect.ismethod(ref):
        def both(*a, **kw):
            port(*a, **kw)
            return ref(*a, **kw)
        return both
    if inspect.isclass(ref):
        return _twin_class(ref, port)
    return _TwinObject(ref, port)


# risectl output fields read off a wall clock: float readings (walls,
# phase splits, timestamps) and a flight-recorder bundle's creation
# second; masked in the commands that print them, compared verbatim
# everywhere else
_CTL_WALL_COMMANDS = ("trace", "profile", "blackbox", "compile-status")
_CTL_FLOAT = re.compile(r"-?\b\d+\.\d+(?:[eE][-+]?\d+)?\b")
_CTL_BUNDLE = re.compile(r"\b\d{9,11}(-\d{3}-)")
# `manifest`'s run-file sizes: a table of host aggregate state persists
# pickled objects, and a pickle names its class's module (the port's
# `risingwave_tpu_torch...` is longer); the runs, rows and epochs compare
_CTL_RUN_BYTES = re.compile(r'("bytes": )\d+')
# `skew --json` prints each job's snapshot with the wall-clock second it
# was written (`ts`); the rest of it compares verbatim
_CTL_SKEW_TS = re.compile(r'("ts": )[0-9.eE+-]+')
# `metrics` prints each package's process-wide registry, filled by
# whatever ran before in this process: only its own two gauges compare
_CTL_METRIC_LINES = re.compile(r"^(committed_epoch|streaming_jobs)\b.*$",
                               re.M)


def _ctl_port_argv(argv):
    """The port's command line for a reference `risectl` command line:
    each path moved to the port's (a data directory or backup to
    `<dir>_port` where that exists, an output file to `<file>.port`), a
    flight-recorder bundle named by its place in the port's list, and
    the port's Database on the CPU. Returns (argv, [(port, ref)])."""
    out, back = [], []
    i = 0
    while i < len(argv):
        a = argv[i]
        out.append(a)
        if a in ("--data-dir", "--dest") and i + 1 < len(argv):
            ref = argv[i + 1]
            port = port_dir(ref)
            if a == "--data-dir" and not os.path.exists(port):
                port = ref
            out.append(port)
            back.append((port, ref))
            i += 2
            continue
        if a in ("-o", "--out") and i + 1 < len(argv):
            out.append(argv[i + 1] + ".port")
            back.append((argv[i + 1] + ".port", argv[i + 1]))
            i += 2
            continue
        i += 1
    if argv[:2] == ["blackbox", "show"] and len(argv) > 2 \
            and not argv[2].startswith("-"):
        from risingwave_tpu.utils.blackbox import list_bundles as ref_ls
        from risingwave_tpu_torch.utils.blackbox import list_bundles
        d = argv[argv.index("--data-dir") + 1]
        ref_names = [n for n, _m in ref_ls(d)]
        if argv[2] in ref_names:
            pd = out[out.index("--data-dir") + 1]
            pname = [n for n, _m in list_bundles(pd)][
                ref_names.index(argv[2])]
            out[2] = pname
            back.append((pname, argv[2]))
    return out + ["--torch-device", "cpu"], back


def _ctl_run(main, argv):
    """(exit code or exception, stdout, stderr) of one `main(argv)`."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except (Exception, SystemExit) as e:     # noqa: BLE001 — compared
            rc = e
    return rc, out.getvalue(), err.getvalue()


def _ctl_masked(cmd, text, back=()):
    for port, ref in back:
        text = text.replace(port, ref)
    if cmd == "metrics":
        return "\n".join(m.group(0)
                         for m in _CTL_METRIC_LINES.finditer(text))
    if cmd == "manifest":
        return _CTL_RUN_BYTES.sub(r"\1<size>", text)
    if cmd == "skew":
        return _CTL_SKEW_TS.sub(r"\1<wall>", text)
    if cmd in _CTL_WALL_COMMANDS:
        text = _CTL_BUNDLE.sub(r"<second>\1", _CTL_FLOAT.sub("<wall>", text))
    return text


def ctl_twin(ref_main, port_main):
    """`ctl.main` acting on both packages: the reference's command, then
    the port's (`_ctl_port_argv`); equal exit codes (or the same
    exception class and message) and equal output, masked by
    `_ctl_masked`. The reference's output is printed and its result
    returned (or its exception raised)."""
    def both(argv=None):
        argv = list(sys.argv[1:] if argv is None else argv)
        cmd = argv[0] if argv else ""
        rc, out, err = _ctl_run(ref_main, argv)
        pargv, back = _ctl_port_argv(argv)
        prc, pout, perr = _ctl_run(port_main, pargv)

        def outcome(r, bk):
            if isinstance(r, BaseException):
                return (type(r).__name__,
                        _ctl_masked(cmd, str(r.args[0] if r.args
                                             else ""), bk))
            return r
        assert outcome(prc, back) == outcome(rc, ()), \
            f"risectl {argv}: the port gave {prc!r}, the reference {rc!r}"
        for name, a, b in (("stdout", out, pout), ("stderr", err, perr)):
            a, b = _ctl_masked(cmd, a), _ctl_masked(cmd, b, back)
            assert a == b, (f"risectl {argv} {name}:\nref:  {a[:3000]!r}\n"
                            f"port: {b[:3000]!r}")
        sys.stdout.write(out)
        sys.stderr.write(err)
        if isinstance(rc, BaseException):
            raise rc
        return rc
    return both


def _port_ctl(mod):
    """The port's `ctl` module as a port-mode test sees it: `main` with
    `--torch-device cpu` appended."""
    def main(argv=None, _main=mod.main):
        argv = list(sys.argv[1:] if argv is None else argv)
        return _main(argv + ["--torch-device", "cpu"])
    return _proxy(mod, main=main)


def _twinned(rel):
    """The reference module `rel` (relative to the package) with its
    TWINS names acting on both packages, or None when it has none."""
    import importlib
    names = TWINS.get(rel)
    if not names:
        return None
    ref = importlib.import_module(f"{REF_ROOT}.{rel}")
    port = importlib.import_module(f"{PORT_ROOT}.{rel}")
    return _proxy(ref, **{n: _twin(getattr(ref, n), getattr(port, n))
                          for n in names})


def _mirror_twins(name, mod, fromlist):
    """`mod` as a mirror-mode `from name import fromlist` sees it."""
    rel = name[len(REF_ROOT) + 1:] if name != REF_ROOT else ""
    swap = {}
    own = _twinned(rel) if rel else None
    for f in fromlist or ():
        sub = _twinned(f"{rel}.{f}" if rel else f)
        if sub is not None and inspect.ismodule(getattr(mod, f, None)):
            swap[f] = sub
        elif f"{rel}.{f}" in TWIN_MODULES \
                and inspect.ismodule(getattr(mod, f, None)):
            import importlib
            swap[f] = _TwinModule(getattr(mod, f), importlib.import_module(
                f"{PORT_ROOT}.{rel}.{f}"))
        elif own is not None and f in TWINS[rel]:
            swap[f] = getattr(own, f)
    return _proxy(mod, **swap) if swap else mod


def _hook(mode, twins=False):
    real = builtins.__import__

    def imp(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and (name == REF_ROOT
                           or name.startswith(REF_ROOT + ".")):
            if mode == "ref":
                return real(name, globals, locals, fromlist, level)
            if mode == "port":
                name = PORT_ROOT + name[len(REF_ROOT):]
            mod = real(name, globals, locals, fromlist, level)
            if mode == "port" and name == f"{PORT_ROOT}.ctl" \
                    and fromlist and "main" in fromlist:
                return _port_ctl(mod)
            if mode == "port" and name == PORT_ROOT and fromlist \
                    and "ctl" in fromlist:
                return _proxy(mod, ctl=_port_ctl(mod.ctl))
            if fromlist and "Database" in fromlist \
                    and name.endswith(".sql"):
                return _proxy(mod, Database=(MirrorDatabase if mode
                                             == "mirror" else
                                             PortTestDatabase))
            cpu = [n for n in CPU_DEFAULT if n in (fromlist or ())]
            if mode == "port" and cpu:
                return _proxy(mod, **{n: _on_cpu(getattr(mod, n))
                                      for n in cpu})
            if mode == "mirror" and twins and fromlist:
                return _mirror_twins(name, mod, fromlist)
            return mod
        return real(name, globals, locals, fromlist, level)
    return imp


_LOADED: dict = {}


def load(ref_file: str, mode: str, twins: bool = False):
    """The reference test module `tests/<ref_file>`, executed afresh with
    its imports bound for `mode` (with `twins`, the TWINS names act on
    both packages: the fused runners' loading)."""
    key = (ref_file, mode, twins)
    if key in _LOADED:
        return _LOADED[key]
    path = TESTS / ref_file
    src = path.read_text()
    bi = dict(vars(builtins))
    bi["__import__"] = _hook(mode, twins)
    g = {"__builtins__": bi, "__name__": f"{mode}_{path.stem}",
         "__file__": str(path)}
    exec(compile(src, str(path), "exec"), g)
    ns = types.SimpleNamespace(**{k: v for k, v in g.items()
                                  if not k.startswith("__")})
    _LOADED[key] = ns
    return ns


# ---------------------------------------------------------------------------
# listing and running the reference cases
# ---------------------------------------------------------------------------


def _param_arms(fn, named_ids=False):
    """[(id, {argname: value})] of a function's parametrize marks (a
    `pytest.param` arm gives its values). With `named_ids` an arm's id is
    the one its mark names (`ids=`, `pytest.param(id=)`) where there is
    one."""
    arms = [("", {})]
    for m in getattr(fn, "pytestmark", []):
        if m.name != "parametrize":
            continue
        names = m.args[0]
        names = [n.strip() for n in names.split(",")] \
            if isinstance(names, str) else list(names)
        ids = m.kwargs.get("ids") if named_ids else None
        new = []
        for k, vals in enumerate(m.args[1]):
            pid = None
            if named_ids and isinstance(vals, type(pytest.param(None))):
                pid, vals = vals.id, vals.values
                vals = vals[0] if len(names) == 1 else vals
            vals = (vals,) if len(names) == 1 else tuple(vals)
            vid = "-".join(str(v) for v in vals)
            if pid is not None:
                vid = pid
            elif isinstance(ids, (list, tuple)) and k < len(ids):
                vid = str(ids[k])
            for aid, kw in arms:
                new.append((vid if not aid else f"{vid}-{aid}",
                            dict(kw, **dict(zip(names, vals)))))
        arms = new
    return arms


def _builds_database(fn, ns) -> bool:
    src = inspect.getsource(fn)
    if "Database(" in src or "db" in inspect.signature(fn).parameters:
        return True
    # a module helper that builds one (`_mk(device)`)
    for name, obj in vars(ns).items():
        if callable(obj) and re.search(rf"\b{re.escape(name)}\(", src) \
                and inspect.isfunction(obj) \
                and "Database(" in inspect.getsource(obj):
            return True
    return False


def cases(ref_file: str, only=None, skip=(), keep=None, port=(),
          mirror=(), named_ids=False):
    """pytest.param-ready (id, ref_file, qualname, kwargs, mode) tuples;
    `keep(id)` filters them (to split one reference file's cases over
    two test files). The cases named in `port` run in "port" mode even
    where they build a `Database`: a case whose asserts reach past the
    `Database` into objects the mirror cannot twin (a worker process it
    kills, a channel it patches) holds the port alone. Those named in
    `mirror` run in "mirror" mode where the `Database` they build is
    out of `_builds_database`'s sight (a helper's helper builds it).
    `named_ids`: arms take the ids their marks name (`_param_arms`)."""
    ns = load(ref_file, "mirror")
    out = []
    for name, obj in vars(ns).items():
        fns = []
        if inspect.isfunction(obj) and name.startswith("test"):
            fns.append((name, obj))
        elif inspect.isclass(obj) and name.startswith("Test"):
            fns += [(f"{name}.{m}", f) for m, f in vars(obj).items()
                    if m.startswith("test") and inspect.isfunction(f)]
        for qual, fn in fns:
            if only is not None and qual not in only:
                continue
            if qual in skip:
                continue
            mode = "mirror" if qual not in port \
                and (qual in mirror or _builds_database(fn, ns)) else "port"
            for aid, kw in _param_arms(fn, named_ids):
                cid = f"{Path(ref_file).stem}::{qual}"
                cid += f"[{aid}]" if aid else ""
                cid += "" if mode == "mirror" else "@port"
                out.append((cid, ref_file, qual, kw, mode))
    return [c for c in out if keep is None or keep(c[0])]


def marks_of(ref_file: str, qual: str) -> set:
    """The names of the pytest marks on a reference case (module-level
    `pytestmark` included)."""
    ns = load(ref_file, "mirror")
    if "." in qual:
        cls_name, meth = qual.split(".")
        fn = getattr(getattr(ns, cls_name), meth)
    else:
        fn = getattr(ns, qual)
    mod = getattr(ns, "pytestmark", [])
    mod = mod if isinstance(mod, list) else [mod]
    return {m.name for m in list(getattr(fn, "pytestmark", [])) + mod}


def pin_clocks(monkeypatch, base_ms=None):
    """Each package reads its own fake clock, one millisecond further on
    at every read, from the same instant (`base_ms`, by default the wall
    clock's when the test starts): barrier epochs (`now_epoch`) and
    `RowIdGenExecutor`'s millis are then the same in both packages — so
    are row ids, and the order of a table's rows — and stay monotonic
    across a restart, as the wall clock's are."""
    import time
    from host_parity import PKGS
    if base_ms is None:
        base_ms = int(time.time() * 1000)
    for P in PKGS:
        clock = [base_ms]
        ep = P.mod("core.epoch")
        rowid = P.mod("ops.simple").RowIdGenExecutor

        def now_epoch(prev=0, clock=clock, ep=ep):
            clock[0] += 1
            e = ep.epoch_from_physical(clock[0])
            return e if e > prev else prev + 1

        def now_ms(_self, clock=clock, rowid=rowid):
            clock[0] += 1
            return clock[0] - rowid._ID_EPOCH_MS
        monkeypatch.setattr(P.mod("ops.source"), "now_epoch", now_epoch)
        monkeypatch.setattr(rowid, "_now_ms", now_ms)


def run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch,
             fuse=False, capsys=None, twins=None, unordered=False,
             devices=None):
    """Run one reference case in `mode`, its fixtures supplied (in mirror
    mode under `pin_clocks`, both flight recorders emptied first; `capsys`
    is the runner's, for a case that reads its output). `fuse` keeps fusion as the reference test asks for
    it (`map_device`); `twins` (by default `fuse`) makes the TWINS names
    act on both packages. `unordered` compares query results as
    multisets: under process placement the coordinator's merge keeps
    pulling its upstream while it waits on the workers, so how far a
    source has read — and whether a row id is minted before or after the
    next barrier's clock read — depends on the workers' timing; the two
    packages' row ids, and so the order of an MV's rows, may then differ
    by a tick of the fake clock. `devices` is the port's device set (by
    default the CPU alone)."""
    SINK_PATHS.clear()
    KEEP_FUSE[0] = fuse
    PORT_DEVICES[0] = devices
    TWINS_ON[0] = fuse if twins is None else twins
    UNORDERED[0] = unordered
    # the clock pins have a patcher of their own: a reference test may
    # undo its `monkeypatch` midway
    try:
        with pytest.MonkeyPatch.context() as pins:
            if mode == "mirror":
                pin_clocks(pins)
                _clear_recorders()
            _run(ref_file, qual, kw, mode, tmp_path, monkeypatch, capsys)
    finally:
        KEEP_FUSE[0] = False
        TWINS_ON[0] = False
        UNORDERED[0] = False
        PORT_DEVICES[0] = None


@contextlib.contextmanager
def reaped_workers():
    """Every worker process a case spawns through either package's
    `remote_fragments` spawn functions is killed when the case ends,
    whatever the case left running (a mirror case shuts down only the
    reference's sets it finds; a failing case none)."""
    import importlib
    spawns = []                 # (module, name, original)
    for root in (REF_ROOT, PORT_ROOT):
        m = importlib.import_module(f"{root}.runtime.remote_fragments")
        # the port also spawns a set's workers at once (`_spawn_workers`)
        for name in ("_spawn_worker", "_spawn_workers"):
            if hasattr(m, name):
                spawns.append((m, name, getattr(m, name)))
    procs = []

    def recording(orig):
        def spawn(plans):
            out = orig(plans)
            procs.extend(w.proc for w in
                         (out if isinstance(out, list) else [out]))
            return out
        return spawn
    for m, name, orig in spawns:
        setattr(m, name, recording(orig))
    try:
        yield procs
    finally:
        for m, name, orig in spawns:
            setattr(m, name, orig)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)


def _clear_recorders():
    """Both packages' flight recorders emptied (ring, sequence, drop and
    dump counts, dump rate limits): a mirror case compares what the two
    record (a bundle's records and their sequence numbers), and each
    ring is process-wide, so what earlier tests left in one package's
    alone (a port-only test, a case in port mode) must not reach it."""
    import importlib
    for root in (REF_ROOT, PORT_ROOT):
        r = importlib.import_module(f"{root}.utils.blackbox").RECORDER
        with r._lock:
            r._ring.clear()
            r._bytes = r._seq = r.dropped = r.dumps = 0
            r._last_dump = {}


@contextlib.contextmanager
def process_case():
    """A process-placement case, isolated: every worker it spawns is
    killed when it ends (`reaped_workers`), and both packages' pressure
    boards are cleared — a case in port mode notes its exchange stalls
    in the port's board alone, and a later mirror case's overload ladders
    read the two."""
    import importlib
    try:
        with reaped_workers():
            yield
    finally:
        for root in (REF_ROOT, PORT_ROOT):
            importlib.import_module(f"{root}.utils.overload").PRESSURE.reset()


# values of the reference modules' module- and session-scoped fixtures
_FIXTURES: dict = {}


def _module_fixtures(ns):
    """name -> (function, marker) of the fixtures a reference module
    defines."""
    out = {}
    for name, obj in vars(ns).items():
        marker = getattr(obj, "_fixture_function_marker", None)
        if marker is not None:
            out[marker.name or name] = (obj._get_wrapped_function(), marker)
    return out


def _run(ref_file, qual, kw, mode, tmp_path, monkeypatch, capsys=None):
    ns = load(ref_file, mode, twins=TWINS_ON[0])
    if "." in qual:
        cls_name, meth = qual.split(".")
        inst = getattr(ns, cls_name)()
        fn = getattr(inst, meth)
    else:
        fn = getattr(ns, qual)
    fixtures = _module_fixtures(ns)
    teardown = []

    def value(p, qual):
        if p == "tmp_path":
            return tmp_path
        if p == "monkeypatch":
            return monkeypatch
        if p == "capsys" and capsys is not None:
            return capsys
        if p == "db":
            return (MirrorDatabase() if mode == "mirror"
                    else PortTestDatabase())
        if p == "mesh8":
            # tests/conftest.py's fixture: the reference's 8-shard mesh
            from risingwave_tpu.parallel.mesh import make_mesh
            return make_mesh(8)
        if p not in fixtures:
            raise TypeError(f"mirror: no fixture {p!r} for {qual}")
        ffn, marker = fixtures[p]
        key = (ref_file, mode, KEEP_FUSE[0], TWINS_ON[0], p)
        if marker.scope in ("module", "session") and key in _FIXTURES:
            return _FIXTURES[key]
        out = ffn(**{q: value(q, p)
                     for q in inspect.signature(ffn).parameters})
        if inspect.isgenerator(out):
            gen, out = out, next(out)
            teardown.append(gen)
        if marker.scope in ("module", "session"):
            _FIXTURES[key] = out
        return out

    try:
        for name, (_f, marker) in fixtures.items():
            if marker.autouse:
                value(name, qual)
        args = dict(kw)
        for p in inspect.signature(fn).parameters:
            if p not in args:
                args[p] = value(p, qual)
        fn(**args)
    finally:
        for gen in reversed(teardown):
            next(gen, None)
