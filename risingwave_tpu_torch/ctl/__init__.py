"""risectl-lite: operator CLI against a live data directory.

The `src/ctl/src/cmd_impl/` analog (hummock/meta/table subcommands) for
the single-process runtime: inspect the DDL log, the LSM manifest, state
tables, and metrics, or trigger a full compaction — without writing any
Python.

    python -m risingwave_tpu_torch.ctl <command> --data-dir DIR [...]

The port's copy of the JAX package's `ctl/`. A command that opens a
`Database` runs its device path on `cuda:0`, as every entry point of the
port does; `--torch-device cpu` asks for the CPU.

Commands:
    jobs                      list catalog objects from the DDL log
    ddl-log                   print the raw DDL log entries
    manifest                  committed epoch + per-table runs/sizes
    dump NAME [--limit N]     rows of an object's state table
    compact                   merge every table's runs into one base
    metrics                   Prometheus exposition after recovery
    backup --dest DIR         self-contained snapshot copy (restore =
                              open the copy as a data directory)
    history                   retained manifest versions (time travel)
    trace [--last N]          per-barrier span summary; flags OPEN
                              (stalled) epochs with the stuck job —
                              works on a LIVE or wedged data dir;
                              --stuck-only drops committed epochs so
                              stalls survive fresh committed traffic
    trace export              merge barrier_trace.jsonl +
                              epoch_profile.jsonl + heartbeat clock
                              samples into Chrome/Perfetto trace-event
                              JSON on one coordinator-clock timeline
                              (--format chrome, -o FILE) — a whole
                              warmup/chaos run opens in ui.perfetto.dev
    profile [JOB]             fused-job epoch timeline from
                              epoch_profile.jsonl: phase totals
                              (host-pack / dispatch / device-sync /
                              commit), compile events, top-N slowest
                              epochs (JSON) — decompose warmup vs
                              steady state without rerunning anything;
                              --follow tails the file live
                              (rotation-aware `tail -f`)
    failpoints [--spec S]     list declared fault-injection points and
                              which the spec (default: $RW_FAILPOINTS)
                              arms; --arm validates a spec and prints
                              the export line to arm a process tree;
                              --ledger [FILE] prints a recorded fire
                              ledger — (ordinal, point, thread, hit) per
                              fire, the exact-replay record a chaos run
                              writes under RW_FAILPOINT_LEDGER (no FILE:
                              the live in-process ledger)
    fused-stats               per-fused-job growth/replay/retrace
                              counters and current per-node capacities
                              (JSON) — diagnose capacity-bound runs
                              without reading bench logs
    tiering [JOB]             hot/cold state-tier report per fused job:
                              per-node resident vs cold row counts,
                              Xor8 negative-cache liveness, and the
                              demotion / promotion / filter-probe
                              counters (the `rw_state_tiering` system
                              table, offline) — answers "is state
                              spilling, and is the filter earning its
                              keep"
    serving                   serving-tier read-cache report: per
                              cached MV the snapshot epoch, row count,
                              and hit / miss / coalesced / fill
                              counters, plus the process-wide device-
                              pull total (the `rw_serving_cache` system
                              table) — answers "are SELECTs actually
                              serving from host memory"
    compile-status [JOB]      per fused job its plan-shape hash and
                              the compile / retrace events its epoch
                              profiler recorded (the port has no
                              background compile service: `aot` is
                              false, every signature `ready`); --wait
                              is accepted and waits for nothing;
                              --offline finds no compile manifest
    skew [JOB]                key-skew summary per fused job: node
                              skew_ratio, per-shard load under the
                              current routing bounds, top-K hot keys,
                              adopted hot-key replication policy, and a
                              vnode-occupancy sparkline — read from the
                              skew_stats.json mirror, so it works on a
                              DEAD data dir (--json for the raw rows)
    blackbox [ACTION]         flight-recorder postmortems: `list` the
                              dumped bundles of a data dir, `show NAME`
                              one bundle's records, or `dump` a fresh
                              bundle from the on-disk telemetry ring
                              mirror (blackbox_ring.jsonl) — the dump
                              path never opens a Database, so it works
                              on a DEAD or wedged directory: the last
                              ~4 MB of ladder moves, pressure ticks,
                              epochs, checkpoints, sheds, rebalances,
                              recoveries and supervisor events, exactly
                              as the process saw them before it died
    dlq [JOB]                 poison-pill dead-letter queue: list the
                              quarantined input rows (default — reads
                              the durable table directly, works on a
                              DEAD dir), --requeue ID,..|all re-injects
                              them into the live job (opens a Database,
                              replays DDL, ticks delivery), --purge
                              ID,..|all drops them (data loss accepted,
                              audit closed)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, List, Optional


def _store(data_dir: str):
    from ..state import SpillStateStore
    if not os.path.exists(os.path.join(data_dir, "MANIFEST.json")):
        raise SystemExit(f"{data_dir}: no MANIFEST.json — not a data dir")
    return SpillStateStore(data_dir)


def _ddl_entries(store) -> List[Any]:
    """(seq, sql) rows of the DDL log without a Database."""
    from ..sql.database import DDL_LOG_DTYPES, DDL_LOG_PK, DDL_LOG_TABLE_ID
    from ..state import StateTable
    log = StateTable(store, DDL_LOG_TABLE_ID, list(DDL_LOG_DTYPES),
                     list(DDL_LOG_PK))
    return sorted(log.iter_all())


def cmd_ddl_log(args) -> int:
    store = _store(args.data_dir)
    for seq, sql in _ddl_entries(store):
        print(f"{seq:6d}  {sql}")
    return 0


def cmd_jobs(args) -> int:
    """Catalog objects, parsed from the DDL log (no dataflow rebuild)."""
    from ..sql import ast as A
    from ..sql.parser import parse_sql
    store = _store(args.data_dir)
    live = {}
    for _seq, sql in _ddl_entries(store):
        try:
            stmts = parse_sql(sql)
        except ValueError:
            continue
        for stmt in stmts:
            if isinstance(stmt, A.CreateTable):
                kind = "SOURCE" if stmt.is_source else "TABLE"
                live[stmt.name] = (kind, f"{len(stmt.columns)} columns")
            elif isinstance(stmt, A.CreateMaterializedView):
                live[stmt.name] = ("MATERIALIZED VIEW", "")
            elif isinstance(stmt, A.CreateSink):
                live[stmt.name] = ("SINK", stmt.with_options.get(
                    "connector", "collect"))
            elif isinstance(stmt, A.CreateFunction):
                live[stmt.name] = ("FUNCTION", stmt.language)
            elif isinstance(stmt, A.DropObject):
                live.pop(stmt.name, None)
    for name, (kind, extra) in live.items():
        print(f"{kind:18s} {name}" + (f"  ({extra})" if extra else ""))
    return 0


def cmd_manifest(args) -> int:
    store = _store(args.data_dir)
    m = store._manifest
    out = {"committed_epoch": m["committed_epoch"], "tables": {}}
    for tid, runs in sorted(m["tables"].items(), key=lambda kv: int(kv[0])):
        sizes = []
        for name in runs:
            try:
                sizes.append(os.path.getsize(store._run_path(name)))
            except OSError:
                sizes.append(-1)
        out["tables"][tid] = {
            "rows": m["counts"].get(tid, 0),
            "runs": [{"name": n, "bytes": s}
                     for n, s in zip(runs, sizes)],
        }
    print(json.dumps(out, indent=2))
    return 0


def cmd_dump(args) -> int:
    """Rows of an object's state table, decoded through the catalog (the
    `ctl table scan` analog). Opens a full Database (DDL replay) so the
    schema and key layout are exact."""
    from ..sql import Database
    db = Database(data_dir=args.data_dir, device="auto",
                  torch_device=args.torch_device)
    try:
        obj = db.catalog.get(args.name)
    except KeyError:
        raise SystemExit(f"no such object: {args.name}")
    job = (obj.runtime or {}).get("fused_job")
    st = (obj.runtime or {}).get("state_table")
    if job is None and st is None:
        raise SystemExit(f"{args.name}: object has no state table "
                         f"({obj.kind})")
    rows = job.mv_rows_now() if job is not None else list(st.iter_all())
    names = [f.name for f in obj.schema.fields]
    print("\t".join(names))
    for i, r in enumerate(rows):
        if args.limit is not None and i >= args.limit:
            print(f"... ({len(rows) - args.limit} more)")
            break
        print("\t".join("NULL" if v is None else str(v) for v in r))
    print(f"-- {len(rows)} rows")
    return 0


def cmd_compact(args) -> int:
    store = _store(args.data_dir)
    merged = store.compact_all()
    if not merged:
        print("nothing to compact")
    for tid, n in sorted(merged.items(), key=lambda kv: int(kv[0])):
        print(f"table {tid}: merged {n} runs -> 1 base")
    return 0


def cmd_metrics(args) -> int:
    """Read-only: recover and expose, WITHOUT ticking a barrier (a
    diagnostic must not advance the committed epoch)."""
    from ..sql import Database
    from ..utils.metrics import REGISTRY
    db = Database(data_dir=args.data_dir, device="auto",
                  torch_device=args.torch_device)
    REGISTRY.gauge("committed_epoch", "last committed epoch"
                   ).set(db.store.committed_epoch)
    REGISTRY.gauge("streaming_jobs", "running dataflows"
                   ).set(len(db._iters) + len(db._fused))
    print(db.metrics())
    return 0


def cmd_trace(args) -> int:
    """Offline barrier-span summary (`monitor_service.rs:82` await-tree
    analog): reads the data dir's trace log without opening the Database,
    so it works against a WEDGED process's directory too.

    `trace export --format chrome [-o FILE]` instead merges the barrier
    trace, the epoch profile and the heartbeat clock samples into ONE
    Chrome/Perfetto trace-event JSON (utils/export.py): a whole warmup
    or chaos run opens in ui.perfetto.dev."""
    from ..utils.trace import TRACE_FILE, diagnose
    if args.action == "export":
        if args.format != "chrome":
            raise SystemExit(f"unknown export format {args.format!r} "
                             "(supported: chrome)")
        from ..utils.export import export_chrome, validate_chrome
        doc = export_chrome(args.data_dir)
        problems = validate_chrome(doc)
        if problems:
            for p in problems:
                print(f"export invariant violated: {p}", file=sys.stderr)
            return 1
        payload = json.dumps(doc)
        if args.out:
            with open(args.out, "w") as f:
                f.write(payload)
            n = len(doc["traceEvents"])
            print(f"wrote {n} events -> {args.out} "
                  "(open in ui.perfetto.dev)")
        else:
            print(payload)
        return 0
    if args.action is not None:
        raise SystemExit(f"unknown trace action {args.action!r} "
                         "(supported: export)")
    path = os.path.join(args.data_dir, TRACE_FILE)
    if not os.path.exists(path):
        print("no barrier trace (directory has no barrier_trace.jsonl)")
        return 1
    print(diagnose(path, last=args.last, stuck_only=args.stuck_only))
    return 0


def cmd_profile(args) -> int:
    """Offline epoch-profile summary (the fused-path flame-graph-lite):
    reads epoch_profile.jsonl without opening the Database — same
    wedged-process contract as `trace`. `--follow` instead TAILS the
    file live (rotation-aware): one line per epoch/compile record as the
    running process flushes them — `tail -f` that understands the
    format and survives `rotate_tail`."""
    from ..utils.profile import (PROFILE_FILE, format_record, summarize_file,
                                 tail_jsonl)
    path = os.path.join(args.data_dir, PROFILE_FILE)
    if args.follow:
        # a missing FILE is fine (the job may not have flushed yet; the
        # tail waits for it) — but a missing DIRECTORY is a typo that
        # would otherwise hang silently forever
        if not os.path.isdir(args.data_dir):
            print(f"{args.data_dir}: not a directory", file=sys.stderr)
            return 1
        if not os.path.exists(path):
            print(f"waiting for {path} ...", file=sys.stderr)
        try:
            for rec in tail_jsonl(path):
                if args.job is not None and rec.get("job") != args.job:
                    continue
                line = format_record(rec)
                if line:
                    print(line, flush=True)
        except KeyboardInterrupt:
            pass
        return 0
    if not os.path.exists(path):
        print("no epoch profile (directory has no epoch_profile.jsonl — "
              "fused jobs write it when DeviceConfig.profile is on)")
        return 1
    out = summarize_file(path, job=args.job, top=args.top)
    if args.job is not None and not out:
        print(f"no profile records for job {args.job!r}")
        return 1
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


def cmd_backup(args) -> int:
    """Copy the committed snapshot (manifest + referenced runs + device
    marker) into a self-contained directory; restore = open it as a data
    directory (`src/meta/src/backup_restore/` analog)."""
    store = _store(args.data_dir)
    n = store.backup(args.dest)
    print(f"backed up {n} run files + manifest -> {args.dest}")
    print("restore: open it as a data_dir "
          f"(Database(data_dir='{args.dest}'))")
    return 0


def cmd_failpoints(args) -> int:
    """Discover/validate fault-injection points (`utils/failpoint.py`).
    Points are declared at their hook sites, so importing the hook-site
    modules populates the listing; arming is per-process via the
    RW_FAILPOINTS environment variable (spawned workers inherit it)."""
    from ..utils import failpoint as fp
    # imported for their declare() side effects: the sink, the spill
    # store, the fused device path (dispatch / device_sync /
    # growth_replay / checkpoint_commit) and the process-placement
    # runtime (the socket exchange, the worker, the fragment sets)
    from ..connectors import sink  # noqa: F401
    from ..device import fused  # noqa: F401
    from ..runtime import exchange_net  # noqa: F401
    from ..runtime import remote_fragments  # noqa: F401
    from ..runtime import worker  # noqa: F401
    from ..state import hummock  # noqa: F401
    if args.ledger is not None:
        try:
            entries = fp.load_ledger(args.ledger) if args.ledger \
                else fp.ledger()
        except OSError as e:
            raise SystemExit(f"cannot read ledger {args.ledger!r}: {e}")
        except ValueError as e:
            raise SystemExit(f"bad ledger {args.ledger!r}: {e}")
        if not entries:
            print("ledger is empty (no failpoint fired"
                  + (f" in {args.ledger}" if args.ledger else "") + ")")
            return 0
        print(f"{'ordinal':>7s}  {'point':28s} {'thread':20s} hit")
        for o, point, thread, hit in entries:
            print(f"{o:7d}  {point:28s} {thread:20s} {hit}")
        print(f"-- {len(entries)} fires; re-arm exactly with "
              f"{fp.LEDGER_ENV}=<this file>")
        return 0
    spec = args.arm if args.arm is not None else args.spec
    try:
        points = {p.name: p for p in fp.parse_spec(spec or "")}
    except ValueError as e:
        raise SystemExit(f"bad failpoint spec: {e}")
    unknown = sorted(set(points) - set(fp.KNOWN))
    if args.arm is not None:
        if unknown:
            raise SystemExit(f"unknown failpoint(s): {', '.join(unknown)}")
        print(f"export {fp.ENV_VAR}="
              f"'{','.join(p.spec() for p in points.values())}'")
        return 0
    for name in sorted(fp.KNOWN):
        p = points.get(name)
        state = (f"ARMED prob={p.prob:g} seed={p.seed}"
                 + (f" max_fires={p.max_fires}"
                    if p.max_fires is not None else "")) if p else "off"
        print(f"{name:28s} {state:40s} {fp.KNOWN[name]}")
    for name in unknown:
        print(f"{name:28s} ARMED (unknown point — never fires)")
    return 0


def cmd_fused_stats(args) -> int:
    """Capacity-lifecycle report of every fused device job (the growth
    counters persist in each job's state table, so the numbers are
    cumulative across restarts). Opens a full Database: the DDL replay
    rebuilds the fused programs and recovery presizes them from the
    persisted high-water marks — a recovery that itself performs growth
    replays would show up in the counters."""
    from ..sql import Database
    db = Database(data_dir=args.data_dir, device="auto",
                  torch_device=args.torch_device)
    if not db._fused:
        print("no fused device jobs in this data directory")
        return 0
    out = {name: job.cap_report() for name, job in db._fused.items()}
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


def cmd_tiering(args) -> int:
    """Hot/cold state-tier report of every fused job (or one JOB): the
    `rw_state_tiering` system-table rows, printed as a table. Opens a
    full Database — recovery rebuilds both tiers (device residents +
    host cold stores) from the journal, so the numbers reflect what a
    restarted job would actually hold."""
    from ..sql import Database
    db = Database(data_dir=args.data_dir, device="auto",
                  torch_device=args.torch_device)
    jobs = {name: job for name, job in db._fused.items()
            if args.job is None or name == args.job}
    if not jobs:
        print("no fused device jobs in this data directory"
              if args.job is None else f"no fused job {args.job!r}")
        return 0 if args.job is None else 1
    cols = ("node", "type", "resident", "cold", "filter", "promotable",
            "demotions", "promotions", "demote_ev", "probes", "hits",
            "fallbacks")
    for name, job in sorted(jobs.items()):
        rows = job.tiering_report()
        if not rows:
            print(f"{name}: state tiering off (or no tierable nodes)")
            continue
        print(name)
        print("  " + "  ".join(f"{c:>9s}" for c in cols))
        for r in rows:
            cells = [str(r[0]), str(r[1]),
                     str(r[2]), str(r[3]),
                     "live" if r[4] else "off",
                     "yes" if r[5] else "no"] + [str(v) for v in r[6:]]
            print("  " + "  ".join(f"{c:>9s}" for c in cells))
    return 0


def cmd_serving(args) -> int:
    """Serving-tier read-cache report (`rw_serving_cache`, offline):
    per cached MV the snapshot epoch / row count and the hit / miss /
    coalesced / fill counters, plus the process-wide device-pull
    total. A healthy read-heavy deployment shows hits >> fills."""
    from ..sql import Database
    from ..device.shard_exec import PULL_STATS
    db = Database(data_dir=args.data_dir, device="auto",
                  torch_device=args.torch_device)
    rows = db.read_cache.report()
    if not rows:
        print("serving cache empty (no fused MV has been read)")
    else:
        cols = ("mv", "epoch", "rows", "hits", "misses", "coalesced",
                "fills")
        print("  ".join(f"{c:>10s}" for c in cols))
        for r in rows:
            print("  ".join(f"{str(v):>10s}" for v in r))
    print(f"device pulls (process total): {PULL_STATS['device_pulls']}")
    reps = PULL_STATS["replica_pulls"]
    if reps:
        # the read-load split over the replica mesh axis — a healthy
        # replicated deployment spreads pulls round-robin, not all on
        # the write path's replica 0
        print("  by replica: " + "  ".join(
            f"r{rep}={n}" for rep, n in sorted(reps.items())))
    return 0


def cmd_blackbox(args) -> int:
    """Flight-recorder postmortems (`utils/blackbox.py`). `dump` reads
    the blackbox_ring.jsonl mirror straight off the directory — no
    Database, no torch device, works on the data dir of a DEAD process (torn
    tail lines from the crash are tolerated) — and writes a
    self-describing bundle under <data-dir>/blackbox/. `list`/`show`
    browse the bundles already there (auto-dumped on escalations,
    in-place recoveries, quarantines and wedge reaps, or by `dump`)."""
    from ..utils.blackbox import dump_from_dir, list_bundles, read_bundle
    if args.action == "dump":
        try:
            path = dump_from_dir(args.data_dir, reason=args.reason)
        except (OSError, ValueError) as e:
            print(f"blackbox dump failed: {e}", file=sys.stderr)
            return 1
        if path is None:
            print(f"no telemetry ring in {args.data_dir} (the process "
                  "never attached a recorder, or the ring file was "
                  "removed) — nothing to dump")
            return 1
        print(f"dumped -> {path}")
        return 0
    try:
        bundles = list_bundles(args.data_dir)
    except OSError as e:
        print(f"cannot read {args.data_dir}: {e}", file=sys.stderr)
        return 1
    if args.action == "list" or args.action is None:
        if not bundles:
            print("no blackbox bundles (nothing triggered a dump; "
                  "`blackbox dump` takes one from the live ring mirror)")
            return 0
        print(f"{'bundle':44s} {'reason':24s} {'records':>7s}  kinds")
        for name, m in bundles:
            print(f"{name:44s} {m.get('reason', '?'):24s} "
                  f"{m.get('records', 0):7d}  "
                  f"{','.join(m.get('kinds', []))}")
        return 0
    if args.action == "show":
        if args.bundle is None:
            raise SystemExit("blackbox show needs a bundle name "
                             "(see `blackbox list`)")
        names = [n for n, _m in bundles]
        if args.bundle not in names:
            raise SystemExit(f"no bundle {args.bundle!r} "
                             f"(have: {', '.join(names) or 'none'})")
        try:
            recs = read_bundle(args.data_dir, args.bundle)
        except (OSError, ValueError) as e:
            raise SystemExit(f"cannot read bundle {args.bundle!r}: {e}")
        for rec in recs:
            print(json.dumps(rec, sort_keys=True))
        print(f"-- {len(recs)} records", file=sys.stderr)
        return 0
    raise SystemExit(f"unknown blackbox action {args.action!r} "
                     "(supported: list, show, dump)")


def cmd_skew(args) -> int:
    """Key-skew summary of every fused job (`rw_key_skew`, offline):
    per-node skew_ratio + per-shard load under the current routing
    bounds, the top-K hot keys, the adopted hot-key replication policy,
    and a vnode-occupancy sparkline. Reads the `skew_stats.json` mirror
    each job writes beside epoch_profile.jsonl at every checkpoint —
    works on a DEAD data dir, the `compile-status --offline` contract
    (the file IS the offline surface; there is no live mode to need)."""
    from ..device.fused import SKEW_FILE
    from ..device.skew_stats import SK_BUCKETS, sparkline
    path = os.path.join(args.data_dir, SKEW_FILE)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        # ValueError: a crash can leave the snapshot truncated — the
        # dead-dir contract degrades gracefully, never tracebacks
        print(f"no skew snapshot ({path} missing or unreadable — the "
              "data dir predates skew mirroring, ran with skew_stats "
              "off, or never reached a checkpoint)")
        return 1
    jobs = doc.get("jobs", {})
    if args.job is not None:
        jobs = {k: v for k, v in jobs.items() if k == args.job}
        if not jobs:
            print(f"no skew snapshot for job {args.job!r}")
            return 1
    if args.json:
        print(json.dumps(jobs, indent=2, sort_keys=True))
        return 0
    for name, rec in sorted(jobs.items()):
        print(f"job {name}  shards={rec.get('mesh_shards', 1)}  "
              f"events={rec.get('committed_events', 0)}  "
              f"rebalances={rec.get('rebalances', 0)}")
        vb = rec.get("vnode_bounds")
        if vb:
            print(f"  vnode bounds: {vb}")
        rows = [tuple(r) for r in rec.get("rows", [])]
        nodes = sorted({(r[0], r[1]) for r in rows})
        for ni, tname in nodes:
            sub = [r for r in rows if r[0] == ni and r[1] == tname]
            occ = [0] * SK_BUCKETS
            for r in sub:
                if r[2] == "vnode_occ":
                    occ[int(r[3])] = int(r[5])
            ratio = next((r[6] for r in sub if r[2] == "skew_ratio"),
                         None)
            shard = next((r[6] for r in sub if r[2] == "shard_skew"),
                         None)
            line = f"  node {ni} {tname}: occ {sparkline(occ)}"
            if ratio is not None:
                line += f"  skew_ratio={ratio:.2f}x"
            if shard is not None:
                line += f"  shard_skew={shard:.2f}x"
            print(line)
            hot = [r for r in sub if r[2] == "hot_key"]
            for r in sorted(hot, key=lambda r: r[3]):
                print(f"    hot key #{r[3]}: key={r[4]} "
                      f"rows/epoch={r[5]}")
            pol = [r for r in sub if r[2] == "hot_policy"]
            if pol:
                keys = [r[4] for r in sorted(pol, key=lambda r: r[3])]
                print(f"    replicating side {pol[0][5]} for hot keys "
                      f"{keys}")
            loads = [r for r in sub if r[2] == "shard_load"]
            if loads:
                print("    shard loads: " + " ".join(
                    f"{int(r[5])}" for r in
                    sorted(loads, key=lambda r: r[3])))
    return 0


def cmd_compile_status(args) -> int:
    """Compile state per fused job. The JAX package answers from its
    background compile service (per-signature pending / ready / cached /
    failed); the port has no such service — its kernels are built once
    per process and nothing is traced per shape — so it answers as the
    reference does for a job built with `aot_compile=False`: `"aot":
    false`, and the signatures are the compile and retrace events the
    job's epoch profiler recorded (each `ready`, compiled by this job).
    Opens a full Database: DDL replay rebuilds the fused programs and
    recovery presizes them. `--wait` waits for nothing: no compile is
    ever in flight.

    --offline reads the `compile_manifest.json` mirror the JAX package's
    service writes into a data directory; the port never writes one, so
    a directory it made answers "no compile manifest"."""
    if args.offline:
        path = os.path.join(args.data_dir, "compile_manifest.json")
        if not os.path.exists(path):
            print("no compile manifest (directory has no "
                  "compile_manifest.json mirror — the data dir predates "
                  "manifest mirroring, or never ran with aot_compile on; "
                  "RW_COMPILE_CACHE_DIR names the cache-dir fallback)")
            return 1
        with open(path) as f:
            print(json.dumps(json.load(f), indent=2, sort_keys=True))
        return 0
    from ..sql import Database
    db = Database(data_dir=args.data_dir, device="auto",
                  torch_device=args.torch_device)
    if not db._fused:
        print("no fused device jobs in this data directory")
        return 0
    if args.job is not None and args.job not in db._fused:
        raise SystemExit(f"no fused job {args.job!r} "
                         f"(have: {', '.join(sorted(db._fused))})")
    jobs = [args.job] if args.job is not None else sorted(db._fused)
    out = {}
    for j in jobs:
        job = db._fused[j]
        rows = [{"label": r["label"], "bucket": str(r.get("bucket")),
                 "state": "ready", "kind": r["kind"],
                 "s": round(r["s"], 3), "shards": job.profiler.shards,
                 "cache_hit": False, "error": None}
                for r in sorted(job.profiler.compile_info,
                                key=lambda r: r["label"])]
        out[j] = {
            "plan_hash": job.plan_hash,
            "aot": False,
            "signatures": rows,
            "counts": {st: sum(1 for r in rows if r["state"] == st)
                       for st in ("pending", "ready", "cached", "failed")},
        }
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


def cmd_dlq(args) -> int:
    """Poison-pill dead-letter queue (`rw_dead_letter`): list the
    quarantined input rows of a job (or all jobs), re-inject them into
    the live dataflow once the underlying poison condition is fixed, or
    purge them. Listing reads the durable DLQ table directly — no
    Database, works on a dead directory; requeue/purge open a full
    Database (DDL replay respawns the worker sets) and commit the
    status flip durably."""
    if args.requeue is None and args.purge is None:
        store = _store(args.data_dir)
        from ..runtime.remote_fragments import DeadLetterQueue
        from ..sql.database import DLQ_TABLE_ID
        from ..state import StateTable
        dlq = DeadLetterQueue(StateTable(
            store, DLQ_TABLE_ID, list(DeadLetterQueue.DTYPES),
            list(DeadLetterQueue.PK)))
        ents = dlq.entries(job=args.job)
        if not ents:
            print("dead-letter queue is empty"
                  + (f" for job {args.job!r}" if args.job else ""))
            return 0
        print(f"{'id':>5s}  {'job':12s} {'slot':>4s} {'side':>4s} "
              f"{'epoch':>7s}  {'status':12s} {'sign':>4s}  row")
        for (i, job, slot, side, epoch, _fp, sign, rrepr, _payload,
             status, _ts) in ents:
            print(f"{i:5d}  {job:12s} {slot:4d} {side:4d} {epoch:7d}  "
                  f"{status:12s} {sign:4d}  {rrepr}")
        print(f"-- {len(ents)} rows; requeue with "
              f"`dlq {args.job or '<job>'} --data-dir {args.data_dir} "
              "--requeue all` once the poison condition is fixed")
        return 0
    if args.requeue is not None and args.purge is not None:
        raise SystemExit("dlq: --requeue and --purge are mutually "
                         "exclusive (one destructive action at a time)")
    if args.job is None:
        raise SystemExit("dlq --requeue/--purge needs the JOB argument")
    from ..sql import Database
    db = Database(data_dir=args.data_dir, device="auto",
                  torch_device=args.torch_device)
    ids = None
    spec = args.purge if args.purge is not None else args.requeue
    if spec != "all":
        try:
            ids = [int(x) for x in spec.split(",") if x]
        except ValueError:
            raise SystemExit(f"bad id list {spec!r} (want 'all' or "
                             "comma-separated ids)")
    if args.purge is not None:
        n = db.dlq_purge(args.job, ids)
        print(f"purged {n} dead-letter rows of {args.job!r}")
        return 0
    try:
        n = db.dlq_requeue(args.job, ids)
    except ValueError as e:
        raise SystemExit(str(e))
    for _ in range(max(0, args.ticks)):
        db.tick()
    print(f"requeued {n} rows into {args.job!r} "
          f"(delivered over {args.ticks} barriers)")
    return 0


def cmd_history(args) -> int:
    """Retained manifest versions (time-travel window)."""
    store = _store(args.data_dir)
    for m in store.history_versions():
        n_runs = sum(len(r) for r in m["tables"].values())
        print(f"epoch {m['committed_epoch']}: {len(m['tables'])} tables, "
              f"{n_runs} runs")
    if not store.history_versions():
        print("no retained versions")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m risingwave_tpu_torch.ctl",
        description="risectl-lite: inspect/operate a data directory")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("jobs", cmd_jobs), ("ddl-log", cmd_ddl_log),
                     ("manifest", cmd_manifest), ("compact", cmd_compact),
                     ("metrics", cmd_metrics),
                     ("fused-stats", cmd_fused_stats)]:
        sp = sub.add_parser(name)
        sp.add_argument("--data-dir", required=True)
        sp.set_defaults(fn=fn)
    sp = sub.add_parser("dump")
    sp.add_argument("name")
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--limit", type=int, default=None)
    sp.set_defaults(fn=cmd_dump)
    sp = sub.add_parser("trace")
    sp.add_argument("action", nargs="?", default=None,
                    help="'export' merges barrier trace + epoch profile "
                         "+ clock samples into Chrome/Perfetto "
                         "trace-event JSON")
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--last", type=int, default=5)
    sp.add_argument("--stuck-only", action="store_true",
                    help="print only OPEN (uncommitted) epochs")
    sp.add_argument("--format", default="chrome",
                    help="export format (chrome)")
    sp.add_argument("-o", "--out", default=None,
                    help="export output file (default: stdout)")
    sp.set_defaults(fn=cmd_trace)
    sp = sub.add_parser("profile")
    sp.add_argument("job", nargs="?", default=None)
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--top", type=int, default=10,
                    help="slowest epochs to list per job")
    sp.add_argument("--follow", action="store_true",
                    help="tail epoch_profile.jsonl live "
                         "(rotation-aware) instead of summarizing")
    sp.set_defaults(fn=cmd_profile)
    sp = sub.add_parser("skew")
    sp.add_argument("job", nargs="?", default=None)
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--json", action="store_true",
                    help="raw snapshot JSON instead of the summary")
    sp.set_defaults(fn=cmd_skew)
    sp = sub.add_parser("tiering")
    sp.add_argument("job", nargs="?", default=None)
    sp.add_argument("--data-dir", required=True)
    sp.set_defaults(fn=cmd_tiering)
    sp = sub.add_parser("serving")
    sp.add_argument("--data-dir", required=True)
    sp.set_defaults(fn=cmd_serving)
    sp = sub.add_parser("blackbox")
    sp.add_argument("action", nargs="?", default=None,
                    help="list (default) | show BUNDLE | dump")
    sp.add_argument("bundle", nargs="?", default=None,
                    help="bundle name for `show`")
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--reason", default="manual",
                    help="reason tag stamped on a `dump` bundle")
    sp.set_defaults(fn=cmd_blackbox)
    sp = sub.add_parser("compile-status")
    sp.add_argument("job", nargs="?", default=None)
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--wait", type=float, default=0.0,
                    help="accepted for the JAX package's command line; "
                         "no compile is ever in flight here")
    sp.add_argument("--offline", action="store_true",
                    help="read the data dir's compile_manifest.json "
                         "mirror instead of opening a Database (the port "
                         "writes none)")
    sp.set_defaults(fn=cmd_compile_status)
    sp = sub.add_parser("backup")
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--dest", required=True)
    sp.set_defaults(fn=cmd_backup)
    sp = sub.add_parser("history")
    sp.add_argument("--data-dir", required=True)
    sp.set_defaults(fn=cmd_history)
    sp = sub.add_parser("dlq")
    sp.add_argument("job", nargs="?", default=None)
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--requeue", default=None, metavar="IDS|all",
                    help="re-inject quarantined rows (comma-separated "
                         "ids or 'all') into the live job")
    sp.add_argument("--purge", default=None, metavar="IDS|all",
                    help="drop quarantined rows outright")
    sp.add_argument("--ticks", type=int, default=4,
                    help="barriers to drive after a requeue so the rows "
                         "reach the MV/sink (default 4)")
    sp.set_defaults(fn=cmd_dlq)
    sp = sub.add_parser("failpoints")
    sp.add_argument("--spec", default=os.environ.get("RW_FAILPOINTS", ""))
    sp.add_argument("--arm", default=None,
                    help="validate a spec and print the export line")
    sp.add_argument("--ledger", nargs="?", const="", default=None,
                    metavar="FILE",
                    help="print a recorded fire ledger (omit FILE for "
                         "the live in-process ledger)")
    sp.set_defaults(fn=cmd_failpoints)
    for sp in sub.choices.values():
        sp.add_argument("--torch-device", default=None,
                        help="device of a Database the command opens "
                             "(default cuda:0; 'cpu' for the CPU)")
    args = p.parse_args(argv)
    return args.fn(args)
