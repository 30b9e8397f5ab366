"""System catalogs + plan rendering (the port's own copy of the JAX
package's `sql/system_catalog.py`).

Analog of the reference's `rw_catalog` system tables
(`src/frontend/src/catalog/system_catalog/rw_catalog/`) and EXPLAIN
output (`src/frontend/src/optimizer/plan_node/mod.rs` Display impls),
collapsed to the single-process runtime: system tables are virtual
batch-only snapshots built from the live catalog; EXPLAIN renders the
actually-planned executor tree (the physical plan — this runtime lowers
AST straight to executors)."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

from ..core import dtypes as T
from ..core.schema import Schema


def _rows_tables(db) -> List[Tuple]:
    return [(o.name, o.table_id, o.append_only)
            for o in db.catalog.objects.values() if o.kind == "table"]


def _rows_mvs(db) -> List[Tuple]:
    return [(o.name, o.table_id,
             o.parallelism if o.parallelism is not None else 0)
            for o in db.catalog.objects.values() if o.kind == "mv"]


def _rows_sources(db) -> List[Tuple]:
    return [(o.name, o.table_id,
             o.with_options.get("connector", "dml"))
            for o in db.catalog.objects.values()
            if o.kind in ("source", "table")]


def _rows_sinks(db) -> List[Tuple]:
    return [(o.name, o.with_options.get("connector", "collect"))
            for o in db.catalog.objects.values() if o.kind == "sink"]


def _rows_params(db) -> List[Tuple]:
    return [(k, str(v)) for k, v in sorted(db.system_params.values.items())]


def _rows_columns(db) -> List[Tuple]:
    out = []
    for o in db.catalog.objects.values():
        if o.kind in ("table", "source", "mv"):
            for i, f in enumerate(o.schema.fields):
                out.append((o.name, f.name, i, str(f.dtype)))
    return out


# name -> (schema, row builder). Names mirror rw_catalog.
SYSTEM_TABLES: Dict[str, Tuple[Schema, Callable[[Any], List[Tuple]]]] = {
    "rw_tables": (Schema.of(("name", T.VARCHAR), ("id", T.INT64),
                            ("append_only", T.BOOLEAN)), _rows_tables),
    "rw_materialized_views": (
        Schema.of(("name", T.VARCHAR), ("id", T.INT64),
                  ("parallelism", T.INT64)), _rows_mvs),
    "rw_sources": (Schema.of(("name", T.VARCHAR), ("id", T.INT64),
                             ("connector", T.VARCHAR)), _rows_sources),
    "rw_sinks": (Schema.of(("name", T.VARCHAR), ("connector", T.VARCHAR)),
                 _rows_sinks),
    "rw_system_parameters": (
        Schema.of(("name", T.VARCHAR), ("value", T.VARCHAR)), _rows_params),
    "rw_columns": (Schema.of(("relation", T.VARCHAR), ("name", T.VARCHAR),
                             ("position", T.INT64), ("type", T.VARCHAR)),
                   _rows_columns),
    # per-barrier span rows (utils/trace.py): job='<barrier>' carries the
    # whole-epoch state/total; phase RUNNING / OPEN marks a stall
    "rw_barrier_trace": (
        Schema.of(("epoch", T.INT64), ("kind", T.VARCHAR),
                  ("job", T.VARCHAR), ("state", T.VARCHAR),
                  ("ms", T.FLOAT64)),
        lambda db: db.tracer.rows()),
    # backfill progress per streaming job (`barrier/progress.rs` /
    # rw_ddl_progress analog): rows emitted / snapshot total per upstream
    "rw_ddl_progress": (
        Schema.of(("job", T.VARCHAR), ("upstream", T.VARCHAR),
                  ("emitted", T.INT64), ("total", T.INT64),
                  ("progress", T.VARCHAR)),
        lambda db: _ddl_progress(db)),
    # epoch-timeline profiler (utils/profile.py): one row per fused-job
    # epoch with its phase split — host pack, H2D transfer enqueue
    # (staged ingest buffers), async dispatch, blocking device sync,
    # state-table commit (ring-buffered; the full history is in
    # epoch_profile.jsonl / `risectl profile`). pack/h2d split the old
    # host_pack column disjointly; promote_h2d/demote_d2h are the state
    # tier's surgery phases (zero with tiering off).
    "rw_epoch_profile": (
        Schema.of(("job", T.VARCHAR), ("seq", T.INT64),
                  ("events", T.INT64), ("shards", T.INT64),
                  ("pack_ms", T.FLOAT64), ("h2d_ms", T.FLOAT64),
                  ("promote_h2d_ms", T.FLOAT64),
                  ("dispatch_ms", T.FLOAT64), ("exchange_ms", T.FLOAT64),
                  ("device_sync_ms", T.FLOAT64),
                  ("demote_d2h_ms", T.FLOAT64),
                  ("commit_ms", T.FLOAT64), ("wall_ms", T.FLOAT64)),
        lambda db: _epoch_profile(db)),
    # per-node attribution from the on-device stats vector: row flow,
    # observed entries vs capacity (occupancy), allocated HBM
    "rw_fused_node_stats": (
        Schema.of(("job", T.VARCHAR), ("node", T.INT64),
                  ("type", T.VARCHAR), ("slot", T.VARCHAR),
                  ("rows_in", T.INT64), ("rows_out", T.INT64),
                  ("entries", T.INT64), ("capacity", T.INT64),
                  ("occupancy", T.FLOAT64), ("hbm_mb", T.FLOAT64),
                  ("overflow", T.BOOLEAN)),
        lambda db: _fused_node_stats(db)),
    # metrics-plane worker heartbeats: age of the last frame per remote
    # worker (ANY frame counts — data proves liveness as well as M
    # frames); `wedged?` = alive process, stale heartbeat, and no
    # undrained output waiting on the coordinator. Ages recompute at
    # SELECT time.
    "rw_worker_liveness": (
        Schema.of(("job", T.VARCHAR), ("worker", T.VARCHAR),
                  ("pid", T.INT64), ("last_epoch", T.INT64),
                  ("heartbeat_age_s", T.FLOAT64), ("state", T.VARCHAR)),
        lambda db: db._worker_liveness_rows()),
    # source->MV end-to-end freshness (utils/freshness.py): last commit's
    # ingest->commit wall, the SELECT-time staleness (now - last
    # committed ingest), and ring quantiles
    "rw_mv_freshness": (
        Schema.of(("mv", T.VARCHAR), ("epoch", T.INT64),
                  ("ingest_ts", T.FLOAT64), ("commit_ts", T.FLOAT64),
                  ("freshness_s", T.FLOAT64), ("staleness_s", T.FLOAT64),
                  ("p50_s", T.FLOAT64), ("p99_s", T.FLOAT64),
                  ("commits", T.INT64)),
        lambda db: db._freshness.rows()),
    # key-skew telemetry (device/skew_stats.py): per keyed fused node,
    # the vnode-occupancy histogram (metric='vnode_occ', one row per
    # bucket, share = fraction of live keys), its max/mean ratio
    # (metric='skew_ratio', share carries the ratio, value the live
    # total) and the top-K heavy-hitter candidates (metric='hot_key',
    # key = 40-bit-truncated hot key, value = its per-epoch row count)
    "rw_key_skew": (
        Schema.of(("job", T.VARCHAR), ("node", T.INT64),
                  ("type", T.VARCHAR), ("metric", T.VARCHAR),
                  ("ordinal", T.INT64), ("key", T.INT64),
                  ("value", T.INT64), ("share", T.FLOAT64)),
        lambda db: _key_skew(db)),
    # tiered-state residency (device/tiering.py): per demotion-eligible
    # fused node, the hot-tier residency high-water vs the cold-tier
    # row count, whether the Xor8 negative cache is live, whether the
    # node can demote at all (promotable=false nodes are recency-stats
    # only), and the job-wide demotion/promotion/filter counters
    "rw_state_tiering": (
        Schema.of(("job", T.VARCHAR), ("node", T.INT64),
                  ("type", T.VARCHAR), ("resident", T.INT64),
                  ("cold", T.INT64), ("filter_live", T.BOOLEAN),
                  ("promotable", T.BOOLEAN), ("demotions", T.INT64),
                  ("promotions", T.INT64), ("demote_events", T.INT64),
                  ("filter_probes", T.INT64), ("filter_hits", T.INT64),
                  ("filter_fallbacks", T.INT64)),
        lambda db: _state_tiering(db)),
    # serving-tier read cache (serving/read_cache.py): one row per
    # cached fused MV — the snapshot's epoch stamp and row count plus
    # the hit/miss/coalesced/fill counters that prove the one-pull-per-
    # (MV, epoch) invariant is holding in production
    "rw_serving_cache": (
        Schema.of(("mv", T.VARCHAR), ("cache_epoch", T.INT64),
                  ("cached_rows", T.INT64), ("hits", T.INT64),
                  ("misses", T.INT64), ("coalesced", T.INT64),
                  ("fills", T.INT64)),
        lambda db: list(db.read_cache.report())),
    # serving-tier device-pull accounting (shard_exec.PULL_STATS): how
    # many host transfers SELECT serving has cost, split by the replica
    # column that served each one — the read-load balance over the
    # replica mesh axis. replica=-1 is the process total.
    "rw_serving_pulls": (
        Schema.of(("replica", T.INT64), ("pulls", T.INT64)),
        lambda db: _serving_pulls(db)),
    # flow telemetry (device/skew_stats.py): the traffic-per-vnode view
    # of rw_key_skew — per flow-armed node, this job-lifetime's ROUTED
    # rows per vnode bucket (metric='vnode_traffic', share = the
    # bucket's fraction of total traffic), the traffic max/mean ratio
    # ('traffic_skew'), the traffic-vs-occupancy divergence
    # ('traffic_div', half the L1 distance of the normalized histograms
    # — the "hot flow over cold state" signal) and the burst-vs-
    # sustained ratio from the per-node EWMA ring ('traffic_burst').
    "rw_vnode_traffic": (
        Schema.of(("job", T.VARCHAR), ("node", T.INT64),
                  ("type", T.VARCHAR), ("metric", T.VARCHAR),
                  ("ordinal", T.INT64), ("value", T.INT64),
                  ("share", T.FLOAT64)),
        lambda db: _vnode_traffic(db)),
    # poison-pill dead-letter queue (fault-tolerance v3): one row per
    # input record the supervisor sidelined after bounded respawns kept
    # dying on the same retained window. The full audit trail of the
    # bounded data loss — `risectl dlq <job>` lists/requeues/purges the
    # same rows. epoch=-1 marks the open (not-yet-barriered) tail of the
    # quarantined window; status walks quarantined -> requeued.
    "rw_dead_letter": (
        Schema.of(("id", T.INT64), ("job", T.VARCHAR), ("slot", T.INT64),
                  ("side", T.INT64), ("epoch", T.INT64),
                  ("fingerprint", T.VARCHAR), ("sign", T.INT64),
                  ("row", T.VARCHAR), ("status", T.VARCHAR),
                  ("ts", T.FLOAT64)),
        lambda db: _dead_letter(db)),
    # overload control plane (utils/overload.py): per job, the current
    # degradation-ladder state (seq=0) plus the transition history
    # (seq>0, newest last) — state walks normal -> throttled -> degraded
    # -> shedding and back with hysteresis; `stretch` is the live epoch-
    # cadence multiplier, `pressure` the [0,1] credit-starvation signal
    # the transition acted on, `dominant_source` the labeled evidence
    # ("stall:<kind>" / "sink:<name>" / "queue:<set>") that drove it —
    # every rung now says WHY it was taken.
    "rw_overload": (
        Schema.of(("job", T.VARCHAR), ("seq", T.INT64),
                  ("state", T.VARCHAR), ("prev_state", T.VARCHAR),
                  ("pressure", T.FLOAT64), ("stretch", T.INT64),
                  ("since_ts", T.FLOAT64), ("ts", T.FLOAT64),
                  ("dominant_source", T.VARCHAR)),
        lambda db: db._overload.rows()),
    # pressure attribution (utils/overload.py): the labeled evidence
    # rows behind the overload_pressure scalar — per-seam stall
    # fractions ('stall'), per-sink spool ratios ('sink'), per-worker-
    # set exchange queue ratios ('queue'), plus one 'combined' row
    # holding the recombined scalar. pressure_of IS
    # combine_contributions(these rows), so SQL can verify the
    # decomposition recombines exactly; `dominant` flags the argmax the
    # ladder transitions were stamped with.
    "rw_pressure_attrib": (
        Schema.of(("family", T.VARCHAR), ("source", T.VARCHAR),
                  ("value", T.FLOAT64), ("dominant", T.BOOLEAN)),
        lambda db: db._overload.attribution_rows()),
    # per-source admission control: token-bucket state + the offered/
    # admitted/deferred poll counters whose difference is the source's
    # admission lag (backpressure debt pushed back to the connector)
    "rw_source_admission": (
        Schema.of(("source", T.VARCHAR), ("state", T.VARCHAR),
                  ("factor", T.FLOAT64), ("offered", T.INT64),
                  ("admitted", T.INT64), ("deferred", T.INT64),
                  ("shed_rows", T.INT64), ("lag", T.INT64)),
        lambda db: db._overload.admission_rows()),
    # durable shed audit (RW_LOAD_SHED only): one row per source window
    # dropped by admission control on the shedding rung — the gap is a
    # recorded decision, never a silent loss (the rw_dead_letter
    # pattern, minus the payload: unadmitted data has no exact bytes to
    # requeue)
    "rw_shed_log": (
        Schema.of(("id", T.INT64), ("source", T.VARCHAR),
                  ("epoch", T.INT64), ("rows", T.INT64),
                  ("reason", T.VARCHAR), ("ts", T.FLOAT64)),
        lambda db: db._shed_log.entries()),
}


def _dead_letter(db) -> List[Tuple]:
    # project the binary payload column out — the system-table view is
    # the human-readable audit surface; exact bytes stay in the store
    return [(r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[9], r[10])
            for r in db._dlq.entries()]


def _epoch_profile(db) -> List[Tuple]:
    return [row for job in db._fused.values()
            for row in job.profiler.rows()]


def _key_skew(db) -> List[Tuple]:
    return [(name,) + row for name, job in db._fused.items()
            for row in job.skew_report()]


_TRAFFIC_METRICS = ("vnode_traffic", "traffic_skew", "traffic_div",
                    "traffic_burst")


def _vnode_traffic(db) -> List[Tuple]:
    # the traffic slice of skew_report, minus the (always-NULL here)
    # hot-key column
    return [(name, node, tname, metric, ordinal, value, share)
            for name, job in db._fused.items()
            for node, tname, metric, ordinal, _key, value, share
            in job.skew_report()
            if metric in _TRAFFIC_METRICS]


def _serving_pulls(db) -> List[Tuple]:
    from ..device.shard_exec import PULL_STATS
    rows = [(int(rep), int(n))
            for rep, n in sorted(PULL_STATS["replica_pulls"].items())]
    return rows + [(-1, int(PULL_STATS["device_pulls"]))]


def _state_tiering(db) -> List[Tuple]:
    return [(name,) + row for name, job in db._fused.items()
            for row in job.tiering_report()]


def _fused_node_stats(db) -> List[Tuple]:
    return [(name,) + row for name, job in db._fused.items()
            for row in job.node_report()]


def _ddl_progress(db) -> List[Tuple]:
    from .database import _Backfill, _walk_executors
    out = []
    for obj in db.catalog.objects.values():
        rt = obj.runtime if isinstance(obj.runtime, dict) else None
        shared = rt.get("shared") if rt else None
        if shared is None:
            continue
        for e in _walk_executors(shared.upstream):
            if isinstance(e, _Backfill) and e.total:
                out.append((obj.name, e.upstream_name, e.emitted,
                            e.total, f"{e.progress * 100:.1f}%"))
    return out


# ---------------------------------------------------------------------------
# EXPLAIN rendering
# ---------------------------------------------------------------------------

def _label(e) -> str:
    name = e.name or type(e).__name__
    bits: List[str] = []
    gk = getattr(e, "group_key_indices", None)
    if gk is not None:
        bits.append(f"group_key={list(gk)}")
    calls = getattr(e, "calls", None)
    if calls:
        try:
            bits.append("aggs=[" + ", ".join(c.kind for c in calls) + "]")
        except Exception:
            pass
    ki = getattr(e, "key_idx", None)
    if isinstance(ki, dict):
        bits.append(f"on={ki.get('a')}={ki.get('b')}")
    mesh = getattr(e, "mesh", None)
    if mesh is not None:
        # the shard count, as the JAX package prints its mesh's
        # `devices.size`
        bits.append(f"mesh={mesh.n}")
    if getattr(e, "append_only", False):
        bits.append("append_only")
    return name + (" { " + ", ".join(bits) + " }" if bits else "")


def _plan_children(e) -> List[Any]:
    """Child executors of one node — the ONE place that knows the child
    attribute names, shared by EXPLAIN and EXPLAIN ANALYZE so the two
    surfaces can never show different trees."""
    children = []
    for attr in ("input", "left_exec", "right_exec", "port"):
        c = getattr(e, attr, None)
        if c is not None:
            children.append(c)
    children.extend(getattr(e, "inputs", ()))
    return children


def render_plan(e, depth: int = 0) -> str:
    lines = ["  " * depth + ("-> " if depth else "") + _label(e)]
    for c in _plan_children(e):
        lines.append(render_plan(c, depth + 1))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# streaming EXPLAIN ANALYZE: the live per-operator tree of a RUNNING job
# ---------------------------------------------------------------------------


def explain_analyze_fused(name: str, job) -> str:
    """Per-operator tree of a running fused device job.

    Every number comes from surfaces the job already maintains — the
    stats vector totals behind `rw_fused_node_stats` (rows/occupancy
    agree with that table by construction: both read `node_report`),
    the epoch profiler's phase totals, per-node compile events, and the
    skew telemetry — so rendering costs zero device traffic and the
    numbers are checkpoint-fresh (the same contract as the system
    tables)."""
    import time
    prog = job.program
    prof = job.profiler
    elapsed = max(1e-9, time.monotonic() - job.t_created)
    ph = dict(prof.totals)
    busy = sum(ph.values())
    head = [
        f"Streaming EXPLAIN ANALYZE: {name} "
        f"(fused, shards={job.mesh_shards}, "
        f"events={job.committed}/{job.max_events or '?'}, "
        f"epochs={prof.epochs}, elapsed={elapsed:.1f}s, "
        f"eps={job.committed / elapsed:.0f})",
        "phase share: " + " | ".join(
            f"{k} {v / elapsed * 100:.1f}%" for k, v in ph.items())
        + f" | idle {max(0.0, elapsed - busy) / elapsed * 100:.1f}%",
    ]
    # per-(node, slot) attribution grouped by node — THE rows behind
    # rw_fused_node_stats, so eps/occupancy columns agree with it
    by_node: Dict[int, List[Tuple]] = {}
    for row in job.node_report():
        by_node.setdefault(row[0], []).append(row)
    # per-node compile wall from the profiler's labeled events
    compile_s: Dict[int, float] = {}
    with prof._ev_lock:
        infos = list(prof.compile_info)
    for rec in infos:
        try:
            idx = int(rec["label"].split(":", 1)[0])
        except (ValueError, KeyError):
            continue
        compile_s[idx] = compile_s.get(idx, 0.0) + rec.get("s", 0.0)
    consumed = {j for n in prog.nodes for j in n.inputs}
    roots = [i for i in range(len(prog.nodes)) if i not in consumed]
    lines: List[str] = []

    def node_line(i: int) -> str:
        node = prog.nodes[i]
        tname = type(node).__name__
        label = f"{i}:{tname}"
        if tname == "ChainNode":
            label += "[" + ">".join(type(m).__name__.replace("Node", "")
                                    for m in node.chain) + "]"
        slots = by_node.get(i, [])
        rows_in = slots[0][3] if slots else 0
        rows_out = slots[0][4] if slots else 0
        bits = [f"rows_in={rows_in}", f"rows_out={rows_out}",
                f"eps_in={rows_in / elapsed:.0f}",
                f"eps_out={rows_out / elapsed:.0f}"]
        if rows_in:
            bits.append(f"amp={rows_out / rows_in:.2f}")
        for (_i, _t, slot, _ri, _ro, entries, cap, occ, hbm,
             overflow) in slots:
            if slot == "-":
                continue
            bits.append(f"{slot}={entries}/{cap}"
                        + (f"({occ * 100:.0f}%)" if cap else "")
                        + (" OVERFLOW" if overflow else ""))
        hbm_total = sum(s[8] for s in slots)
        if hbm_total:
            bits.append(f"hbm={hbm_total:.1f}MB")
        ratio = job.node_skew_ratio(i)
        if ratio is not None:
            bits.append(f"skew={ratio:.1f}x")
        if compile_s.get(i):
            bits.append(f"compile_s={compile_s[i]:.2f}")
        return label + " { " + ", ".join(bits) + " }"

    def render(i: int, depth: int) -> None:
        lines.append("  " * depth + ("-> " if depth else "") + node_line(i))
        for j in prog.nodes[i].inputs:
            render(j, depth + 1)

    for r in roots:
        render(r, 0)
    return "\n".join(head + lines)


def _analyze_bits(e) -> List[str]:
    """Live annotations for one host executor: backfill progress,
    remote-worker liveness, and channel queue depths (the
    busy/backpressure signal of the host path — a full result channel
    means the consumer is the bottleneck, a full dispatch channel means
    the worker is)."""
    bits: List[str] = []
    if getattr(e, "total", None) and hasattr(e, "emitted"):
        bits.append(f"backfill={e.emitted}/{e.total}")
    r = getattr(e, "_remote", None)
    if r is not None:
        for (_j, worker, pid, last_epoch, age,
             state) in r.liveness_rows(""):
            bits.append(f"{worker}[pid={pid} {state} epoch={last_epoch} "
                        f"hb_age={age:.1f}s]")
        # result-side backpressure: queued output the coordinator has
        # not consumed, per worker channel
        for i, ch in enumerate(getattr(r, "channels", ())):
            q = len(getattr(ch, "buf", ()))
            if q:
                bits.append(f"out_queue[{i}]={q}/{ch.capacity}")
        # dispatch-side backpressure: input waiting on a slow worker
        for side, chans in enumerate(getattr(r, "in_channels", ())):
            for i, nc in enumerate(chans):
                q = nc._data_len() if hasattr(nc, "_data_len") else 0
                if q:
                    bits.append(f"in_queue[{side}.{i}]={q}/{nc.capacity}")
    return bits


def explain_analyze_host(name: str, obj) -> str:
    """Per-operator tree of a running host/multi-process MV: the
    planned executor tree annotated with live counters — backfill
    progress, per-worker liveness + last result epoch (the metrics
    plane), and exchange queue depths (backpressure)."""
    shared = (obj.runtime or {}).get("shared")
    if shared is None:
        return f"{name}: no live dataflow (fused or dropped?)"
    head = [f"Streaming EXPLAIN ANALYZE: {name} (host placement)"]
    lines: List[str] = []

    def walk(e, depth: int) -> None:
        bits = _analyze_bits(e)
        lines.append("  " * depth + ("-> " if depth else "") + _label(e)
                     + (" { " + ", ".join(bits) + " }" if bits else ""))
        for c in _plan_children(e):
            walk(c, depth + 1)

    walk(shared.upstream, 0)
    return "\n".join(head + lines)
