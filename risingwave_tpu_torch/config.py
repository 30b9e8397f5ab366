"""Runtime configuration — the reference's 3-tier config system (the
port's own copy of the JAX package's `config.py`).

* `NodeConfig` — per-process startup config, TOML-loadable
  (`src/common/src/config.rs:137`; `risingwave.toml`). Immutable for the
  process lifetime.
* `SystemParams` — cluster-wide parameters alterable at runtime via
  `ALTER SYSTEM SET` (`src/common/src/system_param/mod.rs:97`): mutations
  are DDL-logged so a restarted process replays them.
* session variables — per-connection `SET`/`SHOW`
  (`src/common/src/session_config/`), held on the Database session.

The device tier (`DeviceConfig`) governs the SQL->device dispatch seam:
whether eligible plan fragments lower onto the CUDA executors and over
which mesh.

Two functions named `resolve_device` exist in the port: this one
normalizes the Database(device=...) argument into an
`Optional[DeviceConfig]`; `device.resolve_device` picks the
`torch.device` an entry point runs on. Neither is exported from the
package root.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional


@dataclass
class DeviceConfig:
    """Device-path lowering config (the `from_proto` dispatch policy).

    mesh      — the port's `parallel.mesh.Mesh` to shard operator state
                over; None = one card (no exchanges).
    capacity  — initial per-operator state slots (grows by pow2 on demand).
    minmax    — lower min/max aggregates onto the retractable sorted-
                multiset state (device/minput.py).

    `compile_cache_dir`, `aot_compile` and `compile_buckets` name the
    JAX package's compile machinery (a persistent XLA cache, a
    background compile service). They are kept so config files parse
    the same in both packages and do nothing here: the port compiles
    its kernels once per process (`kernels/binding.py`) and traces
    nothing per shape, and a fused job runs eagerly, so the compile
    service has no counterpart — the port behaves as the JAX package
    does with `aot_compile=False` (`risectl compile-status` reports
    `"aot": false`). There is no `FusedJob.prewarm()`.
    """
    mesh: Optional[Any] = None
    capacity: int = 1024
    minmax: bool = True
    # mesh-sharded FUSED programs (device/shard_exec.py): eligible fused
    # MV fragments execute as ONE epoch program over an n-shard mesh —
    # node state carries a shard axis with vnode-keyed blocks, the
    # cross-vnode shuffle for joins/aggs runs as the `bucket_exchange`
    # kernel, and global stats reduce by sum / max across shards. 1 =
    # the single-card fused path, byte-for-byte unchanged. Distinct from
    # `mesh`, which shards the PER-OPERATOR host executors
    # (parallel/sharded_*) and disables fusion.
    mesh_shards: int = 1
    # serving replicas: the fused mesh becomes (mesh_shards, replicas)
    # with state sharded over the data axis and MIRRORED over the
    # replica axis: mesh_shards * replicas device slots dealt over the
    # Database's device set (`parallel.mesh.device_set`), sharing
    # devices round-robin where it has fewer; 1 = the 1-D mesh,
    # unchanged. RW_MESH_REPLICAS overrides.
    replicas: int = 1
    # whole-fragment fusion (device/fuse_planner.py): eligible MV plans
    # become one epoch program. Off forces the per-operator path.
    fuse: bool = True
    # host-ingest feed for fused sources (device/ingest.py): every
    # source of a fused job becomes an IngestNode whose per-epoch input
    # is a pre-staged device buffer — host connectors poll into reused
    # pinned staging buffers, a staging thread double-buffers the
    # host-to-device copy under the previous epoch's dispatch. Off
    # (default) keeps deterministic sources regenerating on device
    # (fastest for synthetic benchmarks; host ingest is the production
    # source path). RW_HOST_INGEST overrides; a single source opts in
    # via WITH (nexmark.ingest='host').
    host_ingest: bool = False
    # fused jobs mirror their MV into the host state table for non-device
    # readers every N checkpoints (plus at drain/recovery). 1 = every
    # checkpoint (reference-strict); higher trades mirror freshness for
    # throughput — queries always serve live device state regardless.
    mv_persist_every: int = 8
    # capacity lifecycle (device/capacity.py): a growth replay sizes EVERY
    # node from its observed entries-per-event rate extrapolated over
    # max_events (cascade-free, ~1 replay per job) instead of doubling
    # only the overflowed state. Off restores blind pow2 doubling.
    predictive_growth: bool = True
    # device-memory budget the predictor's projections are scaled down
    # to (never below the observed need — the budget trims headroom, not
    # correctness).
    hbm_budget_mb: int = 4096
    # the JAX package's persistent compile cache directory; does nothing
    # in the port (see the class docstring).
    compile_cache_dir: Optional[str] = None
    # epoch-timeline profiler (utils/profile.py): per-epoch phase-split
    # spans (pack / dispatch / device-sync / commit), compile-event
    # timing, and the rw_epoch_profile / rw_fused_node_stats surfaces.
    # Costs a few perf_counter reads per epoch; off removes even that.
    profile: bool = True
    # the JAX package's background compile service; does nothing in the
    # port (see the class docstring).
    aot_compile: bool = True
    # the JAX package's growth-bucket pre-warm rounds; does nothing in
    # the port (see the class docstring).
    compile_buckets: int = 4
    # key-skew telemetry (device/skew_stats.py): keyed fused nodes
    # (Agg/Join) compute a vnode-occupancy histogram over their live key
    # tables and per-epoch top-K heavy-hitter counters inside the epoch
    # step, riding the stats vector (summed / maxed across mesh shards
    # like every other stat). Costs one O(capacity) bucket pass + one
    # O(epoch) sort per keyed node per epoch. RW_SKEW_STATS=0/1 in the
    # environment overrides this without code changes.
    skew_stats: bool = True
    # --- skew defenses (act on the rw_key_skew evidence) ----------------
    # local pre-combine (device/agg_step.py `PrecombineNode`): duplicate-
    # key rows of an agg's epoch input combine to one partial-aggregate
    # row per key BEFORE the state merge — and, under mesh sharding,
    # BEFORE the exchange, so a hot key ships one combined row per
    # (shard, epoch) instead of every raw row. Exact: applies only to
    # integer-reduction aggs (no retractable min/max multisets, no float
    # sums). RW_AGG_PRECOMBINE=0/1 overrides.
    agg_precombine: bool = True
    # hot-key replication: join keys flagged by the heavy-hitter
    # counters get one side's rows replicated to every shard while the
    # other side's rows salt round-robin by row identity.
    # RW_HOT_KEY_REP=0/1.
    hot_key_rep: bool = True
    # a key is "hot" when its per-epoch row count reaches this fraction
    # of the epoch cadence (evidence: the skh* heavy-hitter slots).
    hot_key_frac: float = 0.125
    # barrier-time vnode rebalancing: when the per-shard load implied by
    # the vnode-occupancy histogram exceeds rebalance_threshold
    # (max/mean), the job recomputes the vnode-block bounds at a
    # checkpoint. RW_VNODE_REBALANCE=0/1 overrides.
    vnode_rebalance: bool = True
    rebalance_threshold: float = 2.0
    # tiered state beyond device memory (device/tiering.py): keyed fused
    # state demotes its coldest keys to host stores when occupancy
    # crosses a high-water fraction of capacity, and promotes them back
    # — probed through an Xor8 negative cache — the moment a window
    # touches them again, so results stay bit-identical to the untiered
    # run. RW_STATE_TIERING=0/1 overrides; RW_TIER_HIGH_WATER /
    # RW_TIER_LOW_WATER tune the marks.
    state_tiering: bool = True
    # flow telemetry (device/skew_stats.py): keyed fused nodes count
    # this epoch's ROUTED rows per vnode bucket inside the epoch step —
    # the traffic histogram occupancy-driven rebalancing is blind to
    # (hot flow over cold state). Slots ride the stat_sums split (sum
    # across epochs and shards — exact totals). RW_FLOW_STATS=0/1
    # overrides without code changes.
    flow_stats: bool = True


@dataclass
class StreamingConfig:
    """[streaming] section (`StreamingConfig`, config.rs)."""
    chunk_size: int = 1024             # max rows per stream chunk
    barrier_interval_ms: int = 1000    # timed-runtime barrier cadence
    checkpoint_frequency: int = 1      # checkpoints per N barriers


@dataclass
class StorageConfig:
    """[storage] section (`StorageConfig`, config.rs)."""
    data_dir: Optional[str] = None     # None = in-memory state store
    block_cache_blocks: int = 4096     # hummock LRU capacity
    compact_threshold: int = 8         # runs per table before compaction


@dataclass
class RobustnessConfig:
    """Retry / timeout / supervision knobs for the multi-process runtime
    (the reference's `[meta] max_heartbeat_interval_secs` +
    `[streaming] actor retry` family, collapsed to what this runtime
    needs). Read once per process from `RW_<FIELD>` environment
    variables, so worker OS processes spawned by the coordinator inherit
    the operator's settings without a config file of their own; tests
    mutate the module-global `ROBUSTNESS` instance directly."""
    # RemoteInput -> coordinator exchange connect: bounded exponential
    # backoff (base doubles per attempt, capped at 1s per sleep)
    connect_attempts: int = 5
    connect_backoff_s: float = 0.05
    connect_timeout_s: float = 10.0
    # worker process spawn: ADDR-handshake deadline + retries
    spawn_attempts: int = 3
    spawn_timeout_s: float = 30.0
    spawn_backoff_s: float = 0.05
    # ExchangeServer.wait_drained default deadline (worker shutdown)
    drain_deadline_s: float = 120.0
    # FragmentSupervisor: in-place respawns per worker slot before
    # escalating to RemoteWorkerDied (full job recovery)
    respawn_attempts: int = 3
    respawn_backoff_s: float = 0.05
    # poison-pill quarantine: consecutive respawns of ONE slot that die
    # on the SAME retained input window (fingerprinted) before the
    # supervisor sidelines the window's data chunks into the durable
    # rw_dead_letter table and resumes past them — bounded data loss
    # with an audit trail instead of a wedged-forever fragment. Must be
    # <= respawn_attempts or the attempt bound escalates first; <= 0
    # disables quarantine (the pre-v3 respawn-until-escalate behavior).
    poison_threshold: int = 2
    # fused device jobs: in-place recoveries per job from a device-path
    # failure (dispatch/sync/replay/commit exception or an armed
    # fused.* failpoint) before the error propagates to the classic
    # DDL-replay restart. Recovery rebuilds program state from the last
    # checkpoint and re-dispatches the retained crash-window epochs.
    fused_recovery_attempts: int = 3
    # metrics plane: a worker whose last heartbeat frame (piggybacked on
    # its result stream) is older than this is flagged WEDGED in
    # rw_worker_liveness / worker_liveness — alive-but-stuck detection
    # ahead of the spawn/drain deadlines (detection is passive for
    # unsupervised sets; supervised sets ACT on it, see wedge_kill_factor)
    heartbeat_timeout_s: float = 60.0
    # wedge reaper (supervised sets only): a worker whose heartbeat age
    # exceeds heartbeat_timeout_s * wedge_kill_factor while its process
    # is still alive is SIGKILLed and routed through the same in-place
    # respawn path as a dead worker (bounded attempts, then escalation).
    # <= 0 disables reaping (observe-only, the pre-supervision-v2
    # behavior).
    wedge_kill_factor: float = 3.0
    # ---- overload control plane (credit flow + degradation ladder) ----
    # initial credit (in chunks) a receiver grants each exchange stream,
    # and the unit the producer-side queue bound derives from (queue
    # capacity = 4x credits). Lower = tighter memory bound + earlier
    # backpressure; higher = more in-flight pipelining.
    exchange_credits: int = 256
    # master gate for the graceful-degradation ladder
    # (normal -> throttled -> degraded -> shedding). Off: the ladder
    # observes (pressure gauge, rw_overload stays 'normal') but never
    # throttles, stretches, or sheds.
    overload_ladder: bool = True
    # sliding window the credit-stall fraction is computed over
    overload_window_s: float = 5.0
    # pressure thresholds with a dead band between them (hysteresis):
    # >= high sustained for hold_s escalates one rung; <= low sustained
    # for hold_s recovers one rung; in between nothing moves.
    overload_high: float = 0.5
    overload_low: float = 0.1
    overload_hold_s: float = 2.0
    # epoch-cadence stretch factor on the degraded/shedding rungs: fused
    # jobs dispatch this many epochs per barrier (the same kernels —
    # nothing is rebuilt), host sources allow this many times the
    # per-epoch chunk bound — bigger batches, fewer barrier overheads,
    # freshness p99 traded against eps (rw_mv_freshness measures it).
    overload_stretch: int = 4
    # the ladder's top rung: shed oldest unadmitted source windows into
    # the durable audited rw_shed_log table. DEFAULT OFF — with shedding
    # off the ladder caps at 'degraded' and results stay bit-identical
    # (throttling and stretch only re-time work, never change it).
    load_shed: bool = False
    # front-door SELECT admission: pgwire statements past this many
    # in-flight SELECTs get a clean SQLSTATE 53000 rejection instead of
    # queueing unboundedly on the coordinator lock. <= 0 disables the
    # gate (the repo's knob-off convention).
    select_concurrency: int = 64
    # per-session slice of the SELECT admission budget: one pgwire
    # session may hold at most this many in-flight SELECTs, so a chatty
    # session exhausts its own slice (53000) long before it can starve
    # the global budget for everyone else. <= 0 disables the per-session
    # cap (the knob-off convention); the global bound still applies.
    select_per_session: int = 8
    # serving-tier read cache (serving/read_cache.py): pgwire SELECTs
    # over fused MVs serve from host-side epoch-versioned snapshots —
    # one device pull per (MV, epoch) regardless of reader count, with
    # concurrent cache-miss readers coalesced onto a single pull.
    serving_cache: bool = True
    # staleness bound, in committed epochs: a cached snapshot serves iff
    # cache_epoch >= committed_epoch - serving_staleness_epochs. 0 =
    # always-fresh (the cache still coalesces readers within an epoch);
    # higher trades bounded staleness for zero pulls across commits.
    serving_staleness_epochs: int = 0
    # sink spool bound (rows buffered in one checkpoint window) past
    # which the sink reports pressure to the ladder; a stalled external
    # sink parks its backlog in the DURABLE sink log (disk), never RSS.
    sink_spool_rows: int = 65536
    # coordinator-side fused epoch event log byte cap: entries past it
    # spill beside epoch_profile.jsonl and reload transparently on
    # in-place recovery — a degraded-mode (stretched-cadence) job must
    # not trade queue growth for event-log growth.
    fused_epoch_log_bytes: int = 1 << 20
    # supervised stateful respawn refresh mode: True (default) seeds the
    # respawned worker with state as of its last DELIVERED epoch
    # (un-applying the retained crash-window input), replays the window,
    # and emits a per-epoch NET DIFF vs the seed snapshot — exact, no
    # duplicate rows downstream. False restores the v1 full owned-group
    # refresh (live-shadow seed + re-INSERT of every owned group), which
    # relies on materialize-by-pk / sink dedupe to reconcile.
    incremental_refresh: bool = True

    @classmethod
    def from_env(cls) -> "RobustnessConfig":
        import os
        cfg = cls()
        for f in fields(cls):
            var = "RW_" + f.name.upper()
            raw = os.environ.get(var)
            if raw is not None:
                kind = type(getattr(cfg, f.name))
                try:
                    if kind is bool:
                        low = raw.strip().lower()
                        if low in ("t", "true", "1", "on", "yes"):
                            setattr(cfg, f.name, True)
                        elif low in ("f", "false", "0", "off", "no"):
                            setattr(cfg, f.name, False)
                        else:
                            raise ValueError
                    else:
                        setattr(cfg, f.name, kind(raw))
                except ValueError:
                    raise ValueError(
                        f"bad {var}={raw!r}: expected {kind.__name__}"
                    ) from None
        return cfg


# process-global instance (env-seeded once; workers re-derive from the
# env they inherit at spawn)
ROBUSTNESS = RobustnessConfig.from_env()


@dataclass
class NodeConfig:
    """Per-process startup configuration (the `risingwave.toml` analog).

    Load with `NodeConfig.from_toml(path)`; unknown keys are rejected so
    typos fail at startup, like the reference's serde deny_unknown_fields.
    """
    streaming: StreamingConfig = field(default_factory=StreamingConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    device: Optional[DeviceConfig] = None

    @classmethod
    def from_toml(cls, path: str) -> "NodeConfig":
        try:
            import tomllib             # stdlib since 3.11
        except ModuleNotFoundError:
            import tomli as tomllib    # same API on 3.10
        with open(path, "rb") as f:
            raw = tomllib.load(f)
        cfg = cls()
        for section, target in (("streaming", cfg.streaming),
                                ("storage", cfg.storage)):
            known = {f.name for f in fields(target)}
            for k, v in raw.pop(section, {}).items():
                if k not in known:
                    raise ValueError(
                        f"unknown config key [{section}] {k!r}")
                setattr(target, k, v)
        dev = raw.pop("device", None)
        if dev is not None:
            mode = dev.pop("mode", "off")
            for k in dev:
                if k not in ("capacity", "minmax", "fuse", "mesh_shards",
                             "replicas",
                             "mv_persist_every", "predictive_growth",
                             "hbm_budget_mb", "compile_cache_dir",
                             "profile", "aot_compile", "compile_buckets"):
                    raise ValueError(f"unknown config key [device] {k!r}")
            base = resolve_device(
                int(mode) if isinstance(mode, str) and mode.isdigit()
                else mode)
            if base is not None:
                for k, v in dev.items():
                    setattr(base, k, v)
            cfg.device = base
        if raw:
            raise ValueError(f"unknown config sections {sorted(raw)!r}")
        return cfg


class SystemParams:
    """Cluster parameters alterable via ALTER SYSTEM SET
    (`system_param/mod.rs:97`). Each entry: default + coercion; mutation
    goes through `set` so the runtime can react (e.g. checkpoint
    frequency applies to the running barrier injector)."""

    DEFAULTS: Dict[str, Any] = {
        "checkpoint_frequency": 1,
        "barrier_interval_ms": 1000,
        "pause_on_next_bootstrap": False,
    }

    def __init__(self) -> None:
        self.values: Dict[str, Any] = dict(self.DEFAULTS)

    def get(self, name: str) -> Any:
        if name not in self.values:
            raise ValueError(f"unknown system parameter {name!r}")
        return self.values[name]

    # per-parameter validation: stored and effective values must agree
    _MIN = {"checkpoint_frequency": 1, "barrier_interval_ms": 1}

    def set(self, name: str, value: Any) -> Any:
        if name not in self.DEFAULTS:
            raise ValueError(f"unknown system parameter {name!r}")
        want = type(self.DEFAULTS[name])
        if want is bool and isinstance(value, str):
            value = value.strip().lower() in ("t", "true", "1", "on")
        else:
            value = want(value)
        lo = self._MIN.get(name)
        if lo is not None and value < lo:
            raise ValueError(f"system parameter {name} must be >= {lo}")
        self.values[name] = value
        return value


# session variables: name -> default. The subset the runtime honors;
# unknown SET names are rejected like PG's "unrecognized configuration
# parameter". Values coerce to the default's type on SET.
SESSION_VAR_DEFAULTS: Dict[str, Any] = {
    "timezone": "UTC",
    "query_mode": "auto",
    "streaming_parallelism": 0,        # 0 = use the device config default
    # 'local' = parallel fragments as in-process generators (topology
    # only); 'process' = worker OS processes over the credit-flow exchange
    # (real CPU parallelism — the compute-node placement analog)
    "streaming_placement": "local",
    # true + process placement: a FragmentSupervisor respawns a single
    # dead worker in place (shadow re-seed / epoch replay) instead of
    # tearing the whole job down; bounded attempts, then the classic
    # RemoteWorkerDied full-recovery path (graceful degradation)
    "streaming_supervision": False,
    # true: plan eligible inner joins as arrangement-sharing lookup/delta
    # joins (ops/lookup_join.py) instead of private-state hash joins —
    # the reference's streaming_enable_delta_join session variable
    "streaming_enable_delta_join": False,
    "application_name": "",
    "extra_float_digits": 1,
}


def default_session_vars() -> Dict[str, Any]:
    return dict(SESSION_VAR_DEFAULTS)


def resolve_device(device) -> Optional[DeviceConfig]:
    """Normalize the Database(device=...) argument.

    None | "off"      -> host-only execution
    "on" | "single"   -> device path on one card
    int n             -> device path sharded over an n-shard mesh (the
                         port's `make_mesh(n)`: the shards dealt over
                         every visible card from `cuda:0`, all on
                         `cuda:0` on a host with one; raises with no GPU)
    DeviceConfig      -> as given

    The JAX package also points its persistent compile cache at
    `compile_cache_dir` here; the port has no such cache.
    """
    if device is None or device == "off":
        return None
    if isinstance(device, DeviceConfig):
        cfg = device
    elif device in ("on", "single"):
        cfg = DeviceConfig()
    elif isinstance(device, int):
        from .parallel.mesh import make_mesh
        cfg = DeviceConfig(mesh=make_mesh(device))
    else:
        raise ValueError(f"bad device config {device!r}")
    return cfg
