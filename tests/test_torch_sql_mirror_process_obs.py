"""The process-placement cases of the JAX package's observability,
telemetry, fault-tolerance and overload tests run against the port
through the mirror harness (`sql_mirror.py`): the cluster metrics plane
(worker registry deltas merged under a `worker` label, the
`worker_liveness` gauge, `rw_worker_liveness`), the wedged-worker
heartbeat age, the worker-side heartbeat timer, freshness across an
in-place respawn, the backpressured-but-healthy liveness rule, the slow
worker's credit-stall attribution and ladder, poison-pill quarantine
into `rw_dead_letter` with `risectl dlq` and the requeue, simultaneous
worker deaths in one set and across a join set and its agg set, and the
sink journal across a coordinator restart. The cases that drive worker
processes run in "port" mode (`PORT_MODE`): every `risingwave_tpu` import
gives the port's module, so the case's own asserts hold the port alone —
they kill, stop or slow the port's workers and read its registry, which a
mirror case (walking the reference's plan, reading the reference's
registry) could not reach. The library cases (the heartbeat timer, the
liveness rule, the remote-label lint, the failpoint listing) build no
`Database` and run in port mode too; the dead-letter requeue's refusals
run in mirror mode with fusion kept (`FUSED`). Every worker a case spawns
is killed, and the pressure boards cleared, when it ends
(`process_case`).

Not here: these files' cases that place nothing in worker processes,
each named in `LEFT_OUT` with its reason (`test_every_case_is_run_or_
named` keeps the list whole)."""
import pytest

from sql_mirror import cases, process_case, run_case

OBS = {"test_metrics_plane_cluster_expose",
       "test_wedged_worker_detected_by_heartbeat_age",
       "test_heartbeat_timer_fires_during_quiet_window",
       "test_heartbeat_timer_suppressed_by_traffic",
       "test_heartbeat_timer_default_period_tracks_timeout"}
OBS2 = {"test_freshness_monotonic_across_respawn",
        "test_backpressured_worker_not_wedged",
        "test_lint_flags_remote_label_divergence"}
FLOW = {"test_attribution_sums_to_global_slow_worker"}
FT3 = {"test_poison_chunk_quarantined_job_progresses",
       "test_poison_threshold_zero_disables_quarantine",
       "test_two_simultaneous_join_worker_kills_converge",
       "test_simultaneous_agg_and_join_worker_kills_converge",
       "test_sink_mirror_journal_survives_coordinator_restart",
       "test_risectl_lists_fused_and_poison_failpoints"}
OVERLOAD = {"test_slow_worker_backpressure_closes_the_loop",
            "test_dlq_requeue_against_fused_job_fails_with_clear_error"}
FUSED = {"test_dlq_requeue_against_fused_job_fails_with_clear_error"}
PORT_MODE = (OBS | OBS2 | FLOW | FT3 | OVERLOAD) - FUSED

# reason -> the cases of these five files that run elsewhere or not at all
LEFT_OUT = {
    "fused, in test_torch_sql_mirror_fused_obs.py": {
        "test_epoch_profile_rows_and_phase_sums",
        "test_fused_node_stats_table",
        "test_profile_off_keeps_surfaces_empty",
        "test_explain_analyze_q5_agrees_with_node_stats",
        "test_fused_freshness_rows",
        "test_rw_key_skew_consistent_with_node_stats",
        "test_skew_stats_env_kill_switch",
        "test_skew_stats_off_removes_slots_and_changes_nothing_else"},
    "fused, in test_torch_sql_mirror_fused_skew.py": {
        "test_blackbox_auto_dump_and_offline_read",
        "test_flow_unarmed_no_slots_no_sig_flag",
        "test_rw_serving_pulls_and_replica_metric",
        "test_served_staleness_reported_for_cache_lagged_selects",
        "test_traffic_divergence_zipf_flow_over_spread_state",
        "test_traffic_exact_through_precombine",
        "test_traffic_histogram_exact_unique_keys"},
    "fused, in test_torch_sql_mirror_recovery.py": {
        "test_fused_device_fault_recovers_in_place_bit_identical",
        "test_fused_growth_replay_fault_recovers",
        "test_fused_recovery_attempts_bound_escalates",
        "test_burst_under_pressure_is_bit_identical_with_shed_off",
        "test_epoch_log_spills_and_reloads",
        "test_mv_rows_now_recovers_from_select_path_device_fault"},
    "counts the JAX package's compile service (none in the port)": {
        "test_fused_recovery_is_zero_compile",
        "test_fused_cadence_stretch_zero_compile_bounded_log_and_recovery"},
    "no worker process: the trace, profile, export, telemetry and "
    "overload planes of one process, not this runtime's": {
        "test_profile_file_and_risectl", "test_rotate_tail_is_line_exact",
        "test_trace_stuck_only", "test_tracer_emit_rotates",
        "test_chrome_export_valid_and_monotonic", "test_clock_offset_empty",
        "test_clock_offset_negative_skew_and_bounds",
        "test_clock_offset_recovers_known_skew", "test_ctl_trace_export_cli",
        "test_datagen_freshness_within_tick_of_ground_truth",
        "test_explain_analyze_host_tree_and_rejections",
        "test_explain_analyze_parses",
        "test_freshness_anchors_on_checkpoint_window_oldest",
        "test_profiler_flush_is_single_writer",
        "test_tail_jsonl_survives_rotation",
        "test_attribution_sums_to_global_slow_sink",
        "test_blackbox_ring_byte_bound_and_rate_limit",
        "test_combine_contributions_math", "test_dead_telemetry_lint",
        "test_pressure_board_by_kind_windows", "test_profile_schema_dispatch",
        "test_traffic_ewma_burst_vs_sustained",
        "test_traffic_sums_shard_invariant",
        "test_fused_fault_lands_in_ledger",
        "test_admission_bucket_defers_then_sheds_only_on_shed_rung",
        "test_ladder_escalates_holds_and_recovers_with_hysteresis",
        "test_pgwire_select_admission_rejects_with_sqlstate_53000",
        "test_real_sink_delivery_failure_isolates_instead_of_crashing",
        "test_shedding_sheds_audited_windows_and_recovers",
        "test_slow_sink_escalates_throttles_and_recovers"},
}
FILES = {"test_observability.py": OBS, "test_observability2.py": OBS2,
         "test_flow_telemetry.py": FLOW, "test_ft3.py": FT3,
         "test_overload.py": OVERLOAD}

CASES = [c for ref_file, only in FILES.items()
         for c in cases(ref_file, only=only, port=PORT_MODE)]


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch, capsys):
    _cid, ref_file, qual, kw, mode = case
    with process_case():
        run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch,
                 fuse=qual in FUSED, capsys=capsys, twins=True)


def test_every_case_is_run_or_named():
    """Every case of the five files runs here or is named in
    `LEFT_OUT`, and none is both."""
    named = set().union(*LEFT_OUT.values())
    for ref_file, only in FILES.items():
        quals = {c[2].split(".")[-1] for c in cases(ref_file)}
        assert quals - only - named == set(), ref_file
    assert not named & set().union(*FILES.values())
