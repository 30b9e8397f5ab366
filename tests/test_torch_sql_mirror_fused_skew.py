"""The single-device fused cases of the JAX package's flow-telemetry,
skew-defense, host-ingest and state-tiering tests
(`tests/test_flow_telemetry.py`, `tests/test_skew_ops.py`,
`tests/test_ingest.py`, `tests/test_tiering.py`) run against the port
through the mirror harness (`sql_mirror.py`) with fusion kept: traffic and
occupancy histograms, heavy hitters, pre-combine and the telemetry arms of
SQL-created fused jobs are held to the reference's call by call.

Left out, with the ROADMAP queue 1 item that owns each (the mesh-marked
cases are item 5's and run in neither): every single-device fused case of
`test_ingest.py` and `test_tiering.py` creates a host-fed job, whose
per-source admission buckets are item 3 — the port refuses such a CREATE
— and so do the in-place and restart recoveries (item 3)."""
import pytest

from sql_mirror import cases, run_case

FLOW = {"test_traffic_histogram_exact_unique_keys",
        "test_traffic_exact_through_precombine",
        "test_traffic_divergence_zipf_flow_over_spread_state",
        "test_flow_unarmed_no_slots_no_sig_flag",
        "test_served_staleness_reported_for_cache_lagged_selects",
        "test_rw_serving_pulls_and_replica_metric"}
SKEW = {"test_precombine_bit_identity_and_noop_path",
        "test_precombine_skipped_for_exact_minmax"}
ITEM3 = {
    # test_flow_telemetry.py: the in-place recovery's flight-recorder dump
    "test_blackbox_auto_dump_and_offline_read",
    # test_ingest.py: host-fed fused jobs (admission buckets), and the
    # in-place / restart recoveries
    "test_q1_host_fed_bit_identity", "test_q1_per_source_opt_in",
    "test_q3_multi_source_multiplex", "test_q5_host_fed_bit_identity",
    "test_double_buffer_overlap_and_phases",
    "test_admission_throttle_defer_exact",
    "test_zero_fresh_compiles_across_batch_sizes",
    "test_staged_window_inplace_recovery",
    "test_growth_replay_from_retained_windows", "test_restart_recovery",
    "test_mixed_opt_in_promotes_whole_job",
    # test_tiering.py: every fused case runs host-fed (RW_HOST_INGEST=1)
    "test_agg_demotion_bit_identity_and_no_growth",
    "test_join_demotion_bit_identity_and_growth_replay",
    "test_restart_recovery_rebuilds_both_tiers",
    "test_inplace_recovery_failpoint_rebuilds_both_tiers",
    "test_heavy_hitters_never_demoted",
    "test_demotion_promotion_zero_fresh_compile",
    "test_ctl_tiering_report"}

CASES = (cases("test_flow_telemetry.py", only=FLOW)
         + cases("test_skew_ops.py", only=SKEW))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, fuse=True)
