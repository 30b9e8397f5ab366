"""The single-device fused cases of the JAX package's flow-telemetry,
skew-defense, host-ingest and state-tiering tests
(`tests/test_flow_telemetry.py`, `tests/test_skew_ops.py`,
`tests/test_ingest.py`, `tests/test_tiering.py`) run against the port
through the mirror harness (`sql_mirror.py`) with fusion kept: traffic and
occupancy histograms, heavy hitters, pre-combine and the telemetry arms of
SQL-created fused jobs; host-fed jobs with their admission buckets
(throttled, deferred, stretched); the tiered jobs' demotions and
promotions; and their in-place and restart recoveries (the flight
recorder's dump included) are held to the reference's call by call.

The case that runs `risectl tiering` runs both packages' command, each
against its own data directory (`sql_mirror.ctl_twin`).

Left out: the mesh-marked cases, which run against the reference's own
8-shard runs in `test_torch_sql_mirror_mesh_fused.py` (under
`torch_ref_mesh.ref_mesh()`), and the compile-count cases, which count
the JAX package's background compile service: the port has no compile
service (its kernels are built once per process and nothing is traced
per shape)."""
import pytest

from sql_mirror import cases, marks_of, run_case

FLOW = {"test_traffic_histogram_exact_unique_keys",
        "test_traffic_exact_through_precombine",
        "test_traffic_divergence_zipf_flow_over_spread_state",
        "test_flow_unarmed_no_slots_no_sig_flag",
        "test_served_staleness_reported_for_cache_lagged_selects",
        "test_rw_serving_pulls_and_replica_metric",
        # the in-place recovery's flight-recorder dump
        "test_blackbox_auto_dump_and_offline_read"}
SKEW = {"test_precombine_bit_identity_and_noop_path",
        "test_precombine_skipped_for_exact_minmax"}
# host-fed fused jobs: admission buckets, the staged-window replay, the
# in-place and restart recoveries
INGEST = {"test_q1_host_fed_bit_identity", "test_q1_per_source_opt_in",
          "test_q3_multi_source_multiplex", "test_q5_host_fed_bit_identity",
          "test_double_buffer_overlap_and_phases",
          "test_admission_throttle_defer_exact",
          "test_staged_window_inplace_recovery",
          "test_growth_replay_from_retained_windows", "test_restart_recovery",
          "test_mixed_opt_in_promotes_whole_job"}
# every fused case of test_tiering.py runs host-fed (RW_HOST_INGEST=1)
TIERING = {"test_agg_demotion_bit_identity_and_no_growth",
           "test_join_demotion_bit_identity_and_growth_replay",
           "test_restart_recovery_rebuilds_both_tiers",
           "test_inplace_recovery_failpoint_rebuilds_both_tiers",
           "test_heavy_hitters_never_demoted",
           "test_ctl_tiering_report"}
# compile counts of the reference's compile service (none in the port)
NO_COMPILE_SERVICE = {"test_zero_fresh_compiles_across_batch_sizes",
                      "test_demotion_promotion_zero_fresh_compile"}


def _single_device(ref_file):
    def keep(cid):
        qual = cid.split("::", 1)[1].split("[")[0].split("@")[0]
        # the mesh cases are test_torch_sql_mirror_mesh_fused.py's
        return not (marks_of(ref_file, qual) & {"mesh", "aot", "slow"})
    return keep


CASES = (cases("test_flow_telemetry.py", only=FLOW)
         + cases("test_skew_ops.py", only=SKEW)
         + cases("test_ingest.py", only=INGEST, skip=NO_COMPILE_SERVICE,
                 keep=_single_device("test_ingest.py"))
         + cases("test_tiering.py", only=TIERING, skip=NO_COMPILE_SERVICE,
                 keep=_single_device("test_tiering.py")))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch, capsys):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, fuse=True,
             capsys=capsys)
