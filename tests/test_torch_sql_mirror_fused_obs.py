"""The fused cases of the JAX package's observability tests
(`tests/test_observability.py`, `tests/test_observability2.py`) run
against the port through the mirror harness (`sql_mirror.py`) with fusion
kept: `rw_epoch_profile`, `rw_fused_node_stats`, `rw_key_skew`,
`rw_mv_freshness` and `EXPLAIN ANALYZE` of SQL-created fused jobs are held
to the reference's call by call (wall-clock fields masked), and so is each
fused job's state."""
import pytest

from sql_mirror import cases, run_case

OBS2 = {"test_explain_analyze_q5_agrees_with_node_stats",
        "test_fused_freshness_rows",
        "test_rw_key_skew_consistent_with_node_stats",
        "test_skew_stats_off_removes_slots_and_changes_nothing_else",
        "test_skew_stats_env_kill_switch"}
OBS = {"test_epoch_profile_rows_and_phase_sums",
       "test_fused_node_stats_table",
       "test_profile_off_keeps_surfaces_empty"}

CASES = (cases("test_observability2.py", only=OBS2)
         + cases("test_observability.py", only=OBS))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, fuse=True)
