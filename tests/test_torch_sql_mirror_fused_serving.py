"""The single-device fused cases of the JAX package's serving-tier tests
(`tests/test_serving.py`) run against the port through the mirror harness
(`sql_mirror.py`) with fusion kept: the epoch-versioned read cache, its
single-flight fill through `FusedJob.mv_rows_versioned`, the staleness
bound and the SELECT gate over SQL-created fused jobs are held to the
reference's call by call. Left out, with the ROADMAP queue 1 item that owns
each: in-place recovery and restart over committed fused state (item 3);
the replica mesh and the rebalance policy switch (items 8 and 5) are
`mesh`-marked and run in neither."""
import pytest

from sql_mirror import cases, marks_of, run_case

ITEM3 = {"test_serving_cache_across_inplace_recovery",
         "test_coordinator_restart_cache_rebuilds_cold"}


def _keep(cid):
    # the fused cases: those that build a Database (no "@port" suffix)
    qual = cid.split("::", 1)[1].split("[")[0].split("@")[0]
    return not cid.endswith("@port") and not (
        marks_of("test_serving.py", qual) & {"mesh", "slow"})


CASES = cases("test_serving.py", skip=ITEM3, keep=_keep)


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, fuse=True)
