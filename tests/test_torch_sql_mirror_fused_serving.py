"""The single-device fused cases of the JAX package's serving-tier tests
(`tests/test_serving.py`) run against the port through the mirror harness
(`sql_mirror.py`) with fusion kept: the epoch-versioned read cache, its
single-flight fill through `FusedJob.mv_rows_versioned`, the staleness
bound and the SELECT gate over SQL-created fused jobs, across an in-place
recovery at each `fused.*` failpoint and a restart over committed fused
state, are held to the reference's call by call. The replica mesh and the
rebalance policy switch are `mesh`-marked: they run against the
reference's own mesh runs in `test_torch_sql_mirror_mesh_skew.py`."""
import pytest

from sql_mirror import cases, marks_of, run_case


def _keep(cid):
    # the fused cases: those that build a Database (no "@port" suffix)
    qual = cid.split("::", 1)[1].split("[")[0].split("@")[0]
    return not cid.endswith("@port") and not (
        marks_of("test_serving.py", qual) & {"mesh", "slow"})


CASES = cases("test_serving.py", keep=_keep)


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, fuse=True)
