"""The JAX package's fused-SQL tests (`tests/test_fused_sql.py`) and
capacity-lifecycle tests (`tests/test_capacity_lifecycle.py`) run against
the port through the mirror harness (`sql_mirror.py`) with fusion kept: both
`Database`s lower the MV through `try_fuse`, and the mirror holds the
port's answers, catalog and fused-job state (counters, replays,
recoveries, node classes, capacities, stats totals) to the reference's
after every call — the restarts over committed fused state included. The
cases that run `risectl` run both packages' (`sql_mirror.ctl_twin`), each
against its own data directory, and their outputs must be equal."""
import pytest

from sql_mirror import cases, marks_of, run_case


def _keep(ref_file):
    def keep(cid):
        qual = cid.split("::", 1)[1].split("[")[0].split("@")[0]
        return "slow" not in marks_of(ref_file, qual)
    return keep


CASES = (cases("test_fused_sql.py",
               keep=_keep("test_fused_sql.py"))
         + cases("test_capacity_lifecycle.py",
                 keep=_keep("test_capacity_lifecycle.py")))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch, capsys):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, fuse=True,
             capsys=capsys)
