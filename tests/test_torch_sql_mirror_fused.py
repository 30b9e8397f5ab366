"""The JAX package's fused-SQL tests (`tests/test_fused_sql.py`) and
capacity-lifecycle tests (`tests/test_capacity_lifecycle.py`) run against
the port through the mirror harness (`sql_mirror.py`) with fusion kept as
each test asks for it: both `Database`s lower the MV through `try_fuse`,
and the mirror holds the port's answers, catalog and fused-job state
(counters, replays, node classes, capacities, stats totals) to the
reference's after every call. Left out, with the ROADMAP queue 1 item that
owns each: the cases that restart over committed fused state (item 3,
recovery), and the one that reads the `ctl` command line (item 8,
`ctl/` not ported)."""
import pytest

from sql_mirror import cases, marks_of, run_case

ITEM3 = {"test_fused_recovery_replays_to_committed",
         "test_recovery_presizes_from_high_water",
         "test_ctl_fused_stats"}
ITEM8 = {"test_ctl_fused_stats_no_jobs"}


def _keep(ref_file):
    def keep(cid):
        qual = cid.split("::", 1)[1].split("[")[0].split("@")[0]
        return not (marks_of(ref_file, qual) & {"mesh", "slow"})
    return keep


CASES = (cases("test_fused_sql.py", skip=ITEM3,
               keep=_keep("test_fused_sql.py"))
         + cases("test_capacity_lifecycle.py", skip=ITEM3 | ITEM8,
                 keep=_keep("test_capacity_lifecycle.py")))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, fuse=True)
