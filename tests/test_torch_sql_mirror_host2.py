"""The JAX package's host SQL tests of table functions and temporal joins,
watermarks, state filters and backups, and the barrier trace
(`tests/test_project_set_temporal.py`, `test_union_watermark.py`,
`test_watermark_cleaning.py`, `test_state_filter.py`,
`test_barrier_trace.py`; the trace's elapsed-ms column is a wall-clock
reading in each package and is compared by type only) run against the
port through the mirror harness (`sql_mirror.py`): each reference case
is one test here, its `Database` a `MirrorDatabase` that holds the
port's `Database` (on the CPU) to the reference's call by call; the
cases that build no `Database` run against the port directly."""
import pytest

from sql_mirror import cases, run_case

CASES = [c for f in ("test_project_set_temporal.py", "test_union_watermark.py",
                      "test_watermark_cleaning.py", "test_state_filter.py",
                      "test_barrier_trace.py")
         for c in cases(f)]


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch)
