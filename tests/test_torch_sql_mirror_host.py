"""The JAX package's host SQL tests of append-only plans, approximate
percentiles, as-of and lookup joins, window frames and rescaling
(`tests/test_append_only.py`, `test_approx_percentile.py`,
`test_asof_join.py`, `test_lookup_join.py`,
`test_over_window_frames.py`, `test_rescale_sql.py`) run against the
port through the mirror harness (`sql_mirror.py`): each reference case
is one test here, its `Database` a `MirrorDatabase` that holds the
port's `Database` (on the CPU) to the reference's call by call; the
cases that build no `Database` run against the port directly."""
import pytest

from sql_mirror import cases, run_case

CASES = [c for f in ("test_append_only.py", "test_approx_percentile.py",
                      "test_asof_join.py", "test_lookup_join.py",
                      "test_over_window_frames.py", "test_rescale_sql.py")
         for c in cases(f)]


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch)
