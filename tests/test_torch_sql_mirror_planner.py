"""The JAX package's planner, optimizer and batch-engine tests
(`tests/test_planner_wiring.py`, `tests/test_optimizer.py`,
`tests/test_batch.py`) run against the port through the mirror harness
(`sql_mirror.py`): each reference case is one test here, its `Database`
a `MirrorDatabase` that holds the port's `Database` (on the CPU) to the
reference's call by call; the cases that build no `Database` run against
the port directly."""
import pytest

from sql_mirror import cases, run_case

CASES = (cases("test_planner_wiring.py") + cases("test_optimizer.py")
         + cases("test_batch.py"))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch)
