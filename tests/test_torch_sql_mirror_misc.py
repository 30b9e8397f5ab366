"""The JAX package's metrics-registry tests (`tests/test_metrics.py`) and
review-fix regressions (`tests/test_advice_fixes.py`) run against the
port through the mirror harness (`sql_mirror.py`): each reference case
is one test here, its `Database` a `MirrorDatabase` that holds the
port's `Database` (on the CPU) to the reference's call by call; the
cases that build no `Database` run against the port directly (the three
cases of the socket exchange, `runtime/exchange_net`, among them). Not
run here: the one that drives the JAX package's `DeviceHashAgg` engine
with `jax.numpy` arrays (the port's engine is held by
`tests/test_torch_agg_exec_step.py`)."""
import pytest

from sql_mirror import cases, run_case

NOT_PORTED = {"test_device_agg_key_at_sentinel_not_lost"}
CASES = cases("test_metrics.py") + cases("test_advice_fixes.py",
                                         skip=NOT_PORTED)


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch)
