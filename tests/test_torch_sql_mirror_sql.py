"""The JAX package's SQL front-end tests (`tests/test_sql.py`, and the
cases of `tests/test_config.py` that build a `Database`) run against the
port through the mirror harness (`sql_mirror.py`): each reference case
is one test here, its `Database` a `MirrorDatabase` that holds the port's
`Database` (on the CPU) to the reference's call by call; the cases that
build no `Database` run against the port directly."""
import pytest

from sql_mirror import cases, run_case

CASES = (cases("test_sql.py")
         + cases("test_config.py",
                 only={"test_database_accepts_config_file",
                       "test_session_vars_set_show",
                       "test_alter_system_applies_and_persists",
                       "test_set_accepts_exponent_literal",
                       "test_ctor_overrides_config_file"}))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch)
