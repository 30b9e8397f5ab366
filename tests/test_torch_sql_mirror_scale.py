"""The JAX package's Nexmark scale tests (`tests/test_nexmark_scale.py`:
q4's agg, q7's window max and the full q5 over generated bids, host and
device paths against numpy oracles) run against the port through the
mirror harness (`sql_mirror.py`), the device policy "on" as
`DeviceConfig(fuse=False)` in both packages; each reference case is one
test here."""
import pytest

from sql_mirror import cases, run_case

CASES = cases("test_nexmark_scale.py")


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch)
