"""The 8-shard arms of the JAX package's SQL -> device seam tests
(`tests/test_device_seam.py`, `tests/test_device_join_netting.py`), run
against the port through the mirror harness (`sql_mirror.py`): the
reference's `DeviceConfig(fuse=False)` over its 8-device CPU mesh beside
the port's over `make_mesh(8, devices=[cpu])`, each reference case one
test here."""
import pytest

from sql_mirror import cases, run_case


def _mesh(cid):
    return "[8" in cid or "sharded" in cid


CASES = (cases("test_device_seam.py", keep=_mesh)
         + cases("test_device_join_netting.py", keep=_mesh))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch)
