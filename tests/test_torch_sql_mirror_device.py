"""The JAX package's SQL -> device seam tests (`tests/test_device_seam.py`,
`tests/test_device_join_netting.py`) on one device, run against the port
through the mirror harness (`sql_mirror.py`): the device policy "on" is
`DeviceConfig(fuse=False)` in both packages, and each reference case is
one test here, its `Database` a `MirrorDatabase` that holds the port's
`Database` (on the CPU) to the reference's call by call; the cases that
build no `Database` run against the port directly. The 8-shard arms are
in `test_torch_sql_mirror_mesh.py`."""
import pytest

from sql_mirror import cases, run_case


def _one_device(cid):
    return "[8" not in cid and "sharded" not in cid


CASES = (cases("test_device_seam.py", keep=_one_device)
         + cases("test_device_join_netting.py", keep=_one_device))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch)
