"""The port's sqllogictest runner (`risingwave_tpu_torch/testing/slt.py`)
over the JAX package's `tests/test_slt_e2e.py`: the four `.slt` files of
`e2e_test/` with the device path off and on, and the parity oracle (every
MV equals a batch recompute of its query over generated Nexmark bids).

Each case runs twice, through the mirror harness (`sql_mirror.py`) with
the device argument kept as the reference test gives it ("on" is the
default `DeviceConfig`: eligible MVs fuse):
- "mirror": the reference's runner drives a `MirrorDatabase`, which holds
  the port's `Database` (on the CPU) to the reference's statement by
  statement: equal results, exceptions and catalogs (exact);
- "port": every import of the JAX package is the port's, so the port's
  runner drives the port's `Database` alone and every record's expected
  rows must come out of it (the runner's own comparison: canonical
  strings, floats to 3 decimals, as sqllogictest)."""
import os

import pytest

from sql_mirror import cases, run_case

# ids name each .slt file relative to the repository
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
CASES = [pytest.param(c[:4] + (mode,),
                      id=f"{c[0].replace(ROOT, '')}@{mode}")
         for c in cases("test_slt_e2e.py") for mode in ("mirror", "port")]


@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, tmp_path, monkeypatch):
    _cid, ref_file, qual, kw, mode = case
    run_case(ref_file, qual, kw, mode, tmp_path, monkeypatch, fuse=True)
