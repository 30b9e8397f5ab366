"""The port's Arrow seam (`risingwave_tpu_torch/core/arrow.py`) against
the JAX package's: the reference's cases (`tests/test_arrow.py`) fed to
both packages — column / chunk round trips, the shared value buffer —
and the device seam, `to_torch` / `to_torch_masked` (the reference's
`to_jax` / `to_jax_masked`), value for value."""
from decimal import Decimal
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")

import jax.numpy as jnp

import risingwave_tpu.core.arrow as JA
import risingwave_tpu.core.chunk as JCH
import risingwave_tpu.core.dtypes as JT
import risingwave_tpu_torch.core.arrow as PA
import risingwave_tpu_torch.core.chunk as PCH
import risingwave_tpu_torch.core.dtypes as PT

PKGS = {"ref": SimpleNamespace(A=JA, C=JCH, T=JT),
        "port": SimpleNamespace(A=PA, C=PCH, T=PT)}


@pytest.fixture(params=["ref", "port"])
def pk(request):
    return PKGS[request.param]


def roundtrip(pk, dtype, items):
    col = pk.C.Column.from_list(dtype, items)
    arr = pk.A.column_to_arrow(col)
    back = pk.A.column_from_arrow(arr, dtype)
    assert [back.get(i) for i in range(len(back))] == \
        [col.get(i) for i in range(len(col))]
    return arr


class TestColumnRoundtrip:
    def test_fixed_width(self, pk):
        T = pk.T
        roundtrip(pk, T.INT64, [1, None, -5, 2**62])
        roundtrip(pk, T.INT32, [1, 2, None])
        roundtrip(pk, T.FLOAT64, [1.5, None, -0.25])
        roundtrip(pk, T.BOOLEAN, [True, False, None])

    def test_temporal(self, pk):
        arr = roundtrip(pk, pk.T.TIMESTAMP, [1704067200000000, None])
        assert pa.types.is_timestamp(arr.type)
        arr = roundtrip(pk, pk.T.DATE, [19723, None])
        assert pa.types.is_date32(arr.type)

    def test_strings_and_bytes(self, pk):
        roundtrip(pk, pk.T.VARCHAR, ["a", None, "日本", ""])
        roundtrip(pk, pk.T.BYTEA, [b"\x00\x01", None])

    def test_decimal(self, pk):
        arr = roundtrip(pk, pk.T.DECIMAL, [Decimal("1.5"), None,
                                           Decimal("-7")])
        assert pa.types.is_decimal(arr.type)

    def test_interval(self, pk):
        roundtrip(pk, pk.T.INTERVAL, [pk.T.Interval(1, 2, 3_000_000), None])


class TestZeroCopy:
    def test_int64_value_buffer_is_shared(self, pk):
        vals = np.arange(1024, dtype=np.int64)
        col = pk.C.Column(pk.T.INT64, vals, np.ones(1024, bool))
        arr = pk.A.column_to_arrow(col)
        assert arr.buffers()[1].address == vals.ctypes.data
        back = pk.A.column_from_arrow(arr, pk.T.INT64)
        assert back.values.ctypes.data == vals.ctypes.data


class TestChunks:
    def test_datachunk_roundtrip(self, pk):
        dts = [pk.T.INT64, pk.T.VARCHAR]
        ch = pk.C.DataChunk.from_rows(dts, [(1, "a"), (2, None),
                                            (None, "c")])
        batch = pk.A.datachunk_to_arrow(ch, names=["k", "s"])
        assert batch.schema.names == ["k", "s"]
        back = pk.A.datachunk_from_arrow(batch, dts)
        assert [tuple(back.columns[j].get(i) for j in range(2))
                for i in range(3)] == [(1, "a"), (2, None), (None, "c")]

    def test_streamchunk_roundtrip_preserves_ops(self, pk):
        Op = pk.C.Op
        dts = [pk.T.INT64, pk.T.INT64]
        ch = pk.C.StreamChunk.from_rows(dts, [
            (Op.INSERT, (1, 10)), (Op.DELETE, (2, 20)),
            (Op.UPDATE_DELETE, (3, 30)), (Op.UPDATE_INSERT, (3, 31))])
        back = pk.A.streamchunk_from_arrow(pk.A.streamchunk_to_arrow(ch),
                                           dts)
        assert list(back.ops) == list(ch.ops)
        assert back.columns[1].get(3) == 31


def test_same_arrow_arrays():
    """Both packages write the same Arrow arrays for every type."""
    cases = [("INT64", [1, None, -5]), ("INT16", [3, None]),
             ("FLOAT32", [1.5, None]), ("BOOLEAN", [True, None, False]),
             ("TIMESTAMP", [1704067200000000, None]), ("DATE", [19723]),
             ("TIME", [5, None]), ("VARCHAR", ["a", None, ""]),
             ("DECIMAL", [Decimal("2.5"), None])]
    for kind, items in cases:
        j = JA.column_to_arrow(JCH.Column.from_list(getattr(JT, kind), items))
        p = PA.column_to_arrow(PCH.Column.from_list(getattr(PT, kind), items))
        assert p.type == j.type and p.equals(j), kind


def test_to_torch_device_seam():
    """to_torch is to_jax's counterpart: the same values, no NULLs
    accepted; to_torch_masked fills NULL slots with the sentinel and
    carries validity, as to_jax_masked does."""
    col = PCH.Column(PT.INT64, np.arange(16, dtype=np.int64),
                     np.ones(16, bool))
    x = PA.to_torch(col, device="cpu")
    assert isinstance(x, torch.Tensor) and int(x.sum()) == 120
    jcol = JCH.Column(JT.INT64, np.arange(16, dtype=np.int64),
                      np.ones(16, bool))
    assert np.array_equal(x.numpy(), np.asarray(JA.to_jax(jcol)))
    with pytest.raises(ValueError, match="NULL"):
        PA.to_torch(PCH.Column.from_list(PT.INT64, [1, None]), device="cpu")
    with pytest.raises(ValueError, match="no device representation"):
        PA.to_torch(PCH.Column.from_list(PT.VARCHAR, ["a"]), device="cpu")
    items = [1.5, None, -2.0, None]
    pv, pok = PA.to_torch_masked(PCH.Column.from_list(PT.FLOAT64, items),
                                 sentinel=-1.0, device="cpu")
    jv, jok = JA.to_jax_masked(JCH.Column.from_list(JT.FLOAT64, items),
                               sentinel=-1.0)
    assert np.array_equal(pv.numpy(), np.asarray(jv))
    assert np.array_equal(pok.numpy(), np.asarray(jok))
    assert pv.dtype == torch.float64 and pok.dtype == torch.bool


def test_arrow_imports_lazily():
    """The port's arrow module imports without pyarrow (the card host has
    none): only its functions load it."""
    import ast
    import pathlib
    src = pathlib.Path(PA.__file__).read_text()
    top = [n for n in ast.parse(src).body
           if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top for a in n.names] + \
        [n.module or "" for n in top if isinstance(n, ast.ImportFrom)]
    assert not any(nm.split(".")[0] == "pyarrow" for nm in names)
