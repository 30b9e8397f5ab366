"""The port's `core/` (chunks, vnode hashing, epochs, encodings) against
the JAX package's: the reference's own cases (`tests/test_core.py`), fed
to both packages, then the two packages' hashes, vnodes and device
chunks compared value for value."""
import zlib
from decimal import Decimal
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import risingwave_tpu.core as JC
import risingwave_tpu.core.encoding as JEN
import risingwave_tpu.core.epoch as JEP
import risingwave_tpu.core.vnode as JV
import risingwave_tpu_torch.core as PC
import risingwave_tpu_torch.core.encoding as PEN
import risingwave_tpu_torch.core.epoch as PEP
import risingwave_tpu_torch.core.vnode as PV

PKGS = {
    "ref": SimpleNamespace(
        C=JC, T=JC.dtypes, EN=JEN, EP=JEP, V=JV,
        device_chunk=JC.to_device_chunk,
        dev_vnodes=lambda k: np.asarray(JV.compute_vnodes_jnp(k))),
    "port": SimpleNamespace(
        C=PC, T=PC.dtypes, EN=PEN, EP=PEP, V=PV,
        device_chunk=lambda ch: PC.to_device_chunk(ch, device="cpu"),
        dev_vnodes=lambda k: PV.compute_vnodes_dev(
            torch.from_numpy(k)).numpy()),
}


@pytest.fixture(params=["ref", "port"])
def pk(request):
    return PKGS[request.param]


class TestChunk:
    def test_column_nulls(self, pk):
        c = pk.C.Column.from_list(pk.T.INT64, [1, None, 3])
        assert c.to_list() == [1, None, 3]
        assert list(c.validity) == [True, False, True]

    def test_varchar_column(self, pk):
        c = pk.C.Column.from_list(pk.T.VARCHAR, ["a", None, "ccc"])
        assert c.to_list() == ["a", None, "ccc"]

    def test_datachunk_rows_visibility(self, pk):
        T = pk.T
        ch = pk.C.DataChunk.from_rows([T.INT64, T.VARCHAR],
                                      [(1, "a"), (2, "b"), (3, "c")])
        assert ch.cardinality == 3
        vis = ch.with_visibility(np.array([True, False, True]))
        assert vis.rows() == [(1, "a"), (3, "c")]
        assert vis.compact().cardinality == 2

    def test_stream_chunk_ops_signs(self, pk):
        Op = pk.C.Op
        ch = pk.C.StreamChunk.from_rows(
            [pk.T.INT64],
            [(Op.INSERT, (1,)), (Op.DELETE, (2,)),
             (Op.UPDATE_DELETE, (3,)), (Op.UPDATE_INSERT, (4,))])
        assert list(ch.signs()) == [1, -1, -1, 1]
        assert ch.op_rows()[1] == (Op.DELETE, (2,))

    def test_builder_update_pair_not_split(self, pk):
        Op = pk.C.Op
        b = pk.C.StreamChunkBuilder([pk.T.INT64], max_chunk_size=2)
        b.append_row(Op.INSERT, (1,))
        b.append_row(Op.UPDATE_DELETE, (2,))
        b.append_row(Op.UPDATE_INSERT, (3,))
        assert [c.capacity for c in b.drain()] == [3]

    def test_builder_no_row_loss_on_overflow(self, pk):
        b = pk.C.StreamChunkBuilder([pk.T.INT64], max_chunk_size=4)
        for i in range(10):
            b.append_row(pk.C.Op.INSERT, (i,))
        chunks = b.drain()
        assert sum(c.capacity for c in chunks) == 10
        assert [r[0] for c in chunks for _, r in c.op_rows()] == \
            list(range(10))
        assert b.drain() == []

    def test_device_chunk_padding(self, pk):
        Op = pk.C.Op
        ch = pk.C.StreamChunk.from_rows([pk.T.INT64, pk.T.VARCHAR],
                                        [(Op.INSERT, (7, "x")),
                                         (Op.DELETE, (8, "y"))])
        d = pk.device_chunk(ch)
        assert d.capacity == 16 and d.n_rows == 2
        assert d.cols[0].shape == (16,)
        assert list(np.asarray(d.mask))[:3] == [True, True, False]
        assert list(np.asarray(d.signs))[:3] == [1, -1, 0]


class TestVnode:
    def test_crc32_matrix_matches_zlib(self, pk):
        rows = np.frombuffer(b"hello123worldxyz", dtype=np.uint8).reshape(2, 8)
        out = pk.V.crc32_bytes_matrix(rows)
        assert out[0] == zlib.crc32(b"hello123")
        assert out[1] == zlib.crc32(b"worldxyz")

    def test_vectorized_matches_scalar_int(self, pk):
        vals = [0, 1, -5, 123456789, None]
        vn = pk.V.compute_vnodes([pk.C.Column.from_list(pk.T.INT64, vals)])
        for i, v in enumerate(vals):
            assert vn[i] == pk.V.vnode_of_row([v])

    def test_vectorized_matches_scalar_str(self, pk):
        vals = ["alpha", "beta", None]
        vn = pk.V.compute_vnodes([pk.C.Column.from_list(pk.T.VARCHAR, vals)])
        for i, v in enumerate(vals):
            assert vn[i] == pk.V.vnode_of_row([v])

    def test_multicolumn(self, pk):
        c1 = pk.C.Column.from_list(pk.T.INT64, [1, 2])
        c2 = pk.C.Column.from_list(pk.T.VARCHAR, ["a", "b"])
        vn = pk.V.compute_vnodes([c1, c2])
        assert vn[0] == pk.V.vnode_of_row([1, "a"])
        assert vn[1] == pk.V.vnode_of_row([2, "b"])

    def test_bool_float_parity(self, pk):
        cb = pk.C.Column.from_list(pk.T.BOOLEAN, [True, False])
        vnb = pk.V.compute_vnodes([cb])
        assert vnb[0] == pk.V.vnode_of_row([True])
        assert vnb[1] == pk.V.vnode_of_row([False])
        cf = pk.C.Column.from_list(pk.T.FLOAT64, [1.5, -0.0])
        vnf = pk.V.compute_vnodes([cf])
        assert vnf[0] == pk.V.vnode_of_row([1.5])
        assert vnf[1] == pk.V.vnode_of_row([0.0])

    def test_device_crc_matches_host(self, pk):
        keys = np.array([0, 42, -7, 999999], dtype=np.int64)
        host = pk.V.compute_vnodes([pk.C.Column.from_list(pk.T.INT64,
                                                          keys.tolist())])
        assert list(host) == list(pk.dev_vnodes(keys))

    def test_hash64_null_aware(self, pk):
        c1 = pk.C.Column.from_list(pk.T.INT64, [1, None])
        c2 = pk.C.Column.from_list(pk.T.INT64, [1, None])
        assert list(pk.V.column_hash64(c1)) == list(pk.V.column_hash64(c2))
        h = pk.V.hash_columns64([c1, pk.C.Column.from_list(pk.T.VARCHAR,
                                                           ["x", "y"])])
        assert len(h) == 2 and h[0] != h[1]


class TestEpoch:
    def test_epoch_roundtrip(self, pk):
        e = pk.EP.epoch_from_physical(1234567, 3)
        assert pk.EP.physical_time_ms(e) == 1234567
        assert e & 0xFFFF == 3

    def test_monotonic(self, pk):
        e1 = pk.C.now_epoch()
        assert pk.C.now_epoch(e1) > e1

    def test_pair(self, pk):
        p = pk.EP.EpochPair.new_initial(100 << 16)
        assert p.next(200 << 16).prev == p.curr


class TestEncoding:
    def test_memcomparable_int_order(self, pk):
        encs = [pk.EN.encode_datum_memcomparable(v, pk.T.INT64)
                for v in [-100, -1, 0, 1, 100, None]]
        assert encs == sorted(encs)

    def test_memcomparable_desc(self, pk):
        encs = {v: pk.EN.encode_datum_memcomparable(v, pk.T.INT32, desc=True)
                for v in [3, 1, 2]}
        assert encs[3] < encs[2] < encs[1]

    def test_memcomparable_float_order(self, pk):
        encs = [pk.EN.encode_datum_memcomparable(v, pk.T.FLOAT64)
                for v in [-1.5, -0.5, 0.0, 0.25, 2.0]]
        assert encs == sorted(encs)

    def test_memcomparable_string_prefix(self, pk):
        enc = pk.EN.encode_datum_memcomparable
        assert enc("ab", pk.T.VARCHAR) < enc("abc", pk.T.VARCHAR) \
            < enc("ac", pk.T.VARCHAR)

    def test_value_roundtrip(self, pk):
        T = pk.T
        dtypes = [T.INT64, T.VARCHAR, T.FLOAT64, T.BOOLEAN, T.DECIMAL,
                  T.TIMESTAMP]
        row = (42, "hello", 3.5, True, Decimal("1.25"), 1700000000000000)
        assert pk.EN.decode_row(pk.EN.encode_row(row, dtypes), dtypes) == row

    def test_value_roundtrip_nulls(self, pk):
        dtypes = [pk.T.INT64, pk.T.VARCHAR]
        assert pk.EN.decode_row(pk.EN.encode_row((None, None), dtypes),
                                dtypes) == (None, None)

    def test_sort_key_mixed(self, pk):
        dtypes = [pk.T.INT64, pk.T.VARCHAR]
        rows = [(1, "b"), (1, "a"), (0, "z"), (2, None)]
        ordered = sorted(rows, key=lambda r: pk.EN.SortKey(r, dtypes))
        assert ordered == [(0, "z"), (1, "a"), (1, "b"), (2, None)]


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------

KEY_COLS = [("INT64", [0, 1, -5, None, 2 ** 62, -(2 ** 63)]),
            ("INT32", [7, None, -1, 0, 3, 2 ** 31 - 1]),
            ("VARCHAR", ["alpha", None, "", "日本", "x" * 40, "b"]),
            ("BOOLEAN", [True, False, None, True, True, False]),
            ("FLOAT64", [1.5, -0.0, 0.0, None, float("nan"), -2.5]),
            ("TIMESTAMP", [0, 1700000000000000, None, -1, 5, 6])]


def both_cols(kind, vals):
    return (JC.Column.from_list(getattr(JC.dtypes, kind), vals),
            PC.Column.from_list(getattr(PC.dtypes, kind), vals))


@pytest.mark.parametrize("kind,vals", KEY_COLS)
def test_hashes_and_vnodes_equal(kind, vals):
    j, p = both_cols(kind, vals)
    assert np.array_equal(PV.column_hash64(p), JV.column_hash64(j))
    for count in (256, 16, 1 << 15):
        assert np.array_equal(PV.compute_vnodes([p], vnode_count=count),
                              JV.compute_vnodes([j], vnode_count=count))
    assert [PV.vnode_of_row([v]) for v in vals] == \
        [JV.vnode_of_row([v]) for v in vals]


def test_multicolumn_keys_equal():
    js, ps = zip(*(both_cols(k, v) for k, v in KEY_COLS))
    assert np.array_equal(PV.hash_columns64(list(ps)),
                          JV.hash_columns64(list(js)))
    assert np.array_equal(PV.compute_vnodes(list(ps)),
                          JV.compute_vnodes(list(js)))
    assert np.array_equal(PV.compute_vnodes([], n=5),
                          JV.compute_vnodes([], n=5))


def test_device_chunks_equal():
    """to_device_chunk: the same padded columns (a string column as its
    64-bit hash, int64 in the port), mask and signs."""
    dts = ["INT64", "VARCHAR", "FLOAT64", "BOOLEAN", "INT32"]
    rows = [(1, "a", 0.5, True, 3), (None, "b", None, False, None),
            (3, None, -1.0, None, 7)]
    ops = [JC.Op.INSERT, JC.Op.DELETE, JC.Op.UPDATE_INSERT]
    jch = JC.StreamChunk.from_rows([getattr(JC.dtypes, d) for d in dts],
                                   list(zip(ops, rows)))
    pch = PC.StreamChunk.from_rows([getattr(PC.dtypes, d) for d in dts],
                                   [(PC.Op(int(o)), r)
                                    for o, r in zip(ops, rows)])
    jd = JC.to_device_chunk(jch, capacity=32)
    pd = PC.to_device_chunk(pch, capacity=32, device="cpu")
    assert (pd.capacity, pd.n_rows) == (jd.capacity, jd.n_rows)
    for pc, jc in zip(pd.cols, jd.cols):
        want = np.asarray(jc)
        if want.dtype == np.uint64:
            want = want.view(np.int64)
        assert pc.numpy().dtype == want.dtype
        assert np.array_equal(pc.numpy(), want, equal_nan=True)
    assert np.array_equal(pd.mask.numpy(), np.asarray(jd.mask))
    assert np.array_equal(pd.signs.numpy(), np.asarray(jd.signs))
    assert pd.mask.dtype == torch.bool and pd.signs.dtype == torch.int32
