"""The port's group / join key codecs (`device/key_codec.py`) against the
JAX package's: the reference's `test_key_codecs`
(tests/test_device_seam.py) on both packages, and seeded `DictCodec` /
`PackCodec` runs over string, multi-column and NULL keys — the device
keys equal bit for bit, the decoded tuples and columns equal."""
import numpy as np
import pytest

import risingwave_tpu.device.key_codec as JK
import risingwave_tpu_torch.device.key_codec as PK
from risingwave_tpu.core import dtypes as JT
from risingwave_tpu.core.chunk import Column as JColumn
from risingwave_tpu_torch.core import dtypes as PT
from risingwave_tpu_torch.core.chunk import Column as PColumn

PKGS = [(JK, JT, JColumn), (PK, PT, PColumn)]


def same_columns(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype.kind.value == y.dtype.kind.value
        assert x.values.dtype == y.values.dtype
        assert np.array_equal(x.validity, y.validity)
        # repr: NaN keys compare equal, -0.0 and 0.0 apart
        assert repr(x.values[x.validity].tolist()) == \
            repr(y.values[y.validity].tolist())


@pytest.mark.parametrize("pkg", [0, 1], ids=["reference", "port"])
def test_key_codecs(pkg):
    """The reference's test, run on each package."""
    K, T, Column = PKGS[pkg]
    c = K.make_codec([T.INT32, T.BOOLEAN, T.INT16])
    assert isinstance(c, K.PackCodec)
    rows = [(5, True, -3), (-2**31, False, 32767), (None, None, 0),
            (2**31 - 1, True, -32768)]
    keys = c.encode_rows(rows)
    assert len(set(keys.tolist())) == len(rows)
    assert c.decode(keys) == rows
    c2 = K.make_codec([T.INT64, T.VARCHAR])
    assert isinstance(c2, K.DictCodec)
    rows2 = [(1, "a"), (2, None), (None, "x"), (2**63 - 1, "edge")]
    cols = [Column.from_list(T.INT64, [r[0] for r in rows2]),
            Column.from_list(T.VARCHAR, [r[1] for r in rows2])]
    k2 = c2.encode_columns(cols)
    c2.observe_columns(k2, cols)
    assert c2.decode(k2) == rows2


def random_rows(rng, n, kinds):
    out = []
    for _ in range(n):
        row = []
        for k in kinds:
            if rng.random() < 0.1:
                row.append(None)
            elif k == "VARCHAR":
                row.append(f"s{int(rng.integers(0, 50))}")
            elif k == "BOOLEAN":
                row.append(bool(rng.integers(0, 2)))
            elif k == "INT16":
                row.append(int(rng.integers(-2**15, 2**15)))
            elif k in ("INT32", "DATE"):
                row.append(int(rng.integers(-2**31, 2**31)))
            elif k == "FLOAT64":
                row.append(float(rng.choice([0.5, -0.0, 0.0, 1e300,
                                             float("nan")])))
            else:
                row.append(int(rng.integers(-2**63, 2**63 - 1)))
        out.append(tuple(row))
    return out


@pytest.mark.parametrize("kinds", [
    ["VARCHAR"], ["INT64", "VARCHAR"], ["VARCHAR", "INT32", "BOOLEAN"],
    ["INT64"], ["FLOAT64", "INT64"],
    ["INT32", "BOOLEAN", "INT16"], ["DATE", "INT16"],
    ["INT32", "INT32"]])
def test_codecs_match_reference(kinds):
    """Seeded keys through both packages' `make_codec`: the same codec
    class, the same int64 keys from columns and from rows, the same
    decode, and `forget` / re-observe on the dictionary codec."""
    rng = np.random.default_rng(len(kinds) * 31 + len(kinds[0]))
    rows = random_rows(rng, 300, kinds)
    out = []
    for K, T, Column in PKGS:
        dts = [getattr(T, k) for k in kinds]
        c = K.make_codec(dts)
        cols = [Column.from_list(d, [r[i] for r in rows])
                for i, d in enumerate(dts)]
        kc = c.encode_columns(cols)
        c.observe_columns(kc, cols)
        kr = c.encode_rows(rows)
        c.observe_rows(kr, rows)
        dec_cols = c.decode_columns(kc)
        dec = c.decode(kc)
        c.forget(kc[:10])
        out.append((type(c).__name__, kc, kr, dec, dec_cols))
    (jn, jkc, jkr, jdec, jcols), (pn, pkc, pkr, pdec, pcols) = out
    assert pn == jn
    assert pkc.dtype == jkc.dtype == np.int64
    assert np.array_equal(pkc, jkc) and np.array_equal(pkr, jkr)
    assert np.array_equal(pkc, pkr)
    assert repr(pdec) == repr(jdec)
    same_columns(pcols, jcols)


def test_dict_codec_collision_raises():
    """Two tuples observed under one key raise `KeyCollisionError` in both
    packages."""
    for K, T, Column in PKGS:
        c = K.DictCodec([T.VARCHAR])
        c.observe_rows(np.array([7], np.int64), [("a",)])
        with pytest.raises(K.KeyCollisionError):
            c.observe_rows(np.array([7], np.int64), [("b",)])
