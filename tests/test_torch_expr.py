"""The port's expression layer (`risingwave_tpu_torch/expr/`) against the
JAX package's, and the `expr_eval` lowering against the trees it lowers.

* `TestScalar` / `TestAgg` / `TestDeviceParity`: the reference's own
  cases (`tests/test_expr.py`), fed to both packages; the device parity
  cases hold both packages' `eval_device` and the host `eval` to exact
  equality (the reference's float case uses `assert_allclose`).
* Every device half — arith, neg, compare, and / or / not, cast, the
  `_MATH1` functions, power, tumble_start, CASE, IS [NOT] NULL,
  COALESCE — on seeded inputs with NULLs (a NULL row carries a value,
  which must match too) and the edge values of each type: INT_MIN, -1, 0,
  1, INT_MAX in every operand position, NaN, +-inf, +-2^63, -0.0,
  halves. Equal to the bit (NaN to NaN, signed zeros by sign), dtype
  included. The one tolerance: exp, ln, log10, sin, cos, tan, sqrt and
  power, whose routines differ between XLA's CPU and torch's CPU by the
  ulps in `ULPS` (ROADMAP queue 3 records an input and both results for
  each); subnormals, which XLA's CPU flushes to zero, are held apart.
* The lowered program run by `expr_eval_plain` against the tree's own
  `eval_device`: exact, for every case above.
"""
import zlib
from decimal import Decimal
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import risingwave_tpu.core as JC
import risingwave_tpu.expr as JX
from risingwave_tpu.core import dtypes as JT
from risingwave_tpu.expr import expression as JE
import risingwave_tpu_torch.core as PC
import risingwave_tpu_torch.expr as PX
from risingwave_tpu_torch.core import dtypes as PT
from risingwave_tpu_torch.expr import expression as PE
from risingwave_tpu_torch.kernels import expr_eval as X


def _pkg(core, expr, t, dev):
    return SimpleNamespace(
        Column=core.Column, DataChunk=core.DataChunk, T=t,
        parse_interval=core.parse_interval, InputRef=expr.InputRef,
        Literal=expr.Literal, Case=expr.Case, build_func=expr.build_func,
        cast=expr.cast, AggCall=expr.AggCall,
        create_agg_state=expr.create_agg_state,
        DistinctDedup=expr.DistinctDedup, dev=dev)


PKGS = {"ref": _pkg(JC, JX, JT, jnp.asarray),
        "port": _pkg(PC, PX, PT, torch.from_numpy)}


@pytest.fixture(params=["ref", "port"])
def pk(request):
    return PKGS[request.param]


def chunk_i64(pk, *cols):
    return pk.DataChunk([pk.Column.from_list(pk.T.INT64, list(c))
                         for c in cols])


# ---------------------------------------------------------------------------
# the reference's cases, both packages
# ---------------------------------------------------------------------------


class TestScalar:
    def test_add_ints(self, pk):
        T, I = pk.T, pk.InputRef
        e = pk.build_func("add", [I(0, T.INT64), I(1, T.INT64)])
        out = e.eval(chunk_i64(pk, [1, 2, None], [10, 20, 30]))
        assert out.to_list() == [11, 22, None]

    def test_int_division_truncates_toward_zero(self, pk):
        T, I = pk.T, pk.InputRef
        e = pk.build_func("divide", [I(0, T.INT64), I(1, T.INT64)])
        out = e.eval(chunk_i64(pk, [7, -7, 7, -7], [2, 2, -2, -2]))
        assert out.to_list() == [3, -3, -3, 3]

    def test_division_by_zero_yields_null(self, pk):
        T, I = pk.T, pk.InputRef
        e = pk.build_func("divide", [I(0, T.INT64), I(1, T.INT64)])
        assert e.eval(chunk_i64(pk, [1], [0])).to_list() == [None]

    def test_modulus_sign(self, pk):
        T, I = pk.T, pk.InputRef
        e = pk.build_func("modulus", [I(0, T.INT64), I(1, T.INT64)])
        out = e.eval(chunk_i64(pk, [7, -7, 7, -7], [3, 3, -3, -3]))
        assert out.to_list() == [1, -1, 1, -1]

    def test_decimal_multiply_exact(self, pk):
        T = pk.T
        e = pk.build_func("multiply", [pk.InputRef(0, T.INT64),
                                       pk.Literal(Decimal("0.908"),
                                                  T.DECIMAL)])
        out = e.eval(chunk_i64(pk, [100, 25]))
        assert out.to_list() == [Decimal("90.800"), Decimal("22.700")]

    def test_mixed_promotion(self, pk):
        T, C = pk.T, pk.Column
        e = pk.build_func("add", [pk.InputRef(0, T.INT32),
                                  pk.InputRef(1, T.FLOAT64)])
        ch = pk.DataChunk([C.from_list(T.INT32, [1]),
                           C.from_list(T.FLOAT64, [0.5])])
        assert e.return_type.kind == T.TypeKind.FLOAT64
        assert e.eval(ch).to_list() == [1.5]

    def test_comparison_strings(self, pk):
        T, C = pk.T, pk.Column
        e = pk.build_func("less_than", [pk.InputRef(0, T.VARCHAR),
                                        pk.InputRef(1, T.VARCHAR)])
        ch = pk.DataChunk([C.from_list(T.VARCHAR, ["a", "c", None]),
                           C.from_list(T.VARCHAR, ["b", "b", "x"])])
        assert e.eval(ch).to_list() == [True, False, None]

    def test_three_valued_logic(self, pk):
        T, C = pk.T, pk.Column
        a, b = pk.InputRef(0, T.BOOLEAN), pk.InputRef(1, T.BOOLEAN)
        ch = pk.DataChunk([C.from_list(T.BOOLEAN, [True, False, None, None]),
                           C.from_list(T.BOOLEAN, [None, None, None, True])])
        assert pk.build_func("and", [a, b]).eval(ch).to_list() == \
            [None, False, None, None]
        assert pk.build_func("or", [a, b]).eval(ch).to_list() == \
            [True, None, None, True]

    def test_case(self, pk):
        T = pk.T
        cond = pk.build_func("greater_than", [pk.InputRef(0, T.INT64),
                                              pk.Literal(0, T.INT64)])
        e = pk.Case([(cond, pk.Literal("pos", T.VARCHAR))],
                    pk.Literal("neg", T.VARCHAR), T.VARCHAR)
        assert e.eval(chunk_i64(pk, [5, -5, 0])).to_list() == \
            ["pos", "neg", "neg"]

    def test_cast_str_int(self, pk):
        T = pk.T
        e = pk.cast(pk.InputRef(0, T.VARCHAR), T.INT64)
        ch = pk.DataChunk([pk.Column.from_list(T.VARCHAR,
                                               ["42", " 7 ", "bad"])])
        assert e.eval(ch).to_list() == [42, 7, None]

    def test_cast_timestamp_str(self, pk):
        T = pk.T
        e = pk.cast(pk.InputRef(0, T.VARCHAR), T.TIMESTAMP)
        ch = pk.DataChunk([pk.Column.from_list(T.VARCHAR,
                                               ["2024-01-01 00:00:01"])])
        assert e.eval(ch).to_list() == [1704067201000000]

    def test_like(self, pk):
        T = pk.T
        e = pk.build_func("like", [pk.InputRef(0, T.VARCHAR),
                                   pk.Literal("%rule%", T.VARCHAR)])
        ch = pk.DataChunk([pk.Column.from_list(
            T.VARCHAR, ["hard rules", "soft", None])])
        assert e.eval(ch).to_list() == [True, False, None]

    def test_substr_split_part(self, pk):
        T = pk.T
        e = pk.build_func("split_part", [pk.InputRef(0, T.VARCHAR),
                                         pk.Literal(",", T.VARCHAR),
                                         pk.Literal(2, T.INT32)])
        ch = pk.DataChunk([pk.Column.from_list(T.VARCHAR, ["a,b,c"])])
        assert e.eval(ch).to_list() == ["b"]

    def test_extract_date_trunc(self, pk):
        T = pk.T
        ts = 1704067201000000
        e = pk.build_func("extract", [pk.Literal("year", T.VARCHAR),
                                      pk.InputRef(0, T.TIMESTAMP)])
        ch = pk.DataChunk([pk.Column.from_list(T.TIMESTAMP, [ts])])
        assert e.eval(ch).to_list() == [Decimal(2024)]
        e2 = pk.build_func("date_trunc", [pk.Literal("day", T.VARCHAR),
                                          pk.InputRef(0, T.TIMESTAMP)])
        assert e2.eval(ch).to_list() == [1704067200000000]

    def test_ts_plus_interval(self, pk):
        T = pk.T
        e = pk.build_func("add", [pk.InputRef(0, T.TIMESTAMP),
                                  pk.Literal(pk.parse_interval("10 seconds"),
                                             T.INTERVAL)])
        ch = pk.DataChunk([pk.Column.from_list(T.TIMESTAMP, [1000000])])
        assert e.eval(ch).to_list() == [11000000]


class TestAgg:
    def _run(self, pk, call, pairs):
        st = pk.create_agg_state(call)
        for sign, v in pairs:
            st.apply(sign, v)
        return st.output()

    def test_count_retract(self, pk):
        assert self._run(pk, pk.AggCall("count"),
                         [(1, 1), (1, 1), (-1, 1)]) == 1

    def test_sum_bigint_is_decimal(self, pk):
        c = pk.AggCall("sum", pk.InputRef(0, pk.T.INT64))
        assert c.return_type.kind == pk.T.TypeKind.DECIMAL
        assert self._run(pk, c, [(1, 5), (1, 7), (-1, 2)]) == Decimal(10)

    def test_sum_empty_is_null(self, pk):
        c = pk.AggCall("sum", pk.InputRef(0, pk.T.INT32))
        assert self._run(pk, c, [(1, 5), (-1, 5)]) is None

    def test_min_retract_recovers_next(self, pk):
        c = pk.AggCall("min", pk.InputRef(0, pk.T.INT64))
        assert self._run(pk, c, [(1, 5), (1, 3), (1, 7), (-1, 3)]) == 5

    def test_avg(self, pk):
        c = pk.AggCall("avg", pk.InputRef(0, pk.T.INT64))
        assert self._run(pk, c, [(1, 4), (1, 8)]) == Decimal(6)

    def test_first_last_value(self, pk):
        c = pk.AggCall("last_value", pk.InputRef(0, pk.T.INT64))
        assert self._run(pk, c, [(1, 1), (1, 2), (1, 3)]) == 3

    def test_distinct_dedup(self, pk):
        d = pk.DistinctDedup()
        assert d.apply(1, "x") == 1
        assert d.apply(1, "x") == 0
        assert d.apply(-1, "x") == 0
        assert d.apply(-1, "x") == -1


class TestDeviceParity:
    """The reference's device cases: host `eval`, the reference's and the
    port's `eval_device` — and the port's lowered program — all equal."""

    def _both(self, pk, e, ch):
        host = e.eval(ch)
        cols = [pk.dev(c.values) for c in ch.columns]
        dv, dok = e.eval_device(cols)
        if pk is PKGS["port"]:
            (pv,) = X.expr_eval_plain(X.lower_map([e]), cols)
            assert_bits(pv.numpy(), np.asarray(dv))
        return host, np.asarray(dv), np.asarray(dok)

    def test_arith_parity(self, pk):
        T, I = pk.T, pk.InputRef
        e = pk.build_func("multiply", [
            pk.build_func("add", [I(0, T.INT64), pk.Literal(5, T.INT64)]),
            I(1, T.INT64)])
        assert e.supports_device()
        host, dv, dok = self._both(pk, e, chunk_i64(pk, [1, 2, 3],
                                                    [4, 5, 6]))
        assert host.to_list() == list(dv)

    def test_division_null_parity(self, pk):
        T, I = pk.T, pk.InputRef
        e = pk.build_func("divide", [I(0, T.INT64), I(1, T.INT64)])
        host, dv, dok = self._both(pk, e, chunk_i64(pk, [10, 6], [0, 2]))
        assert list(dok) == [False, True]
        assert host.to_list() == [None, 3]
        assert list(dv) == [10, 3]          # the NULL row carries 10 / 1

    def test_cmp_and_case_parity(self, pk):
        T, I = pk.T, pk.InputRef
        cond = pk.build_func("greater_than_or_equal",
                             [I(0, T.INT64), pk.Literal(2, T.INT64)])
        e = pk.Case([(cond, I(1, T.INT64))], pk.Literal(0, T.INT64), T.INT64)
        assert e.supports_device()
        host, dv, _ = self._both(pk, e, chunk_i64(pk, [1, 2, 3],
                                                  [10, 20, 30]))
        assert host.to_list() == list(dv)

    def test_float_parity(self, pk):
        T = pk.T
        e = pk.build_func("multiply", [pk.InputRef(0, T.FLOAT64),
                                       pk.Literal(0.908, T.FLOAT64)])
        ch = pk.DataChunk([pk.Column.from_list(T.FLOAT64, [1.0, 2.5])])
        host, dv, _ = self._both(pk, e, ch)
        assert_bits(dv, host.values)          # exact, not allclose


# ---------------------------------------------------------------------------
# every device half, both packages, edge values and NULLs
# ---------------------------------------------------------------------------


def assert_bits(got, want, ulps=0, flushed=False):
    """Same dtype and shape; equal values (NaN where NaN, a zero's sign
    kept), or within `ulps` units in the last place for floats. With
    `flushed` (`want` from XLA's CPU), a subnormal result of the port
    matches the zero of its sign that XLA flushed it to."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    if not np.issubdtype(got.dtype, np.floating):
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, (bad[:5], got[bad[:5]], want[bad[:5]])
        return
    gn, wn = np.isnan(got), np.isnan(want)
    assert np.array_equal(gn, wn), np.flatnonzero(gn != wn)[:5]
    g, w = got[~gn], want[~wn]
    if flushed:
        sub = (w == 0) & (np.abs(g) < np.finfo(g.dtype).tiny) \
            & (np.signbit(g) == np.signbit(w))
        g, w = g[~sub], w[~sub]
    if ulps == 0:
        bad = np.flatnonzero((g != w) | (np.signbit(g) != np.signbit(w)))
        assert bad.size == 0, (g[bad[:5]], w[bad[:5]])
        return
    dist = np.abs(_ordered(g) - _ordered(w))
    assert dist.max(initial=0) <= ulps, (dist.max(), g[np.argmax(dist)],
                                         w[np.argmax(dist)])


def _ordered(x):
    """Float bits mapped to integers in the floats' order (ulp distance)."""
    i = x.view(np.int64 if x.dtype == np.float64 else np.int32) \
        .astype(np.int64)
    top = np.int64(-(1 << 63)) if x.dtype == np.float64 \
        else np.int64(-(1 << 31))
    return np.where(i < 0, top - i, i)


# XLA's CPU routines and torch's CPU routines differ by at most these
# ulps on float64 (ROADMAP queue 3); every other op is held to the bit
ULPS = {"exp": 2, "ln": 1, "log10": 2, "sin": 1, "cos": 1, "tan": 1,
        "sqrt": 1, "power": 1}

N = 4000
NP_OF = {"bool": np.bool_, "int16": np.int16, "int32": np.int32,
         "int64": np.int64, "float32": np.float32, "float64": np.float64,
         "date": np.int32, "timestamp": np.int64}
KIND = {"bool": "BOOLEAN", "int16": "INT16", "int32": "INT32",
        "int64": "INT64", "float32": "FLOAT32", "float64": "FLOAT64",
        "date": "DATE", "timestamp": "TIMESTAMP"}
NUMERIC = ["int16", "int32", "int64", "float32", "float64"]


def edges(name):
    """Each type's edge values (traps 1-7 of the port's expression
    kernel)."""
    dt = NP_OF[name]
    if name == "bool":
        return np.array([True, False])
    if np.issubdtype(dt, np.integer):
        i = np.iinfo(dt)
        return np.array([i.min, i.min + 1, -2, -1, 0, 1, 2, 7, i.max - 1,
                         i.max], dt)
    big = 2.0 ** 63
    return np.array([np.nan, np.inf, -np.inf, big, -big, 2 * big, 0.0, -0.0,
                     0.5, -0.5, 1.5, 2.5, -2.5, 1.0, -1.0, 3.0, 1e30,
                     np.finfo(dt).max, -np.finfo(dt).max,
                     np.finfo(dt).tiny, 2.0 ** 31 + 0.5, -2.0 ** 31 - 0.5,
                     32767.5, -32768.5], np.float64).astype(dt)


def column(rng, name, n=N):
    """n seeded values of a type: its edges first, then random."""
    dt = NP_OF[name]
    if name == "bool":
        out = rng.random(n) < 0.5
    elif np.issubdtype(dt, np.integer):
        i = np.iinfo(dt)
        out = rng.integers(i.min, i.max, n, dtype=np.int64, endpoint=True) \
            .astype(dt)
        out[n // 2:] = rng.integers(-50, 50, n - n // 2).astype(dt)
    else:
        out = np.concatenate([rng.normal(0, 100, n // 2),
                              rng.uniform(-1e4, 1e4, n - n // 2)]).astype(dt)
    e = edges(name)
    out[:len(e)] = e
    return out


def first_column(rng, name, other):
    """The first operand of a binary case: each edge of `name` repeated
    against every edge of `other` (`pair_column`), then random."""
    e, oe = edges(name), edges(other)
    out = column(rng, name)
    out[:len(e) * len(oe)] = np.repeat(e, len(oe))
    return out


def pair_column(rng, name, other):
    """The second operand: every edge of `name` under each edge of
    `other` in `first_column`, then random."""
    e, oe = edges(name), edges(other)
    out = column(rng, name)
    out[:len(e) * len(oe)] = np.tile(e, len(oe))
    return out


class JNullable(JE.Expr):
    """Column i with its own validity: cols[2i] values, cols[2i+1] valid
    (a NULL row keeps an arbitrary value)."""

    def __init__(self, i, dt):
        self.i, self.return_type = i, dt

    def supports_device(self):
        return True

    def eval_device(self, cols):
        return cols[2 * self.i], cols[2 * self.i + 1]


class PNullable(PE.Expr):
    def __init__(self, i, dt):
        self.i, self.return_type = i, dt

    def supports_device(self):
        return True

    def eval_device(self, cols):
        return cols[2 * self.i], cols[2 * self.i + 1]


def dtype_of(pkg_t, name):
    return getattr(pkg_t, KIND[name])


def run_case(make, types, data, valid, ulps=0):
    """`make(pkg, leaves)` builds the expression in a package over leaves
    of the given types. Holds (1) the port's tree against the reference's
    over nullable leaves, values of NULL rows included, and (2) the
    port's lowered program (leaves as InputRefs made NULL by a CASE over
    a flag column) run by `expr_eval_plain` against the same tree's
    `eval_device`."""
    jleaves = [JNullable(i, dtype_of(JT, t)) for i, t in enumerate(types)]
    pleaves = [PNullable(i, dtype_of(PT, t)) for i, t in enumerate(types)]
    jcols, pcols = [], []
    for v, ok in zip(data, valid):
        jcols += [jnp.asarray(v), jnp.asarray(ok)]
        pcols += [torch.from_numpy(v), torch.from_numpy(ok)]
    ref = make(PKGS["ref"], jleaves)
    got = make(PKGS["port"], pleaves)
    rv, rok = ref.eval_device(jcols)
    gv, gok = got.eval_device(pcols)
    assert np.array_equal(gok.numpy(), np.asarray(rok))
    assert_bits(gv.numpy(), np.asarray(rv), ulps, flushed=True)
    # the lowered program against the tree, exact
    k = len(types)
    leaves = [PE.Case([(PE.InputRef(k + i, PT.BOOLEAN),
                        PE.InputRef(i, dtype_of(PT, t)))], None,
                      dtype_of(PT, t)) for i, t in enumerate(types)]
    tree = make(PKGS["port"], leaves)
    cols = [torch.from_numpy(v) for v in data] + \
        [torch.from_numpy(ok) for ok in valid]
    tv, tok = tree.eval_device(cols)
    (pv,) = X.expr_eval_plain(X.lower_map([tree]), cols)
    assert_bits(pv.numpy(), tv.numpy())
    if tv.dtype == torch.bool:
        mask = torch.from_numpy(np.random.default_rng(1).random(
            tv.shape[0]) < 0.9)
        pm = X.expr_eval_plain(X.lower_pred(tree), cols, mask)
        assert torch.equal(pm, mask & tv & tok)


def nulls(rng, n=N, p=0.15):
    return rng.random(n) >= p


def fn(name):
    return lambda pk, a: pk.build_func(name, list(a))


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide",
                                "modulus"])
@pytest.mark.parametrize("t", NUMERIC)
def test_arith(op, t):
    """Wrapping ints at their width; a zero divisor NULL and replaced by
    1; INT_MIN, -1, 0, INT_MAX in both operand positions; float NaN /
    inf / +-2^63 / signed zeros."""
    rng = np.random.default_rng(zlib.crc32(f"{op}/{t}".encode()))
    a, b = first_column(rng, t, t), pair_column(rng, t, t)
    run_case(fn(op), [t, t], [a, b], [nulls(rng), nulls(rng)])


@pytest.mark.parametrize("t", NUMERIC)
def test_neg(t):
    rng = np.random.default_rng(3)
    run_case(lambda pk, a: pk.build_func("neg", a), [t], [column(rng, t)],
             [nulls(rng)])


@pytest.mark.parametrize("op", ["equal", "not_equal", "less_than",
                                "less_than_or_equal", "greater_than",
                                "greater_than_or_equal"])
@pytest.mark.parametrize("t", ["bool", "int16", "int32", "float32",
                               "date", "timestamp"])
def test_compare(op, t):
    rng = np.random.default_rng(11)
    a = first_column(rng, t, t)
    b = pair_column(rng, t, t)
    run_case(fn(op), [t, t], [a, b], [nulls(rng), nulls(rng)])


@pytest.mark.parametrize("op", ["and", "or", "not"])
def test_logic(op):
    rng = np.random.default_rng(13)
    ar = 1 if op == "not" else 2
    run_case(fn(op), ["bool"] * ar,
             [column(rng, "bool") for _ in range(ar)],
             [nulls(rng, p=0.3) for _ in range(ar)])


CASTS = [(f, t) for f in ["bool", "int16", "int32", "int64", "float32",
                          "float64"]
         for t in ["bool", "int16", "int32", "int64", "float32", "float64"]
         if f != t] + [("timestamp", "date"), ("date", "timestamp"),
                       ("int64", "timestamp"), ("timestamp", "int64")]


@pytest.mark.parametrize("frm,to", CASTS)
def test_cast(frm, to):
    """astype, float -> int by rint then XLA's saturating convert (NaN 0,
    +-inf and +-2^63 at the ends), DATE <-> TIMESTAMP by floored days."""
    rng = np.random.default_rng(17)
    a = column(rng, frm)
    if frm == "timestamp":
        a[-100:] = rng.integers(-10 ** 12, 10 ** 12, 100)  # whole days apart
        a[-5:] = [-1, 0, 86_400_000_000, -86_400_000_000, -86_400_000_001]

    def make(pk, leaves):
        return pk.cast(leaves[0], dtype_of(pk.T, to))
    run_case(make, [frm], [a], [nulls(rng)])


MATH = ["abs", "floor", "ceil", "round", "sqrt", "exp", "ln", "log10",
        "sin", "cos", "tan"]


def normal_only(x):
    """Inputs whose results stay normal floats (XLA's CPU flushes
    subnormals: test_subnormals_flush_in_xla)."""
    x = x.copy()
    if np.issubdtype(x.dtype, np.floating):
        tiny = np.finfo(x.dtype).tiny
        x[(x != 0) & (np.abs(x) < tiny * 2 ** 30)] = 1.0
    return x


@pytest.mark.parametrize("name", MATH)
@pytest.mark.parametrize("t", NUMERIC)
def test_math1(name, t):
    rng = np.random.default_rng(19)
    a = normal_only(column(rng, t))
    if name == "exp" and t.startswith("float"):
        with np.errstate(invalid="ignore"):
            a = np.where(np.abs(a) > 700, a % 700, a).astype(a.dtype)
    run_case(fn(name), [t], [a], [nulls(rng)], ulps=ULPS.get(name, 0))


def test_power():
    rng = np.random.default_rng(23)
    a = normal_only(np.abs(column(rng, "float64")))
    b = rng.normal(0, 4, N)
    b[:8] = [0.0, -0.0, 1.0, 0.5, np.nan, np.inf, -np.inf, 3.0]
    run_case(fn("power"), ["float64", "float64"], [a, b],
             [nulls(rng), nulls(rng)], ulps=ULPS["power"])
    ia = column(rng, "int32")
    run_case(fn("power"), ["int32", "float64"], [ia, b],
             [nulls(rng), nulls(rng)], ulps=ULPS["power"])


def test_tumble_start():
    """(ts // w) * w floored, with XLA's w = 0 and INT64_MIN // -1."""
    rng = np.random.default_rng(29)
    ts = first_column(rng, "timestamp", "int64")
    w = pair_column(rng, "int64", "timestamp")
    w[-1000:] = rng.choice([1, 2, 10_000_000, 3_600_000_000], 1000)
    run_case(fn("tumble_start"), ["timestamp", "int64"], [ts, w],
             [nulls(rng), nulls(rng)])


@pytest.mark.parametrize("with_else", [True, False])
@pytest.mark.parametrize("t", ["int64", "float32", "bool"])
def test_case(with_else, t):
    """First hit wins; a NULL condition is false; no ELSE gives 0 / NULL."""
    rng = np.random.default_rng(31)
    data = [column(rng, "bool"), column(rng, t), column(rng, "bool"),
            column(rng, t), column(rng, t)]

    def make(pk, lv):
        return pk.Case([(lv[0], lv[1]), (lv[2], lv[3])],
                       lv[4] if with_else else None, dtype_of(pk.T, t))
    run_case(make, ["bool", t, "bool", t, t], data,
             [nulls(rng, p=0.3) for _ in data])


def test_case_widens_branches():
    """greatest(int32, float64) is a CASE whose branches are widened to
    float64, as jnp's `where` promotes them."""
    rng = np.random.default_rng(37)
    run_case(fn("greatest"), ["int32", "float64"],
             [column(rng, "int32"), column(rng, "float64")],
             [nulls(rng), nulls(rng)])


@pytest.mark.parametrize("negated", [False, True])
def test_is_null(negated):
    rng = np.random.default_rng(41)

    def make(pk, lv):
        return pk.build_func("is_not_null" if negated else "is_null", lv)
    run_case(make, ["float64"], [column(rng, "float64")], [nulls(rng, p=0.4)])


@pytest.mark.parametrize("types", [["int64", "int64", "int64"],
                                   ["int32", "int64"],
                                   ["float32", "float64", "int16"]])
def test_coalesce(types):
    """The first valid value; the first argument's value where all are
    NULL; widened to the arguments' common type."""
    rng = np.random.default_rng(43)

    def make(pk, lv):
        return pk.build_func("coalesce", lv)
    run_case(make, types, [column(rng, t) for t in types],
             [nulls(rng, p=0.5) for _ in types])


def test_nested_q1_q2_shapes():
    """The Map of q1c and the Filter of q2c, as the reference binder
    builds them (integer literals typed INT32, folded to INT64 casts)."""
    rng = np.random.default_rng(47)
    price = column(rng, "int64")

    def q1(pk, lv):
        T = pk.T
        return pk.build_func("divide", [pk.build_func("multiply", [
            lv[0], pk.Literal(908, T.INT32)]), pk.Literal(1000, T.INT32)])

    def q2(pk, lv):
        T = pk.T
        return pk.build_func("equal", [pk.build_func("modulus", [
            lv[0], pk.Literal(123, T.INT32)]), pk.Literal(0, T.INT32)])
    run_case(q1, ["int64"], [price], [nulls(rng)])
    run_case(q2, ["int64"], [price], [nulls(rng)])


def test_subnormals_flush_in_xla():
    """XLA's CPU flushes subnormal floats to zero (so does a TPU); torch
    and the H100's float64 keep them. The port follows IEEE: ceil of the
    smallest subnormal is 1.0 there, 0.0 in the reference (ROADMAP queue
    3). The tests above feed normal floats and match a subnormal result
    to XLA's flushed zero (`assert_bits(flushed=True)`)."""
    x = np.array([5e-324, -5e-324, 2.0 ** -1070], np.float64)
    ref = JX.build_func("ceil", [JNullable(0, JT.FLOAT64)]).eval_device(
        [jnp.asarray(x), jnp.ones(3, bool)])[0]
    got = PX.build_func("ceil", [PNullable(0, PT.FLOAT64)]).eval_device(
        [torch.from_numpy(x), torch.ones(3, dtype=torch.bool)])[0]
    assert list(np.asarray(ref)) == [0.0, 0.0, 0.0]
    assert list(got.numpy()) == [1.0, -0.0, 1.0]


# ---------------------------------------------------------------------------
# the lowering itself
# ---------------------------------------------------------------------------


def test_lowering_program_shape():
    """q2c's filter: one column read, two literals, modulus, equal, mask;
    a column read twice is one input slot."""
    e = PX.build_func("equal", [PX.build_func("modulus", [
        PE.InputRef(0, PT.INT64), PE.Literal(123, PT.INT32)]),
        PE.Literal(0, PT.INT32)])
    prog = X.lower_pred(e)
    assert [X.OP_NAMES[o] for o, _, _ in prog.ins] == \
        ["col", "lit", "modulus", "lit", "equal", "mask"]
    assert prog.inputs == [0] and prog.depth == 2
    two = PX.build_func("and", [
        PX.build_func("greater_than", [PE.InputRef(3, PT.INT64),
                                       PE.Literal(1, PT.INT64)]),
        PX.build_func("less_than", [PE.InputRef(3, PT.INT64),
                                    PE.Literal(9, PT.INT64)])])
    assert X.lower_pred(two).inputs == [3]


def test_lowering_raises():
    """No opcode, a non-boolean predicate, a stack deeper than the
    kernel's, a column read as two types: each raises, with no way back
    to torch ops."""
    s = PX.build_func("lower", [PE.InputRef(0, PT.VARCHAR)])
    with pytest.raises(ValueError, match="no opcode"):
        X.lower_map([s])
    with pytest.raises(ValueError, match="predicate must be boolean"):
        X.lower_pred(PE.InputRef(0, PT.INT64))
    e = PE.InputRef(0, PT.INT64)
    for k in range(X.MAX_DEPTH):
        e = PX.build_func("add", [PE.Literal(k, PT.INT64), e])
    with pytest.raises(ValueError, match="deeper"):
        X.lower_map([e])
    with pytest.raises(ValueError, match="two types"):
        X.lower_map([PE.InputRef(0, PT.INT64), PE.InputRef(0, PT.INT32)])


def test_plain_rejects_column_of_other_type():
    prog = X.lower_map([PX.build_func("neg", [PE.InputRef(0, PT.INT64)])])
    with pytest.raises(ValueError, match="the program reads"):
        X.expr_eval_plain(prog, [torch.zeros(4, dtype=torch.int32)])


# one input per routine where XLA's CPU and torch's CPU differ, with both
# results (ROADMAP queue 3): (function, arguments, XLA's, torch's)
RECORDED_ULPS = [
    ("exp", (0.38311895925477113,), 1.46685251537196, 1.4668525153719596),
    ("ln", (0.9971412915682,), -0.0028628023428091875,
     -0.002862802342809187),
    ("log10", (9.065393256103157,), 0.9573866485033548, 0.957386648503355),
    ("sin", (3.6746620574561293,), -0.5081792590309833, -0.5081792590309834),
    ("cos", (-9.75582830599658,), -0.9457014646939067, -0.9457014646939068),
    ("tan", (1.7681246373052466,), -5.001749070949767, -5.001749070949768),
    ("sqrt", (0.13914668524093735,), 0.3730237060039715,
     0.37302370600397144),
    ("power", (23.250307746388344, 4.65160863432608), 2270343.4749309733,
     2270343.4749309737),
]


@pytest.mark.parametrize("name,args,xla,port", RECORDED_ULPS)
def test_recorded_ulp_differences(name, args, xla, port):
    """Each recorded difference, as it stands: the reference's value, the
    port's (torch's vectorised routine on the CPU: a column of 64 rows;
    torch's scalar tail may round otherwise), and their distance within
    `ULPS`."""
    cols = [np.full(64, a, np.float64) for a in args]
    ref = JX.build_func(name, [JNullable(i, JT.FLOAT64)
                               for i in range(len(args))]).eval_device(
        [x for c in cols for x in (jnp.asarray(c), jnp.ones(64, bool))])[0]
    got = PX.build_func(name, [PNullable(i, PT.FLOAT64)
                               for i in range(len(args))]).eval_device(
        [x for c in cols for x in (torch.from_numpy(c),
                                   torch.ones(64, dtype=torch.bool))])[0]
    assert float(np.asarray(ref)[0]) == xla
    assert float(got[0]) == port
    assert 0 < abs(int(_ordered(np.array([xla]))[0])
                   - int(_ordered(np.array([port]))[0])) <= ULPS[name]


def test_smoke_programs_on_cpu(monkeypatch):
    """The smoke's expr_eval phase (`chip_smoke.expr_cases`: the fixed
    trees of every opcode, seeded random programs, the paths' programs)
    lowers and runs here at 4,096 rows; on the CPU the dispatch is the
    plain version, so this holds the generator, not the kernel."""
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    assert chip_smoke.check_expr_eval(torch.device("cpu"), n=1 << 12) == 0.0
