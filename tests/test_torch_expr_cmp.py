"""The port's FunctionCall device evaluation (expr/functions.py) against
the JAX package's `eval_device`: the six comparisons, with NULL inputs,
and three-valued and / or / not over every TRUE / FALSE / NULL pair,
both built by each package's `build_func`."""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from risingwave_tpu.core import dtypes as JT
from risingwave_tpu.expr import expression as JE
from risingwave_tpu.expr.functions import build_func
from risingwave_tpu_torch.core import dtypes as PT
from risingwave_tpu_torch.expr import expression as PE
from risingwave_tpu_torch.expr.functions import build_func as port_func
from torch_parity import assert_same

CMP = ["equal", "not_equal", "less_than", "less_than_or_equal",
       "greater_than", "greater_than_or_equal"]


class JNullable(JE.Expr):
    """Column i with its own validity: cols[2i] values, cols[2i+1] valid."""

    def __init__(self, i, dt):
        self.i, self.return_type = i, dt

    def supports_device(self):
        return True

    def eval_device(self, cols):
        return cols[2 * self.i], cols[2 * self.i + 1]


class PNullable(PE.Expr):
    def __init__(self, i, dt):
        self.i, self.return_type = i, dt

    def eval_device(self, cols):
        return cols[2 * self.i], cols[2 * self.i + 1]


def both(np_cols):
    return ([jnp.asarray(c) for c in np_cols],
            [torch.from_numpy(c) for c in np_cols])


@pytest.mark.parametrize("name", CMP)
@pytest.mark.parametrize("dt", ["int64", "float64"])
def test_compare(name, dt):
    rng = np.random.default_rng(len(name) + len(dt))
    n = 200
    if dt == "int64":
        a, b = rng.integers(-3, 3, n), rng.integers(-3, 3, n)
        jdt, pdt = JT.INT64, PT.INT64
    else:
        a, b = rng.normal(0, 1, n).round(1), rng.normal(0, 1, n).round(1)
        a[::17] = np.nan
        b[::5] = a[::5]
        jdt, pdt = JT.FLOAT64, PT.FLOAT64
    va, vb = rng.random(n) < 0.8, rng.random(n) < 0.8
    jc, pc = both([a, va, b, vb])
    ref = build_func(name, [JNullable(0, jdt), JNullable(1, jdt)])
    got = port_func(name, [PNullable(0, pdt), PNullable(1, pdt)])
    assert got.return_type == PT.BOOLEAN
    assert_same(got.eval_device(pc), ref.eval_device(jc))
    # against a literal, as a filter predicate reads it
    ref = build_func(name, [JNullable(0, jdt), JE.Literal(0, jdt)])
    got = port_func(name, [PNullable(0, pdt), PE.Literal(0, pdt)])
    assert_same(got.eval_device(pc), ref.eval_device(jc))


# every (value, valid) pair of two booleans: TRUE, FALSE, NULL (the NULL
# slot's value is either bit — it must not matter)
_TV = [(True, True), (False, True), (True, False), (False, False)]
_A, _B = zip(*itertools.product(_TV, _TV))


@pytest.mark.parametrize("name", ["and", "or", "not"])
def test_three_valued_logic(name):
    cols = [np.array([v for v, _ in _A]), np.array([ok for _, ok in _A]),
            np.array([v for v, _ in _B]), np.array([ok for _, ok in _B])]
    jc, pc = both(cols)
    arity = 1 if name == "not" else 2
    ref = build_func(name, [JNullable(i, JT.BOOLEAN) for i in range(arity)])
    got = port_func(name, [PNullable(i, PT.BOOLEAN)
                              for i in range(arity)])
    (rv, rok), (gv, gok) = ref.eval_device(jc), got.eval_device(pc)
    assert_same((gok, gv & gok), (rok, rv & rok))   # the known results
    assert_same(gok, rok)


def test_nested_predicate():
    """The shape of a fused filter: and(gt($0, $1), not(eq($0, 3)))."""
    rng = np.random.default_rng(9)
    n = 300
    a, b = rng.integers(0, 6, n), rng.integers(0, 6, n)
    va, vb = rng.random(n) < 0.7, rng.random(n) < 0.7
    jc, pc = both([a, va, b, vb])
    ja, jb = JNullable(0, JT.INT64), JNullable(1, JT.INT64)
    pa, pb = PNullable(0, PT.INT64), PNullable(1, PT.INT64)
    ref = build_func("and", [
        build_func("greater_than", [ja, jb]),
        build_func("not", [build_func("equal", [ja, JE.Literal(3,
                                                               JT.INT64)])])])
    got = port_func("and", [
        port_func("greater_than", [pa, pb]),
        port_func("not", [port_func("equal",
                                          [pa, PE.Literal(3, PT.INT64)])])])
    (rv, rok), (gv, gok) = ref.eval_device(jc), got.eval_device(pc)
    assert_same((gok, gv & gok), (rok, rv & rok))


def test_unknown_function_raises():
    with pytest.raises(ValueError, match="unknown function"):
        port_func("no_such_function", [PE.Literal(1, PT.INT64)] * 2)
