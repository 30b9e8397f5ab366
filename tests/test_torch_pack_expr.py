"""The port's key packing and device expression evaluation (on the CPU)
against the JAX package's, leaf by leaf and dtype by dtype."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import risingwave_tpu.device.fused as JF
from risingwave_tpu.core import dtypes as JT
from risingwave_tpu.expr import expression as JE
from risingwave_tpu_torch.core import dtypes as PT
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.expr.expression import InputRef, Literal
from torch_parity import assert_same, port_pack


def test_pack_plan_matches_reference():
    rng = np.random.default_rng(5)
    jp = JF.PackPlan.plan([(1000, 1304, 1), (-50, 4000, 100), (0, 3, 1)])
    pp = port_pack(jp)
    cols = [rng.integers(1000, 1305, 300), rng.integers(-1, 41, 300) * 100
            - 50, rng.integers(0, 4, 300)]
    cols[1][::7] += 1                       # off the stride: a violation
    mask = rng.random(300) < 0.8
    jk = jp.pack([jnp.asarray(c) for c in cols])
    pk = pp.pack([torch.from_numpy(c) for c in cols])
    assert np.array_equal(pk.numpy(), np.asarray(jk))
    for a, b in zip(pp.unpack(pk), jp.unpack(jk)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert int(pp.check([torch.from_numpy(c) for c in cols],
                        torch.from_numpy(mask))) == \
        int(jp.check([jnp.asarray(c) for c in cols], jnp.asarray(mask)))
    assert PF.PackPlan.plan([(0, 1 << 40, 1)] * 2) is None


@pytest.mark.parametrize("expr", ["input_ref", "literal_int",
                                  "literal_float", "literal_bool"])
def test_eval_device_matches_reference(expr):
    cols = [np.arange(7, dtype=np.int64) * 3, np.arange(7, dtype=np.int64)]
    if expr == "input_ref":
        je, pe = JE.InputRef(1, JT.INT64), InputRef(1, PT.INT64)
    else:
        val, jt, pt = {"literal_int": (42, JT.INT64, PT.INT64),
                       "literal_float": (2.5, JT.FLOAT64, PT.FLOAT64),
                       "literal_bool": (True, JT.BOOLEAN, PT.BOOLEAN)}[expr]
        je, pe = JE.Literal(val, jt), Literal(val, pt)
    ref = je.eval_device([jnp.asarray(c) for c in cols])
    got = pe.eval_device([torch.from_numpy(c) for c in cols])
    assert_same(got, ref)
