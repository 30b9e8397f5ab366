"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
the same seeded numpy inputs go through the JAX package and the port, and
every output leaf must match, dtype included.

Not a test module itself; pytest puts this directory on sys.path for the
test modules that import it."""
import numpy as np
import torch

import jax.numpy as jnp

import risingwave_tpu.device.sorted_state as J
import risingwave_tpu_torch.device.sorted_state as P
from risingwave_tpu.expr import expression as JE
from risingwave_tpu_torch.core import dtypes as PT
from risingwave_tpu_torch.device import fused as PF
from risingwave_tpu_torch.expr import expression as PE
from risingwave_tpu_torch.expr.functions import build_device

# the port's tests run small CPU ops: one intra-op thread keeps them off
# the cores the other test workers share
torch.set_num_threads(1)

EMPTY = int(J.EMPTY_KEY)
S, MN, MX, R = (J.ReduceKind.SUM, J.ReduceKind.MIN, J.ReduceKind.MAX,
                J.ReduceKind.REPLACE)
ALL_KINDS = [(S, np.int64), (MN, np.int64), (MX, np.int64), (R, np.int64),
             (S, np.int32), (R, np.int32), (S, np.float64), (MN, np.float64),
             (MX, np.float64), (R, np.float64), (R, np.bool_)]
Q4_KINDS = [(S, np.int64)] * 4 + [(MX, np.int64), (S, np.int64)]


def leaves(x):
    """Flatten tensors, arrays, tuples, dicts (by sorted key) and deltas
    (cols, sign, mask, pk, pk2) into numpy leaves."""
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in leaves(e)]
    if hasattr(x, "cols") and hasattr(x, "mask"):
        return leaves([x.cols, x.sign, x.mask, x.pk,
                       getattr(x, "pk2", None)])
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [np.asarray(x)]


def assert_same(port, ref, float_rtol=0.0):
    """Every leaf equal and of the same dtype; floats within float_rtol."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
    p, r = leaves(port), leaves(ref)
    assert len(p) == len(r)
    for i, (a, b) in enumerate(zip(p, r)):
        assert a.dtype == b.dtype, (i, a.dtype, b.dtype)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if float_rtol and np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=float_rtol, atol=0)
        else:
            assert np.array_equal(a, b), i


def payload(rng, n, dt):
    dt = np.dtype(dt)
    if dt == np.float64:
        return rng.normal(0, 1000, n)
    if dt == np.bool_:
        return rng.random(n) < 0.5
    return rng.integers(-1000, 1000, n).astype(dt)


def state_pair(rng, cap, keys, spec):
    """The same state in both packages: `keys` (sorted unique) live."""
    n = len(keys)
    kk = np.full(cap, EMPTY, np.int64)
    kk[:n] = keys
    vals = []
    for j, (k, dt) in enumerate(spec):
        v = np.full(cap, np.asarray(J._neutral(k, np.dtype(dt))), dt)
        live = payload(rng, n, dt)
        if j == 0:
            live = np.abs(live) + 1 if dt != np.bool_ else np.ones(n, bool)
        v[:n] = live
        vals.append(v)
    cnt = np.int32(n)
    js = J.SortedState(jnp.asarray(kk), jnp.asarray(cnt),
                       tuple(jnp.asarray(v) for v in vals))
    ps = P.SortedState(torch.from_numpy(kk), torch.tensor(cnt),
                       tuple(torch.from_numpy(v) for v in vals))
    return js, ps


def port_dtype(d):
    """A reference DataType as the port's (same kind, precision, scale)."""
    return PT.DataType(PT.TypeKind(d.kind.value), d.precision, d.scale)


def port_pack(p):
    """A reference PackPlan as the port's (same offsets, strides, bits)."""
    return PF.PackPlan(tuple(PF.PackField(f.offset, f.stride, f.bits)
                             for f in p.fields))


def port_expr(e):
    """A reference device expression (column refs, literals, function
    calls) as the port's."""
    if isinstance(e, JE.InputRef):
        return PE.InputRef(e.index, port_dtype(e.return_type))
    if isinstance(e, JE.Literal):
        return PE.Literal(e.value, port_dtype(e.return_type))
    if isinstance(e, JE.FunctionCall):
        return build_device(e.name, [port_expr(a) for a in e.args])
    raise TypeError(f"no port of {type(e).__name__}")
