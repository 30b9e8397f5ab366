"""The port's agg and MV epoch steps (on the CPU) against the JAX
package's, leaf by leaf and dtype by dtype."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import risingwave_tpu.device.agg_step as JA
import risingwave_tpu.device.materialize as JM
import risingwave_tpu.device.sorted_state as J
import risingwave_tpu_torch.device.agg_step as PA
import risingwave_tpu_torch.device.materialize as PM
from torch_parity import EMPTY, assert_same

# q4's calls, and a float/avg/min mix for the raw (not pre-combined) path
SPECS = {
    "q4": (["count_star", "sum", "max"], [np.int64] * 3),
    "mixed": (["count", "sum", "avg", "min", "max"],
              [np.int64, np.float64, np.float64, np.int64, np.float64]),
}


def specs(name):
    kinds, dts = SPECS[name]
    return (JA.DeviceAggSpec.build(kinds, dts, append_only=True),
            PA.DeviceAggSpec.build(kinds, dts, append_only=True))


def rows(rng, name, n, keyspace):
    """(keys, signs, mask, inputs) as numpy: append-only rows."""
    keys = rng.integers(0, keyspace, n).astype(np.int64)
    signs = np.ones(n, np.int32)
    mask = rng.random(n) < 0.9
    _, dts = SPECS[name]
    inputs = []
    for dt in dts:
        v = rng.normal(100, 50, n) if dt == np.float64 \
            else rng.integers(100, 10_100, n).astype(np.int64)
        inputs.append((v, rng.random(n) < 0.95))
    return keys, signs, mask, inputs


def jx(a):
    return jnp.asarray(a)


def tc(a):
    return torch.from_numpy(np.array(a))


# the reference steps jitted whole (one XLA compile per shape instead of
# one per eager op) — the same functions the JAX package runs in-program
_J_EPOCH = jax.jit(JA.epoch_core, static_argnums=0)
_J_PRE = jax.jit(JA.precombine_core, static_argnums=0)
_J_COMBINED = jax.jit(JA.epoch_core_combined, static_argnums=0)
_J_MV = jax.jit(JM.mv_apply_changes)


def state_from(spec_j, spec_p, cap, rng, name):
    """One epoch of rows through both packages from empty states: the
    starting state of the tests below."""
    js = spec_j.make_state(cap)
    ps = spec_p.make_state(cap, "cpu")
    k, s, m, ins = rows(rng, name, 300, 120)
    js, _, _ = _J_EPOCH(spec_j, js, jx(k), jx(s), jx(m),
                        tuple((jx(v), jx(ok)) for v, ok in ins))
    ps, _, _ = PA.epoch_core(spec_p, ps, tc(k), tc(s), tc(m),
                             tuple((tc(v), tc(ok)) for v, ok in ins))
    return js, ps


@pytest.mark.parametrize("name,cap", [("q4", 256), ("mixed", 256),
                                      ("q4", 64)])
def test_epoch_core(name, cap):
    rng = np.random.default_rng(cap)
    sj, sp = specs(name)
    js, ps = state_from(sj, sp, cap, rng, name)
    assert_same(ps, js, float_rtol=1e-12)
    k, s, m, ins = rows(rng, name, 400, 200)
    ref = _J_EPOCH(sj, js, jx(k), jx(s), jx(m),
                   tuple((jx(v), jx(ok)) for v, ok in ins))
    got = PA.epoch_core(sp, ps, tc(k), tc(s), tc(m),
                        tuple((tc(v), tc(ok)) for v, ok in ins))
    if cap == 64:
        assert int(ref[1]) > cap          # the merge overflowed
    assert_same(got, ref, float_rtol=1e-12)


@pytest.mark.parametrize("n,keyspace", [(500, 60), (1, 5), (300, 1)])
def test_precombine_core(n, keyspace):
    rng = np.random.default_rng(n)
    sj, sp = specs("q4")
    k, s, m, ins = rows(rng, "q4", n, keyspace)
    ref = _J_PRE(sj, jx(k), jx(s), jx(m),
                 tuple((jx(v), jx(ok)) for v, ok in ins))
    got = PA.precombine_core(sp, tc(k), tc(s), tc(m),
                             tuple((tc(v), tc(ok)) for v, ok in ins))
    assert_same(got, ref)


@pytest.mark.parametrize("cap", [256, 64])
def test_epoch_core_combined(cap):
    rng = np.random.default_rng(cap + 1)
    sj, sp = specs("q4")
    js, ps = state_from(sj, sp, cap, rng, "q4")
    k, s, m, ins = rows(rng, "q4", 500, 200)
    uk, ucnt, ud = _J_PRE(
        sj, jx(k), jx(s), jx(m), tuple((jx(v), jx(ok)) for v, ok in ins))
    live = uk != J.EMPTY_KEY
    ref = _J_COMBINED(sj, js, uk, ucnt, list(ud), live)
    got = PA.epoch_core_combined(sp, ps, tc(uk), tc(ucnt),
                                 [tc(d) for d in ud], tc(live))
    assert_same(got, ref)


@pytest.mark.parametrize("case", ["upserts", "deletes_and_noops", "overflow"])
def test_mv_apply_changes(case):
    rng = np.random.default_rng(len(case))
    cap, b = (64, 128) if case == "overflow" else (256, 128)
    dts_j, dts_p = [jnp.int64, jnp.float64], [torch.int64, torch.float64]
    js, ps = JM.make_mv_state(cap, dts_j), PM.make_mv_state(cap, dts_p,
                                                             "cpu")
    # a first change set inserts some groups; the second updates, deletes
    # and (with neither flag) skips some of them
    for step in range(2):
        keys = np.full(b, EMPTY, np.int64)
        uk = np.unique(rng.integers(0, 150, 90))
        keys[:len(uk)] = uk
        live = keys != EMPTY
        upsert = live & (rng.random(b) < (1.0 if step == 0 else 0.6))
        delete = live & ~upsert & (rng.random(b) < 0.5) \
            if case != "upserts" else np.zeros(b, bool)
        if case == "upserts":
            upsert = live.copy()
        cols = [rng.integers(0, 1000, b).astype(np.int64),
                rng.normal(0, 10, b)]
        nulls = [rng.random(b) < 0.1, rng.random(b) < 0.1]
        js, nj = _J_MV(js, jx(keys), jx(upsert), jx(delete),
                       [jx(c) for c in cols], [jx(x) for x in nulls])
        ps, np_ = PM.mv_apply_changes(ps, tc(keys), tc(upsert), tc(delete),
                                      [tc(c) for c in cols],
                                      [tc(x) for x in nulls])
        assert_same((ps, np_), (js, nj))
    if case == "overflow":
        assert int(nj) > cap
    jrows = JM.mv_rows(js, dts_j)
    prows = PM.mv_rows(ps, dts_p)
    assert_same(prows, jrows)


def test_build_rejects_retractable_minmax():
    """Retractable min/max now builds (a multiset side state, as in the
    reference); what has no device path is still rejected."""
    with pytest.raises(ValueError, match="no device path"):
        PA.DeviceAggSpec.build(["stddev_pop"], [np.int64],
                               append_only=False)
    sp = PA.DeviceAggSpec.build(["max"], [np.int64], append_only=False)
    sj = JA.DeviceAggSpec.build(["max"], [np.int64], append_only=False)
    assert [(c.kind, c.cols, c.minput) for c in sp.calls] \
        == [(c.kind, c.cols, c.minput) for c in sj.calls]
    assert [m.call_idx for m in sp.minputs] == \
        [m.call_idx for m in sj.minputs]
    # everything else builds the reference's layout
    for name in SPECS:
        sj, sp = specs(name)
        assert [int(k) for k in sp.kinds] == [int(k) for k in sj.kinds]
        assert [torch.empty(0, dtype=d).numpy().dtype for d in sp.dtypes] \
            == [np.dtype(d) for d in sj.dtypes]
        assert [(c.kind, c.cols) for c in sp.calls] \
            == [(c.kind, c.cols) for c in sj.calls]
