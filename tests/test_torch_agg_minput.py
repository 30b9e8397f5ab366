"""The port's agg epoch step with retractable min/max multisets
(`epoch_core_full`, plain kernels on the CPU) against the JAX package's,
over several epochs of inserts and retractions: min(x) and max(x) share
one multiset (`arg_ids`), x is a float column carried order-encoded
(`order_encode_f64`), max(y) has a multiset of its own. Every leaf and
dtype of the state, the capacity needs and the change set is equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import risingwave_tpu.device.agg_step as JA
import risingwave_tpu.device.minput as JMS
import risingwave_tpu.device.sorted_state as JS
import risingwave_tpu_torch.device.agg_step as PA
import risingwave_tpu_torch.device.minput as PMS
import risingwave_tpu_torch.device.sorted_state as PS
from torch_parity import assert_same

KINDS = ["count_star", "min", "max", "max", "sum"]
DTYPES = [np.int64, np.float64, np.float64, np.int64, np.int64]
ARG_IDS = [("call", 0), ("ref", 1), ("ref", 1), ("ref", 2), ("ref", 3)]


def specs():
    return (JA.DeviceAggSpec.build(KINDS, DTYPES, append_only=False,
                                   arg_ids=ARG_IDS),
            PA.DeviceAggSpec.build(KINDS, DTYPES, append_only=False,
                                   arg_ids=ARG_IDS))


def test_spec_shares_one_multiset_per_column():
    sj, sp = specs()
    assert len(sp.minputs) == len(sj.minputs) == 2
    assert [(c.kind, c.cols, c.minput) for c in sp.calls] \
        == [(c.kind, c.cols, c.minput) for c in sj.calls]
    assert [int(k) for k in sp.kinds] == [int(k) for k in sj.kinds]
    assert not sp.append_only


def epochs(seed, n_epochs, rows_per, groups):
    """Epoch batches of (keys, signs, mask, x, y, z): inserts of new rows
    and retractions of rows inserted earlier (same values), with masked
    rows mixed in."""
    rng = np.random.default_rng(seed)
    live = []
    out = []
    for _ in range(n_epochs):
        n_del = min(len(live), rows_per // 3)
        dels = [live.pop(rng.integers(len(live))) for _ in range(n_del)]
        ins = [(int(rng.integers(0, groups)),
                float(np.round(rng.normal(0, 50), 1)),
                int(rng.integers(-20, 20)), int(rng.integers(-9, 9)))
               for _ in range(rows_per - n_del)]
        batch = [(r, -1) for r in dels] + [(r, 1) for r in ins]
        batch = [batch[i] for i in rng.permutation(len(batch))]
        mask = rng.random(len(batch)) < 0.95
        # a masked row never reaches the state: a masked insert stays out
        # of `live`, a masked retraction leaves its row live
        live += [r for (r, sg), m in zip(batch, mask) if (sg > 0) == m]
        keys = np.array([r[0] for r, _ in batch], np.int64)
        signs = np.array([sg for _, sg in batch], np.int32)
        x = np.array([r[1] for r, _ in batch], np.float64)
        y = np.array([r[2] for r, _ in batch], np.int64)
        z = np.array([r[3] for r, _ in batch], np.int64)
        out.append((keys, signs, mask, x, y, z))
    return out


def inputs(x, y, z, valid):
    enc = JMS.order_encode_f64(x)
    np.testing.assert_array_equal(enc, PMS.order_encode_f64(x))
    zero = np.zeros_like(enc)
    cols = [zero, enc, enc, y, z]
    return ([(jnp.asarray(c), jnp.asarray(valid)) for c in cols],
            [(torch.from_numpy(c), torch.from_numpy(valid)) for c in cols])


@pytest.mark.parametrize("cap,ms_cap", [(64, 256), (8, 16)])
def test_epoch_core_full_with_minputs(cap, ms_cap):
    sj, sp = specs()
    js = JA.DeviceAggState(sj.make_state(cap),
                           tuple(JMS.ms_make(ms_cap) for _ in sj.minputs))
    ps = PA.DeviceAggState(sp.make_state(cap, "cpu"),
                           tuple(PMS.ms_make(ms_cap, "cpu")
                                 for _ in sp.minputs))
    grew = False
    for keys, signs, mask, x, y, z in epochs(cap + ms_cap, 5, 40, 12):
        valid = y % 7 != 0           # NULL arguments, a property of the row
        jin, pin = inputs(x, y, z, valid)
        jout = JA.epoch_core_full(sj, js, jnp.asarray(keys),
                                  jnp.asarray(signs), jnp.asarray(mask),
                                  tuple(jin))
        pout = PA.epoch_core_full(sp, ps, torch.from_numpy(keys),
                                  torch.from_numpy(signs),
                                  torch.from_numpy(mask), tuple(pin))
        assert_same(pout, jout)
        js, (need, ms_need), _ = jout
        ps = pout[0]
        assert set(pout[2]) >= {"minput0", "minput1"}
        # grow like the host does when a need passes a capacity (both
        # packages, the same way), then go on from the grown state
        main = ps.main
        if int(need) > main.capacity:
            c = 2 * int(need)
            js = js._replace(main=JS.grow_state(js.main, c, sj.kinds))
            ps = ps._replace(main=PS.grow_state(main, c, sp.kinds))
            grew = True
        for i, nd in enumerate(ms_need):
            if int(nd) > ps.minputs[i].capacity:
                c = 2 * int(nd)
                js = js._replace(minputs=js.minputs[:i] + (
                    JMS.ms_grow(js.minputs[i], c),) + js.minputs[i + 1:])
                ps = ps._replace(minputs=ps.minputs[:i] + (
                    PMS.ms_grow(ps.minputs[i], c),) + ps.minputs[i + 1:])
                grew = True
    assert grew == (cap == 8)


def test_local_epoch_step_is_epoch_core_full():
    sj, sp = specs()
    keys, signs, mask, x, y, z = epochs(1, 1, 30, 5)[0]
    jin, pin = inputs(x, y, z, np.ones(len(keys), bool))
    js = JA.DeviceAggState(sj.make_state(32),
                           tuple(JMS.ms_make(64) for _ in sj.minputs))
    ps = PA.DeviceAggState(sp.make_state(32, "cpu"),
                           tuple(PMS.ms_make(64, "cpu") for _ in sp.minputs))
    want = JA.local_epoch_step(sj, js, jnp.asarray(keys), jnp.asarray(signs),
                               jnp.asarray(mask), tuple(jin))
    got = PA.local_epoch_step(sp, ps, torch.from_numpy(keys),
                              torch.from_numpy(signs),
                              torch.from_numpy(mask), tuple(pin))
    assert_same(got, want)
