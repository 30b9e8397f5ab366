"""The port's fused device pipeline (datagen -> hash agg -> MV, on the
CPU) against the JAX package's: the reference's own device-MV cases
(tests/test_device_mv.py) fed to both packages, and `bid_agg_epoch`
after several epochs leaf by leaf — agg state, MV state, key and
max_needed — with no tolerance."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import risingwave_tpu.device as J
import risingwave_tpu.device.agg_step as JA
import risingwave_tpu.device.materialize as JM
import risingwave_tpu.device.pipeline as JP
import risingwave_tpu_torch.device.agg_step as PA
import risingwave_tpu_torch.device.materialize as PM
import risingwave_tpu_torch.device.pipeline as PP
import risingwave_tpu_torch.device.sorted_state as P
from risingwave_tpu_torch.device.datagen import gen_bids, prng_key
from risingwave_tpu_torch.device.state_io import (_sorted_from, _sorted_to,
                                                  key_from_numpy,
                                                  key_to_numpy)
from torch_parity import EMPTY, assert_same

Q4_CALLS = ["count_star", "sum", "max"]


def specs():
    return (JA.DeviceAggSpec.build(Q4_CALLS, [np.int64] * 3),
            PA.DeviceAggSpec.build(Q4_CALLS, [np.int64] * 3))


def tc(a):
    return torch.from_numpy(np.array(a))


def test_batch_reduce_replace_last_wins():
    keys = [7, 7, 9, 7, 9]
    mask = [True, True, True, True, False]
    vals = [10, 20, 30, 40, 50]
    ref = J.batch_reduce(jnp.asarray(keys, jnp.int64), jnp.asarray(mask),
                         [jnp.asarray(vals, jnp.int64)],
                         [J.ReduceKind.REPLACE])
    uk, uv, uc = P.batch_reduce(tc(np.array(keys, np.int64)),
                                tc(np.array(mask)),
                                [tc(np.array(vals, np.int64))],
                                [P.ReduceKind.REPLACE])
    assert_same((uk, uv, uc), ref)
    got = {int(k): int(v) for k, v in zip(uk.tolist(), uv[0].tolist())
           if k != EMPTY}
    assert got == {7: 40, 9: 30}  # arrival order wins, masked row ignored


def test_merge_replace_overwrites_state():
    dk = np.array([1, 2, EMPTY, EMPTY], np.int64)
    rounds = [np.array([100, 200, 0, 0], np.int64),
              np.array([111, 0, 0, 0], np.int64)]
    jst = J.make_state(8, [jnp.int64], [J.ReduceKind.REPLACE])
    pst = P.make_state(8, [torch.int64], [P.ReduceKind.REPLACE], "cpu")
    for dv in rounds:
        jst, jneed = J.merge(jst, jnp.asarray(dk), [jnp.asarray(dv)],
                             [J.ReduceKind.REPLACE], drop_dead=False)
        pst, pneed = P.merge(pst, tc(dk), [tc(dv)], [P.ReduceKind.REPLACE],
                             drop_dead=False)
        assert_same((pst, pneed), (jst, jneed))
    n = int(pst.count)
    got = dict(zip(pst.keys[:n].tolist(), pst.vals[0][:n].tolist()))
    assert got[1] == 111 and got[2] == 0


def test_mv_upsert_delete():
    keys = np.array([5, 6, EMPTY], np.int64)
    nulls = [np.zeros(3, bool)]
    steps = [(np.array([True, True, False]), np.zeros(3, bool),
              np.array([50, 60, 0], np.int64), [5, 6], [50, 60]),
             # delete 5, update 6
             (np.array([False, True, False]), np.array([True, False, False]),
              np.array([0, 66, 0], np.int64), [6], [66])]
    jmv = JM.make_mv_state(8, [jnp.int64])
    pmv = PM.make_mv_state(8, [torch.int64], "cpu")
    for ups, dels, col, want_k, want_c in steps:
        jmv, jneed = JM.mv_apply_changes(jmv, jnp.asarray(keys),
                                         jnp.asarray(ups), jnp.asarray(dels),
                                         [jnp.asarray(col)],
                                         [jnp.asarray(nulls[0])])
        pmv, pneed = PM.mv_apply_changes(pmv, tc(keys), tc(ups), tc(dels),
                                         [tc(col)], [tc(nulls[0])])
        assert_same((pmv, pneed), (jmv, jneed))
        k, c, _ = PM.mv_rows(pmv, [torch.int64])
        assert list(k) == want_k and list(c[0]) == want_c


def test_fused_pipeline_matches_host_recompute():
    jspec, pspec = specs()
    jagg, jmv = JP.make_bid_pipeline(jspec, 1024)
    agg, mv = PP.make_bid_pipeline(pspec, 1024, "cpu")
    jrng, rng = jax.random.PRNGKey(3), prng_key(3, "cpu")
    jmn = jnp.zeros((), jnp.int32)
    mn = torch.zeros((), dtype=torch.int32)
    for _ in range(3):
        jagg, jmv, jrng, jmn = JP.bid_agg_epoch(jspec, 2048, 300, jagg, jmv,
                                                jrng, jmn)
        agg, mv, rng, mn = PP.bid_agg_epoch(pspec, 2048, 300, agg, mv, rng,
                                            mn)
    assert_same((agg, mv, mn), (jagg, jmv, jmn))
    assert np.array_equal(key_to_numpy(rng), np.asarray(jrng))
    assert int(mn) <= 1024
    # replay the generator on the host
    rng = prng_key(3, "cpu")
    cnt, tot, mx = {}, {}, {}
    for _ in range(3):
        a, p, rng = gen_bids(rng, 2048, 300)
        for key, price in zip(a.tolist(), p.tolist()):
            cnt[key] = cnt.get(key, 0) + 1
            tot[key] = tot.get(key, 0) + price
            mx[key] = max(mx.get(key, 0), price)
    keys, cols, _ = PM.mv_rows(mv, [c.acc_dtype for c in pspec.calls])
    assert len(keys) == len(cnt)
    for i, key in enumerate(keys.tolist()):
        assert (cols[0][i], cols[1][i], cols[2][i]) == \
               (cnt[key], tot[key], mx[key])


def run_both(jspec, pspec, n, n_auctions, capacity, epochs, seed,
             start=None):
    """`epochs` epochs in both packages from empty states (or `start`:
    the reference's states, key and max_needed, carried into the port)."""
    if start is None:
        jagg, jmv = JP.make_bid_pipeline(jspec, capacity)
        jrng, jmn = jax.random.PRNGKey(seed), jnp.zeros((), jnp.int32)
        agg, mv = PP.make_bid_pipeline(pspec, capacity, "cpu")
        rng, mn = prng_key(seed, "cpu"), torch.zeros((), dtype=torch.int32)
    else:
        jagg, jmv, jrng, jmn = start
        host = jax.device_get(start)
        agg, mv = (_sorted_from(st, torch.device("cpu")) for st in host[:2])
        rng = key_from_numpy(host[2], "cpu")
        mn = torch.from_numpy(np.array(host[3]))
    for _ in range(epochs):
        jagg, jmv, jrng, jmn = JP.bid_agg_epoch(jspec, n, n_auctions, jagg,
                                                jmv, jrng, jmn)
        agg, mv, rng, mn = PP.bid_agg_epoch(pspec, n, n_auctions, agg, mv,
                                            rng, mn)
    return (jagg, jmv, jrng, jmn), (agg, mv, rng, mn)


@pytest.mark.parametrize("epochs", (3, 8))
@pytest.mark.parametrize("n,n_auctions,capacity",
                         [(2048, 300, 1024), (65_536, 10_000, 1 << 14)])
def test_bid_agg_epoch_matches_reference(n, n_auctions, capacity, epochs):
    jspec, pspec = specs()
    ref, port = run_both(jspec, pspec, n, n_auctions, capacity, epochs, 42)
    jagg, jmv, jrng, jmn = ref
    agg, mv, rng, mn = port
    assert_same(agg, jagg)
    assert_same(mv, jmv)
    assert_same(mn, jmn)
    got = key_to_numpy(rng)
    assert got.dtype == np.uint32 and np.array_equal(got, np.asarray(jrng))
    assert int(mn) <= capacity
    assert int(agg.count) == int(mv.count) > 0


def test_carry_across_mid_stream():
    """Three epochs in the reference, its states and key carried into the
    port (`_sorted_from`, `key_from_numpy`), three more in each: equal,
    and back again (`_sorted_to`, `key_to_numpy`)."""
    jspec, pspec = specs()
    jagg, jmv = JP.make_bid_pipeline(jspec, 1 << 12)
    jrng, jmn = jax.random.PRNGKey((1 << 33) + 7), jnp.zeros((), jnp.int32)
    for _ in range(3):
        jagg, jmv, jrng, jmn = JP.bid_agg_epoch(jspec, 4096, 2000, jagg, jmv,
                                                jrng, jmn)
    ref, port = run_both(jspec, pspec, 4096, 2000, 1 << 12, 3, None,
                         start=(jagg, jmv, jrng, jmn))
    assert_same(port[:2] + port[3:], ref[:2] + ref[3:])
    back = (_sorted_to(port[0]), _sorted_to(port[1]), key_to_numpy(port[2]))
    want = jax.device_get(ref[:3])
    assert_same(back[:2], want[:2])
    assert back[2].dtype == np.uint32 and np.array_equal(back[2], want[2])


def test_key_converters():
    for seed in (0, 42, (1 << 33) + 7):
        jk = np.asarray(jax.random.PRNGKey(seed))
        pk = key_from_numpy(jk, "cpu")
        assert pk.dtype == torch.int64
        assert torch.equal(pk, prng_key(seed, "cpu"))
        assert np.array_equal(key_to_numpy(pk), jk)
    with pytest.raises(ValueError):
        key_from_numpy(np.zeros(2, np.int64), "cpu")


def test_capture_needs_a_cuda_device():
    _, pspec = specs()
    with pytest.raises(ValueError):
        PP.capture_bid_epoch(pspec, 2048, 300, 1024, "cpu")
