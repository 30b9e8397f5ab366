"""The per-operator agg step of the port against the JAX package: the
packed epoch step (`agg_epoch_step_packed`, its flags unpacked by
`agg_unpack`), the change-set pull (`_pull_changes`) and the host engine
(`DeviceHashAgg`: buffering, growth with replay, recovery installs).

The same seeded numpy inputs go to both packages; every output leaf must
be equal, dtype included. Float leaves too: the port's float SUM adds in
a fixed order, so no tolerance is needed (none is used)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import risingwave_tpu.device.agg_step as JA
import risingwave_tpu.device.sorted_state as JS
import risingwave_tpu_torch.device.agg_step as PA
import risingwave_tpu_torch.device.sorted_state as PS
from risingwave_tpu_torch.kernels import agg_unpack, agg_unpack_plain
from torch_parity import assert_same

EMPTY = int(JS.EMPTY_KEY)
MIXED = (["count_star", "sum", "avg", "min", "max", "count", "max"],
         [np.int64, np.float64, np.int64, np.float64, np.float64, np.int64,
          np.int64])
# min and max of column 1 share one multiset; max of column 6 has its own
MIXED_ARGS = [("call", 0), ("ref", 1), ("ref", 2), ("ref", 1), ("ref", 1),
              ("ref", 5), ("ref", 6)]


def specs(kinds, dtypes, append_only, arg_ids=None):
    return (JA.DeviceAggSpec.build(kinds, dtypes, append_only, arg_ids),
            PA.DeviceAggSpec.build(kinds, dtypes, append_only, arg_ids))


def call_inputs(rng, spec, n):
    """Per call (values, valid): floats for float calls, order-encoded
    int64 for minput calls (as the executor ships them)."""
    from risingwave_tpu_torch.device.minput import order_encode_f64
    out = []
    for c in spec.calls:
        valid = rng.random(n) > 0.15
        if c.acc_dtype.is_floating_point:
            v = np.round(rng.normal(0, 100, n), 3)
            if c.minput is not None:
                v = order_encode_f64(v)
        else:
            v = rng.integers(-1000, 1000, n).astype(np.int64)
        out.append((np.where(valid, v, 0).astype(v.dtype), valid))
    return out


def pack(spec, keys, signs, ins, b):
    """The host's two matrices, as `DeviceHashAgg.flush_epoch` packs them."""
    n = len(keys)
    p64 = np.zeros((1 + len(spec.calls), b), np.int64)
    p8 = np.zeros((2 + len(spec.calls), b), np.int8)
    p64[0, :n], p8[0, :n], p8[1, :n] = keys, signs, 1
    for i, (v, m) in enumerate(ins):
        av = PA._acc_cast(v)
        p64[1 + i, :n] = av.view(np.int64) if av.dtype == np.float64 \
            else av
        p8[2 + i, :n] = m
    return p64, p8


def both_states(jspec, pspec, cap):
    js = JA.DeviceAggState(jspec.make_state(cap),
                           tuple(JA.ms_make(cap) for _ in jspec.minputs))
    from risingwave_tpu_torch.device.minput import ms_make
    ps = PA.DeviceAggState(pspec.make_state(cap, "cpu"),
                           tuple(ms_make(cap, "cpu") for _ in pspec.minputs))
    return js, ps


@pytest.mark.parametrize("append_only", [False, True])
def test_packed_step_matches_reference(append_only):
    """Three epochs through the packed step, the state carried: inserts,
    then mixed signs (-1, 0, +1) over the same keys; masked rows among
    the live ones and in the padded tail; int, float and (retractable)
    minput calls, min and max of one column sharing a multiset."""
    rng = np.random.default_rng(12)
    kinds, dts = MIXED
    jspec, pspec = specs(kinds, dts, append_only, MIXED_ARGS)
    assert len(pspec.minputs) == (0 if append_only else 2)
    js, ps = both_states(jspec, pspec, 256)
    for epoch in range(3):
        n = 700
        keys = rng.integers(0, 90, n).astype(np.int64)
        signs = np.ones(n, np.int32) if append_only or epoch == 0 else \
            rng.choice([-1, 0, 1], n).astype(np.int32)
        ins = call_inputs(rng, pspec, n)
        p64, p8 = pack(pspec, keys, signs, ins, 1024)
        p8[1, :n] = rng.random(n) > 0.1          # masked rows inside too
        jout = JA.agg_epoch_step_packed(jspec, js, jnp.asarray(p64),
                                        jnp.asarray(p8))
        pout = PA.agg_epoch_step_packed(pspec, ps, torch.from_numpy(p64),
                                        torch.from_numpy(p8))
        assert_same(pout[1:], jout[1:])
        assert_same(pout[0], jout[0])
        js, ps = jout[0], pout[0]


def test_full_and_plain_steps_match_reference():
    """`agg_epoch_step_full` (raw tensors, multisets) and `agg_epoch_step`
    (main state only) against the reference's jitted steps."""
    rng = np.random.default_rng(5)
    jspec, pspec = specs(["count_star", "max", "avg"],
                         [np.int64, np.int64, np.float64], False)
    js, ps = both_states(jspec, pspec, 128)
    n = 300
    keys = rng.integers(0, 40, n).astype(np.int64)
    signs = np.ones(n, np.int32)
    mask = rng.random(n) > 0.1
    ins = call_inputs(rng, pspec, n)
    jins = tuple((jnp.asarray(v), jnp.asarray(m)) for v, m in ins)
    pins = tuple((torch.from_numpy(v), torch.from_numpy(m)) for v, m in ins)
    jout = JA.agg_epoch_step_full(jspec, js, jnp.asarray(keys),
                                  jnp.asarray(signs), jnp.asarray(mask), jins)
    pout = PA.agg_epoch_step_full(pspec, ps, torch.from_numpy(keys),
                                  torch.from_numpy(signs),
                                  torch.from_numpy(mask), pins)
    assert_same(pout, jout)
    ajspec, apspec = specs(["count_star", "sum"], [np.int64, np.float64],
                           True)
    jst, pst = ajspec.make_state(64), apspec.make_state(64, "cpu")
    jins, pins = jins[:2], pins[:2]
    assert_same(PA.agg_epoch_step(apspec, pst, torch.from_numpy(keys),
                                  torch.from_numpy(signs),
                                  torch.from_numpy(mask), pins),
                JA.agg_epoch_step(ajspec, jst, jnp.asarray(keys),
                                  jnp.asarray(signs), jnp.asarray(mask),
                                  jins))


@pytest.mark.parametrize("count", [100, 256, 300])
@pytest.mark.parametrize("formatted", [True, False])
def test_pull_changes_matches_reference(count, formatted):
    """Change sets cut to their live pow2 head: `count` unique keys among
    B = 1024 rows, below, at and above lo = 256, minput heads included."""
    rng = np.random.default_rng(count)
    jspec, pspec = specs(["count_star", "min", "sum"],
                         [np.int64, np.int64, np.float64], False)
    js, ps = both_states(jspec, pspec, 2048)
    b = 1024
    keys = rng.permutation(np.resize(np.arange(count) * 7 + 3, b))
    keys = keys.astype(np.int64)
    signs = np.ones(b, np.int32)
    ins = call_inputs(rng, pspec, b)
    p64, p8 = pack(pspec, keys, signs, ins, b)
    *_, jch = JA.agg_epoch_step_packed(jspec, js, jnp.asarray(p64),
                                       jnp.asarray(p8))
    *_, pch = PA.agg_epoch_step_packed(pspec, ps, torch.from_numpy(p64),
                                       torch.from_numpy(p8))
    jp = JA._pull_changes(jch, formatted, count=count)
    pp = PA._pull_changes(pch, formatted, count=count)
    assert_same(pp, jp)
    assert all(isinstance(x, np.ndarray) for x in
               [pp["keys"], pp["count"], *pp["new_vals"]])
    assert pp["keys"].shape[0] == max(256, 1 << (count - 1).bit_length())
    # the count read back from the change set when none is given
    assert_same(PA._pull_changes(pch, formatted),
                JA._pull_changes(jch, formatted))


def engines(kinds, dtypes, capacity, append_only=True, arg_ids=None,
            pull_formatted=True):
    jspec, pspec = specs(kinds, dtypes, append_only, arg_ids)
    return (JA.DeviceHashAgg(jspec, capacity, pull_formatted),
            PA.DeviceHashAgg(pspec, capacity, pull_formatted,
                             device="cpu"))


def flush_both(ja, pa):
    jch, pch = ja.flush_epoch(), pa.flush_epoch()
    if jch is None:
        assert pch is None
        return None
    assert_same(pch, jch)
    assert_same(pa.state, ja.state)
    assert_same(pa.minputs, ja.minputs)
    return pch


def random_parity_run(seed, kinds, n_epochs=6, rows=200, keyspace=17,
                      append_only=True):
    """`random_oracle_run` of the reference's tests/test_device_state.py,
    fed to both engines: every flush's change set and state compared."""
    rng = np.random.default_rng(seed)
    ja, pa = engines(kinds, [np.int64] * len(kinds), 8, append_only)
    live = {}
    for _ in range(n_epochs):
        keys = rng.integers(0, keyspace, size=rows).astype(np.int64)
        vals = rng.integers(-50, 50, size=rows).astype(np.int64)
        valid = rng.random(rows) > 0.1
        if append_only and any(k in ("min", "max") for k in kinds):
            signs = np.ones(rows, dtype=np.int32)
        else:
            signs = np.where(rng.random(rows) > 0.3, 1, -1).astype(np.int32)
            for i in range(rows):
                k = int(keys[i])
                if signs[i] < 0 and live.get(k, 0) <= 0:
                    signs[i] = 1
                live[k] = live.get(k, 0) + int(signs[i])
        for a in (ja, pa):
            a.push_rows(keys, signs, [(vals, valid) for _ in kinds])
        ch = flush_both(ja, pa)
        assert ch is not None
    assert pa.state.capacity > 8          # it grew, as the reference did
    assert pa.growth_replays >= 1


def test_agg_retractable_matches_reference():
    random_parity_run(1, ["count_star", "sum", "count", "avg"])


def test_agg_append_only_minmax_matches_reference():
    random_parity_run(2, ["min", "max", "sum"])


def test_agg_retractable_minmax_matches_reference():
    """min / max through the multisets (append_only=False), retractions
    included."""
    random_parity_run(4, ["min", "max", "count_star"], append_only=False)


def test_capacity_growth_matches_reference():
    ja, pa = engines(["sum"], [np.int64], 8)
    keys = np.arange(1000, dtype=np.int64)
    for a in (ja, pa):
        a.push_rows(keys, np.ones(1000, dtype=np.int32),
                    [(keys * 2, np.ones(1000, dtype=bool))])
    ch = flush_both(ja, pa)
    assert int(ch["count"]) == 1000
    assert pa.state.capacity >= 1000 and int(pa.state.count) == 1000


def test_merge_overflow_reports_needed_matches_reference():
    """The reference's `test_merge_overflow_reports_needed` on both
    packages' `merge`, then the engine that grows past it."""
    jst = JS.make_state(4, [jnp.int64], [JS.ReduceKind.SUM])
    pst = PS.make_state(4, [torch.int64], [PS.ReduceKind.SUM], "cpu")
    dk = np.arange(1, 7, dtype=np.int64)
    jst, jneed = JS.merge(jst, jnp.asarray(dk), [jnp.ones(6, jnp.int64)],
                          [JS.ReduceKind.SUM])
    pst, pneed = PS.merge(pst, torch.from_numpy(dk),
                          [torch.ones(6, dtype=torch.int64)],
                          [PS.ReduceKind.SUM])
    assert int(pneed) == int(jneed) == 6
    assert_same((pst, pneed), (jst, jneed))
    ja, pa = engines(["count_star"], [np.int64], 4)
    for a in (ja, pa):
        a.push_rows(dk, np.ones(6, np.int32), [(dk, np.ones(6, bool))])
    flush_both(ja, pa)
    assert pa.growth_replays == 1 and int(pa.state.count) == 6


def test_key_at_sentinel_not_lost():
    """The reference's test_advice_fixes.py `test_device_agg_key_at_
    sentinel_not_lost`: an int64-max key is remapped, not dropped."""
    ja, pa = engines(["count_star"], [np.int64], 16)
    keys = np.array([np.iinfo(np.int64).max, 5], dtype=np.int64)
    for a in (ja, pa):
        a.push_rows(keys, np.ones(2, np.int32),
                    [(np.ones(2, np.int64), np.ones(2, bool))])
    ch = flush_both(ja, pa)
    assert int(ch["count"]) == 2


def test_empty_flush_is_none():
    ja, pa = engines(["count_star"], [np.int64], 16)
    assert flush_both(ja, pa) is None


def test_load_and_live_round_trips():
    """Recovery installs (`load_state`, `load_minput`) and the host pulls
    of state cleaning (`live_main`, `live_minput`) on both packages, then
    an epoch on the installed state; the SQL executor's pull (formatted
    entries dropped)."""
    rng = np.random.default_rng(9)
    ja, pa = engines(["count_star", "max", "sum"],
                     [np.int64, np.int64, np.float64], 64, False,
                     pull_formatted=False)
    n = 300                              # grows the 64-slot state on load
    keys = rng.choice(np.arange(-500, 500), n, replace=False)
    keys = np.concatenate([keys[:-1], [np.iinfo(np.int64).max]])
    # row_count, count(*), max's valid count, sum, sum's valid count
    vals = [rng.integers(1, 5, n), rng.integers(1, 5, n),
            rng.integers(1, 5, n), np.round(rng.normal(0, 10, n), 2),
            rng.integers(1, 5, n)]
    vals = [v.astype(np.float64 if v.dtype.kind == "f" else np.int64)
            for v in vals]
    k1 = np.repeat(keys[:50], 3)
    k2 = rng.integers(-(2 ** 62), 2 ** 62, 150)
    k2[0] = np.iinfo(np.int64).max      # a value at the sentinel stays
    cnt = rng.integers(1, 4, 150)
    for a in (ja, pa):
        a.load_state(keys, vals)
        a.load_minput(0, k1, k2, cnt)
    assert_same(pa.state, ja.state)
    assert_same(pa.minputs, ja.minputs)
    assert_same(pa.live_main(), ja.live_main())
    assert_same(pa.live_minput(0), ja.live_minput(0))
    q = np.concatenate([keys[:40], rng.integers(600, 700, 40)])
    for a in (ja, pa):
        a.push_rows(q, np.ones(len(q), np.int32),
                    [(np.full(len(q), 3, np.int64), np.ones(len(q), bool)),
                     (np.arange(len(q), dtype=np.int64),
                      np.ones(len(q), bool)),
                     (np.full(len(q), 0.5), np.ones(len(q), bool))])
    ch = flush_both(ja, pa)
    assert "new_out" not in ch


def test_device_none_needs_a_gpu():
    """With no device given, the engine runs on cuda:0 or raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is cuda:0")
    spec = PA.DeviceAggSpec.build(["count_star"], [np.int64])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PA.DeviceHashAgg(spec)


@pytest.mark.parametrize("n_calls", [0, 1, 3, 6])
@pytest.mark.parametrize("b", [1, 3, 4, 257, 1024])
def test_agg_unpack_plain_matches_reference(n_calls, b):
    """`agg_unpack_plain` against the reference's unpack
    (agg_step.py:345-355): signs sign-extended to int32, `!= 0` masks."""
    rng = np.random.default_rng(n_calls * 1000 + b)
    p8 = np.empty((2 + n_calls, b), np.int8)
    p8[0] = rng.choice([-1, 0, 1], b)
    p8[1:] = rng.integers(0, 2, (1 + n_calls, b))
    p8[1:, ::7] = rng.integers(-128, 128, p8[1:, ::7].shape)
    jp8 = jnp.asarray(p8)
    ref = (jp8[0].astype(jnp.int32), jp8[1] != 0,
           tuple(jp8[2 + i] != 0 for i in range(n_calls)))
    signs, mask, valid = agg_unpack_plain(torch.from_numpy(p8), n_calls)
    assert valid.shape == (n_calls, b)
    assert_same((signs, mask, tuple(valid)), ref)
    # the dispatch takes the plain version for a CPU tensor
    assert_same(agg_unpack(torch.from_numpy(p8), n_calls),
                (signs, mask, valid))
