"""The port's key-skew telemetry (`risingwave_tpu_torch/device/skew_stats.py`
over the `vnode_hist` / `topk_packed` plain versions on the CPU) against
the JAX package's `device/skew_stats.py`: the same seeded numpy inputs
through `vnode_occupancy`, `vnode_traffic`, `epoch_topk` and
`weighted_topk`, and the host helpers on the same histograms. Exact:
every value is an integer (the helpers' floats come from the same
Python arithmetic).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from risingwave_tpu.core.vnode import compute_vnodes_jnp
from risingwave_tpu.device import skew_stats as JS
from risingwave_tpu_torch.core.vnode import vnodes_i64
from risingwave_tpu_torch.device import skew_stats as PS
from risingwave_tpu_torch import kernels as K
from risingwave_tpu_torch.kernels import binding
from torch_parity import EMPTY

I64 = np.iinfo(np.int64)


def ref(vals):
    return np.array([int(v) for v in vals], np.int64)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def case(name, rng):
    """(keys, live, weights or counts) for one named case."""
    n = {"n=1": 1, "n=3": 3, "n=4": 4}.get(name, 5000)
    keys = rng.integers(0, 300, n).astype(np.int64)
    live = rng.random(n) < 0.8
    w = rng.integers(0, 9, n).astype(np.int64)
    if name == "all_masked":
        live[:] = False
    elif name == "negative_keys":
        keys = rng.integers(I64.min, -(1 << 50), n)
    elif name == "empty_inside":
        keys[rng.random(n) < 0.2] = EMPTY
    elif name == "one_hot_key":
        keys[: n // 2] = 77
    elif name == "count_clamp":
        w[:3] = [PS.SK_COUNT_MAX + 5, 1 << 40, PS.SK_COUNT_MAX]
    elif name == "same_low_40_bits":
        keys = (rng.integers(0, 4, n) << 40) + 12345
    elif name == "one_bucket":
        # keys whose vnodes all fall in bucket 3
        from risingwave_tpu_torch.core.vnode import vnodes_i64
        pool = np.arange(200_000, dtype=np.int64)
        pool = pool[vnodes_i64(pool) * PS.SK_BUCKETS // 256 == 3]
        keys = rng.choice(pool, n)
    return keys, live, w


CASES = ["random", "all_masked", "n=1", "n=3", "n=4", "negative_keys",
         "empty_inside", "one_hot_key", "count_clamp", "same_low_40_bits",
         "one_bucket"]


def test_constants_match():
    for nm in ("SK_BUCKETS", "SK_TOPK", "SK_KEY_BITS", "SK_SHIFT",
               "SK_KEY_MASK", "SK_COUNT_MAX", "SKEW_STAT_NAMES",
               "TRAFFIC_STAT_NAMES"):
        assert getattr(PS, nm) == getattr(JS, nm), nm


@pytest.mark.parametrize("name", CASES)
def test_vnode_occupancy_and_traffic(name):
    rng = np.random.default_rng(CASES.index(name))
    keys, live, w = case(name, rng)
    occ = PS.vnode_occupancy(t(keys), EMPTY)
    assert occ.dtype == torch.int64 and occ.shape == (PS.SK_BUCKETS,)
    assert np.array_equal(occ.numpy(),
                          ref(JS.vnode_occupancy(jnp.asarray(keys), EMPTY)))
    tr = PS.vnode_traffic(t(keys), t(live))
    assert np.array_equal(tr.numpy(), ref(JS.vnode_traffic(
        jnp.asarray(keys), jnp.asarray(live))))
    tw = PS.vnode_traffic(t(keys), t(live), weights=t(w))
    assert np.array_equal(tw.numpy(), ref(JS.vnode_traffic(
        jnp.asarray(keys), jnp.asarray(live), weights=jnp.asarray(w))))
    if name == "one_bucket":
        assert occ[3] == len(keys) and occ.sum() == len(keys)
    # adding into a given histogram: two tables share one (a join)
    both = K.vnode_hist(t(keys), None, None, EMPTY,
                        out=PS.vnode_occupancy(t(keys[::-1].copy()), EMPTY))
    assert np.array_equal(both.numpy(), 2 * occ.numpy())


@pytest.mark.parametrize("name", CASES)
def test_epoch_and_weighted_topk(name):
    rng = np.random.default_rng(100 + CASES.index(name))
    keys, live, w = case(name, rng)
    got = PS.epoch_topk(t(keys), t(live), EMPTY)
    assert got.dtype == torch.int64 and got.shape == (PS.SK_TOPK,)
    assert np.array_equal(got.numpy(), ref(JS.epoch_topk(
        jnp.asarray(keys), jnp.asarray(live), EMPTY)))
    # weighted: (key, count) rows — unique keys as a pre-combine emits
    # them, and the raw keys (duplicates keep their multiplicity)
    uk = np.unique(keys)
    cnt = rng.integers(-2, 12, len(uk)).astype(np.int64)
    if name == "count_clamp":
        cnt[:2] = [PS.SK_COUNT_MAX + 1, 1 << 30]
    for kk, cc in ((uk, cnt), (keys, w)):
        got = PS.weighted_topk(t(kk), t(cc), EMPTY)
        assert np.array_equal(got.numpy(), ref(JS.weighted_topk(
            jnp.asarray(kk), jnp.asarray(cc), EMPTY)))
    if name == "one_hot_key":
        key, count = PS.unpack_hot(int(PS.epoch_topk(t(keys), t(live),
                                                      EMPTY)[0]))
        assert key == 77 and count == int((live & (keys == 77)).sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_host_helpers(seed):
    rng = np.random.default_rng(seed)
    keys, live, w = case("one_hot_key", rng)
    occ = PS.vnode_occupancy(t(keys), EMPTY).tolist()
    tv = PS.vnode_traffic(t(keys), t(live), weights=t(w)).tolist()
    hot = PS.epoch_topk(t(keys), t(live), EMPTY).tolist()
    for p in hot + [0, (5 << 40) | 9]:
        assert PS.unpack_hot(p) == JS.unpack_hot(p)
    stats = {f"skh{i}": p for i, p in enumerate(hot)}
    assert PS.hot_key_set(stats) == JS.hot_key_set(stats)
    for h in (occ, tv, [0] * 16, [5] + [0] * 15):
        assert PS.skew_ratio(h) == JS.skew_ratio(h)
        assert PS.sparkline(h) == JS.sparkline(h)
        assert PS.traffic_divergence(tv, h) == JS.traffic_divergence(tv, h)
    pe, je = PS.TrafficEwma(), JS.TrafficEwma()
    assert pe.burst_ratio() == je.burst_ratio() == 0.0
    cum = np.zeros(16, np.int64)
    for step in range(6):
        cum = cum + rng.integers(0, 50, 16) * (step != 3)
        assert pe.update(cum) == je.update(cum)
        assert pe.ewma == je.ewma
        assert pe.burst_ratio() == je.burst_ratio()


# ---------------------------------------------------------------------------
# the kernel's table-free bucket, and the multi-segment form
# ---------------------------------------------------------------------------


def parity_keys(name):
    rng = np.random.default_rng(7 + ["random", "specials", "single_bits",
                                     "dense_low"].index(name))
    if name == "random":
        return rng.integers(I64.min, I64.max, 200_000, dtype=np.int64,
                            endpoint=True)
    if name == "specials":
        return np.array([0, -1, I64.min, I64.max, EMPTY, 1, -2, I64.min + 1,
                         I64.max - 1], np.int64)
    if name == "single_bits":
        bits = np.array([1 << i for i in range(63)] + [I64.min], np.int64)
        return np.concatenate([bits, ~bits, bits ^ 0x5a5a])
    return np.arange(-70_000, 70_000, dtype=np.int64)


@pytest.mark.parametrize("name", ["random", "specials", "single_bits",
                                  "dense_low"])
def test_parity_bucket_masks(name):
    """The masks the binding hands the vnode_hist kernel give each key the
    bucket vnode * 16 // 256 of both packages' CRC vnode."""
    masks, flip = binding.hist_parity()
    assert len(masks) == 4 and 0 <= flip < 16
    keys = parity_keys(name)
    u = keys.view(np.uint64)
    got = np.zeros(len(keys), np.int64)
    for j, mk in enumerate(masks):
        par = np.bitwise_count(u & np.uint64(mk)).astype(np.int64) & 1
        got |= (par ^ ((flip >> j) & 1)) << j
    want = vnodes_i64(keys).astype(np.int64) * PS.SK_BUCKETS // 256
    assert np.array_equal(got, want)
    jref = np.asarray(compute_vnodes_jnp(jnp.asarray(keys))).astype(np.int64)
    assert np.array_equal(got, jref * PS.SK_BUCKETS // 256)


def hists_case(name, rng):
    """(segments as numpy (keys, live, weights, row), rows)."""
    n = 3000
    a = rng.integers(0, 1 << 40, n).astype(np.int64)
    a[rng.random(n) < 0.3] = EMPTY
    b = rng.integers(-(1 << 50), 1 << 50, n // 2).astype(np.int64)
    b[-100:] = EMPTY
    k = rng.integers(0, 500, 2 * n).astype(np.int64)
    live = rng.random(2 * n) < 0.8
    w = rng.integers(0, 1 << 20, 2 * n).astype(np.int64)
    e = np.zeros(0, np.int64)
    if name == "two_tables_one_row":
        return [(a, None, None, 0), (b, None, None, 0), (k, live, None, 1)], 2
    if name == "weighted":
        return [(a, None, None, 0), (k, live, w, 1)], 2
    if name == "all_masked":
        return [(a[:0], None, None, 0),
                (np.full(64, EMPTY, np.int64), None, None, 0),
                (k, np.zeros(2 * n, bool), w, 1)], 2
    return [(e, None, None, 0), (e, np.zeros(0, bool), e, 1)], 2     # n0


@pytest.mark.parametrize("name", ["two_tables_one_row", "weighted",
                                  "all_masked", "n0"])
def test_vnode_hists(name):
    """The multi-segment form (a node's one call) against separate
    one-segment calls into the same rows, and against the reference's
    vnode_occupancy / vnode_traffic summed the same way."""
    rng = np.random.default_rng(["two_tables_one_row", "weighted",
                                 "all_masked", "n0"].index(name))
    segs, rows = hists_case(name, rng)
    tsegs = [(t(k), None if lv is None else t(lv),
              None if w is None else t(w), r) for k, lv, w, r in segs]
    got = K.vnode_hists(tsegs, rows)
    assert got.dtype == torch.int64 and got.shape == (rows, PS.SK_BUCKETS)
    sep = torch.zeros((rows, PS.SK_BUCKETS), dtype=torch.int64)
    for k, lv, w, r in tsegs:
        K.vnode_hist_plain(k, lv, w, EMPTY, sep[r])
    assert torch.equal(got, sep)
    want = np.zeros((rows, PS.SK_BUCKETS), np.int64)
    for k, lv, w, r in segs:
        if len(k) == 0:
            continue
        if lv is None:
            want[r] += ref(JS.vnode_occupancy(jnp.asarray(k), EMPTY))
        else:
            want[r] += ref(JS.vnode_traffic(
                jnp.asarray(k), jnp.asarray(lv),
                weights=None if w is None else jnp.asarray(w)))
    assert np.array_equal(got.numpy(), want)
    occ, traffic = PS.node_hists(
        [s[0] for s in tsegs if s[3] == 0], tsegs[-1][0], tsegs[-1][1],
        tsegs[-1][2], EMPTY)
    assert torch.equal(occ, got[0]) and torch.equal(traffic, got[1])


def policy_histograms(seed):
    """Seeded occupancy histograms for the mesh policy's math: uniform,
    Zipf-lumpy, one hot bucket, two hot buckets, sparse, all empty."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1000, 16),
            np.minimum(rng.zipf(1.6, 16), 10 ** 7),
            np.eye(16, dtype=np.int64)[rng.integers(0, 16)] * 4096,
            np.where(rng.random(16) < 0.15, rng.integers(1, 9, 16) * 1000,
                     rng.integers(0, 3, 16)),
            np.where(rng.random(16) < 0.3, rng.integers(0, 50, 16), 0),
            np.zeros(16, np.int64)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 11, 16, 20])
def test_shard_policy_math(n, seed):
    """`shard_loads`, `shard_skew_ratio` and `balanced_bounds` against the
    reference's on the same histograms, under the uniform blocks, the
    reference's balanced bounds (empty blocks where one bucket dominates)
    and hand-made bounds with empty blocks; floats compared exactly."""
    from risingwave_tpu.parallel.mesh import vnode_block_bounds
    for h in policy_histograms(seed):
        c = [int(x) for x in h]
        nb = JS.balanced_bounds(c, n)
        assert PS.balanced_bounds(c, n) == nb
        assert len(nb) == n + 1 and nb[0] == 0 and nb[-1] == 256
        assert all(a <= b for a, b in zip(nb, nb[1:]))
        uniform = tuple(int(v) for v in vnode_block_bounds(n))
        empty = tuple([0] * (n // 2) + [17] + [256] * (n - n // 2))[:n + 1]
        for b in (uniform, nb, empty):
            assert PS.shard_loads(c, b) == JS.shard_loads(c, b)
            assert PS.shard_skew_ratio(c, b) == JS.shard_skew_ratio(c, b)
        if sum(c) and 16 % n == 0:
            # the uniform blocks are then a bucket-aligned partition, one
            # of those balanced_bounds minimizes the largest load over
            assert PS.shard_skew_ratio(c, nb) \
                <= PS.shard_skew_ratio(c, uniform) + 1e-9
