"""The port's retractable min/max multiset (plain PyTorch versions, on the
CPU) against the JAX package's `device/minput.py`: ms_batch_reduce (the
hand kernel's tile edges included),
ms_merge, ms_group_minmax, ms_find, ms_make / ms_grow and the float
order encoding — every leaf and dtype equal, padding included."""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import risingwave_tpu.device.minput as J
import risingwave_tpu_torch.device.minput as P
from risingwave_tpu_torch import kernels as K
from torch_parity import EMPTY, assert_same


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def multiset_pair(cap, k1, k2, cnt):
    """The same multiset in both packages: (k1, k2) rows sorted, unique."""
    order = np.lexsort((k2, k1))
    n = len(order)
    a1 = np.full(cap, EMPTY, np.int64)
    a2 = np.full(cap, EMPTY, np.int64)
    ac = np.zeros(cap, np.int64)
    a1[:n] = np.asarray(k1)[order]
    a2[:n] = np.asarray(k2)[order]
    ac[:n] = np.asarray(cnt)[order]
    count = np.int32(n)
    return (J.SortedMultiset(jnp.asarray(a1), jnp.asarray(a2),
                             jnp.asarray(count), jnp.asarray(ac)),
            P.SortedMultiset(torch.from_numpy(a1), torch.from_numpy(a2),
                             torch.tensor(count), torch.from_numpy(ac)))


def unique_pairs(rng, n, hi1, hi2):
    p = np.unique(np.stack([rng.integers(0, hi1, 4 * n + 8),
                            rng.integers(0, hi2, 4 * n + 8)], 1), axis=0)
    p = p[rng.permutation(len(p))[:n]]
    return p[:, 0].copy(), p[:, 1].copy()


def rows(rng, n, hi1, hi2, mask_p=0.85, signs=(-1, 1, 1)):
    return (rng.integers(0, hi1, n), rng.integers(-hi2, hi2, n),
            rng.choice(signs, n).astype(np.int64), rng.random(n) < mask_p)


# ---------------------------------------------------------------------------
# order encoding
# ---------------------------------------------------------------------------


def test_order_encoding_matches_reference():
    rng = _rng("enc")
    v = np.concatenate([rng.normal(0, 1e6, 200),
                        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-310,
                         -1e-310, np.finfo(np.float64).max]])
    enc = P.order_encode_f64(v)
    assert enc.dtype == np.int64
    assert np.array_equal(enc, J.order_encode_f64(v))
    # monotone: sorting the codes sorts the floats (NaN last)
    order = np.argsort(enc, kind="stable")
    fin = v[order][~np.isnan(v[order])]
    assert np.all(fin[1:] >= fin[:-1]) and np.isnan(v[order][-1])
    back = P.order_decode_f64(enc)
    assert np.array_equal(back.view(np.int64), v.view(np.int64))
    assert np.array_equal(back.view(np.int64),
                          J.order_decode_f64(enc).view(np.int64))


# ---------------------------------------------------------------------------
# ms_batch_reduce
# ---------------------------------------------------------------------------


TILE = chip_smoke.RED_TILE       # sorted rows per tile of the reduce kernel
EDGES = [TILE * i + e for i in range(1, 5) for e in (-1, 0, 1)] + [6 * TILE]


def br_case(name):
    """(k1, k2, delta, mask). Besides the reference's own shapes, those the
    hand kernel's tiled reduce makes hard (2048 (k1, k2)-sorted rows a
    tile): one pair over more than three tiles, a pair boundary at each
    tile edge and one row either side (masked rows moving them, EMPTY_KEY
    k1 beside a live k2), int64 sums that wrap, fewer rows than a tile;
    the same shapes run against the kernel in chip_smoke.py."""
    rng = _rng(name)
    if name == "random":
        return rows(rng, 200, 6, 40)
    if name == "masked_rows":
        return rows(rng, 128, 4, 10, mask_p=0.3)
    if name == "all_masked":
        return rows(rng, 64, 4, 10, mask_p=0.0)
    if name == "cancelling":
        k1, k2 = unique_pairs(rng, 40, 5, 20)
        return (np.repeat(k1, 2), np.repeat(k2, 2),
                np.tile(np.array([1, -1], np.int64), 40),
                np.ones(80, bool))
    if name == "n=1":
        return (np.array([3]), np.array([-7]), np.array([-1], np.int64),
                np.ones(1, bool))
    if name == "one_pair_3_tiles+3":
        n = 3 * TILE + 3
        return (np.full(n, 5), np.full(n, -9),
                rng.choice([-1, 1, 2], n).astype(np.int64), np.ones(n, bool))
    if name in ("pair_tile_edges", "pair_tile_edges_masked",
                "empty_k1_at_tile_edges"):
        k1, k2 = chip_smoke.pair_runs(rng, EDGES)
        m = np.ones(len(k1), bool) if name == "pair_tile_edges" \
            else rng.random(len(k1)) < 0.9
        if name == "empty_k1_at_tile_edges":   # runs 9.. : EMPTY, live k2
            k1 = np.where(k1 >= 3, EMPTY, k1)
        return k1, k2, rng.choice([-1, 1], len(k1)).astype(np.int64), m
    if name == "wrapping_deltas":
        n = 4 * TILE
        return (rng.integers(0, 6, n), rng.integers(0, 4, n),
                rng.integers(1 << 61, (1 << 63) - 1, n, dtype=np.int64),
                rng.random(n) < 0.9)
    if name == "n_below_tile":
        return rows(rng, 1000, 40, 60, mask_p=0.6)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random", "masked_rows", "all_masked",
                                  "cancelling", "n=1", "one_pair_3_tiles+3",
                                  "pair_tile_edges", "pair_tile_edges_masked",
                                  "empty_k1_at_tile_edges", "wrapping_deltas",
                                  "n_below_tile"])
def test_ms_batch_reduce(name):
    k1, k2, d, m = br_case(name)
    want = J.ms_batch_reduce(jnp.asarray(k1), jnp.asarray(k2),
                             jnp.asarray(d), jnp.asarray(m))
    got = K.ms_batch_reduce(*(torch.from_numpy(np.ascontiguousarray(x))
                              for x in (k1, k2, d, m)))
    assert_same(got, want)
    if name == "cancelling":          # every pair nets to 0 but stays
        assert int((got[0] != EMPTY).sum()) == 40
        assert int(got[2].abs().sum()) == 0
    if name == "wrapping_deltas":     # the sums did wrap
        assert int((got[2] < 0).sum()) > 0
    if name == "empty_k1_at_tile_edges":   # EMPTY k1 beside a live k2
        u1, u2, ud = got
        assert int(((u1 == EMPTY) & (u2 != EMPTY)).sum()) > 0
        assert int(ud[u1 == EMPTY].abs().sum()) == 0


# ---------------------------------------------------------------------------
# ms_merge
# ---------------------------------------------------------------------------


def merge_case(name, cap):
    """(reference multiset, port multiset, delta rows) for one case."""
    rng = _rng(f"{name}/{cap}")
    live = max(1, cap - 1 - cap // 4)
    s1, s2 = unique_pairs(rng, live, 5, 30)
    cnt = rng.integers(1, 4, live)
    jm, pm = multiset_pair(cap, s1, s2, cnt)
    if name == "mixed":
        d = rows(rng, 3 * cap + 4, 5, 30)
    elif name == "retract_to_zero":
        # every live pair retracted to 0: it compacts away
        d = (np.repeat(s1, cnt), np.repeat(s2, cnt),
             -np.ones(int(cnt.sum()), np.int64),
             np.ones(int(cnt.sum()), bool))
    elif name == "needed>C":
        n1, n2 = unique_pairs(rng, cap + 3, 50, 50)
        d = (n1 + 100, n2, np.ones(cap + 3, np.int64),
             np.ones(cap + 3, bool))
    elif name == "zero_count_deltas":
        # +1/-1 pairs that net to 0: no-ops on existing pairs, and new
        # pairs of count 0 vanish alone
        a1 = np.concatenate([s1[: live // 2], [70, 71]]).astype(np.int64)
        a2 = np.concatenate([s2[: live // 2], [1, 2]]).astype(np.int64)
        d = (np.repeat(a1, 2), np.repeat(a2, 2),
             np.tile(np.array([1, -1], np.int64), len(a1)),
             np.ones(2 * len(a1), bool))
    elif name == "below_zero":
        # retract more than the pair holds: a count below 0 stays alive
        k = int(cnt[0]) + 2
        d = (s1[:1].repeat(k), s2[:1].repeat(k), -np.ones(k, np.int64),
             np.ones(k, bool))
    else:
        raise KeyError(name)
    return jm, pm, d


@pytest.mark.parametrize("cap", [1, 2, 3, 16])
@pytest.mark.parametrize("name", ["mixed", "retract_to_zero", "needed>C",
                                  "zero_count_deltas", "below_zero"])
def test_ms_merge(name, cap):
    jm, pm, (k1, k2, d, m) = merge_case(name, cap)
    ju = J.ms_batch_reduce(jnp.asarray(k1), jnp.asarray(k2),
                           jnp.asarray(d), jnp.asarray(m))
    pu = K.ms_batch_reduce(*(torch.from_numpy(np.asarray(x))
                             for x in (k1, k2, d, m)))
    want = J.ms_merge(jm, *ju)
    got = K.ms_merge(pm, *pu)
    assert_same(got, want)
    new, needed = got
    if name == "needed>C":
        assert int(needed) > cap and int(new.count) == cap
    if name == "retract_to_zero":
        assert int(needed) == 0
    if name == "below_zero":
        assert bool((new.cnt < 0).any())


def test_ms_merge_plain_rejects_delta_out_of_order():
    _, pm = multiset_pair(8, [1, 2], [5, 5], [1, 1])

    def t(*xs):
        return [torch.tensor(x, dtype=torch.int64) for x in xs]
    for u1, u2 in (([2, 1, EMPTY], [5, 5, EMPTY]),      # descending
                   ([1, EMPTY, 2], [5, EMPTY, 5]),      # EMPTY hole
                   ([1, 1, EMPTY], [5, 5, EMPTY])):     # duplicate pair
        with pytest.raises(ValueError, match="ms_merge"):
            K.ms_merge_plain(pm, *t(u1, u2, [1, 1, 0]))


# ---------------------------------------------------------------------------
# ms_group_minmax and ms_find
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [1, 2, 3, 16, 64])
def test_ms_group_minmax_and_find(cap):
    rng = _rng(f"find/{cap}")
    live = cap if cap < 4 else cap - 5
    s1, s2 = unique_pairs(rng, live, 6, 20)
    jm, pm = multiset_pair(cap, s1, s2, rng.integers(1, 5, live))
    # groups present and absent (below, between, above), and EMPTY
    groups = np.concatenate([s1[:4], [-3, 2, 7, 99, EMPTY]]).astype(np.int64)
    want = J.ms_group_minmax(jm, jnp.asarray(groups))
    got = P.ms_group_minmax(pm, torch.from_numpy(groups))
    assert_same(got, want)      # absent groups: the clipped range ends too
    q1 = np.concatenate([s1, rng.integers(-2, 8, 30), [EMPTY, EMPTY]])
    q2 = np.concatenate([s2, rng.integers(0, 20, 30), [EMPTY, 3]])
    want = J.ms_find(jm, jnp.asarray(q1), jnp.asarray(q2))
    got = K.ms_find(pm, torch.from_numpy(q1), torch.from_numpy(q2))
    assert_same(got, want)
    assert bool(got[0][:live].all())


def test_ms_make_grow():
    assert_same(P.ms_make(5, "cpu"), J.ms_make(5))
    jm, pm = multiset_pair(4, [1, 2], [3, 4], [2, 1])
    assert_same(P.ms_grow(pm, 16), J.ms_grow(jm, 16))
    with pytest.raises(ValueError):
        P.ms_grow(pm, 2)
