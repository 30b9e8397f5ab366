"""The two state-tiering kernels' plain versions (`kernels/tier_runs.py`)
and the six tier surgery cores of `device/fused.py` built on them, on the
CPU, against the JAX package: `touch_stamp` in both modes against the
reference's `AggNode._tier_tail` and its promote-core touch carry,
`tier_partition` against the reference's searchsorted membership and
`compact_rows`, and `_agg_evict_core` … `_join_promote_core` on the same
`TieredState` in both packages, every leaf equal, dtype included.

Edge cases: all-EMPTY_KEY tables, no demoted keys, every row demoted,
duplicate join keys across the old side (the stamp of the first row of a
key carries), a grown capacity (the old table shorter than the new), and
ticks that straddle TIER_TTL; for the touch_stamp kernel's merge path
(tiles of 2048 merged rows of the new and old keys, and of the new and
touched keys) runs of equal keys straddling tile edges in all three
runs, an old run across tiles whose first row carries, many deleted old
keys between two new ones, no old rows, no touched keys (none, or only
EMPTY_KEY), and stamps exactly TIER_TTL old. The reference takes no
zero-row table: where the port's has none, it gets one EMPTY_KEY row,
which holds no key either.
"""
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import risingwave_tpu.device.agg_step as JA
import risingwave_tpu.device.fused as JF
import risingwave_tpu.device.join_step as JJ
import risingwave_tpu.device.sorted_state as J
import risingwave_tpu.device.tiering as JT
import risingwave_tpu_torch.device.agg_step as PA
import risingwave_tpu_torch.device.fused as PF
import risingwave_tpu_torch.device.join_step as PJ
import risingwave_tpu_torch.device.tiering as PT
from risingwave_tpu_torch import kernels as K
from torch_parity import EMPTY, assert_same, state_pair

S, MX, R = J.ReduceKind.SUM, J.ReduceKind.MAX, J.ReduceKind.REPLACE
AGG_SPEC = [(S, np.int64), (S, np.int64), (MX, np.int64), (S, np.float64)]
MV_SPEC = [(R, np.int32), (R, np.int64), (R, np.bool_), (R, np.int64),
           (R, np.bool_)]
TTL = JT.TIER_TTL


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def padded(keys, n, fill=EMPTY):
    out = np.full(n, fill, np.int64)
    out[:len(keys)] = keys
    return out


def touch_for(rng, keys, lo=0, hi=12):
    t = rng.integers(lo, hi, len(keys)).astype(np.int64)
    return np.where(keys != EMPTY, t, 0)


def tiered(ref_inner, port_inner, touch, tick):
    """The same TieredState in both packages (`touch` an array, or a pair
    of arrays for a join)."""
    if isinstance(touch, tuple):
        jt = tuple(jnp.asarray(t) for t in touch)
        pt = tuple(torch.from_numpy(t.copy()) for t in touch)
    else:
        jt, pt = jnp.asarray(touch), torch.from_numpy(touch.copy())
    return (JT.TieredState(ref_inner, jt, jnp.asarray(np.int64(tick))),
            PT.TieredState(port_inner, pt, torch.tensor(tick,
                                                        dtype=torch.int64)))


def side_pair(rng, cap, jk, pk, dtypes):
    """The same join side in both packages: (jk, pk) rows sorted, unique."""
    order = np.lexsort((pk, jk))
    jk, pk = np.asarray(jk)[order], np.asarray(pk)[order]
    n = len(jk)
    kk, pp = padded(jk, cap), padded(pk, cap)
    vals = []
    for dt in dtypes:
        v = np.zeros(cap, dt)
        v[:n] = rng.normal(0, 100, n) if dt == np.float64 \
            else rng.integers(-1000, 1000, n)
        vals.append(v)
    cnt = np.int32(n)
    return (JJ.JoinSide(jnp.asarray(kk), jnp.asarray(pp), jnp.asarray(cnt),
                        tuple(jnp.asarray(v) for v in vals)),
            PJ.JoinSide(torch.from_numpy(kk), torch.from_numpy(pp),
                        torch.tensor(cnt),
                        tuple(torch.from_numpy(v) for v in vals)))


def side_rows(rng, n, jk_hi, pk_hi):
    """n distinct (jk, pk) pairs; join keys repeat."""
    jk = rng.integers(0, jk_hi, 4 * n)
    pk = rng.integers(0, pk_hi, 4 * n)
    pairs = np.unique(np.stack([jk, pk], 1), axis=0)
    pairs = pairs[rng.permutation(len(pairs))[:n]]
    return pairs[:, 0].copy(), pairs[:, 1].copy()


def agg_node():
    kinds = [k for k, _ in AGG_SPEC]
    return (SimpleNamespace(spec=SimpleNamespace(kinds=kinds)),) * 2


def mv_node():
    ncalls = (len(MV_SPEC) - 1) // 2
    return (SimpleNamespace(agg=SimpleNamespace(spec=SimpleNamespace(
        calls=[None] * ncalls))),) * 2


# ---------------------------------------------------------------------------
# touch_stamp
# ---------------------------------------------------------------------------


def ref_promote_touch(new_keys, old_keys, old_touch, pkeys, ptouch):
    """The promote cores' touch carry, as the reference computes it
    (`risingwave_tpu/device/fused.py:1852-1860`, `one()` :1891-1898)."""
    oc = old_keys.shape[0]
    oidx = jnp.clip(jnp.searchsorted(old_keys, new_keys, side="left"), 0,
                    oc - 1)
    ofound = old_keys[oidx] == new_keys
    pix = jnp.clip(jnp.searchsorted(pkeys, new_keys, side="left"), 0,
                   pkeys.shape[0] - 1)
    pfound = pkeys[pix] == new_keys
    return jnp.where(new_keys != J.EMPTY_KEY,
                     jnp.where(ofound, old_touch[oidx],
                               jnp.where(pfound, ptouch[pix], 0)), 0)


def stamp_cases():
    """(case, new keys, old keys, old touch, touched keys, promoted touch,
    tick) — sorted arrays, EMPTY_KEY padded."""
    rng = _rng("stamp")
    base = np.sort(rng.choice(1 << 20, 3000, replace=False))
    new = padded(np.sort(np.concatenate([base[:2000],
                                         rng.choice(1 << 19, 500) + (1 << 20)
                                         ])), 4096)
    new = padded(np.unique(new[new != EMPTY]), 4096)
    old = padded(base[:2400], 4096)
    tch = padded(np.sort(rng.choice(new[new != EMPTY], 700, replace=False)),
                 1024)
    yield ("agg", new, old, touch_for(rng, old), tch,
           touch_for(rng, tch), 9)
    yield ("all_empty", padded([], 256), padded([], 256),
           np.zeros(256, np.int64), padded([], 64), np.zeros(64, np.int64),
           5)
    # a grown table: the old run is shorter than the new one
    yield ("grown", new, old[:2048], touch_for(rng, old[:2048]), tch,
           touch_for(rng, tch), 9)
    # ticks straddling TTL: stamps at tick - TTL - 1 .. tick
    for tick in (TTL - 1, TTL, TTL + 1, 3 * TTL):
        lo = max(0, tick - TTL - 1)
        yield (f"tick{tick}", new, old, touch_for(rng, old, lo, tick + 1),
               tch, touch_for(rng, tch, lo, tick + 1), tick)
    # a join side: every join key repeats, and the stamp of the FIRST
    # old row of a key carries (the rows of one key differ here)
    jk = np.sort(rng.integers(0, 300, 3000))
    njk = np.sort(np.concatenate([jk[:2500], rng.integers(200, 400, 400)]))
    yield ("join_dups", padded(njk, 4096), padded(jk, 4096),
           touch_for(rng, padded(jk, 4096)),
           padded(np.sort(rng.integers(0, 400, 600)), 1024),
           touch_for(rng, padded(np.sort(rng.integers(0, 400, 600)), 1024)),
           7)
    # runs of ~1K equal keys in all three runs, across every kind of tile
    # edge; half the new keys touched
    rk = padded(np.sort(rng.integers(0, 12, 12000)), 12288)
    ro = padded(np.sort(rng.integers(0, 14, 10000)), 10240)
    rs = padded(np.sort(rng.integers(0, 6, 4000)) * 2, 4096)
    yield "straddling_runs", rk, ro, touch_for(rng, ro), rs, \
        touch_for(rng, rs), 9
    # an old run of 5,000 rows (each its own stamp) across tiles, 2,500 new
    # rows of its key before it in the merged order
    orun = np.concatenate([np.arange(1000) * 2, np.full(5000, 2001),
                           np.arange(1000) * 2 + 3000])
    nrun = np.concatenate([np.arange(500) * 4, np.full(2500, 2001),
                           np.arange(700) * 3 + 3000])
    nrun = padded(nrun, 4096)
    yield "old_run_across_tiles", nrun, padded(orun, 8192), \
        touch_for(rng, padded(orun, 8192)), nrun[::11].copy(), \
        touch_for(rng, nrun[::11]), 9
    # 30,000 old keys deleted between 20 new ones: tiles of old rows only
    dnew = padded(np.concatenate([np.arange(20) * 5000,
                                  np.arange(3000) + (1 << 30)]), 4096)
    dold = padded(np.sort(rng.choice(100_000, 30_000, replace=False)),
                  32768)
    yield "deleted_old_keys", dnew, dold, touch_for(rng, dold), \
        dnew[::7].copy(), touch_for(rng, dnew[::7]), 9
    none = np.zeros(0, np.int64)
    yield "n_old=0", new, none, none, tch, touch_for(rng, tch), 9
    yield ("touched_all_empty", new, old, touch_for(rng, old),
           padded([], 1024), np.zeros(1024, np.int64), 9)
    yield "n_touched=0", new, old, touch_for(rng, old), none, none, 9
    # every carried stamp tick - TTL (cold) or one newer (not)
    yield ("age_at_ttl", new, old, touch_for(rng, old, 9 - TTL, 11 - TTL),
           padded(new[new != EMPTY][::9], 1024),
           np.zeros(1024, np.int64), 9)


@pytest.mark.parametrize("case", [c[0] for c in stamp_cases()])
def test_touch_stamp_matches_reference(case):
    new, old, ot, tch, pt, tick = next(c[1:] for c in stamp_cases()
                                       if c[0] == case)
    # the reference's tables hold >= 1 row: one EMPTY_KEY row for none
    rold, rot = (old, ot) if len(old) else (padded([], 1),
                                            np.zeros(1, np.int64))
    rtch, rpt = (tch, pt) if len(tch) else (padded([], 1),
                                            np.zeros(1, np.int64))
    # epoch mode: the reference's agg tail (searchsorted over the change
    # set's keys), which the join tail repeats per side
    tstate = JT.TieredState(None, jnp.asarray(rot),
                            jnp.asarray(np.int64(tick)))
    (rstate, rstats) = JF.AggNode._tier_tail(
        None, tstate, SimpleNamespace(keys=jnp.asarray(rold)),
        SimpleNamespace(main=SimpleNamespace(keys=jnp.asarray(new))),
        {"keys": jnp.asarray(rtch)})
    t = torch.from_numpy
    tick_t = torch.tensor(tick, dtype=torch.int64)
    got, counts = K.touch_stamp(t(new), t(old), t(ot), t(tch), None,
                                tick_t, TTL)
    assert_same(got, rstate.touch)
    assert [int(c) for c in counts] == [int(x) for x in rstats]
    assert counts.dtype == torch.int64
    # promote mode: the old table wins over the promoted stamps
    got, _ = K.touch_stamp(t(new), t(old), t(ot), t(tch), t(pt), tick_t, TTL)
    assert_same(got, ref_promote_touch(jnp.asarray(new), jnp.asarray(rold),
                                       jnp.asarray(rot), jnp.asarray(rtch),
                                       jnp.asarray(rpt)))



# ---------------------------------------------------------------------------
# tier_partition
# ---------------------------------------------------------------------------


def ref_partition(keys, cols, fills, dkeys, hits):
    """The reference evict cores' membership and compaction
    (`fused.py:1773-1783`, :1819-1827)."""
    L = dkeys.shape[0]
    ridx = jnp.clip(jnp.searchsorted(dkeys, keys), 0, L - 1)
    hit = (dkeys[ridx] == keys) & (keys != J.EMPTY_KEY)
    alive = (keys != J.EMPTY_KEY) & ~hit
    n = keys.shape[0]
    kept = J.compact_rows(alive, [], list(cols), n, fills)
    gone = J.compact_rows(hit, [], list(cols), n, fills) if hits else ()
    counts = jnp.stack([jnp.sum(alive), jnp.sum(hit)]).astype(jnp.int32)
    return tuple(kept), tuple(gone), counts


def partition_cases():
    rng = _rng("partition")
    keys = padded(np.sort(rng.choice(1 << 30, 3000, replace=False)), 4096)
    live = keys[keys != EMPTY]
    some = padded(np.sort(np.concatenate([
        rng.choice(live, 400, replace=False),
        rng.choice(1 << 30, 50) + (1 << 31)])), 512)
    yield "some", keys, some
    yield "no_dkeys", keys, padded([], 64)
    yield "every_row", keys, padded(live, 4096)
    yield "all_empty", padded([], 1024), some
    jk = padded(np.sort(rng.integers(0, 500, 3500)), 4096)
    yield "join_dups", jk, padded(np.unique(rng.integers(0, 500, 60)), 64)


@pytest.mark.parametrize("hits", [False, True])
@pytest.mark.parametrize("case", [c[0] for c in partition_cases()])
def test_tier_partition_matches_reference(case, hits):
    keys, dkeys = next(c[1:] for c in partition_cases() if c[0] == case)
    rng = _rng(case)
    n = len(keys)
    cols = [keys, rng.integers(-9, 9, n).astype(np.int64),
            rng.normal(0, 1, n), rng.random(n) < 0.5,
            rng.integers(0, 9, n).astype(np.int32)]
    fills = [EMPTY, 7, -1.5, True, 0]
    want = ref_partition(jnp.asarray(keys), [jnp.asarray(c) for c in cols],
                         fills, jnp.asarray(dkeys), hits)
    got = K.tier_partition(torch.from_numpy(keys),
                           [torch.from_numpy(c) for c in cols], fills,
                           torch.from_numpy(dkeys), hits)
    assert_same(list(got), list(want))


# ---------------------------------------------------------------------------
# the six surgery cores on one TieredState in both packages
# ---------------------------------------------------------------------------


def agg_state(rng, cap, n, tick):
    keys = np.sort(rng.choice(1 << 24, n, replace=False))
    js, ps = state_pair(rng, cap, keys, AGG_SPEC)
    touch = touch_for(rng, padded(keys, cap), 0, tick + 1)
    return tiered(JA.DeviceAggState(js, ()), PA.DeviceAggState(ps, ()),
                  touch, tick), keys


def dkeys_of(rng, keys, k, L):
    """k keys of the table and a few absent ones, sorted, padded to L."""
    pick = rng.choice(keys, min(k, len(keys)), replace=False) \
        if len(keys) else np.zeros(0, np.int64)
    extra = rng.choice(1 << 24, 5) + (1 << 25)
    return padded(np.sort(np.concatenate([pick, extra])), L)


@pytest.mark.parametrize("n,k", [(700, 90), (0, 10), (300, 300)])
def test_agg_and_mv_evict_cores_match_reference(n, k):
    rng = _rng(f"agg_evict{n}")
    (jt, pt), keys = agg_state(rng, 1024, n, 9)
    dk = dkeys_of(rng, keys, k, 512)
    jnode, pnode = agg_node()
    want = JF._agg_evict_core(jt, jnp.asarray(dk), node=jnode)
    got = PF._agg_evict_core(pt, torch.from_numpy(dk), pnode)
    assert_same(list(got), list(want))
    js, ps = state_pair(rng, 1024, keys, MV_SPEC)
    jnode, pnode = mv_node()
    want = JF._mv_evict_core(js, jnp.asarray(dk), node=jnode)
    got = PF._mv_evict_core(ps, torch.from_numpy(dk), pnode)
    assert_same(list(got), list(want))


def join_state(rng, cap_a, cap_b, na, nb, tick):
    dts = [np.int64, np.float64, np.int64]
    ja, pa = side_pair(rng, cap_a, *side_rows(rng, na, 300, 1 << 20), dts)
    jb, pb = side_pair(rng, cap_b, *side_rows(rng, nb, 300, 1 << 20), dts)
    ta = touch_for(rng, np.asarray(ja.jk), 0, tick + 1)
    tb = touch_for(rng, np.asarray(jb.jk), 0, tick + 1)
    return tiered((ja, jb), (pa, pb), (ta, tb), tick)


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("which", ["some", "none", "all"])
def test_join_evict_core_matches_reference(side, which):
    rng = _rng(f"join_evict{side}{which}")
    jt, pt = join_state(rng, 2048, 1024, 1500, 700, 6)
    jk = np.asarray(jt.inner[side].jk)
    live = np.unique(jk[jk != EMPTY])
    pick = {"some": rng.choice(live, 40, replace=False),
            "none": np.zeros(0, np.int64), "all": live}[which]
    dk = padded(np.sort(pick), max(64, 1 << int(len(pick)).bit_length()))
    want = JF._join_evict_core(jt, jnp.asarray(dk), node=None, side=side)
    got = PF._join_evict_core(pt, torch.from_numpy(dk), None, side)
    assert_same(list(got), list(want))


@pytest.mark.parametrize("m", [0, 37, 300])
def test_agg_and_mv_promote_cores_match_reference(m):
    rng = _rng(f"agg_promote{m}")
    (jt, pt), keys = agg_state(rng, 1024, 500, 11)
    absent = np.setdiff1d(rng.choice(1 << 24, 2 * m + 8), keys)[:m]
    L = max(64, 1 << int(m).bit_length())
    pk = padded(np.sort(absent), L)
    pvals = []
    for j, (_k, dt) in enumerate(AGG_SPEC):
        v = np.zeros(L, dt)
        v[:m] = np.abs(rng.normal(0, 50, m)) + 1 if dt == np.float64 \
            else rng.integers(1, 50, m)
        pvals.append(v)
    ptouch = padded(rng.integers(0, 11, m), L, 0)
    jnode, pnode = agg_node()
    rs, racc = JF._agg_promote_core(
        jt, jnp.asarray(pk), tuple(jnp.asarray(v) for v in pvals),
        jnp.asarray(ptouch), jnp.asarray(np.int64(0)), node=jnode)
    ps, need = PF._agg_promote_core(
        pt, torch.from_numpy(pk), [torch.from_numpy(v) for v in pvals],
        torch.from_numpy(ptouch), pnode)
    assert_same(ps, rs)
    assert int(need) == int(racc)
    js, mps = state_pair(rng, 1024, keys, MV_SPEC)
    mvals = [np.zeros(L, dt) for _k, dt in MV_SPEC]
    mvals[0][:m] = 1
    for v in mvals[1:]:
        v[:m] = rng.integers(0, 2, m) if v.dtype == np.bool_ \
            else rng.integers(-50, 50, m)
    jnode, pnode = mv_node()
    rs, racc = JF._mv_promote_core(
        js, jnp.asarray(pk), tuple(jnp.asarray(v) for v in mvals),
        jnp.asarray(np.int64(0)), node=jnode)
    ps, need = PF._mv_promote_core(
        mps, torch.from_numpy(pk), [torch.from_numpy(v) for v in mvals],
        pnode)
    assert_same(ps, rs)
    assert int(need) == int(racc)


@pytest.mark.parametrize("ma,mb", [(0, 0), (45, 0), (120, 33)])
def test_join_promote_core_matches_reference(ma, mb):
    rng = _rng(f"join_promote{ma}{mb}")
    jt, pt = join_state(rng, 2048, 1024, 900, 400, 8)
    bufs_j, bufs_p = [], []
    for side, m in ((0, ma), (1, mb)):
        have = np.asarray(jt.inner[side].jk)
        jk = np.setdiff1d(rng.integers(400, 600, 3 * m + 1), have)
        jk = np.sort(rng.choice(jk, m)) if m else np.zeros(0, np.int64)
        pk = rng.choice(1 << 20, m, replace=False)
        order = np.lexsort((pk, jk))
        jk, pk = jk[order], pk[order]
        L = max(64, 1 << int(m).bit_length())
        vals = [padded(rng.integers(-9, 9, m), L, 0),
                np.where(np.arange(L) < m, rng.normal(0, 9, L), 0.0),
                padded(rng.integers(-9, 9, m), L, 0)]
        tch = padded(rng.integers(0, 9, m), L, 0)
        cols = (padded(jk, L), padded(pk, L), vals, tch)
        bufs_j.append((jnp.asarray(cols[0]), jnp.asarray(cols[1]),
                       tuple(jnp.asarray(v) for v in vals),
                       jnp.asarray(tch)))
        bufs_p.append((torch.from_numpy(cols[0]), torch.from_numpy(cols[1]),
                       tuple(torch.from_numpy(v) for v in vals),
                       torch.from_numpy(tch)))
    z = jnp.asarray(np.int64(0))
    rs, (ra, rb) = JF._join_promote_core(jt, bufs_j[0], bufs_j[1], (z, z),
                                         node=None)
    ps, (na, nb) = PF._join_promote_core(pt, bufs_p[0], bufs_p[1], None)
    assert_same(ps, rs)
    assert (int(na), int(nb)) == (int(ra), int(rb))
