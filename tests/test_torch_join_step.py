"""The port's join step (plain PyTorch versions, on the CPU) against the
JAX package's `device/join_step.py`: batch_reduce_rows, merge_side,
probe, join_core and local_join_step, every leaf and dtype equal,
padding included."""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import risingwave_tpu.device.join_step as J
import risingwave_tpu_torch.device.join_step as P
from risingwave_tpu_torch import kernels as K
from torch_parity import EMPTY, assert_same

_J_BRR = jax.jit(J.batch_reduce_rows)
_J_MERGE = jax.jit(J.merge_side)
_J_PROBE = jax.jit(J.probe, static_argnums=3)
_J_CORE = jax.jit(J.join_core, static_argnums=12)
_J_LOCAL = jax.jit(J.local_join_step, static_argnums=12)


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _t(xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def side_pair(rng, cap, jk, pk, dtypes):
    """The same side in both packages: (jk, pk) rows sorted and unique."""
    order = np.lexsort((pk, jk))
    jk, pk = np.asarray(jk)[order], np.asarray(pk)[order]
    n = len(jk)
    kk = np.full(cap, EMPTY, np.int64)
    pp = np.full(cap, EMPTY, np.int64)
    kk[:n], pp[:n] = jk, pk
    vals = []
    for dt in dtypes:
        v = np.zeros(cap, dt)
        v[:n] = rng.normal(0, 100, n) if dt == np.float64 \
            else rng.integers(-1000, 1000, n)
        vals.append(v)
    cnt = np.int32(n)
    return (J.JoinSide(jnp.asarray(kk), jnp.asarray(pp), jnp.asarray(cnt),
                       tuple(_j(vals))),
            P.JoinSide(torch.from_numpy(kk), torch.from_numpy(pp),
                       torch.tensor(cnt), tuple(_t(vals))))


def unique_pairs(rng, n, jk_hi, pk_hi):
    jk = rng.integers(0, jk_hi, 4 * n)
    pk = rng.integers(0, pk_hi, 4 * n)
    pairs = np.unique(np.stack([jk, pk], 1), axis=0)
    pairs = pairs[rng.permutation(len(pairs))[:n]]
    return pairs[:, 0].copy(), pairs[:, 1].copy()


# ---------------------------------------------------------------------------
# batch_reduce_rows
# ---------------------------------------------------------------------------


def rows_case(name):
    rng = _rng(name)
    n, jk_hi, pk_hi = 96, 8, 12
    dtypes = [np.int64, np.float64, np.int64]
    signs = rng.choice([-1, 1], n)
    mask = rng.random(n) < 0.8
    if name == "dups_mixed_signs":
        jk_hi, pk_hi = 3, 4
        signs = rng.choice([-1, 0, 1, 2], n)
    jk = rng.integers(0, jk_hi, n)
    pk = rng.integers(0, pk_hi, n)
    if name == "net_zero":
        # every (jk, pk) inserted once and deleted once
        jk, pk = np.repeat(jk[:n // 2], 2), np.repeat(pk[:n // 2], 2)
        signs = np.tile([1, -1], n // 2)
        mask = np.ones(n, bool)
    elif name == "all_masked":
        mask = np.zeros(n, bool)
    elif name == "n1":
        jk, pk, signs, mask = jk[:1], pk[:1], signs[:1], np.ones(1, bool)
    elif name == "empty_jk_unmasked":
        jk[rng.random(n) < 0.2] = EMPTY
    elif name == "no_payload":
        dtypes = []
    vals = [rng.normal(0, 100, len(jk)) if dt == np.float64
            else rng.integers(-1000, 1000, len(jk)) for dt in dtypes]
    return jk, pk, signs.astype(np.int32), mask, vals


@pytest.mark.parametrize("case", ["random", "dups_mixed_signs", "net_zero",
                                  "all_masked", "n1", "empty_jk_unmasked",
                                  "no_payload"])
def test_batch_reduce_rows(case):
    jk, pk, signs, mask, vals = rows_case(case)
    ref = _J_BRR(*_j([jk, pk, signs, mask]), _j(vals))
    got = P.batch_reduce_rows(*_t([jk, pk, signs, mask]), _t(vals))
    assert_same(got, ref)
    if case == "net_zero":
        live = got[0] != EMPTY
        assert bool(torch.all(got[2][live] == 0)) and bool(live.any())


# ---------------------------------------------------------------------------
# merge_side
# ---------------------------------------------------------------------------


def merge_case(name):
    rng = _rng(name)
    cap, b = 64, 48
    dtypes = [np.int64, np.float64]
    sjk, spk = unique_pairs(rng, 0 if name == "empty_state" else 30, 6, 20)
    if name == "needed_gt_c":
        cap = 32
    js, ps = side_pair(rng, cap, sjk, spk, dtypes)
    # deltas: some on present rows, some absent, in (jk, pk) order
    djk, dpk = unique_pairs(rng, 0 if name == "empty_delta" else 36, 6, 20)
    order = np.lexsort((dpk, djk))
    djk, dpk = djk[order], dpk[order]
    nd = len(djk)
    sign = rng.choice([-1, 0, 1, 2], nd)
    if name == "needed_gt_c":
        sign = np.ones(nd, np.int64)
    kk = np.full(b, EMPTY, np.int64)
    pp = np.full(b, EMPTY, np.int64)
    ss = np.zeros(b, np.int32)
    kk[:nd], pp[:nd], ss[:nd] = djk, dpk, sign
    dvals = [rng.integers(-1000, 1000, b), rng.normal(0, 100, b)]
    return js, ps, kk, pp, ss, dvals


@pytest.mark.parametrize("case", ["random", "empty_state", "empty_delta",
                                  "needed_gt_c"])
def test_merge_side(case):
    js, ps, djk, dpk, dsign, dvals = merge_case(case)
    ref = _J_MERGE(js, *_j([djk, dpk, dsign]), _j(dvals))
    got = P.merge_side(ps, *_t([djk, dpk, dsign]), _t(dvals))
    if case == "needed_gt_c":
        assert int(ref[1]) > js.jk.shape[0]
    assert_same(got, ref)


def test_merge_side_semantics():
    """Upsert, delete of a present row, delete of an absent row, a zero
    sign on a present row, a lone net +2 insert — one delta each."""
    rng = _rng("semantics")
    js, ps = side_pair(rng, 8, [1, 1, 2], [10, 11, 20], [np.int64])
    djk = np.array([1, 1, 2, 3, 4, EMPTY, EMPTY, EMPTY], np.int64)
    dpk = np.array([10, 11, 21, 30, 40, EMPTY, EMPTY, EMPTY], np.int64)
    dsign = np.array([1, -1, -1, 2, 0, 0, 0, 0], np.int32)
    dval = np.array([777, 5, 6, 8, 9, 0, 0, 0], np.int64)
    ref = _J_MERGE(js, *_j([djk, dpk, dsign]), _j([dval]))
    got = P.merge_side(ps, *_t([djk, dpk, dsign]), _t([dval]))
    assert_same(got, ref)
    side, needed = got
    n = int(side.count)
    rows = list(zip(side.jk[:n].tolist(), side.pk[:n].tolist(),
                    side.vals[0][:n].tolist()))
    keep = int(ps.vals[0][2])                 # (2, 20): untouched
    assert rows == [(1, 10, 777), (2, 20, keep), (3, 30, 8)]
    assert int(needed) == 3


@pytest.mark.parametrize("case", ["unsorted", "empty_hole", "duplicate"])
def test_merge_side_rejects_delta_out_of_order(case):
    """The kernel merges two sorted runs without re-sorting, so the plain
    version holds every caller to the same order and raises."""
    _, ps, djk, dpk, dsign, dvals = merge_case("random")
    if case == "unsorted":
        djk[[0, 1]], dpk[[0, 1]] = djk[[1, 0]], dpk[[1, 0]]
    elif case == "empty_hole":
        djk[2], dpk[2] = EMPTY, EMPTY
    else:
        djk[1], dpk[1] = djk[0], dpk[0]
    with pytest.raises(ValueError, match="ascending"):
        K.merge_side_plain(ps, *_t([djk, dpk, dsign]), _t(dvals))


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------


def probe_case(name):
    rng = _rng(name)
    cap, q, m = 128, 40, 96
    sjk, spk = unique_pairs(rng, 0 if name == "empty_side" else 90, 10, 50)
    if name == "hot_key":
        sjk[:60] = 4
        spk[:60] = np.arange(60) + 1000
    js, ps = side_pair(rng, cap, sjk, spk, [np.int64])
    qjk = rng.integers(0, 11, q)
    qmask = rng.random(q) < 0.85
    if name == "total_gt_m":
        m = 16
    elif name == "masked_and_empty":
        qjk[rng.random(q) < 0.3] = EMPTY
        qmask[-1] = False
    elif name == "q1":
        qjk, qmask = qjk[:1], np.ones(1, bool)
    elif name.startswith("brr_order"):
        # the main path's queries: batch_reduce_rows' output, jk sorted,
        # rows whose signs net to 0 masked in place, EMPTY_KEY padding
        bjk = rng.integers(0, 11, q)
        if name == "brr_order_hot":
            bjk[: q // 2] = 4
        bpk = rng.integers(0, 6, q)
        signs = rng.choice([-1, 0, 1, 1], q).astype(np.int32)
        ujk, _, usign, _ = P.batch_reduce_rows(
            *_t([bjk, bpk, signs, rng.random(q) < 0.9]), [])
        qjk, qmask = ujk.numpy(), (usign != 0).numpy()
        assert (~qmask & (qjk != EMPTY)).any() and (qjk == EMPTY).any()
    elif name == "all_masked":
        qmask[:] = False
    return js, ps, qjk, qmask, m


@pytest.mark.parametrize("case", ["random", "total_gt_m", "hot_key",
                                  "masked_and_empty", "empty_side", "q1",
                                  "brr_order", "brr_order_hot",
                                  "all_masked"])
def test_probe(case):
    js, ps, qjk, qmask, m = probe_case(case)
    ref = _J_PROBE(js, *_j([qjk, qmask]), m)
    got = P.probe(ps, *_t([qjk, qmask]), m)
    if case == "total_gt_m":
        assert int(ref[3]) > m
    assert_same(got, ref)


# ---------------------------------------------------------------------------
# join_core and local_join_step over several epochs
# ---------------------------------------------------------------------------


A_DT = [np.int64, np.int64, np.float64]
B_DT = [np.int64, np.int64]


def epoch_rows(rng, n, live_a, live_b, name):
    """One epoch of both sides' rows: inserts of fresh pks and, for
    "retractions", deletes of rows inserted earlier."""
    out = []
    for side, dts, live in (("a", A_DT, live_a), ("b", B_DT, live_b)):
        jk = rng.integers(0, 6, n)
        pk = rng.integers(0, 1 << 40, n)
        sign = np.ones(n, np.int32)
        if name == "retractions" and live:
            k = min(len(live), n // 3)
            pick = rng.choice(len(live), k, replace=False)
            for i, j in enumerate(pick):
                jk[i], pk[i] = live[j]
                sign[i] = -1
        mask = rng.random(n) < 0.9
        vals = [rng.normal(0, 100, n) if dt == np.float64
                else rng.integers(-1000, 1000, n) for dt in dts]
        # the payload of a delete is the row's (the reference reads it
        # for the retracted pair)
        out.append((jk, pk, sign, mask, vals))
        for i in range(n):
            if mask[i] and sign[i] == 1:
                live.append((jk[i], pk[i]))
            elif mask[i] and sign[i] == -1 and (jk[i], pk[i]) in live:
                live.remove((jk[i], pk[i]))
    return out


@pytest.mark.parametrize("case", ["random", "retractions", "needed_gt_c",
                                  "total_gt_m"])
@pytest.mark.parametrize("fn", ["join_core", "local_join_step"])
def test_join_steps(fn, case):
    rng = _rng(fn + case)
    cap, m, n = 64, 128, 24
    if case == "needed_gt_c":
        cap = 16
    elif case == "total_gt_m":
        m = 8
    ja, pa = side_pair(rng, cap, [], [], A_DT)
    jb, pb = side_pair(rng, cap, [], [], B_DT)
    live_a, live_b = [], []
    ref_fn, port_fn = ((_J_CORE, P.join_core) if fn == "join_core"
                       else (_J_LOCAL, P.local_join_step))
    for _ in range(3):
        (ajk, apk, asg, amk, avals), (bjk, bpk, bsg, bmk, bvals) = \
            epoch_rows(rng, n, live_a, live_b, case)
        ref = ref_fn(ja, jb, *_j([ajk, apk, asg, amk]), tuple(_j(avals)),
                     *_j([bjk, bpk, bsg, bmk]), tuple(_j(bvals)), m)
        got = port_fn(pa, pb, *_t([ajk, apk, asg, amk]), tuple(_t(avals)),
                      *_t([bjk, bpk, bsg, bmk]), tuple(_t(bvals)), m)
        assert_same(got, ref)
        ja, jb, pa, pb = ref[0], ref[1], got[0], got[1]
    needed = ref[-1]
    if case == "needed_gt_c":
        assert int(needed["a"]) > cap or int(needed["b"]) > cap
    if case == "total_gt_m":
        assert int(needed["pairs"]) > m


def test_same_epoch_two_sided_change_nets_to_zero():
    """A new left row and the delete of its only right match in ONE
    epoch: dA >< B_old emits the pair (+1) that A_new >< dB retracts
    (-1). local_join_step nets it to sign 0 (masked), and retracts the
    old left row's pair, as the reference does."""
    rng = _rng("netting")
    ja, pa = side_pair(rng, 8, [1], [100], [np.int64])
    jb, pb = side_pair(rng, 8, [1], [200], [np.int64])
    a = ([1], [101], [1], [True], [[5]])
    b = ([1], [200], [-1], [True], [[int(pb.vals[0][0])]])
    args_a = [np.asarray(x, np.int32 if i == 2 else None)
              for i, x in enumerate(a[:4])]
    args_b = [np.asarray(x, np.int32 if i == 2 else None)
              for i, x in enumerate(b[:4])]
    va, vb = [np.asarray(v) for v in a[4]], [np.asarray(v) for v in b[4]]
    ref = _J_LOCAL(ja, jb, *_j(args_a), tuple(_j(va)), *_j(args_b),
                   tuple(_j(vb)), 4)
    got = P.local_join_step(pa, pb, *_t(args_a), tuple(_t(va)),
                            *_t(args_b), tuple(_t(vb)), 4)
    assert_same(got, ref)
    _, _, njk, npk, nsign, _, _ = got
    pairs = {(int(x), int(y)): int(s) for x, y, s in zip(njk, npk, nsign)
             if int(x) != EMPTY}
    assert pairs == {(100, 200): -1, (101, 200): 0}


def test_make_and_grow_side():
    js = J.make_side(8, [jnp.int64, jnp.float64])
    ps = P.make_side(8, [torch.int64, torch.float64], "cpu")
    assert_same(ps, js)
    assert_same(P.grow_side(ps, 32), J.grow_side(js, 32))
    with pytest.raises(ValueError):
        P.grow_side(ps, 4)
