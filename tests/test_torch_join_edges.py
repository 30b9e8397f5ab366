"""Edge shapes of the port's merge_side and batch_reduce_rows (plain
PyTorch versions, on the CPU) against the JAX package's, leaf by leaf and
dtype by dtype, padding included. The shapes are the ones the hand
kernels' tiles make hard (2048 rows of the merged order, or of sorted
rows, per tile): a side row and its delta twin straddling every tile edge
of the merge path, C + B at a multiple of the tile and one row either
side, an empty side, a delta of only EMPTY_KEY, all deletes, sign 0 and
+2 deltas, a result truncated to the capacity, f64 / int32 / bool
payloads; (jk, pk) runs crossing tiles or ending at their edges, and the
EMPTY_KEY segments' payload, which is sorted row 0's. The same shapes run
against the kernels on the card in chip_smoke.py. Inputs from numpy
seeds; every case has more than 3 tiles of rows."""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import risingwave_tpu.device.join_step as J
import risingwave_tpu_torch.device.join_step as P
from torch_parity import EMPTY, assert_same, payload

_J_BRR = jax.jit(J.batch_reduce_rows)
_J_MERGE = jax.jit(J.merge_side)

TILE = 2048                       # merged (or sorted) rows per kernel tile
C = 3 * TILE                      # side capacity of the merge cases
DTYPES = [np.float64, np.int32, np.bool_, np.int64]


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def sorted_pairs(rng, n):
    """n distinct (jk, pk) pairs ascending; jk repeats (a multimap)."""
    jk = rng.integers(0, max(n // 3, 1), 2 * n + 64)
    pk = rng.integers(-(1 << 40), 1 << 40, 2 * n + 64)
    pairs = np.unique(np.stack([jk, pk], 1), axis=0)
    pairs = pairs[np.sort(rng.choice(len(pairs), n, replace=False))]
    return pairs[:, 0].copy(), pairs[:, 1].copy()


def merge_items(rng, n_side, n_delta, p_pair, straddle):
    """Item kinds in merged order — "s" a side row alone, "d" a delta row
    alone, "p" a side row and its delta twin — up to n_side side and
    n_delta delta rows. With `straddle` a pair sits across every tile edge
    of the merged order (its side row the tile's last, its twin the next
    tile's first) until one run has no row left for a pair; returns the
    kinds and the first edge left without one."""
    kinds, pos, ns, nd, stop = [], 0, 0, 0, 1 << 62
    while ns < n_side or nd < n_delta:
        edge_next = straddle and (pos + 1) % TILE == 0
        edge_after = straddle and (pos + 2) % TILE == 0
        if edge_next and (ns == n_side or nd == n_delta):
            straddle, stop = False, pos + 1
        if straddle and edge_next:
            k = "p"
        else:
            # a lone row from either run in proportion to what it has left
            rs, rd = n_side - ns, n_delta - nd
            if rng.random() < p_pair and not edge_after:
                k = "p"
            else:
                k = "s" if rng.random() * (rs + rd) < rs else "d"
        ds, dd = (1, 1) if k == "p" else ((1, 0) if k == "s" else (0, 1))
        if ns + ds > n_side or nd + dd > n_delta:
            continue
        kinds.append(k)
        ns, nd, pos = ns + ds, nd + dd, pos + ds + dd
    return kinds, stop


def merge_case(case):
    """(side pair, djk, dpk, dsign, dvals) of one merge_side case."""
    rng = _rng(case)
    b, n_side, n_delta, p_pair, straddle = TILE, C - 40, TILE - 30, 0.3, True
    signs = [-1, 0, 1, 2]
    if case.startswith("n=4T"):
        # C + B at four tiles and one row either side, every slot live
        b = TILE + {"n=4T-1": -1, "n=4T": 0, "n=4T+1": 1}[case]
        n_side, n_delta, signs = C, b, [1, 1, 1, -1]
    elif case == "empty_side":
        n_side, signs = 0, [1, 1, -1, 2]
    elif case == "delta_all_empty":
        n_delta = 0
    elif case == "all_deletes":
        signs = [-1]
    elif case == "sign0_plus2":
        signs = [0, 2]
    elif case == "needed>C":
        p_pair, signs = 0.05, [1]
    kinds, stop = merge_items(rng, n_side, n_delta, p_pair, straddle)
    jk, pk = sorted_pairs(rng, len(kinds))
    kinds = np.array(kinds)
    in_side, in_delta = kinds != "d", kinds != "s"
    if case == "needed>C":
        assert in_side.sum() + (kinds == "d").sum() > C
    side = [np.full(C, EMPTY, np.int64) for _ in range(2)]
    ns = int(in_side.sum())
    side[0][:ns], side[1][:ns] = jk[in_side], pk[in_side]
    svals = []
    for dt in DTYPES:
        v = np.zeros(C, dt)
        v[:ns] = payload(rng, ns, dt)
        svals.append(v)
    nd = int(in_delta.sum())
    djk, dpk = np.full(b, EMPTY, np.int64), np.full(b, EMPTY, np.int64)
    djk[:nd], dpk[:nd] = jk[in_delta], pk[in_delta]
    dsign = np.zeros(b, np.int32)
    dsign[:nd] = rng.choice(signs, nd)
    dvals = [payload(rng, b, dt) for dt in DTYPES]
    cnt = np.int32(ns)
    jside = J.JoinSide(jnp.asarray(side[0]), jnp.asarray(side[1]),
                       jnp.asarray(cnt), tuple(jnp.asarray(v) for v in svals))
    pside = P.JoinSide(torch.from_numpy(side[0]), torch.from_numpy(side[1]),
                       torch.tensor(cnt),
                       tuple(torch.from_numpy(v) for v in svals))
    return jside, pside, djk, dpk, dsign, dvals, stop


def straddles(djk, dpk, side_jk, side_pk):
    """Tile edges e with merged row e - 1 a side row whose twin is row e."""
    n_s = int(np.sum(side_jk != EMPTY))
    n_d = int(np.sum(djk != EMPTY))
    jk = np.concatenate([side_jk[:n_s], djk[:n_d]])
    pk = np.concatenate([side_pk[:n_s], dpk[:n_d]])
    is_d = np.r_[np.zeros(n_s, int), np.ones(n_d, int)]
    o = np.lexsort((is_d, pk, jk))
    jk, pk, is_d = jk[o], pk[o], is_d[o]
    return [e for e in range(TILE, len(jk), TILE)
            if is_d[e - 1] == 0 and is_d[e] == 1 and jk[e - 1] == jk[e]
            and pk[e - 1] == pk[e]]


@pytest.mark.parametrize("case", ["straddle", "n=4T-1", "n=4T", "n=4T+1",
                                  "empty_side", "delta_all_empty",
                                  "all_deletes", "sign0_plus2", "needed>C"])
def test_merge_side_edges(case):
    jside, pside, djk, dpk, dsign, dvals, stop = merge_case(case)
    n = C + len(djk)
    assert n > 3 * TILE
    if case not in ("empty_side", "delta_all_empty"):
        # a twin pair across every tile edge of the live merged rows, up
        # to the first edge one run had no row left for
        live = int(np.sum(np.asarray(jside.jk) != EMPTY)) + int(
            np.sum(djk != EMPTY))
        edges = straddles(djk, dpk, np.asarray(jside.jk),
                          np.asarray(jside.pk))
        assert edges == list(range(TILE, min(live, stop), TILE))
        assert len(edges) >= 2
    ref = _J_MERGE(jside, jnp.asarray(djk), jnp.asarray(dpk),
                   jnp.asarray(dsign), [jnp.asarray(v) for v in dvals])
    got = P.merge_side(pside, torch.from_numpy(djk), torch.from_numpy(dpk),
                       torch.from_numpy(dsign),
                       [torch.from_numpy(v) for v in dvals])
    if case == "needed>C":
        assert int(ref[1]) > C
    if case == "delta_all_empty":
        assert int(ref[1]) == int(jside.count)
    assert_same(got, ref)


def reduce_case(case):
    """(jk, pk, signs, mask, vals) of one batch_reduce_rows case."""
    rng = _rng(case)
    n = 4 * TILE + 5
    mask = rng.random(n) < 0.9
    signs = rng.choice([-1, 0, 1, 2], n)
    if case == "segments_cross_tiles":
        # five (jk, pk) pairs: every run crosses several tiles
        pick = rng.integers(0, 5, n)
        jk, pk = np.array([3, 3, 8, 9, 9])[pick], np.array([1, 4, 0, 2, 7])[pick]
    elif case == "tile_edges":
        # runs that end at a tile edge, one row either side of one, or
        # cross more than one
        t = TILE
        ends = np.array([t - 1, t, t + 1, 2 * t - 1, 2 * t + 1, 3 * t,
                         3 * t + 2, n])
        run = np.repeat(np.arange(len(ends)), np.diff(np.r_[0, ends]))
        jk, pk = run // 3 * 5 - 7, (run % 3) * 11 + 2
        o = rng.permutation(n)
        jk, pk = jk[o], pk[o]
        mask = np.ones(n, bool)
    elif case == "unique_bids":
        jk, pk = rng.integers(0, 500, n), rng.permutation(n)
        signs = np.ones(n)
        mask = rng.random(n) < 0.92
    elif case == "empty_segment_row0":
        # unmasked EMPTY_KEY join keys beside live pks, and masked rows
        jk, pk = rng.integers(0, 40, n), rng.integers(0, 30, n)
        jk[rng.random(n) < 0.15] = EMPTY
    else:                         # "all_masked"
        jk, pk = rng.integers(0, 40, n), rng.integers(0, 30, n)
        mask = np.zeros(n, bool)
    vals = [payload(rng, n, dt) for dt in DTYPES]
    return (jk.astype(np.int64), pk.astype(np.int64), signs.astype(np.int32),
            mask, vals)


@pytest.mark.parametrize("case", ["segments_cross_tiles", "tile_edges",
                                  "unique_bids", "empty_segment_row0",
                                  "all_masked"])
def test_batch_reduce_rows_edges(case):
    jk, pk, signs, mask, vals = reduce_case(case)
    ref = _J_BRR(jnp.asarray(jk), jnp.asarray(pk), jnp.asarray(signs),
                 jnp.asarray(mask), [jnp.asarray(v) for v in vals])
    got = P.batch_reduce_rows(torch.from_numpy(jk), torch.from_numpy(pk),
                              torch.from_numpy(signs), torch.from_numpy(mask),
                              [torch.from_numpy(v) for v in vals])
    assert_same(got, ref)
    ujk, upk, usign, uvals = got
    pad = ujk == EMPTY
    if case in ("empty_segment_row0", "all_masked"):
        # the EMPTY_KEY segments and the slots past the last segment carry
        # the payload of sorted row 0 (not a neutral value), with sign 0
        mjk = np.where(mask, jk, EMPTY)
        mpk = np.where(mask, pk, EMPTY)
        row0 = np.lexsort((mpk, mjk))[0]
        assert bool(pad.any()) and bool(torch.all(usign[pad] == 0))
        for u, v in zip(uvals, vals):
            assert bool(torch.all(u[pad] == torch.from_numpy(v[row0:row0 + 1])))
    if case == "segments_cross_tiles":
        assert int((~pad).sum()) == 5
