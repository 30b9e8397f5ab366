#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py          # from the repository root

Phases (any failure exits non-zero; nothing is caught):
  1. card     — name, power limit, torch and CUDA versions
  2. build    — compile every kernel source in
                 risingwave_tpu_torch/kernels/csrc (sorted_runs.cu and
                 join_runs.cu, one nvcc each, in parallel) into
                 build/torch_kernels
  3. kernels  — each of the seven kernels against its plain PyTorch version
                 on the card, at the main paths' shapes and on edge cases:
                 exact for integer and bool leaves; a float SUM within 1e-12
                 of the summed magnitudes (the plain version adds with
                 atomics, in no fixed order)
  4a. q4      — Nexmark q4 (`SELECT auction, count(*), sum(price),
                 max(price) FROM bid GROUP BY auction`, pre-combine on) over
                 2^24 events in epochs of 2^20 from a 2^16 capacity, with a
                 checkpoint every 4 epochs; rows checked in key order against
                 a numpy group-by of the port generator's bid stream
  4b. q3a     — Nexmark q3a (`SELECT b.auction, b.price, a.seller,
                 a.category FROM bid b JOIN auction a ON b.auction = a.id
                 WHERE b.price > 500`) over 2^23 events in epochs of 2^20,
                 join sides and MV from 2^16, pairs from 4 x 2^16, a
                 checkpoint every 4 epochs; rows checked in (bid, auction)
                 row-id order against a numpy hash join of the port
                 generator's streams
  5. timings  — each kernel at its main-path shape: median of CUDA-event
                 times over 25 runs, beside its plain version, a PyTorch
                 library composition of the same function, and its
                 device-memory bound at 3.35 TB/s (H100 SXM)
Launch counts are zeroed just before each main path and read just after.
The last four lines are the card line, the {"main": ...} line, the
{"kernels": [...]} line and the {"ok": ...} line, in that order.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from risingwave_tpu_torch import kernels as K
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
from risingwave_tpu_torch.core import dtypes as T
from risingwave_tpu_torch.device import fused as F
from risingwave_tpu_torch.device.agg_step import DeviceAggSpec
from risingwave_tpu_torch.device.join_step import JoinSide, join_core
from risingwave_tpu_torch.device.nexmark_gen import (GenCfg, gen_table,
                                                     table_mask)
from risingwave_tpu_torch.device.sorted_state import (EMPTY_KEY, ReduceKind,
                                                      SortedState, _neutral)
from risingwave_tpu_torch.expr.expression import InputRef, Literal
from risingwave_tpu_torch.expr.functions import build_device

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
CSRC = "risingwave_tpu_torch/kernels/csrc/"
REPLACES = {"sort_cols": "risingwave_tpu/device/sorted_state.py:189",
            "batch_reduce": "risingwave_tpu/device/sorted_state.py:108",
            "merge": "risingwave_tpu/device/sorted_state.py:227",
            "compact_rows": "risingwave_tpu/device/sorted_state.py:206",
            "batch_reduce_rows": "risingwave_tpu/device/join_step.py:57",
            "merge_side": "risingwave_tpu/device/join_step.py:83",
            "probe": "risingwave_tpu/device/join_step.py:118"}
Q4_KERNELS = ("sort_cols", "batch_reduce", "merge", "compact_rows")
Q3A_KERNELS = ("sort_cols", "compact_rows", "batch_reduce_rows", "merge_side",
               "probe")
SOURCE = {k: CSRC + ("join_runs.cu" if "join_step" in v else "sorted_runs.cu")
          for k, v in REPLACES.items()}
MAX_EVENTS = 1 << 24
Q3_EVENTS = 1 << 23
EPOCH_EVENTS = 1 << 20
CAPACITY = 1 << 16
CKPT_EVERY = 4

S, MN, MX, R = (ReduceKind.SUM, ReduceKind.MIN, ReduceKind.MAX,
                ReduceKind.REPLACE)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in leaves(e)]
    raise TypeError(type(x))


def compare(name: str, case: str, got, want, float_atol: float = 0.0
            ) -> float:
    """Every leaf equal (integer/bool exactly; float within float_atol);
    returns the max abs difference."""
    g, w = leaves(got), leaves(want)
    if len(g) != len(w):
        raise AssertionError(f"{name}/{case}: {len(g)} leaves vs {len(w)}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(g, w)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}/{case} leaf {i}: {a.dtype}{tuple(a.shape)}"
                                 f" vs {b.dtype}{tuple(b.shape)}")
        if a.dtype.is_floating_point:
            fin = torch.isfinite(b)
            if not torch.equal(torch.isfinite(a), fin) or not torch.equal(
                    a[~fin], b[~fin]):
                raise AssertionError(f"{name}/{case} leaf {i}: non-finite differ")
            d = (a[fin] - b[fin]).abs()
            err = float(d.max()) if d.numel() else 0.0
            if err > float_atol:
                raise AssertionError(f"{name}/{case} leaf {i}: max abs err "
                                     f"{err} > {float_atol}")
            worst = max(worst, err)
        elif not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{name}/{case} leaf {i}: {bad} elements differ")
    return worst


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def rand_keys(rng, n, lo, hi):
    return rng.integers(lo, hi, size=n, dtype=np.int64)


def payload(rng, n, dtype):
    if dtype == torch.float64:
        return torch.from_numpy(rng.normal(0, 1000, n))
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(n) < 0.5)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-1000, 1000, n, dtype=np.int32))
    return torch.from_numpy(rng.integers(-10**6, 10**6, n, dtype=np.int64))


ALL_KINDS = [(S, torch.int64), (MN, torch.int64), (MX, torch.int64),
             (R, torch.int64), (S, torch.int32), (R, torch.int32),
             (S, torch.float64), (MN, torch.float64), (MX, torch.float64),
             (R, torch.float64), (R, torch.bool)]
Q4_PRE_KINDS = [(S, torch.int64)] * 4 + [(MX, torch.int64), (S, torch.int64)]


def br_cases(rng, dev):
    """(case, keys, mask, vals, kinds) for batch_reduce at 2^20 and edges."""
    n = 1 << 20
    out = []

    def mk(case, keys, mask, spec):
        vals = [payload(rng, len(keys), d).to(dev) for _, d in spec]
        out.append((case, torch.from_numpy(keys).to(dev),
                    torch.from_numpy(mask).to(dev), vals,
                    [k for k, _ in spec]))

    mk("q4_shape_2^20", rand_keys(rng, n, 0, 1 << 20), rng.random(n) < 0.92,
       [(S, torch.int64)] + Q4_PRE_KINDS)
    mk("all_kinds_2^20", rand_keys(rng, n, -5000, 5000),
       rng.random(n) < 0.9, ALL_KINDS)
    mk("n=1", rand_keys(rng, 1, 0, 10), np.ones(1, bool), ALL_KINDS)
    mk("all_keys_equal", np.full(n, 7, np.int64), np.ones(n, bool),
       ALL_KINDS)
    mk("all_masked", rand_keys(rng, 4096, 0, 100), np.zeros(4096, bool),
       ALL_KINDS)
    k = rand_keys(rng, 65536, 0, 1000)
    k[rng.random(65536) < 0.1] = EMPTY_KEY
    mk("empty_key_inside", k, rng.random(65536) < 0.9, ALL_KINDS)
    mk("negative_keys", rand_keys(rng, 65536, -(1 << 62), -(1 << 62) + 5000),
       rng.random(65536) < 0.9, ALL_KINDS)
    return out


def sorted_unique(rng, m, lo, hi):
    return np.unique(rng.integers(lo, hi, size=m, dtype=np.int64))


def make_sorted_state(rng, cap, keys, spec, dev):
    """A SortedState of capacity `cap` holding `keys` (sorted unique); the
    first (dead) column is nonzero on every live row."""
    n = len(keys)
    kk = np.full(cap, EMPTY_KEY, np.int64)
    kk[:n] = keys
    vals = []
    for j, (k, d) in enumerate(spec):
        v = torch.full((cap,), _neutral(k, d), dtype=d)
        live = payload(rng, n, d)
        if j == 0:
            live = live.abs() + 1 if d != torch.bool else torch.ones(n, dtype=d)
        v[:n] = live
        vals.append(v.to(dev))
    return SortedState(torch.from_numpy(kk).to(dev),
                       torch.tensor(n, dtype=torch.int32, device=dev),
                       tuple(vals))


def merge_cases(rng, dev):
    """(case, state, dkeys, dvals, kinds, drop_dead) with sorted unique
    deltas (batch_reduce output order), EMPTY_KEY padded."""
    out = []

    def mk(case, cap, skeys, b, dkeys, spec, drop_dead=True, kill=0.2):
        st = make_sorted_state(rng, cap, skeys, spec, dev)
        nd = len(dkeys)
        dk = np.full(b, EMPTY_KEY, np.int64)
        dk[:nd] = dkeys
        dvals = []
        for k, d in spec:
            v = payload(rng, b, d)
            v[nd:] = _neutral(k, d)
            dvals.append(v)
        if nd and len(skeys):
            # some deltas take their group's dead column to 0 (death)
            pos = np.clip(np.searchsorted(skeys, dkeys), 0, len(skeys) - 1)
            kill_m = (skeys[pos] == dkeys) & (rng.random(nd) < kill)
            rows = torch.from_numpy(np.flatnonzero(kill_m))
            s0 = st.vals[0].cpu()[torch.from_numpy(pos[kill_m])]
            dvals[0][rows] = -s0 if spec[0][0] == S else torch.zeros_like(s0)
        out.append((case, st, torch.from_numpy(dk).to(dev),
                    [v.to(dev) for v in dvals], [k for k, _ in spec],
                    drop_dead))

    c, b = 1 << 21, 1 << 20
    agg = [(S, torch.int64)] * 4 + [(MX, torch.int64), (S, torch.int64)]
    mk("agg_C=2^21_B=2^20", c, sorted_unique(rng, 1 << 20, 0, 1 << 21), b,
       sorted_unique(rng, 300_000, 0, 1 << 21), agg)
    mv = [(R, torch.int32)] + [(R, torch.int64), (R, torch.bool)] * 3
    mk("mv_replace", c, sorted_unique(rng, 1 << 20, 0, 1 << 21), b,
       sorted_unique(rng, 300_000, 0, 1 << 21), mv)
    mk("all_kinds", 8192, sorted_unique(rng, 3000, -5000, 5000), 4096,
       sorted_unique(rng, 2000, -5000, 5000), ALL_KINDS)
    mk("no_drop_dead", 8192, sorted_unique(rng, 3000, -5000, 5000), 4096,
       sorted_unique(rng, 2000, -5000, 5000), ALL_KINDS, drop_dead=False)
    mk("needed>C", 4096, sorted_unique(rng, 3500, 0, 10**6), 4096,
       sorted_unique(rng, 3000, 0, 10**6), agg, kill=0.0)
    mk("n=1", 1, np.array([5], np.int64), 1, np.array([5], np.int64), agg,
       kill=0.0)
    mk("negative_keys", 8192, sorted_unique(rng, 3000, -(1 << 62),
                                            -(1 << 62) + 9000), 4096,
       sorted_unique(rng, 2000, -(1 << 62), -(1 << 62) + 9000), agg)
    mk("empty_state", 4096, np.zeros(0, np.int64), 4096,
       sorted_unique(rng, 1000, 0, 10**6), agg)
    return out


def compact_cases(rng, dev):
    out = []
    cols_spec = [torch.int64, torch.int32, torch.float64, torch.bool]

    def mk(case, alive, out_len):
        n = len(alive)
        keys = [torch.from_numpy(rand_keys(rng, n, 0, 1 << 40)).to(dev)]
        cols = [payload(rng, n, d).to(dev) for d in cols_spec]
        fills = [EMPTY_KEY, 0, -1, 0.5, False]
        out.append((case, torch.from_numpy(alive).to(dev), keys, cols,
                    out_len, fills))

    n = (1 << 21) + (1 << 20)
    mk("merge_shape", rng.random(n) < 0.4, 1 << 21)
    mk("needed>out_len", rng.random(n) < 0.9, 1 << 21)
    mk("all_alive", np.ones(1 << 20, bool), 1 << 20)
    mk("none_alive", np.zeros(1 << 20, bool), 1 << 20)
    mk("n=1", np.ones(1, bool), 1)
    mk("out_len>n", rng.random(1000) < 0.5, 5000)
    return out


def sort_cases(rng, dev):
    out = []
    n = 1 << 20
    pay = [torch.int64, torch.int32, torch.float64, torch.bool]

    def mk(case, keys):
        ks = [torch.from_numpy(k).to(dev) for k in keys]
        cols = [payload(rng, len(keys[0]), d).to(dev) for d in pay]
        out.append((case, ks, cols))

    k = rand_keys(rng, n, -(1 << 40), 1 << 40)
    k[rng.random(n) < 0.05] = EMPTY_KEY
    mk("one_key_2^20_with_empty", [k])
    mk("two_keys_2^20", [rand_keys(rng, n, 0, 1000),
                         rand_keys(rng, n, -(1 << 62), 1 << 62)])
    mk("all_equal_2^20", [np.full(n, -3, np.int64)])
    mk("n=1", [rand_keys(rng, 1, 0, 5)])
    mk("negative_keys", [rand_keys(rng, 65536, np.iinfo(np.int64).min,
                                   -(1 << 50))])
    return out


def _dev(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def unique_pairs(rng, n, jk_hi, pk_hi):
    """n distinct (jk, pk) pairs in random order."""
    jk = rand_keys(rng, 2 * n + 16, 0, jk_hi)
    pk = rand_keys(rng, 2 * n + 16, 0, pk_hi)
    pairs = np.unique(np.stack([jk, pk], 1), axis=0)
    pairs = pairs[rng.permutation(len(pairs))[:n]]
    return pairs[:, 0].copy(), pairs[:, 1].copy()


def brr_cases(rng, dev):
    """(case, jk, pk, signs, mask, vals) for batch_reduce_rows at the q3a
    shapes (an epoch's bids, the netting pass's 2m pair rows x 19
    columns) and on edge cases."""
    out = []

    def mk(case, jk, pk, signs, mask, dtypes):
        vals = [payload(rng, len(jk), d).to(dev) for d in dtypes]
        out.append((case, _dev(jk, dev), _dev(pk, dev),
                    _dev(np.asarray(signs, np.int32), dev), _dev(mask, dev),
                    vals))

    n = 1 << 20
    mk("q3a_bids_2^20", rand_keys(rng, n, 0, 1 << 19),
       np.arange(n, dtype=np.int64), np.ones(n), rng.random(n) < 0.92,
       [torch.int64] * 8)
    m2 = 1 << 21
    a, b = rand_keys(rng, m2, 0, 1 << 23), rand_keys(rng, m2, 0, 1 << 22)
    dup = rng.random(m2) < 0.3                 # pairs from both probes
    src = rng.integers(0, m2, m2)
    a[dup], b[dup] = a[src[dup]], b[src[dup]]
    mk("netting_2^21x19", a, b, rng.choice([-1, 1], m2),
       rng.random(m2) < 0.7, [torch.int64] * 15 + [torch.float64] * 4)
    k = 65536
    mk("dups_mixed_signs", rand_keys(rng, k, 0, 40), rand_keys(rng, k, 0, 30),
       rng.choice([-1, 0, 1, 2], k), rng.random(k) < 0.9,
       [torch.int64, torch.float64, torch.int32, torch.bool])
    jk, pk = unique_pairs(rng, k // 2, 1000, 1000)
    mk("net_zero", np.repeat(jk, 2), np.repeat(pk, 2), np.tile([1, -1], k // 2),
       np.ones(k, bool), [torch.int64, torch.float64])
    mk("all_masked", rand_keys(rng, 4096, 0, 9), rand_keys(rng, 4096, 0, 9),
       np.ones(4096), np.zeros(4096, bool), [torch.int64, torch.float64])
    mk("n=1", np.array([3]), np.array([4]), np.array([-1]), np.ones(1, bool),
       [torch.int64])
    jk = rand_keys(rng, k, 0, 100)
    jk[rng.random(k) < 0.1] = EMPTY_KEY
    mk("empty_jk_unmasked", jk, rand_keys(rng, k, 0, 100), np.ones(k),
       rng.random(k) < 0.9, [torch.int64, torch.float64])
    jk, pk = rand_keys(rng, k, 0, 50), rand_keys(rng, k, 0, 50)
    jk[: k // 2], pk[: k // 2] = 7, 9           # one hot (jk, pk) pair
    mk("hot_pair", jk, pk, rng.choice([-1, 1], k), np.ones(k, bool),
       [torch.int64])
    return out


def join_side(rng, cap, jk, pk, dtypes, dev):
    """A JoinSide of capacity `cap` holding the (jk, pk) rows, sorted."""
    order = np.lexsort((pk, jk))
    n = len(order)
    kk = np.full(cap, EMPTY_KEY, np.int64)
    pp = np.full(cap, EMPTY_KEY, np.int64)
    kk[:n], pp[:n] = np.asarray(jk)[order], np.asarray(pk)[order]
    vals = []
    for d in dtypes:
        v = torch.zeros(cap, dtype=d)
        v[:n] = payload(rng, n, d)
        vals.append(v.to(dev))
    return JoinSide(_dev(kk, dev), _dev(pp, dev),
                    torch.tensor(n, dtype=torch.int32, device=dev),
                    tuple(vals))


def side_delta(rng, b, jk, pk, signs, dtypes, dev):
    """(djk, dpk, dsign, dvals): the rows sorted by (jk, pk), padded to b
    with EMPTY_KEY — batch_reduce_rows' output order."""
    order = np.lexsort((pk, jk))
    n = len(order)
    kk = np.full(b, EMPTY_KEY, np.int64)
    pp = np.full(b, EMPTY_KEY, np.int64)
    ss = np.zeros(b, np.int32)
    kk[:n], pp[:n] = np.asarray(jk)[order], np.asarray(pk)[order]
    ss[:n] = np.asarray(signs)[order]
    return (_dev(kk, dev), _dev(pp, dev), _dev(ss, dev),
            [payload(rng, b, d).to(dev) for d in dtypes])


def ms_cases(rng, dev):
    """(case, side, djk, dpk, dsign, dvals) for merge_side."""
    out = []

    def mk(case, cap, b, s_pairs, d_pairs, signs, dtypes):
        side = join_side(rng, cap, *s_pairs, dtypes, dev)
        out.append((case, side) + side_delta(rng, b, *d_pairs, signs,
                                             dtypes, dev))

    # the bid side: ~3M rows, an epoch of 0.9M new bids (unique pks)
    n_s, n_d = 3_000_000, 900_000
    pk = rng.permutation(n_s + n_d)
    mk("q3a_bids_C=2^22_B=2^20", 1 << 22, 1 << 20,
       (rand_keys(rng, n_s, 0, 1 << 19), pk[:n_s]),
       (rand_keys(rng, n_d, 0, 1 << 19), pk[n_s:]), np.ones(n_d),
       [torch.int64] * 8)
    # the pair MV: inserts, retractions of present pairs, masked (0) rows
    sj, sp = unique_pairs(rng, 1_000_000, 1 << 22, 1 << 22)
    nj, np_ = unique_pairs(rng, 600_000, 1 << 22, 1 << 22)
    hit = rng.random(len(nj)) < 0.3
    pick = rng.integers(0, len(sj), len(nj))
    nj[hit], np_[hit] = sj[pick[hit]], sp[pick[hit]]
    dj, dp = np.unique(np.stack([nj, np_], 1), axis=0).T
    mk("mv_pairs_C=2^21", 1 << 21, 1 << 20, (sj, sp), (dj, dp),
       rng.choice([-1, 0, 1, 1, 1], len(dj)), [torch.int64] * 6)
    # upserts, deletes of present and absent rows, zero signs, net +2
    sj, sp = unique_pairs(rng, 3000, 200, 200)
    nj, np_ = unique_pairs(rng, 3000, 200, 200)
    dj, dp = np.unique(np.stack([np.r_[sj[:1500], nj], np.r_[sp[:1500], np_]],
                                1), axis=0).T
    mk("upsert_delete_absent_+2", 8192, 8192, (sj, sp), (dj, dp),
       rng.choice([-1, 0, 1, 2], len(dj)),
       [torch.int64, torch.float64, torch.int64])
    e = np.zeros(0, np.int64)
    mk("empty_state", 4096, 4096, (e, e), unique_pairs(rng, 1000, 99, 99),
       np.ones(1000), [torch.int64])
    mk("empty_delta", 4096, 4096, unique_pairs(rng, 1000, 99, 99), (e, e),
       e, [torch.int64])
    mk("needed>C", 4096, 4096, unique_pairs(rng, 3500, 10**6, 10**6),
       unique_pairs(rng, 3000, 10**6, 10**6), np.ones(3000), [torch.int64])
    mk("n=1", 1, 1, (np.array([5]), np.array([6])),
       (np.array([5]), np.array([6])), np.array([1]), [torch.int64])
    return out


def probe_cases(rng, dev):
    """(case, side, qjk, qmask, m) for probe."""
    out = []

    def mk(case, side, qjk, qmask, m):
        out.append((case, side, _dev(qjk, dev), _dev(qmask, dev), m))

    q = 1 << 20
    # an epoch's bids probing the auction side (one match each)
    auctions = join_side(rng, 1 << 20, np.arange(500_000),
                         np.arange(500_000), [torch.int64] * 11, dev)
    mk("q3a_bids_x_auctions", auctions, rand_keys(rng, q, 0, 520_000),
       rng.random(q) < 0.92, 1 << 21)
    # new auctions probing the bid side (many matches each)
    big = join_side(rng, 1 << 22, rand_keys(rng, 3_000_000, 0, 1 << 19),
                    rng.permutation(3_000_000), [torch.int64], dev)
    qjk = rand_keys(rng, q, 0, 1 << 19)
    mk("total>m", big, qjk, rng.random(q) < 0.92, 1 << 16)
    jk = rand_keys(rng, 20_000, 0, 1000)
    jk[:5000] = 7                              # a hot key, 5000 matches
    hot = join_side(rng, 32768, jk, np.arange(20_000), [torch.int64], dev)
    qjk = rand_keys(rng, 65536, 0, 1000)
    qjk[rng.random(65536) < 0.003] = 7
    mk("hot_key_5000", hot, qjk, np.ones(65536, bool), 1 << 21)
    qjk = rand_keys(rng, 65536, 0, 1000)
    qjk[rng.random(65536) < 0.2] = EMPTY_KEY
    qm = rng.random(65536) < 0.8
    qm[-1] = False
    mk("masked_and_empty", hot, qjk, qm, 1 << 18)
    e = np.zeros(0, np.int64)
    mk("empty_side", join_side(rng, 4096, e, e, [torch.int64], dev),
       rand_keys(rng, 4096, 0, 10), np.ones(4096, bool), 4096)
    mk("q=1", hot, np.array([7]), np.ones(1, bool), 8192)
    return out


def check_kernels(dev) -> dict:
    rng = np.random.default_rng(20241017)
    err = {k: 0.0 for k in REPLACES}
    for case, keys, cols in sort_cases(rng, dev):
        got = K.sort_cols(keys, cols)
        want = K.sort_cols_plain(keys, cols)
        torch.cuda.synchronize()
        err["sort_cols"] = max(err["sort_cols"],
                               compare("sort_cols", case, got, want))
    for case, keys, mask, vals, kinds in br_cases(rng, dev):
        got = K.batch_reduce(keys, mask, vals, kinds)
        want = K.batch_reduce_plain(keys, mask, vals, kinds)
        torch.cuda.synchronize()
        # a float SUM may differ by rounding order: within 1e-12 of the
        # summed magnitudes (the plain version adds with atomics)
        scale = max([float(v.abs().sum()) for v in vals
                     if v.dtype.is_floating_point] or [0.0])
        err["batch_reduce"] = max(err["batch_reduce"], compare(
            "batch_reduce", case, got, want, float_atol=1e-12 * scale))
    for case, st, dk, dv, kinds, drop in merge_cases(rng, dev):
        got = K.merge(st, dk, dv, kinds, drop_dead=drop)
        want = K.merge_plain(st, dk, dv, kinds, drop_dead=drop)
        torch.cuda.synchronize()
        err["merge"] = max(err["merge"], compare("merge", case, got, want))
    for case, alive, keys, cols, out_len, fills in compact_cases(rng, dev):
        got = K.compact_rows(alive, keys, cols, out_len, fills)
        want = K.compact_rows_plain(alive, keys, cols, out_len, fills)
        torch.cuda.synchronize()
        err["compact_rows"] = max(err["compact_rows"], compare(
            "compact_rows", case, got, want))
    # the join-side kernels only gather and add ints: exact on every leaf
    for case, *args in brr_cases(rng, dev):
        got = K.batch_reduce_rows(*args)
        want = K.batch_reduce_rows_plain(*args)
        torch.cuda.synchronize()
        compare("batch_reduce_rows", case, got, want)
    for case, *args in ms_cases(rng, dev):
        got = K.merge_side(*args)
        want = K.merge_side_plain(*args)
        torch.cuda.synchronize()
        compare("merge_side", case, got, want)
    for case, *args in probe_cases(rng, dev):
        got = K.probe(*args)
        want = K.probe_plain(*args)
        torch.cuda.synchronize()
        compare("probe", case, got, want)
    return err


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def q4_job(dev, max_events=MAX_EVENTS, precombine=True):
    """The node graph the fuse planner lowers q4 to: Source(bid) ->
    Map($0, $2, $2) -> [Precombine ->] Agg -> MVKeyed."""
    gencfg = GenCfg.from_config(NexmarkConfig())
    names = ["auction", "bidder", "price", "channel", "url", "date_time",
             "extra", "_row_id"]
    dts = [T.INT64, T.INT64, T.INT64, T.VARCHAR, T.VARCHAR, T.TIMESTAMP,
           T.VARCHAR, T.INT64]
    src = F.SourceNode("bid", gencfg, names, 7, max_events, dts, device=dev)
    mp = F.MapNode(0, [InputRef(0, T.INT64), InputRef(2, T.INT64),
                       InputRef(2, T.INT64)], device=dev)
    calls = [F.AggCall("count"), F.AggCall("sum", 1), F.AggCall("max", 2)]
    spec = DeviceAggSpec.build(["count_star", "sum", "max"],
                               [np.int64] * 3, append_only=True)
    pack = F.PackPlan.plan([src.ranges[0]])
    nodes = [src, mp]
    if precombine:
        nodes.append(F.PrecombineNode(1, [0], calls, pack, spec, device=dev))
    agg = F.AggNode(len(nodes) - 1, [0], calls, pack, spec, CAPACITY, None,
                    device=dev)
    if precombine:
        agg.enable_precombine()
    nodes.append(agg)
    nodes.append(F.MVKeyedNode(len(nodes) - 1, agg, CAPACITY, device=dev))
    pull = F.MVPull("keyed", len(nodes) - 1,
                    [T.INT64, T.INT64, T.DECIMAL, T.INT64], [F.NUM] * 4,
                    agg=agg, out_map=[("g", 0), ("c", 0), ("c", 1), ("c", 2)])
    prog = F.FusedProgram(nodes, EPOCH_EVENTS, device=dev)
    return F.FusedJob("q4", prog, pull, max_events, device=dev)


def q4_oracle(dev, max_events=MAX_EVENTS):
    """numpy group-by over the bid stream of the port's generator."""
    gencfg = GenCfg.from_config(NexmarkConfig())
    auc, price = [], []
    for lo in range(0, max_events, EPOCH_EVENTS):
        ids = torch.arange(lo, lo + EPOCH_EVENTS, dtype=torch.int64,
                           device=dev)
        m = table_mask("bid", ids)
        cols = gen_table(gencfg, "bid", ids)
        auc.append(cols["auction"][m].cpu().numpy())
        price.append(cols["price"][m].cpu().numpy())
    auction, price = np.concatenate(auc), np.concatenate(price)
    order = np.argsort(auction, kind="stable")
    k = auction[order]
    bounds = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    cnt = np.diff(np.r_[bounds, len(k)])
    s = np.add.reduceat(price[order], bounds)
    m = np.maximum.reduceat(price[order], bounds)
    return k[bounds], cnt, s, m


def drive(job):
    """Drive a job to the end of its stream, then pull the MV. Returns the
    rows, the drive seconds (dispatch, checkpoint syncs, growth replays;
    ends synced), the pull seconds, the kernel launches and the epochs
    dispatched (replays included). The launch counts are zeroed just
    before the drive and read just after the pull."""
    steps = [0]
    step = job.program.step

    def counted(*a):
        steps[0] += 1
        return step(*a)
    job.program.step = counted
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch = 0
    while not job.drained:
        epoch += 1
        job.on_barrier(SimpleNamespace(
            is_checkpoint=epoch % CKPT_EVERY == 0,
            epoch=SimpleNamespace(curr=epoch)))
    job.on_barrier(SimpleNamespace(is_checkpoint=True,
                                   epoch=SimpleNamespace(curr=epoch + 1)))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rows = job.mv_rows_now()
    t2 = time.perf_counter()
    launches = dict(K.LAUNCHES)
    del job.program.step
    return rows, t1 - t0, t2 - t1, launches, steps[0]


def run_main(dev, max_events=MAX_EVENTS, precombine=True):
    """q4 through `drive`: (job, rows, drive s, pull s, launches, epochs)."""
    job = q4_job(dev, max_events, precombine)
    return (job,) + drive(job)


def check_rows(rows, oracle):
    k, cnt, s, m = oracle
    if len(rows) != len(k):
        raise AssertionError(f"q4: {len(rows)} rows vs oracle {len(k)}")
    auc = np.array([r[0] for r in rows], np.int64)
    if not np.all(auc[1:] > auc[:-1]):
        raise AssertionError("q4 rows are not in key order")
    if not np.array_equal(auc, k):
        raise AssertionError("q4 group keys differ from the oracle")
    if not np.array_equal(np.array([r[1] for r in rows], np.int64), cnt):
        raise AssertionError("q4 count(*) differs from the oracle")
    if not np.array_equal(np.array([int(r[2]) for r in rows], np.int64), s):
        raise AssertionError("q4 sum(price) differs from the oracle")
    if not np.array_equal(np.array([r[3] for r in rows], np.int64), m):
        raise AssertionError("q4 max(price) differs from the oracle")


BID_COLS = [("auction", T.INT64), ("bidder", T.INT64), ("price", T.INT64),
            ("channel", T.VARCHAR), ("url", T.VARCHAR),
            ("date_time", T.TIMESTAMP), ("extra", T.VARCHAR),
            ("_row_id", T.INT64)]
AUCTION_COLS = [("id", T.INT64), ("item_name", T.VARCHAR),
                ("description", T.VARCHAR), ("initial_bid", T.INT64),
                ("reserve", T.INT64), ("date_time", T.TIMESTAMP),
                ("expires", T.TIMESTAMP), ("seller", T.INT64),
                ("category", T.INT64), ("extra", T.VARCHAR),
                ("_row_id", T.INT64)]
# SELECT b.auction, b.price, a.seller, a.category — plus both row ids,
# the pair MV's hidden stream key — over the joined bid ++ auction columns
Q3A_OUT = [0, 2, 8 + 7, 8 + 8, 7, 8 + 10]


def q3a_job(dev, max_events=Q3_EVENTS, epoch_events=EPOCH_EVENTS,
            capacity=CAPACITY):
    """The node graph the fuse planner lowers q3a to (`SELECT b.auction,
    b.price, a.seller, a.category FROM bid b JOIN auction a ON b.auction
    = a.id WHERE b.price > 500`): Source(bid), Source(auction) ->
    Join(auction = id, pair capacity 4 x capacity) -> Filter($2 > 500) ->
    Map -> MVPair."""
    gencfg = GenCfg.from_config(NexmarkConfig())
    srcs = [F.SourceNode(table, gencfg, [c for c, _ in cols], len(cols) - 1,
                         max_events, [d for _, d in cols], device=dev)
            for table, cols in (("bid", BID_COLS), ("auction", AUCTION_COLS))]
    # the join key packs over both sides' ranges (fuse_planner._join)
    (alo, ahi, ast), (blo, bhi, bst) = srcs[0].ranges[0], srcs[1].ranges[0]
    pack = F.PackPlan.plan([(min(alo, blo), max(ahi, bhi),
                             math.gcd(ast, bst) or 1)])
    join = F.JoinNode(0, 1, [0], [0], pack, None, capacity, 4 * capacity,
                      [torch.int64] * len(BID_COLS),
                      [torch.int64] * len(AUCTION_COLS), device=dev)
    filt = F.FilterNode(2, build_device(
        "greater_than", [InputRef(2, T.INT64), Literal(500, T.INT64)]),
        device=dev)
    mp = F.MapNode(3, [InputRef(i, T.INT64) for i in Q3A_OUT], device=dev)
    mv = F.MVPairNode(4, [torch.int64] * len(Q3A_OUT), capacity, device=dev)
    pull = F.MVPull("pair", 5, [T.INT64] * len(Q3A_OUT),
                    [F.NUM] * len(Q3A_OUT))
    prog = F.FusedProgram(srcs + [join, filt, mp, mv], epoch_events,
                          device=dev)
    return F.FusedJob("q3a", prog, pull, max_events, device=dev)


def q3a_oracle(dev, max_events=Q3_EVENTS):
    """numpy hash join of the port generator's bid and auction streams,
    filtered on price > 500, in (bid row id, auction row id) order: an
    [n, 6] int64 array of the MV's columns."""
    gencfg = GenCfg.from_config(NexmarkConfig())
    bids, aucs = [], []
    for lo in range(0, max_events, EPOCH_EVENTS):
        ids = torch.arange(lo, min(lo + EPOCH_EVENTS, max_events),
                           dtype=torch.int64, device=dev)
        for table, names, acc in (("bid", ("auction", "price"), bids),
                                  ("auction", ("id", "seller", "category"),
                                   aucs)):
            m = table_mask(table, ids)
            cols = gen_table(gencfg, table, ids)
            acc.append(np.stack([cols[c][m].cpu().numpy() for c in names]
                                + [ids[m].cpu().numpy()], 1))
    bid, auc = np.concatenate(bids), np.concatenate(aucs)
    bid = bid[bid[:, 1] > 500]
    order = np.argsort(auc[:, 0], kind="stable")
    aid = auc[order, 0]
    pos = np.clip(np.searchsorted(aid, bid[:, 0]), 0, len(aid) - 1)
    hit = aid[pos] == bid[:, 0]
    if len(np.unique(aid)) != len(aid):
        raise AssertionError("q3a oracle: auction ids are not unique")
    bid, a = bid[hit], auc[order[pos[hit]]]
    rows = np.stack([bid[:, 0], bid[:, 1], a[:, 1], a[:, 2], bid[:, 2],
                     a[:, 3]], 1)
    return rows[np.lexsort((rows[:, 5], rows[:, 4]))]


def check_q3a_rows(rows, oracle):
    got = np.array(rows, dtype=np.int64).reshape(-1, len(Q3A_OUT))
    if got.shape != oracle.shape:
        raise AssertionError(f"q3a: {got.shape[0]} rows vs oracle "
                             f"{oracle.shape[0]}")
    if not np.array_equal(got, oracle):
        bad = int(np.sum(np.any(got != oracle, axis=1)))
        raise AssertionError(f"q3a: {bad} rows differ from the oracle")


def node_times(job):
    """One more epoch over the final state with a CUDA-event pair around
    each node's step (the result is discarded): per-node milliseconds."""
    prog = job.program
    evs = []
    for node in prog.nodes:
        orig = node.apply

        def timed(*a, _orig=orig, _evs=evs, _n=type(node).__name__):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = _orig(*a)
            e1.record()
            _evs.append((_n, e0, e1))
            return out
        node.apply = timed
    prog.step(job.states, 0, job.stats_acc)
    torch.cuda.synchronize()
    for node in prog.nodes:
        del node.apply
    return [(n, e0.elapsed_time(e1)) for n, e0, e1 in evs]


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------


def median_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return float(np.median(ts))


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def lib_batch_reduce(keys, mask, vals, kinds):
    """PyTorch library composition: stable sort, unique_consecutive,
    scatter_reduce per column (SUM / MIN / MAX kinds)."""
    mk = torch.where(mask, keys, EMPTY_KEY)
    sk, perm = torch.sort(mk, stable=True)
    uk, inv = torch.unique_consecutive(sk, return_inverse=True)
    n, u = keys.shape[0], uk.shape[0]
    ukeys = torch.full((n,), EMPTY_KEY, dtype=torch.int64, device=keys.device)
    ukeys[:u] = uk
    outs = []
    red = {S: "sum", MN: "amin", MX: "amax"}
    for v, k in zip(vals, kinds):
        r = torch.full((n,), _neutral(k, v.dtype), dtype=v.dtype,
                       device=v.device)
        r[:u] = torch.zeros(u, dtype=v.dtype, device=v.device).scatter_reduce(
            0, inv, v[perm], red[k], include_self=False)
        outs.append(torch.where(ukeys == EMPTY_KEY, _neutral(k, v.dtype), r))
    return ukeys, outs


def lib_merge(state, dkeys, dvals, kinds):
    """PyTorch library composition: cat, stable sort with gather, the
    shifted combine, nonzero compaction."""
    c = state.capacity
    keys = torch.cat([state.keys, dkeys])
    sk, perm = torch.sort(keys, stable=True)
    same_next = torch.zeros_like(sk, dtype=torch.bool)
    same_next[:-1] = sk[:-1] == sk[1:]
    alive = sk != EMPTY_KEY
    alive[1:] &= ~same_next[:-1]
    vals = []
    for sv, dv, k in zip(state.vals, dvals, kinds):
        v = torch.cat([sv, dv])[perm]
        nxt = torch.cat([v[1:], v[-1:]])
        comb = v + nxt if k == S else torch.maximum(v, nxt)
        vals.append(torch.where(same_next, comb, v))
    alive &= vals[0] != 0
    idx = torch.nonzero(alive).squeeze(1)[:c]
    out = [torch.full((c,), EMPTY_KEY, dtype=torch.int64, device=sk.device)]
    out[0][:idx.shape[0]] = sk[idx]
    for v, k in zip(vals, kinds):
        o = torch.full((c,), _neutral(k, v.dtype), dtype=v.dtype,
                       device=v.device)
        o[:idx.shape[0]] = v[idx]
        out.append(o)
    return out


def lib_compact(alive, cols, out_len, fills):
    """PyTorch library composition: nonzero, then index."""
    idx = torch.nonzero(alive).squeeze(1)[:out_len]
    outs = []
    for c, f in zip(cols, fills):
        o = torch.full((min(out_len, c.shape[0]),), f, dtype=c.dtype,
                       device=c.device)
        o[:idx.shape[0]] = c[idx]
        outs.append(o)
    return outs


def timings(dev, final_caps) -> dict:
    """Each kernel at the main path's shapes: sort and batch_reduce at an
    epoch of 2^20 rows (the pre-combine's 7 columns), merge at the final
    agg capacity with a 2^20-row delta, compact_rows at that merge's
    C + B rows."""
    rng = np.random.default_rng(7)
    n = EPOCH_EVENTS
    out = {}
    gencfg = GenCfg.from_config(NexmarkConfig())
    ids = torch.arange(MAX_EVENTS - n, MAX_EVENTS, dtype=torch.int64,
                       device=dev)
    keys = gen_table(gencfg, "bid", ids)["auction"] - 1000
    mask = table_mask("bid", ids)
    vals = [payload(rng, n, torch.int64).to(dev) for _ in range(7)]
    kinds = [S, S, S, S, S, MX, S]
    mk = torch.where(mask, keys, EMPTY_KEY)

    out["sort_cols"] = dict(
        ms=median_ms(lambda: K.sort_cols([mk], [])),
        plain_ms=median_ms(lambda: K.sort_cols_plain([mk], [])),
        library_ms=median_ms(lambda: torch.sort(mk, stable=True)),
        bound_ms=bound_ms(8 * n + 16 * n), bound_by="bytes")
    out["batch_reduce"] = dict(
        ms=median_ms(lambda: K.batch_reduce(keys, mask, vals, kinds)),
        plain_ms=median_ms(lambda: K.batch_reduce_plain(keys, mask, vals,
                                                        kinds)),
        library_ms=median_ms(lambda: lib_batch_reduce(keys, mask, vals,
                                                      kinds)),
        bound_ms=bound_ms(9 * n + 8 * 7 * n + 8 * n + 8 * 7 * n + 4),
        bound_by="bytes")

    c = final_caps
    spec = [(S, torch.int64)] * 4 + [(MX, torch.int64), (S, torch.int64)]
    live = min(c, 1 << 20)
    st = make_sorted_state(rng, c, sorted_unique(rng, live, 0, 1 << 21),
                           spec, dev)
    dk_np = np.full(n, EMPTY_KEY, np.int64)
    d = sorted_unique(rng, 300_000, 0, 1 << 21)
    dk_np[:len(d)] = d
    dk = torch.from_numpy(dk_np).to(dev)
    dv = [torch.where(dk != EMPTY_KEY, v, 0)
          for v in (payload(rng, n, torch.int64).abs().to(dev) + 1
                    for _ in spec)]
    mkinds = [k for k, _ in spec]
    ncol = len(spec)
    out["merge"] = dict(
        ms=median_ms(lambda: K.merge(st, dk, dv, mkinds)),
        plain_ms=median_ms(lambda: K.merge_plain(st, dk, dv, mkinds)),
        library_ms=median_ms(lambda: lib_merge(st, dk, dv, mkinds)),
        bound_ms=bound_ms(8 * (1 + ncol) * (2 * c + n) + 4),
        bound_by="bytes")

    m = c + n
    alive = torch.from_numpy(rng.random(m) < (live + len(d)) / m).to(dev)
    ccols = [torch.from_numpy(rand_keys(rng, m, 0, 1 << 40)).to(dev)] + \
        [payload(rng, m, torch.int64).to(dev) for _ in range(ncol)]
    fills = [EMPTY_KEY] + [0] * ncol
    n_alive = int(alive.sum())
    kept = min(n_alive, c)
    out["compact_rows"] = dict(
        ms=median_ms(lambda: K.compact_rows(alive, ccols[:1], ccols[1:], c,
                                            fills)),
        plain_ms=median_ms(lambda: K.compact_rows_plain(
            alive, ccols[:1], ccols[1:], c, fills)),
        library_ms=median_ms(lambda: lib_compact(alive, ccols, c, fills)),
        bound_ms=bound_ms(m + 8 * (1 + ncol) * (kept + c) + 4),
        bound_by="bytes")
    return out


def _two_key_perm(k1, k2):
    """Stable order by (k1, k2) from two stable library sorts."""
    p1 = torch.sort(k2, stable=True).indices
    return p1[torch.sort(k1[p1], stable=True).indices]


def lib_batch_reduce_rows(jk, pk, signs, mask, vals):
    """PyTorch library composition: two stable sorts, unique_consecutive
    over the (jk, pk) pairs, index_add of the signs, a gather of each
    segment's last row."""
    n = jk.shape[0]
    mjk = torch.where(mask, jk, EMPTY_KEY)
    mpk = torch.where(mask, pk, EMPTY_KEY)
    perm = _two_key_perm(mjk, mpk)
    pairs = torch.stack([mjk[perm], mpk[perm]], 1)
    u, inv, cnt = torch.unique_consecutive(pairs, dim=0, return_inverse=True,
                                           return_counts=True)
    nseg = u.shape[0]
    usign = torch.zeros(n, dtype=torch.int32, device=jk.device).index_add_(
        0, inv, torch.where(mask, signs, 0).to(torch.int32)[perm])
    ujk = torch.full((n,), EMPTY_KEY, dtype=torch.int64, device=jk.device)
    upk = ujk.clone()
    ujk[:nseg], upk[:nseg] = u[:, 0], u[:, 1]
    # a segment's last row; row 0 for masked rows and the padding
    src = torch.full((n,), 0, dtype=torch.int64, device=jk.device)
    src[:nseg] = torch.cumsum(cnt, 0) - 1
    src = perm[torch.where(ujk != EMPTY_KEY, src, 0)]
    return (ujk, upk, torch.where(ujk != EMPTY_KEY, usign, 0),
            [v[src] for v in vals])


def lib_merge_side(side, djk, dpk, dsign, dvals):
    """PyTorch library composition: cat, two stable sorts with gathers,
    the shifted presence combine, nonzero compaction."""
    c = side.jk.shape[0]
    jk, pk = torch.cat([side.jk, djk]), torch.cat([side.pk, dpk])
    perm = _two_key_perm(jk, pk)
    jk, pk = jk[perm], pk[perm]
    pres = torch.cat([(side.jk != EMPTY_KEY).to(torch.int32), dsign])[perm]
    same = (jk[:-1] == jk[1:]) & (pk[:-1] == pk[1:])
    nxt_p = torch.cat([pres[1:], pres[-1:]])
    same_next = torch.cat([same, same[:1] & False])
    pres_m = torch.where(same_next, torch.clamp(pres + nxt_p, 0, 1), pres)
    take = same_next & (nxt_p > 0)
    alive = (jk != EMPTY_KEY) & (pres_m > 0)
    alive[1:] &= ~same
    idx = torch.nonzero(alive).squeeze(1)[:c]
    k = idx.shape[0]
    out = []
    for col, fill in [(jk, EMPTY_KEY), (pk, EMPTY_KEY)] + [
            (torch.cat([sv, dv])[perm], 0)
            for sv, dv in zip(side.vals, dvals)]:
        if fill == 0:
            col = torch.where(take, torch.cat([col[1:], col[-1:]]), col)
        o = torch.full((c,), fill, dtype=col.dtype, device=col.device)
        o[:k] = col[idx]
        out.append(o)
    return out


def lib_probe(side_jk, qjk, qmask, m):
    """PyTorch library composition: two searchsorted, cumsum, a
    searchsorted of the slots over the offsets, gathers."""
    q = torch.where(qmask, qjk, EMPTY_KEY)
    lo = torch.searchsorted(side_jk, q)
    hi = torch.searchsorted(side_jk, q, right=True)
    off = torch.cumsum(torch.where(qmask & (q != EMPTY_KEY), hi - lo, 0), 0)
    t = torch.arange(m, device=qjk.device)
    row = torch.clamp(torch.searchsorted(off, t, right=True), 0,
                      q.shape[0] - 1)
    prev = torch.where(row > 0, off[row - 1], 0)
    sidx = torch.clamp(lo[row] + t - prev, 0, side_jk.shape[0] - 1)
    return row.to(torch.int32), sidx, t < off[-1], off[-1]


def join_timings(dev, job) -> dict:
    """The three join kernels on the q3a job's final state, fed the next
    epoch of the generator's bids: batch_reduce_rows on the epoch's 2^20
    bid rows x 8 columns (and, under "netting", on that epoch's 2m pair
    rows x 19 columns), merge_side of the reduced bids into the bid side
    at its final capacity, probe of the auction side by the reduced bids
    with the final pair capacity m."""
    rng = np.random.default_rng(11)
    jn = job.program.nodes[2]
    a, b = job.states[2]
    n = EPOCH_EVENTS
    gencfg = GenCfg.from_config(NexmarkConfig())
    ids = torch.arange(Q3_EVENTS, Q3_EVENTS + n, dtype=torch.int64,
                       device=dev)
    cols = gen_table(gencfg, "bid", ids)
    vals = [ids if nm == "_row_id" else cols[nm] for nm, _ in BID_COLS]
    jk = jn.pack.pack([cols["auction"]])
    sign = torch.ones(n, dtype=torch.int32, device=dev)
    mask = table_mask("bid", ids)
    args = (jk, ids, sign, mask, vals)
    k = len(vals)
    out = {"batch_reduce_rows": dict(
        ms=median_ms(lambda: K.batch_reduce_rows(*args)),
        plain_ms=median_ms(lambda: K.batch_reduce_rows_plain(*args)),
        library_ms=median_ms(lambda: lib_batch_reduce_rows(*args)),
        bound_ms=bound_ms(n * (8 + 8 + 4 + 1 + 8 * k)
                          + n * (8 + 8 + 4 + 8 * k)),
        bound_by="bytes", shape=f"B={n} x {k} int64")}
    dajk, dapk, dasign, davals = K.batch_reduce_rows(*args)
    c = a.jk.shape[0]
    margs = (a, dajk, dapk, dasign, davals)
    out["merge_side"] = dict(
        ms=median_ms(lambda: K.merge_side(*margs)),
        plain_ms=median_ms(lambda: K.merge_side_plain(*margs)),
        library_ms=median_ms(lambda: lib_merge_side(*margs)),
        bound_ms=bound_ms(c * (16 + 8 * k) + n * (16 + 4 + 8 * k)
                          + c * (16 + 8 * k) + 4),
        bound_by="bytes", shape=f"C={c}, B={n} x {k} int64",
        live=int(a.count))
    qmask = dasign != 0
    cb, m = b.jk.shape[0], jn.m
    pargs = (b, dajk, qmask, m)
    total = int(K.probe_plain(*pargs)[3])
    out["probe"] = dict(
        ms=median_ms(lambda: K.probe(*pargs)),
        plain_ms=median_ms(lambda: K.probe_plain(*pargs)),
        library_ms=median_ms(lambda: lib_probe(b.jk, dajk, qmask, m)),
        bound_ms=bound_ms(n * 9 + cb * 8 + m * 13 + 8), bound_by="bytes",
        # one 32-byte sector per binary-search step: per query over the
        # side, per slot over the query offsets
        search_bound_ms=bound_ms(32 * (n * math.log2(cb)
                                       + m * math.log2(n))),
        shape=f"C={cb}, Q={n}, m={m}", total=total)
    # the netting pass of that epoch: join_core's two pair sets
    bcols = gen_table(gencfg, "auction", ids)
    bvals = [ids if nm == "_row_id" else bcols[nm] for nm, _ in AUCTION_COLS]
    bmask = table_mask("auction", ids)
    _, _, o1, o2, _ = join_core(
        a, b, *args, jn.pack.pack([bcols["id"]]), ids, sign, bmask, bvals,
        m)
    sg = torch.cat([o1["sign"], o2["sign"]])
    nargs = (torch.cat([o1["a_pk"], o2["a_pk"]]),
             torch.cat([o1["b_pk"], o2["b_pk"]]), sg,
             torch.cat([o1["mask"], o2["mask"]]) & (sg != 0),
             [torch.cat([x, y]) for x, y in
              zip(o1["a_vals"] + o1["b_vals"], o2["a_vals"] + o2["b_vals"])])
    n2, k2 = 2 * m, len(nargs[4])
    out["batch_reduce_rows"]["netting"] = dict(
        ms=median_ms(lambda: K.batch_reduce_rows(*nargs)),
        plain_ms=median_ms(lambda: K.batch_reduce_rows_plain(*nargs)),
        library_ms=median_ms(lambda: lib_batch_reduce_rows(*nargs)),
        bound_ms=bound_ms(n2 * (8 + 8 + 4 + 1 + 8 * k2)
                          + n2 * (8 + 8 + 4 + 8 * k2)),
        shape=f"B={n2} x {k2} int64")
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    t = time.perf_counter()
    K.binding.build()
    log(f"[build] kernels built in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    err = check_kernels(dev)
    log(f"[kernels] all {len(REPLACES)} kernels equal their plain versions "
        f"({time.perf_counter() - t:.1f} s); max abs err {err}")

    # ---- q4: the agg path --------------------------------------------
    job, rows, drive_s, pull_s, launches, epochs = run_main(dev)
    oracle = q4_oracle(dev)
    check_rows(rows, oracle)
    q4 = {"events": MAX_EVENTS, "drive_s": drive_s, "pull_s": pull_s,
          "events_per_s": MAX_EVENTS / drive_s,
          "growth_replays": job.growth_replays, "groups": len(rows),
          "agg_capacity": job.program.nodes[2].capacity,
          "mv_capacity": job.program.nodes[3].capacity,
          "launches": launches, "epochs_dispatched": epochs, "card": smi}
    log(f"[main] q4 {json.dumps(q4)}")
    if job.growth_replays < 1:
        raise AssertionError("q4 main path made no growth replay")
    missing = [k for k in Q4_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"q4 path never launched {missing}")
    # the raw (not pre-combined) agg arm, smaller, outside the counted run
    raw_job, raw_rows, *_ = run_main(dev, 1 << 22, precombine=False)
    check_rows(raw_rows, q4_oracle(dev, 1 << 22))
    log(f"[main] raw agg arm: 2^22 events, {len(raw_rows)} groups, "
        f"{raw_job.growth_replays} growth replays, oracle equal")
    q4["node_ms"] = node_times(job)
    log(f"[main] q4 one steady epoch by node (ms): {q4['node_ms']}")
    tm = timings(dev, job.program.nodes[2].capacity)
    del job, rows, oracle, raw_job, raw_rows

    # ---- q3a: the join path ------------------------------------------
    qjob = q3a_job(dev)
    qrows, qdrive_s, qpull_s, qlaunches, qepochs = drive(qjob)
    t = time.perf_counter()
    check_q3a_rows(qrows, q3a_oracle(dev))
    jn = qjob.program.nodes[2]
    q3a = {"events": Q3_EVENTS, "drive_s": qdrive_s, "pull_s": qpull_s,
           "events_per_s": Q3_EVENTS / qdrive_s,
           "growth_replays": qjob.growth_replays, "rows": len(qrows),
           "bid_capacity": jn.cap_a, "auction_capacity": jn.cap_b,
           "pair_capacity": jn.m, "mv_capacity": qjob.program.nodes[4]
           .capacity, "launches": qlaunches, "epochs_dispatched": qepochs,
           "oracle_check_s": time.perf_counter() - t, "card": smi}
    log(f"[main] q3a {json.dumps(q3a)}")
    if qjob.growth_replays < 1:
        raise AssertionError("q3a main path made no growth replay")
    missing = [k for k in Q3A_KERNELS if qlaunches[k] == 0]
    if missing:
        raise AssertionError(f"q3a path never launched {missing}")
    del qrows
    q3a["node_ms"] = node_times(qjob)
    log(f"[main] q3a one steady epoch by node (ms): {q3a['node_ms']}")
    tm.update(join_timings(dev, qjob))

    kernels = []
    for name in REPLACES:
        row = {"name": name, "route": "cuda", "source": SOURCE[name],
               "replaces": REPLACES[name],
               "launches": launches[name] + qlaunches[name],
               "launches_per_epoch": {"q4": launches[name] / epochs,
                                      "q3a": qlaunches[name] / qepochs},
               "max_abs_err": err[name], "max_abs_diff": err[name]}
        row.update(tm[name])
        kernels.append(row)
        log(f"[timing] {name}: {tm[name]}")
    print(smi)
    print(json.dumps({"main": {"q4": q4, "q3a": q3a}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
