#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py          # from the repository root

Phases (any failure exits non-zero; nothing is caught):
  1. card     — name, power limit, torch and CUDA versions
  2. build    — compile every kernel source in
                 risingwave_tpu_torch/kernels/csrc (sorted_runs.cu,
                 join_runs.cu, multiset_runs.cu, window_runs.cu,
                 skew_runs.cu, tier_runs.cu: one nvcc each, in parallel)
                 into build/torch_kernels
  3. kernels  — each of the fifteen kernels against its plain PyTorch
                 version on the card, at the main paths' shapes and on edge
                 cases: exact for integer and bool leaves, padding included;
                 a float SUM within 1e-12 of the summed magnitudes (the plain
                 version adds with atomics, in no fixed order); NaN where
                 the plain version has NaN. sort_cols is held with its
                 permutation (a row-index payload) on keys live in one
                 byte or none, with EMPTY rows, at a sort tile's row count
                 and one either side, and on q5's 10,485,760 pairs;
                 batch_reduce on segments ending at its tile edges, across
                 tiles, and few long ones with NaN, bool MIN / MAX (AND /
                 OR) included; merge_side with a side row and its delta
                 twin across every 2048-row tile edge of the merged order,
                 C + B at four tiles and one row either side, all deletes,
                 sign 0 and +2 deltas; batch_reduce_rows on (jk, pk) runs
                 crossing its tiles or ending at their edges and on
                 EMPTY_KEY segments (sorted row 0's payload)
Every main path runs under the reference's default arms: each keyed
node (agg, join) adds its vnode occupancy, heavy hitters and vnode
traffic to its stats every epoch (the vnode_hist and topk_packed
kernels) and stamps each row's last-touched epoch (touch_stamp; its
`tres` must equal the node's final live rows), and each path prints its
`skew_report` skew_ratio and rank-0 hot_key rows per keyed node. What
the telemetry and the touch arm cost is measured per path: each keyed
node's time in one epoch armed and disarmed (median of 9, in turns),
and the whole drive without the pull, bare and armed in turns.
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
  4c. q5      — Nexmark q5 (two HOP(2 s, 10 s) branches: count per (window,
                 auction), and the max of those counts per window through a
                 retractable max — a multiset — joined on the window with
                 num >= maxn) over 2^23 events in epochs of 2^20, every node
                 from 2^16 (pairs 4 x 2^16), a checkpoint every 4 epochs; the
                 sorted multiset of (auction, num) checked against a numpy
                 oracle of the port generator's bids
  4d. q7      — Nexmark q7 (the max price per TUMBLE(10 s) window joined back
                 to the bids of that window) over 2^23 events, the same
                 cadence; rows checked against a numpy oracle
  4e. q8      — Nexmark q8 (the persons who sold an auction in the TUMBLE(10
                 s) window they joined in: two distincts joined on (id =
                 seller, window)) over 2^26 events (Nexmark's usual 10^8, cut
                 for time), the same cadence; rows checked against a numpy
                 oracle of the port generator's persons and auctions, and
                 each distinct agg's telemetry against its final key table
                 (a numpy vnode histogram) and the rows it was routed
  4f. q3a_tiered, qa_tiered — host-fed (HostIngest) over 2^23 events in
                 epochs of 2^14, a checkpoint every 4: q3a with its bid side
                 held at 2^21 slots (rows equal to 4b's and the oracle's;
                 it must demote), and a zipf:1.5 group-by with pre-combine
                 off held at 2^14 groups (rows equal a numpy group-by; it
                 must demote and promote; its heavy hitters stay out of
                 the cold stores); every tiering counter and the
                 promote_h2d / demote_d2h walls printed
  4g. qa_zipf_device — the zipf:1.5 group-by fed by the device generator
                 (its power-law picks on CUDA) over 2^22 events in epochs
                 of 2^20 from 2^12 groups; rows equal the host generator's
                 numpy group-by
  5. timings  — each kernel at its main-path shape: median of CUDA-event
                 times over 25 runs, beside its plain version, a PyTorch
                 library composition of the same function, and its
                 device-memory bound at 3.35 TB/s (H100 SXM), and by
                 CUDA-graph replay, without the host's launch path;
                 batch_reduce_rows split into its sort and its reduce, and
                 merge_side's peak device memory of one call beyond its
                 outputs

    python3 chip_smoke.py --merge-side-memory

builds the kernels and prints only merge_side's memory line at the timing
shape, for a tree whose merge_side is to be compared.
Launch counts are zeroed just before each main path and read just after.
The last four lines are the card line, the {"main": ...} line, the
{"kernels": [...]} line and the {"ok": ...} line, in that order; the
paths' {"telemetry": ...} lines come just before them.
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
from risingwave_tpu_torch.connectors.nexmark import (NexmarkConfig,
                                                     _event_kinds,
                                                     gen_surrogates)
from risingwave_tpu_torch.core import dtypes as T
from risingwave_tpu_torch.device import fused as F
from risingwave_tpu_torch.device.agg_step import DeviceAggSpec, _row_deltas
from risingwave_tpu_torch.core.vnode import compute_vnodes, compute_vnodes_dev
from risingwave_tpu_torch.device.fuse_planner import (_TsShift, arm_telemetry,
                                                      host_ingest,
                                                      prune_ingest_columns,
                                                      tier_plans, to_ingest)
from risingwave_tpu_torch.device.join_step import JoinSide, join_core
from risingwave_tpu_torch.device.minput import SortedMultiset
from risingwave_tpu_torch.device.nexmark_gen import (GenCfg, gen_table,
                                                     table_mask)
from risingwave_tpu_torch.device.skew_stats import (SK_BUCKETS, SK_COUNT_MAX,
                                                    SK_KEY_MASK, SK_TOPK,
                                                    hot_key_set)
from risingwave_tpu_torch.device.sorted_state import (EMPTY_KEY, ReduceKind,
                                                      SortedState, _neutral)
from risingwave_tpu_torch.device.tiering import TIER_TTL, TieredState
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
            "probe": "risingwave_tpu/device/join_step.py:118",
            "hop_expand": "risingwave_tpu/device/fused.py:786",
            "ms_batch_reduce": "risingwave_tpu/device/minput.py:79",
            "ms_merge": "risingwave_tpu/device/minput.py:98",
            "ms_find": "risingwave_tpu/device/minput.py:136",
            "vnode_hist": "risingwave_tpu/device/skew_stats.py:69",
            "topk_packed": "risingwave_tpu/device/skew_stats.py:102",
            "touch_stamp": "risingwave_tpu/device/fused.py:1186",
            "tier_partition": "risingwave_tpu/device/fused.py:1758"}
# every path runs armed: each keyed node launches both telemetry kernels
# and the tiering recency arm (touch_stamp); demotion (tier_partition)
# runs only on the host-fed tiered paths
SKEW_KERNELS = ("vnode_hist", "topk_packed", "touch_stamp")
Q4_KERNELS = ("sort_cols", "batch_reduce", "merge", "compact_rows") \
    + SKEW_KERNELS
# merge_side compacts in its own pass, so the join paths launch compact_rows
# only where an agg's merge or a hop's bound does
Q3A_KERNELS = ("sort_cols", "batch_reduce_rows", "merge_side", "probe") \
    + SKEW_KERNELS
Q5_KERNELS = tuple(k for k in REPLACES if k != "tier_partition")
Q7_KERNELS = Q4_KERNELS + ("batch_reduce_rows", "merge_side", "probe",
                           "hop_expand")
Q8_KERNELS = Q7_KERNELS
Q3T_KERNELS = Q3A_KERNELS + ("tier_partition",)
QA_KERNELS = ("sort_cols", "batch_reduce", "merge", "compact_rows",
              "tier_partition") + SKEW_KERNELS
QZ_KERNELS = tuple(k for k in QA_KERNELS if k != "tier_partition")
_CU = {"join_step": "join_runs.cu", "minput": "multiset_runs.cu",
       "fused": "window_runs.cu", "sorted_state": "sorted_runs.cu",
       "skew_stats": "skew_runs.cu"}
SOURCE = {k: CSRC + _CU[v.split("/")[-1].split(".")[0]]
          for k, v in REPLACES.items()}
SOURCE["touch_stamp"] = SOURCE["tier_partition"] = CSRC + "tier_runs.cu"
MAX_EVENTS = 1 << 24
Q3_EVENTS = 1 << 23
QA_EVENTS = 1 << 23
QA_KEY_DIST = "zipf:1.5"
# The tiered paths' epochs: a checkpoint every CKPT_EVERY of them, and
# demotion acts one checkpoint after the pull that selects it, so a
# checkpoint window must be a small share of the clamp (at 2^20-event
# epochs the whole 2^23-event run is two checkpoints)
TIER_EPOCH_EVENTS = 1 << 14
# q3a_tiered: the bid side is held at 2^21 slots (the untiered run's
# final bid side takes 2^23, 4x); the auction side, pair buffer and MV
# start at sizes that never grow, so no other slot's growth replay
# drops a pending recency pull
Q3T_CLAMP = 1 << 21
Q3T_PRESIZE = {"a": Q3T_CLAMP, "b": 1 << 19, "pairs": 1 << 18,
               "mv": 1 << 23}
# qa_tiered: the agg (and its MV) held at 2^14 groups; untiered it
# takes 2^16
QA_CLAMP = 1 << 14
# qa_zipf_device: the same query fed by the device generator (its
# _zipf_ordinal on CUDA) over 2^22 events from 2^12 groups, so it grows
QZ_EVENTS = 1 << 22
QZ_CAPACITY = 1 << 12
Q5_EVENTS = 1 << 23
Q7_EVENTS = 1 << 23
Q8_EVENTS = 1 << 26
USEC = 1_000_000
TS = ("ts",)
EPOCH_EVENTS = 1 << 20
CAPACITY = 1 << 16
CKPT_EVERY = 4

S, MN, MX, R = (ReduceKind.SUM, ReduceKind.MIN, ReduceKind.MAX,
                ReduceKind.REPLACE)


def inner(state):
    """A node's state without its tiering wrapper."""
    return state.inner if isinstance(state, TieredState) else state


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
            # NaN where the other has NaN, the same infinities elsewhere
            fin, nan = torch.isfinite(b), torch.isnan(b)
            inf = ~fin & ~nan
            if not torch.equal(torch.isfinite(a), fin) or not torch.equal(
                    torch.isnan(a), nan) or not torch.equal(a[inf], b[inf]):
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


BOOL_MINMAX = [(MN, torch.bool), (MX, torch.bool), (S, torch.bool)]
RED_TILE = 2048                # rows per tile of the reduce kernels and of
                               # merge_side's merged order
SORT_TILE = 4096               # rows per tile of the sort kernel's passes


def seg_keys(rng, bounds):
    """Shuffled keys whose sorted runs end at `bounds` (exclusive ends):
    run i holds key 7 i - 20."""
    lens = np.diff(np.concatenate([[0], bounds]))
    keys = np.repeat(np.arange(len(lens), dtype=np.int64) * 7 - 20, lens)
    return keys[rng.permutation(len(keys))]


def br_cases(rng, dev):
    """(case, keys, mask, vals, kinds) for batch_reduce at 2^20 and edges."""
    n = 1 << 20
    out = []

    def mk(case, keys, mask, spec, nan_rows=None):
        vals = [payload(rng, len(keys), d).to(dev) for _, d in spec]
        if nan_rows is not None:
            for v in vals:
                if v.dtype == torch.float64:
                    v[torch.from_numpy(nan_rows).to(dev)] = float("nan")
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
    # segments that end at a tile edge and one row either side, and ones
    # that cross more than three tiles
    t = RED_TILE
    bounds = [t, 2 * t - 1, 2 * t + 1, 3 * t - 1, 3 * t, 3 * t + 1, 4 * t,
              8 * t - 1, 8 * t + 1, 13 * t, 13 * t + 2, 20 * t + 5]
    k = seg_keys(rng, bounds)
    mk("tile_edges", k, np.ones(len(k), bool), ALL_KINDS + BOOL_MINMAX)
    m = rng.random(len(k)) < 0.9
    mk("tile_edges_masked", k, m, ALL_KINDS + BOOL_MINMAX)
    # few long segments (a window per key, as the pre-combines see them):
    # REPLACE, f64 SUM with NaN in two of the segments, NaN MIN / MAX,
    # bool MIN / MAX
    k = rand_keys(rng, n, 0, 11)
    mk("few_long_segments", k, rng.random(n) < 0.92, ALL_KINDS + BOOL_MINMAX,
       nan_rows=np.isin(k, [3, 8]) & (rng.random(n) < 1e-4))
    mk("one_segment_nan", np.full(n, -4, np.int64), np.ones(n, bool),
       ALL_KINDS + BOOL_MINMAX, nan_rows=np.arange(n) == n // 3)
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
    """(case, keys, cols) for sort_cols; cols[0] is the row index, so the
    permutation itself is compared."""
    out = []
    n = 1 << 20
    pay = [torch.int64, torch.int32, torch.float64, torch.bool]

    def mk(case, keys, payloads=pay):
        ks = [torch.from_numpy(np.asarray(k, np.int64)).to(dev) for k in keys]
        m = len(keys[0])
        cols = [torch.arange(m, device=dev)] + [
            payload(rng, m, d).to(dev) for d in payloads]
        out.append((case, ks, cols))

    def with_empty(k, p=0.08):
        k = k.copy()
        k[rng.random(len(k)) < p] = EMPTY_KEY
        return k

    k = rand_keys(rng, n, -(1 << 40), 1 << 40)
    k[rng.random(n) < 0.05] = EMPTY_KEY
    mk("one_key_2^20_with_empty", [k])
    mk("two_keys_2^20", [rand_keys(rng, n, 0, 1000),
                         rand_keys(rng, n, -(1 << 62), 1 << 62)])
    mk("all_equal_2^20", [np.full(n, -3, np.int64)])
    mk("n=1", [rand_keys(rng, 1, 0, 5)])
    mk("negative_keys", [rand_keys(rng, 65536, np.iinfo(np.int64).min,
                                   -(1 << 50))])
    # live keys that vary in one byte only, or not at all (the other
    # digits dead), with and without EMPTY rows
    shapes = {"top_byte_only": rng.integers(-128, 128, n) << 56,
              "middle_byte_only": (rng.integers(0, 256, n) << 24) + 12345,
              "constant": np.full(n, 42, np.int64)}
    for name, k in shapes.items():
        mk(name, [k])
        mk(name + "_with_empty", [with_empty(k)])
    mk("all_empty", [np.full(n, EMPTY_KEY, np.int64)])
    k = rand_keys(rng, n, -5000, 0)
    k[:3] = [np.iinfo(np.int64).min, EMPTY_KEY - 1, -1]
    mk("negative_next_to_empty", [with_empty(k, 0.3)])
    for m in (SORT_TILE - 1, SORT_TILE, SORT_TILE + 1, 100_003):
        mk(f"n={m}", [with_empty(rand_keys(rng, m, -(1 << 40), 1 << 40))])
    mk("two_keys_k1_constant", [np.full(n, 5, np.int64),
                                with_empty(rand_keys(rng, n, -999, 999))])
    mk("two_keys_k2_constant", [with_empty(rand_keys(rng, n, 0, 1000)),
                                np.full(n, -9, np.int64)])
    # q5's retractable max input: 10,485,760 masked (window, count) pairs
    k1, k2, _, m = q5_pairs(rng, 10_485_760)
    mk("q5_pairs_10485760", [np.where(m, k1, EMPTY_KEY),
                             np.where(m, k2, EMPTY_KEY)], payloads=[])
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
    # runs crossing the reduce's 2048-row tiles, or ending at a tile edge
    # and one row either side of one; f64 / int32 / bool payloads
    t = RED_TILE
    m = 40 * t
    pick = rng.integers(0, 5, m)
    mk("segments_cross_tiles", np.array([3, 3, 8, 9, 9])[pick],
       np.array([1, 4, 0, 2, 7])[pick], rng.choice([-1, 0, 1, 2], m),
       rng.random(m) < 0.9, EDGE_DTYPES)
    ends = [t - 1, t, t + 1, 2 * t - 1, 2 * t + 1, 3 * t, 3 * t + 2,
            8 * t - 1, 8 * t + 1, 13 * t, 20 * t + 5]
    run = np.repeat(np.arange(len(ends)), np.diff(np.r_[0, ends]))
    o = rng.permutation(len(run))
    mk("tile_edges", (run // 3 * 5 - 7)[o], ((run % 3) * 11 + 2)[o],
       rng.choice([-1, 0, 1, 2], len(run)), np.ones(len(run), bool),
       EDGE_DTYPES)
    jk = rand_keys(rng, m, 0, 40)
    jk[rng.random(m) < 0.15] = EMPTY_KEY     # EMPTY segments: row 0's payload
    mk("empty_segment_row0", jk, rand_keys(rng, m, 0, 30),
       rng.choice([-1, 0, 1, 2], m), rng.random(m) < 0.9, EDGE_DTYPES)
    return out


EDGE_DTYPES = [torch.float64, torch.int32, torch.bool, torch.int64]


def straddle_items(rng, n_side, n_delta, p_pair):
    """Item kinds in merged order — "s" a side row alone, "d" a delta row
    alone, "p" a side row and its delta twin — up to n_side side and
    n_delta delta rows, a pair across every RED_TILE-row tile edge of the
    merged order (its side row the tile's last, its twin the next tile's
    first) while both runs have rows left; lone rows from either run in
    proportion to what it has left."""
    kinds, pos, ns, nd = [], 0, 0, 0
    while ns < n_side or nd < n_delta:
        room = ns < n_side and nd < n_delta
        if room and (pos + 1) % RED_TILE == 0:
            k = "p"
        elif room and rng.random() < p_pair and (pos + 2) % RED_TILE:
            k = "p"
        else:
            rs, rd = n_side - ns, n_delta - nd
            k = "s" if rng.random() * (rs + rd) < rs else "d"
        ds, dd = (k != "d"), (k != "s")
        kinds.append(k)
        ns, nd, pos = ns + ds, nd + dd, pos + ds + dd
    return np.array(kinds)


def straddle_pairs(rng, kinds):
    """The (jk, pk) of the side and of the delta for `straddle_items`'
    kinds: distinct pairs ascending, jk repeating (a multimap)."""
    n = len(kinds)
    jk = np.sort(rng.integers(0, max(n // 3, 1), n))
    pk = rng.integers(-(1 << 40), 1 << 40, n)
    o = np.lexsort((pk, jk))
    jk, pk = jk[o], pk[o]
    keep = np.r_[True, (jk[1:] != jk[:-1]) | (pk[1:] != pk[:-1])]
    if not keep.all():
        raise AssertionError("straddle_pairs: a duplicate pair")
    s, d = kinds != "d", kinds != "s"
    return (jk[s], pk[s]), (jk[d], pk[d])


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
    # the one-pass kernel's tiles: a side row and its delta twin across
    # every 2048-row tile edge of the merged order, C + B at four tiles and
    # one row either side (every slot live), all deletes, sign 0 and +2
    # only, an empty side and a delta of only EMPTY_KEY, truncation; f64 /
    # int32 / bool payloads
    t = RED_TILE

    def straddled(case, cap, b, n_side, n_delta, signs, p_pair=0.3):
        s_pairs, d_pairs = straddle_pairs(
            rng, straddle_items(rng, n_side, n_delta, p_pair))
        mk(case, cap, b, s_pairs, d_pairs,
           rng.choice(signs, len(d_pairs[0])), EDGE_DTYPES)
    straddled("straddle_C=2^20_B=2^18", 1 << 20, 1 << 18, (1 << 20) - 1000,
              (1 << 18) - 100, [-1, 0, 1, 2])
    for db in (-1, 0, 1):
        straddled(f"C+B=4x2048{db:+d}", 3 * t, t + db, 3 * t, t + db,
                  [1, 1, 1, -1])
    straddled("all_deletes", 1 << 16, 1 << 14, (1 << 16) - 50,
              (1 << 14) - 50, [-1])
    straddled("sign0_plus2", 1 << 16, 1 << 14, (1 << 16) - 50,
              (1 << 14) - 50, [0, 2])
    straddled("needed>C_straddle", 3 * t, t, 3 * t - 40, t - 30, [1],
              p_pair=0.05)
    straddled("empty_side_edge_dtypes", 3 * t, t, 0, t - 30, [1, 1, -1, 2])
    straddled("delta_all_empty_edge_dtypes", 3 * t, t, 3 * t - 40, 0, [1])
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


def hop_cases(rng, dev):
    """(case, cols, time_col, hop, size, pk, sign, mask) for hop_expand:
    an epoch of the generator's bids (2^20 rows x 8 columns) under q5's
    HOP(2 s, 10 s) and q7's TUMBLE(10 s), and edge cases."""
    out = []
    n = EPOCH_EVENTS
    gencfg = GenCfg.from_config(NexmarkConfig())
    ids = torch.arange(0, n, dtype=torch.int64, device=dev)
    gen = gen_table(gencfg, "bid", ids)
    bid = [ids if nm == "_row_id" else gen[nm] for nm, _ in BID_COLS]
    one = torch.ones(n, dtype=torch.int32, device=dev)
    mask = table_mask("bid", ids)
    out.append(("q5_2^20x8_n=5", bid, 5, 2 * USEC, 10 * USEC, ids, one, mask))
    out.append(("q7_2^20x8_n=1", bid, 5, 10 * USEC, 10 * USEC, ids, one,
                mask))
    k = 4096
    ts = _dev(rng.integers(-10**8, 10**8, k), dev)
    ts[:4] = torch.tensor([0, -1, -7, 7])
    cols = [_dev(rng.integers(0, 100, k), dev), ts,
            payload(rng, k, torch.float64).to(dev),
            payload(rng, k, torch.int32).to(dev),
            payload(rng, k, torch.bool).to(dev)]
    sign = _dev(rng.choice([-1, 1], k).astype(np.int32), dev)
    m = _dev(rng.random(k) < 0.7, dev)
    out.append(("negative_ts_mixed_dtypes_n=3", cols, 1, 7, 21,
                _dev(rng.integers(-(1 << 62), 1 << 62, k), dev), sign, m))
    out.append(("pk_absent_n=5", cols, 1, 7, 35, None, sign, m))
    out.append(("n=1_row", [c[:1] for c in cols], 1, 5, 5, None, sign[:1],
                m[:1]))
    return out


def q5_pairs(rng, n, mask_p=0.6):
    """(k1, k2, delta, mask) rows like q5's retractable max input: packed
    window keys, per-(window, auction) counts, signs from a change
    stream (masked where a group did not change)."""
    return (rng.integers(0, 424, n), rng.integers(1, 60, n),
            rng.choice([-1, 1], n).astype(np.int64), rng.random(n) < mask_p)


def msbr_cases(rng, dev):
    """(case, k1, k2, delta, mask) for ms_batch_reduce."""
    out = []

    def mk(case, k1, k2, d, m):
        out.append((case,) + tuple(_dev(np.asarray(x), dev)
                                   for x in (k1, k2, d, m)))
    mk("q5_2^21", *q5_pairs(rng, 1 << 21))
    mk("all_masked", *q5_pairs(rng, 4096, mask_p=0.0))
    k1, k2 = unique_pairs(rng, 30_000, 500, 500)
    mk("cancelling", np.repeat(k1, 2), np.repeat(k2, 2),
       np.tile(np.array([1, -1], np.int64), len(k1)),
       np.ones(2 * len(k1), bool))
    k1, k2, d, m = q5_pairs(rng, 65536)
    k1[rng.random(65536) < 0.05] = EMPTY_KEY
    mk("empty_k1_unmasked", k1, k2, d, m)
    mk("n=1", np.array([3]), np.array([-7]), np.array([-1]),
       np.ones(1, bool))
    return out


def multiset(rng, cap, k1, k2, cnt, dev):
    """A SortedMultiset of capacity `cap` holding the (k1, k2) pairs."""
    order = np.lexsort((k2, k1))
    n = len(order)
    a1 = np.full(cap, EMPTY_KEY, np.int64)
    a2 = np.full(cap, EMPTY_KEY, np.int64)
    ac = np.zeros(cap, np.int64)
    a1[:n], a2[:n] = np.asarray(k1)[order], np.asarray(k2)[order]
    ac[:n] = np.asarray(cnt)[order]
    return SortedMultiset(_dev(a1, dev), _dev(a2, dev),
                          torch.tensor(n, dtype=torch.int32, device=dev),
                          _dev(ac, dev))


def msm_cases(rng, dev):
    """(case, multiset, u1, u2, ud) for ms_merge, the deltas in
    ms_batch_reduce's order (made by its plain version)."""
    out = []

    def mk(case, ms, rows):
        u = K.ms_batch_reduce_plain(*(_dev(np.asarray(x), dev)
                                      for x in rows))
        out.append((case, ms) + tuple(u))
    s1, s2 = unique_pairs(rng, 12_000, 424, 60)
    cnt = rng.integers(1, 40, len(s1))
    q5_ms = multiset(rng, 1 << 14, s1, s2, cnt, dev)
    mk("q5_C=2^14_B=2^21", q5_ms, q5_pairs(rng, 1 << 21))
    small = unique_pairs(rng, 3000, 100, 100)
    sc = rng.integers(1, 3, 3000)
    ms = multiset(rng, 4096, *small, sc, dev)
    mk("retract_all_to_0", ms, (np.repeat(small[0], sc),
                                np.repeat(small[1], sc),
                                -np.ones(int(sc.sum()), np.int64),
                                np.ones(int(sc.sum()), bool)))
    mk("needed>C", ms, (rng.integers(200, 400, 4000),
                        rng.integers(0, 1000, 4000),
                        np.ones(4000, np.int64), np.ones(4000, bool)))
    z1 = np.concatenate([small[0][:1000], rng.integers(500, 600, 500)])
    z2 = np.concatenate([small[1][:1000], rng.integers(0, 50, 500)])
    mk("zero_count_deltas", ms, (np.repeat(z1, 2), np.repeat(z2, 2),
                                 np.tile(np.array([1, -1], np.int64),
                                         len(z1)),
                                 np.ones(2 * len(z1), bool)))
    mk("below_zero", ms, (np.repeat(small[0][:50], 5),
                          np.repeat(small[1][:50], 5),
                          -np.ones(250, np.int64), np.ones(250, bool)))
    e = np.zeros(0, np.int64)
    mk("empty_multiset", multiset(rng, 4096, e, e, e, dev),
       q5_pairs(rng, 8192))
    mk("C=1", multiset(rng, 1, [5], [6], [1], dev),
       (np.array([5, 5, 7]), np.array([6, 6, 1]), np.array([1, -1, 1]),
        np.ones(3, bool)))
    return out


def msf_cases(rng, dev):
    """(case, multiset, q1, q2) for ms_find: q5's multiset and queries,
    and capacities 1, 2, 3 (every slot live)."""
    out = []
    s1, s2 = unique_pairs(rng, 12_000, 424, 60)
    ms = multiset(rng, 1 << 14, s1, s2, rng.integers(1, 40, len(s1)), dev)
    q1, q2, _, m = q5_pairs(rng, 1 << 21)
    q1[~m] = EMPTY_KEY
    out.append(("q5_C=2^14_Q=2^21", ms, _dev(q1, dev), _dev(q2, dev)))
    for c in (1, 2, 3):
        k1, k2 = unique_pairs(rng, c, 4, 4)
        ms = multiset(rng, c, k1, k2, rng.integers(-2, 5, c), dev)
        q1 = np.concatenate([k1, rng.integers(-1, 6, 64), [EMPTY_KEY]])
        q2 = np.concatenate([k2, rng.integers(-1, 6, 64), [0]])
        out.append((f"C={c}", ms, _dev(q1, dev), _dev(q2, dev)))
    return out


def one_bucket_keys(rng, n, bucket=3):
    """n keys whose vnodes all fall in one telemetry bucket."""
    pool = np.arange(1 << 18, dtype=np.int64)
    pool = pool[compute_vnodes(pool) * SK_BUCKETS // 256 == bucket]
    return rng.choice(pool, n)


def vh_cases(rng, dev):
    """(case, keys, live, weights, out) for vnode_hist: an agg's key table
    (occupancy) at 2^23, an epoch's input at 2^20 (traffic, weighted),
    and edge cases; `out` is the histogram added into (None: zeros)."""
    out = []

    def mk(case, keys, live=None, weights=None, into=None):
        out.append((case, _dev(keys, dev),
                    None if live is None else _dev(live, dev),
                    None if weights is None else _dev(weights, dev),
                    None if into is None else _dev(into, dev)))
    c = 1 << 23
    table = np.full(c, EMPTY_KEY, np.int64)
    table[: 5_000_000] = np.sort(rand_keys(rng, 5_000_000, 0, 1 << 48))
    mk("occupancy_C=2^23", table)
    n = EPOCH_EVENTS
    k = rand_keys(rng, n, 0, 1 << 40)
    mk("traffic_2^20", k, rng.random(n) < 0.3)
    mk("weighted_2^20", k, rng.random(n) < 0.9,
       rng.integers(0, 1 << 20, n).astype(np.int64))
    mk("all_masked", k[:4096], np.zeros(4096, bool))
    mk("all_empty", np.full(4096, EMPTY_KEY, np.int64))
    mk("n=3", np.array([5, -5, EMPTY_KEY], np.int64))
    mk("n=0", np.zeros(0, np.int64))
    mk("negative_keys", rand_keys(rng, 65536, np.iinfo(np.int64).min, 0),
       rng.random(65536) < 0.8)
    mk("one_bucket", one_bucket_keys(rng, 65536))
    mk("weights_above_2^32", k[:65536], np.ones(65536, bool),
       rng.integers(1 << 33, 1 << 40, 65536).astype(np.int64))
    mk("added_into_out", k[:65536], None, None,
       rng.integers(0, 1000, SK_BUCKETS).astype(np.int64))
    return out


def tk_cases(rng, dev):
    """(case, keys, counts) for topk_packed: weighted mode on (key, count)
    rows as a pre-combine emits them, runs mode (counts None) on sorted
    keys with EMPTY_KEY at the tail, at the main paths' shapes and on edge
    cases."""
    out = []

    def mk(case, keys, counts=None):
        out.append((case, _dev(keys, dev),
                    None if counts is None else _dev(counts, dev)))

    def runs(keys, live):
        return np.sort(np.where(live, keys, EMPTY_KEY))
    n = EPOCH_EVENTS
    uk = np.full(n, EMPTY_KEY, np.int64)
    u = sorted_unique(rng, 300_000, 0, 1 << 45)
    uk[: len(u)] = u
    cnt = np.zeros(n, np.int64)
    cnt[: len(u)] = rng.integers(1, 40, len(u))
    mk("weighted_2^20", uk, cnt)
    k = rand_keys(rng, 2 * n, 0, 1 << 30)
    mk("runs_join_2^21", runs(k, rng.random(2 * n) < 0.3))
    k = rand_keys(rng, 10_485_760, 0, 57)
    mk("runs_q5_max_agg_10485760", runs(k, rng.random(10_485_760) < 0.125))
    mk("weighted_all_zero_counts", uk[:4096], np.zeros(4096, np.int64))
    mk("runs_all_masked", np.full(4096, EMPTY_KEY, np.int64))
    mk("weighted_all_empty", np.full(4096, EMPTY_KEY, np.int64),
       np.ones(4096, np.int64))
    for m in (0, 1, 3):
        mk(f"weighted_n={m}", rand_keys(rng, m, 0, 9),
           rng.integers(-1, 5, m).astype(np.int64))
        mk(f"runs_n={m}", np.sort(rand_keys(rng, m, 0, 2)))
    neg = rand_keys(rng, 65536, np.iinfo(np.int64).min, -(1 << 50))
    mk("weighted_negative_keys", neg, rng.integers(-3, 60, 65536))
    mk("runs_negative_keys", np.sort(np.concatenate([neg[:1000]] * 7)))
    big = np.array([3, 4, 5, 6, 7], np.int64)
    mk("weighted_count>max", big, np.array([SK_COUNT_MAX + 1, 1 << 40,
                                            SK_COUNT_MAX, 2, 1 << 23]))
    hot = np.concatenate([np.full(SK_COUNT_MAX + 100, 42, np.int64),
                          np.arange(100, dtype=np.int64)])
    mk("runs_count>max_one_hot_key", np.sort(hot))
    same = (np.arange(8, dtype=np.int64) << 40) + 99     # equal low 40 bits
    mk("weighted_equal_packed_values", same, np.full(8, 7, np.int64))
    mk("runs_equal_packed_values", np.sort(np.repeat(same, 7)))
    return out


def sorted_keys(n, live, hi, dev, dups=False):
    """n sorted int64 keys, the first `live` drawn from [0, hi) (unique
    unless `dups`), EMPTY_KEY after them."""
    if dups:
        k = torch.randint(0, hi, (live,), device=dev)
    else:
        k = torch.unique(torch.randint(0, hi, (2 * live + 64,), device=dev))
        k = k[torch.randperm(k.shape[0], device=dev)[:live]]
        if k.shape[0] != live:
            raise ValueError(f"{live} unique keys below {hi}: too dense")
    out = torch.full((n,), EMPTY_KEY, dtype=torch.int64, device=dev)
    out[:live] = torch.sort(k).values
    return out


def ts_cases(rng, dev):
    """(case, keys, old keys, old touch, touched keys, promoted touch or
    None, tick) for touch_stamp: the main paths' shapes (q3a's bid side
    untiered, C = 2^23 with join keys repeating, T = 2 x 2^20; a q8
    distinct, C = 2^22) and the edges."""
    torch.manual_seed(int(rng.integers(1 << 30)))
    tick = torch.tensor(9, dtype=torch.int64, device=dev)

    def touch(keys, lo=0, hi=10):
        t = torch.randint(lo, hi, keys.shape, device=dev)
        return torch.where(keys != EMPTY_KEY, t, 0)
    c = 1 << 23
    new = sorted_keys(c, 7_700_000, 480_000, dev, dups=True)
    old = new.clone()
    old[7_600_000:] = EMPTY_KEY
    tk = sorted_keys(1 << 21, 1_930_000, 500_000, dev, dups=True)
    yield "q3a_bid_side", new, old, touch(old), tk, None, tick
    yield "q3a_bid_side_promote", new, old, touch(old), tk, touch(tk), tick
    q8 = sorted_keys(1 << 22, 2_825_318, 1 << 40, dev)
    q8old = q8.clone()
    q8old[2_700_000:] = EMPTY_KEY
    q8t = sorted_keys(1 << 20, 600_000, 1 << 40, dev)
    yield "q8_distinct", q8, q8old, touch(q8old), q8t, None, tick
    e = torch.full((4096,), EMPTY_KEY, dtype=torch.int64, device=dev)
    yield "all_empty", e, e, torch.zeros_like(e), e[:256], None, tick
    small = sorted_keys(4096, 3000, 1 << 20, dev)
    yield "grown", small, small[:2048].clone(), touch(small[:2048]), \
        small[::3].contiguous(), None, tick
    dup = sorted_keys(4096, 4000, 300, dev, dups=True)
    dold = sorted_keys(4096, 3500, 300, dev, dups=True)
    yield "join_dups", dup, dold, touch(dold), dup[::5].contiguous(), \
        touch(dup[::5]), tick
    for tk_ in (3, 4, 5, 12):
        t = torch.tensor(tk_, dtype=torch.int64, device=dev)
        yield f"tick{tk_}", small, small, touch(small, max(0, tk_ - 5),
                                                 tk_ + 1), \
            small[::7].contiguous(), None, t
    one = sorted_keys(1, 1, 10, dev)
    yield "one_row", one, one, touch(one), one, None, tick


def tp_cases(rng, dev):
    """(case, keys, cols, fills, dkeys, hits) for tier_partition: a q3a
    bid side at the tiered clamp (2^21 rows x 11 columns, a demotion of
    2^17 keys, hits kept), an agg table with neutral fills, and the
    edges."""
    torch.manual_seed(int(rng.integers(1 << 30)))
    n = 1 << 21
    jk = sorted_keys(n, 1_800_000, 120_000, dev, dups=True)
    pk = torch.randint(0, 1 << 40, (n,), device=dev)
    cols = [jk, pk] + [torch.randint(-1 << 40, 1 << 40, (n,), device=dev)
                       for _ in range(8)] + [torch.randint(0, 99, (n,),
                                                           device=dev)]
    fills = [EMPTY_KEY, EMPTY_KEY] + [0] * 9
    live = jk[jk != EMPTY_KEY]
    dk = torch.full((1 << 17,), EMPTY_KEY, dtype=torch.int64, device=dev)
    pick = torch.unique(live[torch.randint(0, live.shape[0], (90_000,),
                                           device=dev)])
    dk[:pick.shape[0]] = pick
    yield "q3a_bid_side", jk, cols, fills, dk, True
    m = 1 << 14
    ak = sorted_keys(m, 13_000, 1 << 30, dev)
    acols = [ak, torch.randint(1, 99, (m,), device=dev),
             torch.rand(m, device=dev, dtype=torch.float64),
             torch.randint(0, 2, (m,), device=dev).bool(),
             torch.randint(0, 9, (m,), device=dev, dtype=torch.int32),
             torch.randint(0, 20, (m,), device=dev)]
    afills = [EMPTY_KEY, 0, float("inf"), False, -(1 << 31), 0]
    akl = ak[ak != EMPTY_KEY]
    adk = torch.full((4096,), EMPTY_KEY, dtype=torch.int64, device=dev)
    adk[:3000] = akl[torch.randperm(akl.shape[0], device=dev)[:3000]
                     ].sort().values
    yield "agg", ak, acols, afills, adk, False
    none = torch.full((64,), EMPTY_KEY, dtype=torch.int64, device=dev)
    yield "no_dkeys", ak, acols, afills, none, True
    every = torch.full((m,), EMPTY_KEY, dtype=torch.int64, device=dev)
    every[:akl.shape[0]] = akl
    yield "every_row", ak, acols, afills, every, True
    e = torch.full((1024,), EMPTY_KEY, dtype=torch.int64, device=dev)
    yield "all_empty", e, [e, e.clone()], [EMPTY_KEY, 0], adk, True
    yield "join_dups", jk[:4096].contiguous(), [c[:4096].contiguous()
                                                for c in cols], fills, \
        torch.unique(jk[:4096:9]).contiguous(), True


def hop_leaves(r):
    cols, pk, sign, mask = r
    return list(cols) + ([] if pk is None else [pk]) + [sign, mask]


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
        # summed magnitudes (the plain version adds with atomics); NaN
        # rows are left out of the scale
        scale = max([float(v.abs().nansum()) for v in vals
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
    # the window and multiset kernels copy, add and compare ints: exact
    for case, *args in hop_cases(rng, dev):
        got = K.hop_expand(*args)
        want = K.hop_expand_plain(*args)
        torch.cuda.synchronize()
        if (got[1] is None) != (want[1] is None):
            raise AssertionError(f"hop_expand/{case}: pk presence differs")
        compare("hop_expand", case, hop_leaves(got), hop_leaves(want))
    for case, *args in msbr_cases(rng, dev):
        got = K.ms_batch_reduce(*args)
        want = K.ms_batch_reduce_plain(*args)
        torch.cuda.synchronize()
        compare("ms_batch_reduce", case, got, want)
    for case, *args in msm_cases(rng, dev):
        got = K.ms_merge(*args)
        want = K.ms_merge_plain(*args)
        torch.cuda.synchronize()
        compare("ms_merge", case, got, want)
    for case, *args in msf_cases(rng, dev):
        got = K.ms_find(*args)
        want = K.ms_find_plain(*args)
        torch.cuda.synchronize()
        compare("ms_find", case, got, want)
    # the telemetry kernels add and compare ints: exact
    for case, keys, live, w, into in vh_cases(rng, dev):
        got = K.vnode_hist(keys, live, w, EMPTY_KEY,
                           None if into is None else into.clone())
        want = K.vnode_hist_plain(keys, live, w, EMPTY_KEY,
                                  None if into is None else into.clone())
        torch.cuda.synchronize()
        compare("vnode_hist", case, got, want)
    for case, keys, counts in tk_cases(rng, dev):
        got = K.topk_packed(keys, counts)
        want = K.topk_packed_plain(keys, counts, EMPTY_KEY)
        torch.cuda.synchronize()
        compare("topk_packed", case, got, want)
    # the tiering kernels search, copy and add ints: exact
    for case, *args in ts_cases(rng, dev):
        got = K.touch_stamp(*args, TIER_TTL)
        want = K.touch_stamp_plain(*args, TIER_TTL, EMPTY_KEY)
        torch.cuda.synchronize()
        compare("touch_stamp", case, got, want)
    for case, keys, cols, fills, dk, hits in tp_cases(rng, dev):
        got = K.tier_partition(keys, cols, fills, dk, hits)
        want = K.tier_partition_plain(keys, cols, fills, dk, hits, EMPTY_KEY)
        torch.cuda.synchronize()
        compare("tier_partition", case, list(got), list(want))
    return err


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


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


def bid_source(dev, max_events):
    """The bid source with every column, as the fuse planner builds it."""
    return F.SourceNode("bid", GenCfg.from_config(NexmarkConfig()),
                        [c for c, _ in BID_COLS], len(BID_COLS) - 1,
                        max_events, [d for _, d in BID_COLS], device=dev)


def table_stream(dev, table, max_events, names):
    """The port generator's rows of `table` over [0, max_events), as numpy
    columns."""
    gencfg = GenCfg.from_config(NexmarkConfig())
    acc = {nm: [] for nm in names}
    for lo in range(0, max_events, EPOCH_EVENTS):
        ids = torch.arange(lo, min(lo + EPOCH_EVENTS, max_events),
                           dtype=torch.int64, device=dev)
        m = table_mask(table, ids)
        cols = gen_table(gencfg, table, ids)
        for nm in names:
            acc[nm].append(cols[nm][m].cpu().numpy())
    return [np.concatenate(acc[nm]) for nm in names]


def bid_stream(dev, max_events, names):
    """The port generator's bids over [0, max_events), as numpy columns."""
    return table_stream(dev, "bid", max_events, names)


def groupby_reduce(keys, cols):
    """Sort-reduceat group-by: [(reduce, col), ...] -> (ukeys, results)."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    bounds = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    out = []
    for how, c in cols:
        if how == "count":
            out.append(np.diff(np.r_[bounds, len(k)]))
        elif how == "sum":
            out.append(np.add.reduceat(c[order], bounds))
        elif how == "max":
            out.append(np.maximum.reduceat(c[order], bounds))
    return k[bounds], out


def q4_job(dev, max_events=MAX_EVENTS, precombine=True, telemetry=True,
           tier=True):
    """The node graph the fuse planner lowers q4 to: Source(bid) ->
    Map($0, $2, $2) -> [Precombine ->] Agg -> MVKeyed."""
    src = bid_source(dev, max_events)
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
    arm_telemetry(nodes, telemetry, telemetry, tier)
    prog = F.FusedProgram(nodes, EPOCH_EVENTS, device=dev)
    return F.FusedJob("q4", prog, pull, max_events, device=dev)


def q4_oracle(dev, max_events=MAX_EVENTS):
    """numpy group-by over the bid stream of the port's generator."""
    auction, price = bid_stream(dev, max_events, ("auction", "price"))
    k, (cnt, s, m) = groupby_reduce(auction, [("count", None),
                                              ("sum", price),
                                              ("max", price)])
    return k, cnt, s, m


def drive(job, last=None):
    """Drive a job to the end of its stream, then pull the MV. Returns the
    rows, the drive seconds (dispatch, checkpoint syncs, growth replays;
    ends synced), the pull seconds, the kernel launches and the epochs
    dispatched (replays included). The launch counts are zeroed just
    before the drive and read just after the pull. With `last` (a dict),
    last["at"] holds the last dispatched epoch's input states and first
    event id."""
    steps = [0]
    step = job.program.step

    def counted(states, event_lo, acc, feeds=None):
        steps[0] += 1
        if last is not None:
            last["at"] = (states, event_lo, feeds)
        return step(states, event_lo, acc, feeds)
    job.program.step = counted
    K.reset_launches()
    drive_s = run_epochs(job)
    t1 = time.perf_counter()
    rows = job.mv_rows_now()
    t2 = time.perf_counter()
    launches = dict(K.LAUNCHES)
    del job.program.step
    return rows, drive_s, t2 - t1, launches, steps[0]


def run_epochs(job) -> float:
    """The barrier loop to the end of the job's stream, a checkpoint
    every CKPT_EVERY epochs and one after the last; returns its seconds
    (ends synced)."""
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
    return time.perf_counter() - t0


def drive_cost(make, rounds: int = 3) -> dict:
    """The drive's seconds with the telemetry disarmed and armed, in turns
    (bare, armed, armed, bare, `rounds` times), each a fresh job from
    `make(telemetry)` driven to its end with no pull."""
    out = {"bare_s": [], "armed_s": []}
    for on in (False, True, True, False) * rounds:
        job = make(on)
        out["armed_s" if on else "bare_s"].append(run_epochs(job))
        del job
    return out


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




def q3a_job(dev, max_events=Q3_EVENTS, epoch_events=EPOCH_EVENTS,
            capacity=CAPACITY, telemetry=True, tier=True, host_fed=False,
            budget_mb=4096, presize=None):
    """The node graph the fuse planner lowers q3a to (`SELECT b.auction,
    b.price, a.seller, a.category FROM bid b JOIN auction a ON b.auction
    = a.id WHERE b.price > 500`): Source(bid), Source(auction) ->
    Join(auction = id, pair capacity 4 x capacity) -> Filter($2 > 500) ->
    Map -> MVPair. With `host_fed`, both sources are IngestNodes fed by
    the job's HostIngest, and the join demotes under `budget_mb`.
    `presize` ({"a", "b", "pairs", "mv"} -> slots) sets starting
    capacities above `capacity`."""
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
    nodes = srcs + [join, filt, mp, mv]
    if presize:
        join.preset_caps(presize)
        mv.preset_caps({"main": presize.get("mv", 0)})
    arm_telemetry(nodes, telemetry, telemetry, tier)
    return _job("q3a", nodes, pull, max_events, epoch_events, dev, host_fed,
                budget_mb)


def _job(name, nodes, pull, max_events, epoch_events, dev, host_fed=False,
         budget_mb=4096):
    """The FusedJob of a node list; `host_fed` makes its sources
    IngestNodes (only the columns some node reads ship) fed by a
    HostIngest, with the planner's tier plans and the memory budget."""
    if not host_fed:
        prog = F.FusedProgram(nodes, epoch_events, device=dev)
        return F.FusedJob(name, prog, pull, max_events, device=dev,
                          hbm_budget_mb=budget_mb)
    to_ingest(nodes)
    prune_ingest_columns(nodes)
    prog = F.FusedProgram(nodes, epoch_events, device=dev)
    ingest = host_ingest(prog, max_events)
    return F.FusedJob(name, prog, pull, max_events, device=dev,
                      hbm_budget_mb=budget_mb, ingest=ingest,
                      tier_plans=tier_plans(prog, ingest))


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


# ---------------------------------------------------------------------------
# the host-fed tiered paths
# ---------------------------------------------------------------------------


def qa_job(dev, max_events=QA_EVENTS, epoch_events=EPOCH_EVENTS,
           capacity=CAPACITY, budget_mb=4096, host_fed=True):
    """`SELECT auction, count(*), sum(price) FROM bid GROUP BY auction`
    over bids with `nexmark.key.dist='zipf:1.5'`, pre-combine off (the
    raw agg users set for exact aggs): Ingest(bid) -> Map($0, $2) -> Agg ->
    MVKeyed, every arm on, host-fed under `budget_mb`."""
    gencfg = GenCfg.from_config(NexmarkConfig(key_dist=QA_KEY_DIST))
    src = F.SourceNode("bid", gencfg, [c for c, _ in BID_COLS],
                       len(BID_COLS) - 1, max_events,
                       [d for _, d in BID_COLS], device=dev)
    mp = F.MapNode(0, [InputRef(0, T.INT64), InputRef(2, T.INT64)],
                   device=dev)
    calls = [F.AggCall("count"), F.AggCall("sum", 1)]
    spec = DeviceAggSpec.build(["count_star", "sum"], [np.int64] * 2,
                               append_only=True)
    agg = F.AggNode(1, [0], calls, F.PackPlan.plan([src.ranges[0]]), spec,
                    capacity, None, device=dev)
    mv = F.MVKeyedNode(2, agg, capacity, device=dev)
    pull = F.MVPull("keyed", 3, [T.INT64, T.INT64, T.DECIMAL], [F.NUM] * 3,
                    agg=agg, out_map=[("g", 0), ("c", 0), ("c", 1)])
    nodes = [src, mp, agg, mv]
    arm_telemetry(nodes)
    return _job("qa", nodes, pull, max_events, epoch_events, dev, host_fed,
                budget_mb)


def qa_oracle(max_events=QA_EVENTS):
    """numpy group-by over the zipf bid stream of the host generator:
    (auction, count, sum(price))."""
    gencfg = GenCfg.from_config(NexmarkConfig(key_dist=QA_KEY_DIST))
    auc, price = [], []
    for lo in range(0, max_events, EPOCH_EVENTS):
        ids = np.arange(lo, min(lo + EPOCH_EVENTS, max_events),
                        dtype=np.int64)
        ids = ids[_event_kinds(ids) == 2]
        cols = gen_surrogates(gencfg, "bid", ids, cols=["auction", "price"])
        auc.append(cols["auction"])
        price.append(cols["price"])
    k, (cnt, sm) = groupby_reduce(np.concatenate(auc),
                                  [("count", None),
                                   ("sum", np.concatenate(price))])
    return k, cnt, sm


def check_qa_rows(rows, oracle):
    k, cnt, sm = oracle
    got = np.array([(r[0], r[1], int(r[2])) for r in rows],
                   np.int64).reshape(-1, 3)
    want = np.stack([k, cnt, sm], 1)
    if got.shape[0] != len(k) or not np.all(got[1:, 0] > got[:-1, 0]) \
            or not np.array_equal(got, want):
        m = min(len(got), len(want))
        bad = np.flatnonzero(np.any(got[:m] != want[:m], axis=1))
        first = int(bad[0]) if len(bad) else m
        raise AssertionError(
            f"qa: {got.shape[0]} rows differ from the oracle's {len(k)}; "
            f"first at {first}: "
            f"{got[first].tolist() if first < len(got) else None} vs "
            f"{want[first].tolist() if first < len(want) else None}")


def tiered_tables(job) -> dict:
    """The key tables that demote, by name -> (capacity, device bytes):
    both sides of a join, an agg's main table and its lockstep MV's (the
    budget's own accounting, `cap_bytes` x capacity)."""
    out = {}
    for p in job.tiering.plans:
        if not p.recipes:
            continue
        node = job.program.nodes[p.node_idx]
        nodes = [(p.node_idx, node)]
        if p.mv_idx is not None:
            nodes.append((p.mv_idx, job.program.nodes[p.mv_idx]))
        for i, n in nodes:
            cur, b = n.cap_current(), n.cap_bytes()
            for sl in ("a", "b", "main"):
                if sl in cur:
                    out[f"{i}:{type(n).__name__}.{sl}"] = (cur[sl],
                                                           cur[sl] * b[sl])
    return out


def clamp_budget_mb(job, table: str, slots: int) -> int:
    """The memory budget that holds `table` (a `tiered_tables` name) at
    `slots` slots, in MiB."""
    i, rest = table.split(":")
    sl = rest.split(".")[1]
    return -(-slots * job.program.nodes[int(i)].cap_bytes()[sl] >> 20)


def check_tres(name, job) -> dict:
    """Each tier-armed node's `tres` high-water equals the live rows of its
    final state (both sides of a join)."""
    out = {}
    for i, node in enumerate(job.program.nodes):
        if not node.tier:
            continue
        st = inner(job.states[i])
        live = int(st.main.count) if isinstance(node, F.AggNode) \
            else int(st[0].count) + int(st[1].count)
        tres = job.program.node_stats(i, job._stat_totals)["tres"]
        if tres != live:
            raise AssertionError(f"{name} node {i}: tres {tres} vs "
                                 f"{live} live rows")
        out[f"{i}:{type(node).__name__}"] = live
    return out


def tiered_phase(name, job, events, kernels_needed, check, smi) -> dict:
    """Drive a host-fed tiered path, check its rows and its tiering: it
    demoted, stayed inside its memory budget, and launched its kernels.
    Prints every tiering counter and the tier phases' walls."""
    rows, drive_s, pull_s, launches, epochs = drive(job)
    t = time.perf_counter()
    check(rows)
    tm = job.tiering
    budget = job.hbm_budget_mb << 20
    tables = tiered_tables(job)
    rep = {"events": events, "drive_s": drive_s, "pull_s": pull_s,
           "events_per_s": events / drive_s, "rows": len(rows),
           "growth_replays": job.growth_replays,
           "capacities": {f"{i}:{type(n).__name__}": n.cap_current()
                          for i, n in enumerate(job.program.nodes)
                          if n.cap_current()},
           "tiered_tables": tables, "budget_bytes": budget,
           "tiering": dict(tm.counters), "tier_walls_s": dict(job.tier_walls),
           "tiering_report": job.tiering_report(),
           "cold_rows": {str(k): len(v) for k, v in tm.stores.items()},
           "ingest": {k: v for k, v in job.ingest.stats().items()
                      if k != "sources"},
           "launches": launches, "epochs_dispatched": epochs,
           "oracle_check_s": time.perf_counter() - t, "card": smi}
    job.ingest.close()
    log(f"[main] {name} {json.dumps(rep)}")
    if tm.counters["demotions"] <= 0:
        raise AssertionError(f"{name}: no demotion")
    past = {k: v for k, v in tables.items() if v[1] > budget}
    if past:
        raise AssertionError(f"{name}: {past} grew past the {budget}-byte "
                             "budget")
    missing = [k for k in kernels_needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name} path never launched {missing}")
    return rep


def hop_ranges(tr, hop, size):
    """(window_start, window_end) ranges of a hop over the time range tr,
    as the fuse planner's interval analysis proves them."""
    ws = ((tr[0] // hop - size // hop) * hop, tr[1], hop)
    return ws, (ws[0] + size, tr[1] + size, hop)


def _i64(k):
    return InputRef(k, T.INT64)


def _ts(k):
    return InputRef(k, T.TIMESTAMP)


class _Graph:
    """Nodes appended in order; `add` returns the new node's index."""

    def __init__(self, dev):
        self.dev = dev
        self.nodes = []

    def add(self, cls, *args, **kw):
        self.nodes.append(cls(*args, device=self.dev, **kw))
        return len(self.nodes) - 1


def q5_job(dev, max_events=Q5_EVENTS, epoch_events=EPOCH_EVENTS,
           capacity=CAPACITY, telemetry=True, tier=True):
    """The node graph the fuse planner lowers Nexmark q5 to (pre-combine
    on): Source(bid) feeds two HOP(2 s, 10 s) branches.
      A: Hop -> Map(ws, auction) -> Precombine -> Agg count(*) per
         (window, auction), with row identity -> Map(auction, num, ws);
      B: Hop -> Map(auction, ws) -> Precombine -> Agg count(*) ->
         Map -> Map(ws, num) -> Agg max(num) per window, retractable (a
         multiset fed B's retracting change stream) -> Map(maxn, ws).
    Join(A.ws = B.ws, num >= maxn) -> Map -> MVPair."""
    g = _Graph(dev)
    src = bid_source(dev, max_events)
    g.nodes.append(src)
    rng = src.ranges
    hop, size = 2 * USEC, 10 * USEC
    ws, _ = hop_ranges(rng[5], hop, size)
    cnt = (0, (size // hop) * max_events, 1)      # count(*) after the hop
    count = [F.AggCall("count")]
    cspec = DeviceAggSpec.build(["count_star"], [np.int64])
    # branch A: count per (window, auction), row identity for the join
    h = g.add(F.HopNode, 0, 5, hop, size)
    m = g.add(F.MapNode, h, [_ts(8), _i64(0)])
    pack = F.PackPlan.plan([ws, rng[0]])
    p = g.add(F.PrecombineNode, m, [0, 1], count, pack, cspec)
    a = g.add(F.AggNode, p, [0, 1], count, pack, cspec, capacity,
              F.PackPlan.plan([ws, rng[0], cnt]))
    g.nodes[a].enable_precombine()
    left = g.add(F.MapNode, a, [_i64(1), _i64(2), _ts(0)])
    # branch B: the max of those counts per window
    h = g.add(F.HopNode, 0, 5, hop, size)
    m = g.add(F.MapNode, h, [_i64(0), _ts(8)])
    pack = F.PackPlan.plan([rng[0], ws])
    p = g.add(F.PrecombineNode, m, [0, 1], count, pack, cspec)
    b = g.add(F.AggNode, p, [0, 1], count, pack, cspec, capacity, None)
    g.nodes[b].enable_precombine()
    m = g.add(F.MapNode, b, [_i64(2), _ts(1), _i64(0)])
    m = g.add(F.MapNode, m, [_ts(1), _i64(0)])
    mspec = DeviceAggSpec.build(["max"], [np.int64], append_only=False,
                                arg_ids=[("ref", 1)])
    mx = g.add(F.AggNode, m, [0], [F.AggCall("max", 1)],
               F.PackPlan.plan([ws]), mspec, capacity,
               F.PackPlan.plan([ws, cnt]))
    right = g.add(F.MapNode, mx, [_i64(1), _ts(0)])
    j = g.add(F.JoinNode, left, right, [2], [1], F.PackPlan.plan([ws]),
              build_device("greater_than_or_equal", [_i64(1), _i64(3)]),
              capacity, 4 * capacity, [torch.int64] * 3, [torch.int64] * 2)
    out = g.add(F.MapNode, j, [_i64(0), _i64(1), _ts(2), _ts(4)])
    mv = g.add(F.MVPairNode, out, [torch.int64] * 4, capacity)
    pull = F.MVPull("pair", mv, [T.INT64, T.INT64, T.TIMESTAMP, T.TIMESTAMP],
                    [F.NUM, F.NUM, TS, TS])
    arm_telemetry(g.nodes, telemetry, telemetry, tier)
    prog = F.FusedProgram(g.nodes, epoch_events, device=dev)
    return F.FusedJob("q5", prog, pull, max_events, device=dev)


def q7_job(dev, max_events=Q7_EVENTS, epoch_events=EPOCH_EVENTS,
           capacity=CAPACITY, telemetry=True, tier=True):
    """The node graph the fuse planner lowers Nexmark q7 to (pre-combine
    on): Source(bid) -> Hop(TUMBLE 10 s) -> Map(window_end, price) ->
    Precombine -> Agg max(price) per window (append-only), with row
    identity -> Map(maxprice, window_end); Join(bid.price = maxprice)
    -> Filter(date_time BETWEEN window_end - 10 s AND window_end) -> Map
    -> MVPair."""
    g = _Graph(dev)
    src = bid_source(dev, max_events)
    g.nodes.append(src)
    rng = src.ranges
    size = 10 * USEC
    _, we = hop_ranges(rng[5], size, size)
    h = g.add(F.HopNode, 0, 5, size, size)
    m = g.add(F.MapNode, h, [_ts(9), _i64(2)])
    calls = [F.AggCall("max", 1)]
    spec = DeviceAggSpec.build(["max"], [np.int64], append_only=True)
    pack = F.PackPlan.plan([we])
    p = g.add(F.PrecombineNode, m, [0], calls, pack, spec)
    a = g.add(F.AggNode, p, [0], calls, pack, spec, capacity,
              F.PackPlan.plan([we, rng[2]]))
    g.nodes[a].enable_precombine()
    right = g.add(F.MapNode, a, [_i64(1), _ts(0)])
    j = g.add(F.JoinNode, 0, right, [2], [0], F.PackPlan.plan([rng[2]]),
              None, capacity, 4 * capacity, [torch.int64] * len(BID_COLS),
              [torch.int64] * 2)
    pred = build_device("and", [
        build_device("greater_than_or_equal", [_ts(5),
                                               _TsShift(_ts(9), -size)]),
        build_device("less_than_or_equal", [_ts(5), _ts(9)])])
    f = g.add(F.FilterNode, j, pred)
    out = g.add(F.MapNode, f, [_i64(0), _i64(2), _i64(1), _ts(5), _i64(7),
                               _ts(9)])
    mv = g.add(F.MVPairNode, out, [torch.int64] * 6, capacity)
    pull = F.MVPull("pair", mv, [T.INT64, T.INT64, T.INT64, T.TIMESTAMP,
                                 T.INT64, T.TIMESTAMP],
                    [F.NUM, F.NUM, F.NUM, TS, F.NUM, TS])
    arm_telemetry(g.nodes, telemetry, telemetry, tier)
    prog = F.FusedProgram(g.nodes, epoch_events, device=dev)
    return F.FusedJob("q7", prog, pull, max_events, device=dev)


def np_hop_expand(ts, hop, size):
    """Per-row window starts of HOP (the latest aligned start <= ts, then
    n - 1 back), row-major: row i repeats n times."""
    n = size // hop
    first = (ts // hop) * hop
    return (first[:, None] - (np.arange(n) * hop)[None, :]).reshape(-1)


def numpy_q5(auction, ts):
    """q5 over whole columns: per HOP(2 s, 10 s) window, the auctions whose
    bid count reaches the window's maximum — the sorted multiset of
    (auction, num)."""
    hop, size = 2 * USEC, 10 * USEC
    ws = np_hop_expand(ts, hop, size)
    au = np.repeat(auction, size // hop)
    wn = (ws - ws.min()) // hop       # small window ordinals
    keys, (num,) = groupby_reduce(wn * np.int64(1 << 32) + au,
                                  [("count", None)])
    kws, kau = keys >> 32, keys & ((1 << 32) - 1)
    rows = []
    for w in np.unique(kws):
        sel = kws == w
        mx = num[sel].max()
        top = num[sel] >= mx
        rows += [(int(a), int(c)) for a, c in zip(kau[sel][top],
                                                  num[sel][top])]
    return sorted(rows)


def numpy_q7(auction, bidder, price, ts):
    """q7 over whole columns: the bids at their TUMBLE(10 s) window's max
    price with date_time in [window_end - 10 s, window_end], sorted."""
    size = 10 * USEC
    wend = (ts // size) * size + size
    keys, (mp,) = groupby_reduce(wend, [("max", price)])
    rows = []
    for e, m in zip(keys, mp):
        sel = (price == m) & (ts >= e - size) & (ts <= e)
        rows += [(int(auction[i]), int(price[i]), int(bidder[i]), int(ts[i]))
                 for i in np.flatnonzero(sel)]
    return sorted(rows)


def q5_oracle(dev, max_events=Q5_EVENTS):
    return numpy_q5(*bid_stream(dev, max_events, ("auction", "date_time")))


def q7_oracle(dev, max_events=Q7_EVENTS):
    return numpy_q7(*bid_stream(dev, max_events, ("auction", "bidder",
                                                  "price", "date_time")))


def check_q5_rows(rows, oracle):
    got = sorted((int(r[0]), int(r[1])) for r in rows)
    if not oracle or got != oracle:
        raise AssertionError(f"q5: {len(got)} rows differ from the oracle's "
                             f"{len(oracle)}")


def check_q7_rows(rows, oracle):
    got = sorted((int(r[0]), int(r[1]), int(r[2]), int(r[3])) for r in rows)
    if not oracle or got != oracle:
        raise AssertionError(f"q7: {len(got)} rows differ from the oracle's "
                             f"{len(oracle)}")


PERSON_COLS = [("id", T.INT64), ("name", T.VARCHAR),
               ("email_address", T.VARCHAR), ("credit_card", T.VARCHAR),
               ("city", T.VARCHAR), ("state", T.VARCHAR),
               ("date_time", T.TIMESTAMP), ("extra", T.VARCHAR),
               ("_row_id", T.INT64)]


def q8_job(dev, max_events=Q8_EVENTS, epoch_events=EPOCH_EVENTS,
           capacity=CAPACITY, telemetry=True, tier=True):
    """The node graph the fuse planner lowers Nexmark q8 to (pre-combine
    on): two TUMBLE(10 s) distincts joined on (id = seller, window).
      P: Source(person) -> Hop -> Map(id, name, ws, we) -> Precombine ->
         Agg with no calls per (id, name, ws, we), with row identity ->
         Map;
      A: Source(auction) -> Hop -> Map(seller, ws, we) -> Precombine ->
         Agg with no calls per (seller, ws, we) -> Map.
    Join(P.(id, ws, we) = A.(seller, ws, we)) -> Map -> MVPair. Every
    PackPlan field is proven from the generator's ranges at this scale
    (the window bounds by `hop_ranges`, as the planner's interval
    analysis does), so a packbad stat never fires."""
    g = _Graph(dev)
    gencfg = GenCfg.from_config(NexmarkConfig())
    size = 10 * USEC
    none = DeviceAggSpec.build([], [])
    sides = []
    for table, cols, time_col, key_cols in (
            ("person", PERSON_COLS, 6, (0, 1)),
            ("auction", AUCTION_COLS, 5, (7,))):
        src = F.SourceNode(table, gencfg, [c for c, _ in cols], len(cols) - 1,
                           max_events, [d for _, d in cols], device=dev)
        g.nodes.append(src)
        h = g.add(F.HopNode, len(g.nodes) - 1, time_col, size, size)
        ws, we = hop_ranges(src.ranges[time_col], size, size)
        w = len(cols)                   # window_start, then window_end
        m = g.add(F.MapNode, h, [InputRef(k, cols[k][1]) for k in key_cols]
                  + [_ts(w), _ts(w + 1)])
        rng = [src.ranges[k] for k in key_cols] + [ws, we]
        gidx = list(range(len(rng)))
        pack = F.PackPlan.plan(rng)
        p = g.add(F.PrecombineNode, m, gidx, [], pack, none)
        a = g.add(F.AggNode, p, gidx, [], pack, none, capacity, pack)
        g.nodes[a].enable_precombine()
        out = g.add(F.MapNode, a, [InputRef(k, g.nodes[m].exprs[k]
                                            .return_type) for k in gidx])
        sides.append((out, rng, src))
    (left, lr, psrc), (right, rr, _) = sides
    # (id, ws, we) = (seller, ws, we), packed over both sides' ranges
    jpack = F.PackPlan.plan([(min(a[0], b[0]), max(a[1], b[1]),
                              math.gcd(a[2], b[2]) or 1)
                             for a, b in zip([lr[0], lr[2], lr[3]], rr)])
    j = g.add(F.JoinNode, left, right, [0, 2, 3], [0, 1, 2], jpack, None,
              capacity, 4 * capacity, [torch.int64] * 4, [torch.int64] * 3)
    dts = [T.INT64, T.VARCHAR, T.TIMESTAMP, T.TIMESTAMP, T.INT64,
           T.TIMESTAMP, T.TIMESTAMP]
    out = g.add(F.MapNode, j, [InputRef(k, d) for k, d in enumerate(dts)])
    mv = g.add(F.MVPairNode, out, [torch.int64] * len(dts), capacity)
    pull = F.MVPull("pair", mv, dts,
                    [F.NUM, psrc.decoders[1], TS, TS, F.NUM, TS, TS])
    arm_telemetry(g.nodes, telemetry, telemetry, tier)
    prog = F.FusedProgram(g.nodes, epoch_events, device=dev)
    return F.FusedJob("q8", prog, pull, max_events, device=dev)


def numpy_q8(p_id, p_name, p_ts, a_seller, a_ts):
    """q8 over whole columns: the (id, name, window_start) of every person
    whose TUMBLE(10 s) window also holds an auction they sell — sorted
    unique rows as an [n, 3] int64 array (name as its surrogate)."""
    size = 10 * USEC
    pw, aw = (p_ts // size) * size, (a_ts // size) * size
    w0 = min(pw.min(), aw.min())
    persons = np.unique(np.stack([p_id, p_name, pw], 1), axis=0)
    # (id, window ordinal) packed into one int64 for the membership test
    shift = int(max(pw.max(), aw.max()) - w0) // size + 1
    pk = persons[:, 0] * shift + (persons[:, 2] - w0) // size
    sk = np.unique(a_seller * shift + (aw - w0) // size)
    return persons[np.isin(pk, sk)]


def q8_streams(dev, max_events=Q8_EVENTS):
    """(person id, name surrogate, date_time), (auction seller, date_time)
    of the port generator."""
    return (table_stream(dev, "person", max_events,
                         ("id", "name", "date_time")),
            table_stream(dev, "auction", max_events,
                         ("seller", "date_time")))


def check_q8_rows(rows, oracle, name_pool):
    """The MV's (id, name, starttime) against the oracle's rows, names
    through the source's surrogate pool."""
    index = {nm: i for i, nm in enumerate(name_pool)}
    got = np.array([(r[0], index[r[1]], r[2]) for r in rows],
                   np.int64).reshape(-1, 3)
    got = got[np.lexsort(got.T[::-1])]
    if not len(oracle) or got.shape != oracle.shape \
            or not np.array_equal(got, oracle):
        raise AssertionError(f"q8: {len(got)} rows differ from the oracle's "
                             f"{len(oracle)}")


def check_q8_telemetry(job, streams) -> dict:
    """Each distinct agg's telemetry against what the run holds: its
    occupancy high-water sums to its live groups and equals a numpy
    histogram of its final key table (the host `compute_vnodes`); its
    traffic sums to the rows it was routed (its rows_in total), which is
    every person / auction row once."""
    (pid, _, _), (seller, _) = streams
    prog = job.program
    out = {}
    aggs = [i for i, n in enumerate(prog.nodes) if isinstance(n, F.AggNode)]
    for i, rows in zip(aggs, (len(pid), len(seller))):
        st = prog.node_stats(i, job._stat_totals)
        occ = np.array([st[f"skv{b}"] for b in range(SK_BUCKETS)])
        tv = np.array([st[f"tv{b}"] for b in range(SK_BUCKETS)])
        main = inner(job.states[i]).main
        live = int(main.count)
        keys = main.keys[:live].cpu().numpy()
        hist = np.bincount(compute_vnodes(keys) * SK_BUCKETS // 256,
                           minlength=SK_BUCKETS)
        if occ.sum() != live or not np.array_equal(occ, hist):
            raise AssertionError(f"q8 node {i}: occupancy {occ.tolist()} vs "
                                 f"{live} live groups {hist.tolist()}")
        if tv.sum() != st["rows_in"] or tv.sum() != rows:
            raise AssertionError(f"q8 node {i}: traffic {int(tv.sum())} vs "
                                 f"rows_in {st['rows_in']}, {rows} rows")
        out[f"{i}:AggNode"] = {"live_groups": live, "routed_rows": rows}
    return out


def telemetry_line(name, job) -> dict:
    """Each keyed node's skew_ratio row and rank-0 hot_key row."""
    rows = {}
    for r in job.skew_report():
        if r[2] == "skew_ratio" or (r[2] == "hot_key" and r[3] == 0):
            rows.setdefault(f"{r[0]}:{r[1]}", {})[r[2]] = \
                [r[4], r[5], r[6]]
    return {"telemetry": name, "nodes": rows}


def node_times(job, keep=(), at=None):
    """One more epoch with a CUDA-event pair around each node's step (the
    result is discarded): per-node milliseconds, and the input deltas of
    the nodes in `keep` (index -> [Delta]). The epoch runs over `at`
    (states, first event id): by default the final state and the
    stream's first epoch."""
    prog = job.program
    evs = []
    kept = {}
    for i, node in enumerate(prog.nodes):
        orig = node.apply

        def timed(*a, _orig=orig, _evs=evs, _n=type(node).__name__, _i=i):
            if _i in keep:
                kept[_i] = a[1]
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = _orig(*a)
            e1.record()
            _evs.append((_n, e0, e1))
            return out
        node.apply = timed
    prog.epoch(*(at or (job.states, 0)))
    torch.cuda.synchronize()
    for node in prog.nodes:
        del node.apply
    return [(n, e0.elapsed_time(e1)) for n, e0, e1 in evs], kept


def telemetry_cost(job, rounds: int = 9, at=None) -> dict:
    """Per keyed node: the median of `rounds` node times of one epoch
    (`node_times`' `at`) with its telemetry armed and with it disarmed
    (in turns), and their difference."""
    prog = job.program
    keyed = [i for i, n in enumerate(prog.nodes) if n.skew or n.flow]
    armed = {i: [] for i in keyed}
    bare = {i: [] for i in keyed}
    for _ in range(rounds):
        for on, acc in ((True, armed), (False, bare)):
            for i in keyed:
                prog.nodes[i].skew = prog.nodes[i].flow = on
            ms, _ = node_times(job, at=at)
            for i in keyed:
                acc[i].append(ms[i][1])
    for i in keyed:
        prog.nodes[i].skew = prog.nodes[i].flow = True
    out = {}
    for i in keyed:
        a, b = float(np.median(armed[i])), float(np.median(bare[i]))
        out[f"{i}:{type(prog.nodes[i]).__name__}"] = dict(
            armed_ms=a, bare_ms=b, telemetry_ms=a - b)
    return out


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
        device_ms=graph_ms(lambda: K.sort_cols([mk], [])),
        plain_ms=median_ms(lambda: K.sort_cols_plain([mk], [])),
        library_ms=median_ms(lambda: torch.sort(mk, stable=True)),
        bound_ms=bound_ms(8 * n + 16 * n), bound_by="bytes")
    out["batch_reduce"] = dict(
        ms=median_ms(lambda: K.batch_reduce(keys, mask, vals, kinds)),
        device_ms=graph_ms(lambda: K.batch_reduce(keys, mask, vals, kinds)),
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
        device_ms=graph_ms(lambda: K.merge(st, dk, dv, mkinds)),
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
        device_ms=graph_ms(lambda: K.compact_rows(alive, ccols[:1], ccols[1:], c,
                                            fills)),
        plain_ms=median_ms(lambda: K.compact_rows_plain(
            alive, ccols[:1], ccols[1:], c, fills)),
        library_ms=median_ms(lambda: lib_compact(alive, ccols, c, fills)),
        bound_ms=bound_ms(m + 8 * (1 + ncol) * (kept + c) + 4),
        bound_by="bytes")
    return out


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one call of `fn`: `reps` calls captured in
    a CUDA graph, the replay timed by `median_ms`, divided by `reps` —
    the host's launch path (Python, ctypes) left out. `fn` must not
    synchronise."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return median_ms(g.replay, runs=11) / reps


def lib_vnode_hist(keys, live, weights):
    """PyTorch library composition: the CRC by int64 ops, then one
    bincount (float counts when weighted)."""
    bucket = compute_vnodes_dev(keys).to(torch.int64) * SK_BUCKETS // 256
    live = keys != EMPTY_KEY if live is None else live
    bucket = torch.where(live, bucket, SK_BUCKETS)
    return torch.bincount(bucket, weights=weights,
                          minlength=SK_BUCKETS + 1)[:SK_BUCKETS]


def lib_topk(keys, counts):
    """PyTorch library composition: (runs mode) unique_consecutive with
    counts over the sorted keys, then the pack and torch.topk."""
    if counts is None:
        keys, counts = torch.unique_consecutive(keys, return_counts=True)
    packed = torch.where((counts > 0) & (keys != EMPTY_KEY),
                         (torch.clamp(counts, max=SK_COUNT_MAX) << 40)
                         | (keys & ((1 << 40) - 1)), 0)
    return torch.topk(packed, min(SK_TOPK, packed.shape[0])).values


def hist_entry(keys, live=None, weights=None, **extra) -> dict:
    """vnode_hist at one shape, held against its plain version first."""
    compare("vnode_hist", extra.get("shape", "main_path"),
            K.vnode_hist(keys, live, weights, EMPTY_KEY),
            K.vnode_hist_plain(keys, live, weights, EMPTY_KEY))
    n = keys.shape[0]
    nbytes = 8 * n + (0 if live is None else n) \
        + (0 if weights is None else 8 * n) + 8 * SK_BUCKETS
    return dict(ms=median_ms(lambda: K.vnode_hist(keys, live, weights,
                                                  EMPTY_KEY)),
                device_ms=graph_ms(lambda: K.vnode_hist(keys, live, weights,
                                                        EMPTY_KEY)),
                plain_ms=median_ms(lambda: K.vnode_hist_plain(
                    keys, live, weights, EMPTY_KEY)),
                library_ms=median_ms(lambda: lib_vnode_hist(keys, live,
                                                            weights)),
                bound_ms=bound_ms(nbytes), bound_by="bytes", **extra)


def topk_entry(keys, counts=None, **extra) -> dict:
    """topk_packed at one shape, held against its plain version first."""
    compare("topk_packed", extra.get("shape", "main_path"),
            K.topk_packed(keys, counts),
            K.topk_packed_plain(keys, counts, EMPTY_KEY))
    n = keys.shape[0]
    return dict(ms=median_ms(lambda: K.topk_packed(keys, counts)),
                device_ms=graph_ms(lambda: K.topk_packed(keys, counts)),
                plain_ms=median_ms(lambda: K.topk_packed_plain(
                    keys, counts, EMPTY_KEY)),
                library_ms=median_ms(lambda: lib_topk(keys, counts)),
                bound_ms=bound_ms((16 if counts is not None else 8) * n
                                  + 32), bound_by="bytes", **extra)


def skew_timings(job, kept, ai, ji) -> dict:
    """The telemetry kernels on the q8 job's final state, fed the inputs
    its nodes saw in `node_times`' extra epoch (`ai`: the person agg,
    `ji`: the join): vnode_hist as the occupancy of the agg's key table
    and as the weighted traffic of its pre-combined input; topk_packed
    weighted over that input's (key, raw-row count) rows and in runs mode
    over the join's two sorted input deltas."""
    d = kept[ai][0]
    keys, cnt = d.cols[0], d.cols[1]
    live = d.mask & (d.sign != 0)
    table = inner(job.states[ai]).main.keys
    occ = hist_entry(table, shape=f"occupancy C={table.shape[0]}",
                     live_keys=int(inner(job.states[ai]).main.count))
    occ["traffic_weighted"] = hist_entry(
        keys, live, cnt.abs(), shape=f"traffic B={keys.shape[0]}, weighted",
        live_rows=int(live.sum()))
    ukeys, (ucnt,), _ = K.batch_reduce(keys, live, [cnt], [S])
    top = topk_entry(ukeys, ucnt, shape=f"weighted B={ukeys.shape[0]}")
    jn = job.program.nodes[ji]
    dl, dr = kept[ji]
    jk = torch.cat([jn.pack.pack([dl.cols[i] for i in jn.l_keys]),
                    jn.pack.pack([dr.cols[i] for i in jn.r_keys])])
    jlive = torch.cat([dl.mask & (dl.sign != 0), dr.mask & (dr.sign != 0)])
    (sk,), _ = K.sort_cols([torch.where(jlive, jk, EMPTY_KEY)], [])
    occ["traffic_join"] = hist_entry(jk, jlive, shape=f"traffic B="
                                     f"{jk.shape[0]}")
    top["runs_join"] = topk_entry(sk, shape=f"runs B={sk.shape[0]}",
                                  live_rows=int(jlive.sum()))
    return {"vnode_hist": occ, "topk_packed": top}


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


def rows_split(jk, pk, signs, mask, vals) -> dict:
    """batch_reduce_rows' two parts apart: its two-key sort, and the
    reduce kernels on that sort's output."""
    mjk = torch.where(mask, jk, EMPTY_KEY)
    mpk = torch.where(mask, pk, EMPTY_KEY)
    perm, sk = K._sort_perm([mjk, mpk])
    sign = signs.to(torch.int32).contiguous()
    vals = [v.contiguous() for v in vals]

    def reduce():
        return K.binding.reduce_rows(sk, mpk, perm, sign, vals)
    return dict(sort_ms=median_ms(lambda: K._sort_perm([mjk, mpk])),
                sort_device_ms=graph_ms(lambda: K._sort_perm([mjk, mpk])),
                reduce_ms=median_ms(reduce), reduce_device_ms=graph_ms(reduce))


def merge_side_memory(dev) -> dict:
    """merge_side's device memory at the timing shape, on inputs made on
    the card from a seed: a 2^23-slot side holding 7,700,000 rows x 8
    int64 columns, a delta of 2^20 slots with 964,689 inserts. The peak
    bytes one call allocates beyond its inputs, its outputs' bytes, and
    the difference: its temporaries."""
    c, b, live, nd, k = 1 << 23, 1 << 20, 7_700_000, 964_689, 8
    g = torch.Generator(device=dev)
    g.manual_seed(5)

    def run(cap, n, pk0):
        jk = torch.full((cap,), EMPTY_KEY, dtype=torch.int64, device=dev)
        pk = jk.clone()
        jk[:n] = torch.sort(torch.randint(0, 1 << 19, (n,), device=dev,
                                          generator=g)).values
        pk[:n] = pk0 + torch.arange(n, device=dev)   # ascending within a jk
        vals = [torch.randint(-10**6, 10**6, (cap,), device=dev, generator=g)
                for _ in range(k)]
        return jk, pk, vals
    sjk, spk, svals = run(c, live, 0)
    side = JoinSide(sjk, spk, torch.tensor(live, dtype=torch.int32,
                                           device=dev), tuple(svals))
    djk, dpk, dvals = run(b, nd, live)
    dsign = (djk != EMPTY_KEY).to(torch.int32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = K.merge_side(side, djk, dpk, dsign, dvals)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    kept = torch.cuda.memory_allocated() - base
    if int(out[1]) != live + nd:
        raise AssertionError(f"merge_side memory: needed {int(out[1])}")
    return dict(shape=f"C={c} ({live} live), B={b} ({nd} live) x {k} int64",
                peak_bytes=peak, output_bytes=kept, temp_bytes=peak - kept)


def join_timings(dev, job) -> dict:
    """The three join kernels on the q3a job's final state, fed the next
    epoch of the generator's bids: batch_reduce_rows on the epoch's 2^20
    bid rows x 8 columns (and, under "netting", on that epoch's 2m pair
    rows x 19 columns), merge_side of the reduced bids into the bid side
    at its final capacity, probe of the auction side by the reduced bids
    with the final pair capacity m."""
    rng = np.random.default_rng(11)
    jn = job.program.nodes[2]
    a, b = inner(job.states[2])
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
    # sort_cols on the (jk, pk) pairs batch_reduce_rows sorts
    sk1 = torch.where(mask, jk, EMPTY_KEY)
    sk2 = torch.where(mask, ids, EMPTY_KEY)
    idx = torch.arange(n, device=dev)
    compare("sort_cols", "q3a_jk_pk", K.sort_cols([sk1, sk2], [idx]),
            K.sort_cols_plain([sk1, sk2], [idx]))
    out = {"sort_cols": dict(
        ms=median_ms(lambda: K.sort_cols([sk1, sk2], [])),
        device_ms=graph_ms(lambda: K.sort_cols([sk1, sk2], [])),
        plain_ms=median_ms(lambda: K.sort_cols_plain([sk1, sk2], [])),
        library_ms=median_ms(lambda: _two_key_perm(sk1, sk2)),
        bound_ms=bound_ms(16 * n + 16 * n), bound_by="bytes",
        shape=f"2 keys x {n} (jk, pk)",
        library_note="two stable torch.sort calls: no one-call form")}
    out["batch_reduce_rows"] = dict(
        ms=median_ms(lambda: K.batch_reduce_rows(*args)),
        device_ms=graph_ms(lambda: K.batch_reduce_rows(*args)),
        plain_ms=median_ms(lambda: K.batch_reduce_rows_plain(*args)),
        library_ms=median_ms(lambda: lib_batch_reduce_rows(*args)),
        bound_ms=bound_ms(n * (8 + 8 + 4 + 1 + 8 * k)
                          + n * (8 + 8 + 4 + 8 * k)),
        bound_by="bytes", shape=f"B={n} x {k} int64", **rows_split(*args))
    dajk, dapk, dasign, davals = K.batch_reduce_rows(*args)
    c = a.jk.shape[0]
    margs = (a, dajk, dapk, dasign, davals)
    out["merge_side"] = dict(
        ms=median_ms(lambda: K.merge_side(*margs)),
        device_ms=graph_ms(lambda: K.merge_side(*margs)),
        plain_ms=median_ms(lambda: K.merge_side_plain(*margs)),
        library_ms=median_ms(lambda: lib_merge_side(*margs)),
        bound_ms=bound_ms(c * (16 + 8 * k) + n * (16 + 4 + 8 * k)
                          + c * (16 + 8 * k) + 4),
        bound_by="bytes", shape=f"C={c}, B={n} x {k} int64",
        live=int(a.count), memory=merge_side_memory(dev))
    qmask = dasign != 0
    cb, m = b.jk.shape[0], jn.m
    pargs = (b, dajk, qmask, m)
    total = int(K.probe_plain(*pargs)[3])
    out["probe"] = dict(
        ms=median_ms(lambda: K.probe(*pargs)),
        device_ms=graph_ms(lambda: K.probe(*pargs)),
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
        device_ms=graph_ms(lambda: K.batch_reduce_rows(*nargs)),
        plain_ms=median_ms(lambda: K.batch_reduce_rows_plain(*nargs)),
        library_ms=median_ms(lambda: lib_batch_reduce_rows(*nargs)),
        bound_ms=bound_ms(n2 * (8 + 8 + 4 + 1 + 8 * k2)
                          + n2 * (8 + 8 + 4 + 8 * k2)),
        shape=f"B={n2} x {k2} int64", **rows_split(*nargs))
    return out


def lib_hop_expand(cols, time_col, hop, size, pk, sign, mask):
    """PyTorch library composition: repeat_interleave per column, arange
    arithmetic for the window bounds and row ids."""
    n = size // hop
    k = torch.arange(n, device=sign.device).repeat(sign.shape[0])
    first = torch.div(cols[time_col], hop, rounding_mode="floor") * hop
    start = first.repeat_interleave(n) - k * hop
    return ([c.repeat_interleave(n) for c in cols] + [start, start + size],
            pk.repeat_interleave(n) * n + k, sign.repeat_interleave(n),
            mask.repeat_interleave(n))


def lib_ms_batch_reduce(k1, k2, delta, mask):
    """PyTorch library composition: two stable sorts, unique_consecutive
    over the (k1, k2) pairs, index_add_ of the deltas."""
    n = k1.shape[0]
    m1 = torch.where(mask, k1, EMPTY_KEY)
    m2 = torch.where(mask, k2, EMPTY_KEY)
    perm = _two_key_perm(m1, m2)
    u, inv = torch.unique_consecutive(torch.stack([m1[perm], m2[perm]], 1),
                                      dim=0, return_inverse=True)
    ud = torch.zeros(n, dtype=torch.int64, device=k1.device).index_add_(
        0, inv, torch.where(mask, delta, 0)[perm])
    u1 = torch.full((n,), EMPTY_KEY, dtype=torch.int64, device=k1.device)
    u2 = u1.clone()
    u1[:u.shape[0]], u2[:u.shape[0]] = u[:, 0], u[:, 1]
    return u1, u2, torch.where(u1 == EMPTY_KEY, 0, ud)


def lib_ms_merge(ms, u1, u2, ud):
    """PyTorch library composition: cat, two stable sorts with gathers,
    the shifted compare, nonzero compaction."""
    c = ms.k1.shape[0]
    k1, k2 = torch.cat([ms.k1, u1]), torch.cat([ms.k2, u2])
    perm = _two_key_perm(k1, k2)
    k1, k2, cnt = k1[perm], k2[perm], torch.cat([ms.cnt, ud])[perm]
    same = (k1[:-1] == k1[1:]) & (k2[:-1] == k2[1:])
    merged = cnt.clone()
    merged[:-1] += torch.where(same, cnt[1:], 0)
    alive = (k1 != EMPTY_KEY) & (merged != 0)
    alive[1:] &= ~same
    idx = torch.nonzero(alive).squeeze(1)[:c]
    out = []
    for col, fill in ((k1, EMPTY_KEY), (k2, EMPTY_KEY), (merged, 0)):
        o = torch.full((c,), fill, dtype=torch.int64, device=col.device)
        o[:idx.shape[0]] = col[idx]
        out.append(o)
    return out


def lib_ms_find(ms, q1, q2):
    """One searchsorted over (k1, k2) packed into one int64 key, valid only
    where every group key is in [0, 2^31) and every value in [0, 2^32)
    (the caller checks)."""
    def pack(a, b):
        return torch.where(a == EMPTY_KEY, EMPTY_KEY, (a << 32) | b)
    sk, qk = pack(ms.k1, ms.k2), pack(q1, q2)
    lo = torch.clamp(torch.searchsorted(sk, qk), max=sk.shape[0] - 1)
    found = (sk[lo] == qk) & (q1 != EMPTY_KEY)
    return found, torch.where(found, ms.cnt[lo], 0)


def _packable(k1, k2):
    live = k1 != EMPTY_KEY
    return bool(torch.all(~live | ((k1 >= 0) & (k1 < (1 << 31))
                                   & (k2 >= 0) & (k2 < (1 << 32)))))


def window_multiset_timings(job, kept, hi, ai) -> dict:
    """The window and multiset kernels on the q5 job's final state, fed
    the inputs its nodes saw in `node_times`' extra epoch: hop_expand on
    the source's 2^20 rows x 8 columns (HOP 2 s / 10 s, n = 5);
    ms_batch_reduce on the retractable max agg's change-stream input;
    ms_merge of that reduced delta into the final multiset; ms_find of
    the delta's pairs in the merged multiset (`hi`, `ai`: the indices of
    the first HopNode and of the retractable max agg). Each kernel is
    also held against its plain version at these main-path shapes."""
    hn = job.program.nodes[hi]
    d = kept[hi][0]
    hargs = (d.cols, hn.time_col, hn.hop, hn.size, d.pk, d.sign, d.mask)
    rows, k, n = d.sign.shape[0], len(d.cols), hn.n
    compare("hop_expand", "q5_main_path", hop_leaves(K.hop_expand(*hargs)),
            hop_leaves(K.hop_expand_plain(*hargs)))
    out = {"hop_expand": dict(
        ms=median_ms(lambda: K.hop_expand(*hargs)),
        device_ms=graph_ms(lambda: K.hop_expand(*hargs)),
        plain_ms=median_ms(lambda: K.hop_expand_plain(*hargs)),
        library_ms=median_ms(lambda: lib_hop_expand(*hargs)),
        bound_ms=bound_ms(rows * (8 * k + 8 + 4 + 1)
                          + rows * n * (8 * k + 16 + 8 + 4 + 1)),
        bound_by="bytes", shape=f"{rows} x {k} int64, n={n}")}
    an = job.program.nodes[ai]
    d = kept[ai][0]
    keys = an.pack.pack([d.cols[i] for i in an.group_idx])
    s64 = torch.where(d.mask, d.sign, 0).to(torch.int64)
    bargs = (keys, d.cols[an.calls[0].arg], s64, d.mask)
    b = keys.shape[0]
    compare("ms_batch_reduce", "q5_main_path", K.ms_batch_reduce(*bargs),
            K.ms_batch_reduce_plain(*bargs))
    # the two-key sort it starts with, on the same masked pairs
    sk1 = torch.where(d.mask, keys, EMPTY_KEY)
    sk2 = torch.where(d.mask, bargs[1], EMPTY_KEY)
    out["ms_batch_reduce"] = dict(
        ms=median_ms(lambda: K.ms_batch_reduce(*bargs)),
        device_ms=graph_ms(lambda: K.ms_batch_reduce(*bargs)),
        plain_ms=median_ms(lambda: K.ms_batch_reduce_plain(*bargs)),
        library_ms=median_ms(lambda: lib_ms_batch_reduce(*bargs)),
        bound_ms=bound_ms(b * (8 + 8 + 8 + 1) + b * 3 * 8),
        bound_by="bytes", shape=f"B={b}", live=int(d.mask.sum()),
        sort_ms=median_ms(lambda: K.sort_cols([sk1, sk2], [])),
        sort_device_ms=graph_ms(lambda: K.sort_cols([sk1, sk2], [])))
    u = K.ms_batch_reduce(*bargs)
    ms = inner(job.states[ai]).minputs[0]
    c = ms.capacity
    margs = (ms,) + tuple(u)
    compare("ms_merge", "q5_main_path", K.ms_merge(*margs),
            K.ms_merge_plain(*margs))
    out["ms_merge"] = dict(
        ms=median_ms(lambda: K.ms_merge(*margs)),
        device_ms=graph_ms(lambda: K.ms_merge(*margs)),
        plain_ms=median_ms(lambda: K.ms_merge_plain(*margs)),
        library_ms=median_ms(lambda: lib_ms_merge(*margs)),
        bound_ms=bound_ms(24 * c + 24 * b + 24 * c + 8), bound_by="bytes",
        shape=f"C={c}, B={b}", live=int(ms.count))
    merged, _ = K.ms_merge(*margs)
    fargs = (merged, u[0], u[1])
    compare("ms_find", "q5_main_path", K.ms_find(*fargs),
            K.ms_find_plain(*fargs))
    lib = None
    if _packable(merged.k1, merged.k2) and _packable(u[0], u[1]):
        compare("ms_find", "library", lib_ms_find(*fargs),
                K.ms_find_plain(*fargs))
        lib = median_ms(lambda: lib_ms_find(*fargs))
    out["ms_find"] = dict(
        ms=median_ms(lambda: K.ms_find(*fargs)),
        device_ms=graph_ms(lambda: K.ms_find(*fargs)),
        plain_ms=median_ms(lambda: K.ms_find_plain(*fargs)),
        library_ms=lib,
        bound_ms=bound_ms(24 * c + 16 * b + 9 * b), bound_by="bytes",
        # one 32-byte sector per binary-search step of each query
        search_bound_ms=bound_ms(32 * b * max(1, math.ceil(math.log2(c)))),
        shape=f"C={c}, Q={b}",
        library_note=None if lib is not None else
        "no one-call library form: the pairs do not pack into one int64")
    return out


def batch_reduce_few_keys(node, d) -> dict:
    """batch_reduce as `node` (a PrecombineNode, or an AggNode on raw
    rows) calls it on its epoch input `d`: with few distinct keys (a
    window per key) each segment is long, the worst case of the kernel's
    one-thread-per-segment walk."""
    keys = node.pack.pack([d.cols[i] for i in node.group_idx])
    deltas = _row_deltas(node.spec, d.sign, d.mask,
                         F._agg_inputs(node.calls, d.cols, keys))
    if isinstance(node, F.PrecombineNode):
        mask = d.mask & (d.sign != 0)
        vals = [torch.where(mask, 1, 0).to(torch.int64)] + deltas
        kinds = [S] + list(node.spec.kinds)
    else:
        mask, vals, kinds = d.mask, deltas, list(node.spec.kinds)
    args = (keys, mask, vals, kinds)
    scale = max([float(v.abs().nansum()) for v in vals
                 if v.dtype.is_floating_point] or [0.0])
    compare("batch_reduce", "few_keys", K.batch_reduce(*args),
            K.batch_reduce_plain(*args), float_atol=1e-12 * scale)
    b = keys.shape[0]
    width = sum(v.element_size() for v in vals)
    lib = None
    if all(k in (S, MN, MX) for k in kinds):
        lib = median_ms(lambda: lib_batch_reduce(*args))
    return dict(ms=median_ms(lambda: K.batch_reduce(*args)),
                device_ms=graph_ms(lambda: K.batch_reduce(*args)),
                plain_ms=median_ms(lambda: K.batch_reduce_plain(*args)),
                library_ms=lib,
                # keys and mask read, columns read, ukeys and columns written
                bound_ms=bound_ms(9 * b + width * b + 8 * b + width * b + 4),
                bound_by="bytes", shape=f"B={b} x {len(vals)}",
                live=int(mask.sum()),
                distinct_keys=int(torch.unique(keys[mask]).numel()))


def lib_touch_stamp(keys, old, old_touch, tkeys, tick, ttl):
    """PyTorch library composition: two searchsorted, gathers, where,
    two sums."""
    oi = torch.clamp(torch.searchsorted(old, keys), max=old.shape[0] - 1)
    ti = torch.clamp(torch.searchsorted(tkeys, keys), max=tkeys.shape[0] - 1)
    live = keys != EMPTY_KEY
    st = torch.where(live, torch.where(
        tkeys[ti] == keys, tick, torch.where(old[oi] == keys,
                                             old_touch[oi], 0)), 0)
    return st, live.sum(), (live & (tick - st >= ttl)).sum()


def lib_tier_partition(keys, cols, fills, dkeys):
    """PyTorch library composition: isin, then two nonzero compactions."""
    hit = torch.isin(keys, dkeys) & (keys != EMPTY_KEY)
    kept = (keys != EMPTY_KEY) & ~hit
    n = keys.shape[0]
    return lib_compact(kept, cols, n, fills), lib_compact(hit, cols, n, fills)


def tier_timings(dev, qjob, tjob) -> dict:
    """The two tiering kernels at the main paths' shapes: touch_stamp over
    the device q3a job's final bid side (its epoch stamp: the side
    against itself, the touched keys the sort of the next epoch's bid and
    auction join keys, 2 x 2^20); tier_partition over the tiered q3a
    job's final bid side (11 columns with the touch) and a demotion
    batch of its oldest-touched join keys."""
    js = qjob.states[2]
    a, ta, tick = js.inner[0], js.touch[0], js.tick
    jn = qjob.program.nodes[2]
    n = EPOCH_EVENTS
    gencfg = GenCfg.from_config(NexmarkConfig())
    ids = torch.arange(Q3_EVENTS, Q3_EVENTS + n, dtype=torch.int64,
                       device=dev)
    jk = torch.cat([torch.where(table_mask("bid", ids), jn.pack.pack(
        [gen_table(gencfg, "bid", ids)["auction"]]), EMPTY_KEY),
        torch.where(table_mask("auction", ids), jn.pack.pack(
            [gen_table(gencfg, "auction", ids)["id"]]), EMPTY_KEY)])
    (tk,), _ = K.sort_cols([jk], [])
    args = (a.jk, a.jk, ta, tk, None, tick, TIER_TTL)
    compare("touch_stamp", "q3a_main_path", K.touch_stamp(*args),
            K.touch_stamp_plain(*args, EMPTY_KEY))
    c, t = a.jk.shape[0], tk.shape[0]
    out = {"touch_stamp": dict(
        ms=median_ms(lambda: K.touch_stamp(*args)),
        device_ms=graph_ms(lambda: K.touch_stamp(*args)),
        plain_ms=median_ms(lambda: K.touch_stamp_plain(*args, EMPTY_KEY)),
        library_ms=median_ms(lambda: lib_touch_stamp(a.jk, a.jk, ta, tk,
                                                     tick, TIER_TTL)),
        bound_ms=bound_ms(8 * c + 16 * c + 8 * t + 8 * c + 16),
        bound_by="bytes",
        # one 32-byte sector per binary-search step of each row, into the
        # old keys and into the touched keys
        search_bound_ms=bound_ms(32 * c * (math.ceil(math.log2(c))
                                           + math.ceil(math.log2(t)))),
        shape=f"C={c}, T={t}", live=int(a.count),
        touched_live=int((tk != EMPTY_KEY).sum()))}
    ts = tjob.states[2]
    b, tb = ts.inner[0], ts.touch[0]
    cols = [b.jk, b.pk] + list(b.vals) + [tb]
    fills = [EMPTY_KEY, EMPTY_KEY] + [0] * len(b.vals) + [0]
    live = int(b.count)
    order = torch.argsort(tb[:live], stable=True)
    dk = torch.unique(b.jk[:live][order[:live * 3 // 10]])
    dpad = torch.full((max(64, 1 << int(dk.shape[0] - 1).bit_length()),),
                      EMPTY_KEY, dtype=torch.int64, device=dev)
    dpad[:dk.shape[0]] = dk
    pargs = (b.jk, cols, fills, dpad, True)
    got = K.tier_partition(*pargs)
    compare("tier_partition", "q3a_tiered_main_path", list(got),
            list(K.tier_partition_plain(*pargs, EMPTY_KEY)))
    m, row = b.jk.shape[0], 8 * len(cols)
    out["tier_partition"] = dict(
        ms=median_ms(lambda: K.tier_partition(*pargs)),
        device_ms=graph_ms(lambda: K.tier_partition(*pargs)),
        plain_ms=median_ms(lambda: K.tier_partition_plain(*pargs,
                                                          EMPTY_KEY)),
        library_ms=median_ms(lambda: lib_tier_partition(b.jk, cols, fills,
                                                        dpad)),
        bound_ms=bound_ms(m * row + 8 * dpad.shape[0] + 2 * m * row + 8),
        bound_by="bytes",
        search_bound_ms=bound_ms(32 * m * 2 * math.ceil(
            math.log2(dpad.shape[0]))),
        shape=f"C={m} x {len(cols)} int64, L={dpad.shape[0]}",
        live=live, demoted_rows=int(got[2][1]), demoted_keys=int(dk.shape[0]))
    return out


def tier_cost(job, rounds: int = 9, at=None) -> dict:
    """Per tier-armed node: the median of `rounds` node times of one epoch
    (`node_times`' `at`) with its touch arm on and off (in turns: off
    runs the node on its state without the TieredState wrapper), and
    their difference."""
    prog = job.program
    keyed = [i for i, n in enumerate(prog.nodes) if n.tier]
    states, *rest = at or (job.states, 0)
    bare_states = tuple(inner(s) for s in states)
    armed = {i: [] for i in keyed}
    bare = {i: [] for i in keyed}
    for _ in range(rounds):
        for on, st, acc in ((True, states, armed), (False, bare_states,
                                                    bare)):
            for i in keyed:
                prog.nodes[i].tier = on
            ms, _ = node_times(job, at=(st, *rest))
            for i in keyed:
                acc[i].append(ms[i][1])
    for i in keyed:
        prog.nodes[i].tier = True
    out = {}
    for i in keyed:
        a, b = float(np.median(armed[i])), float(np.median(bare[i]))
        out[f"{i}:{type(prog.nodes[i]).__name__}"] = dict(
            armed_ms=a, bare_ms=b, touch_ms=a - b)
    return out


def path_phase(name, job, events, kernels_needed, check, smi, last=None):
    """Drive one main path, check its rows, and report it (`last`: see
    `drive`)."""
    rows, drive_s, pull_s, launches, epochs = drive(job, last)
    t = time.perf_counter()
    check(rows)
    rep = {"events": events, "drive_s": drive_s, "pull_s": pull_s,
           "events_per_s": events / drive_s,
           "growth_replays": job.growth_replays, "rows": len(rows),
           "capacities": {f"{i}:{type(n).__name__}": n.cap_current()
                          for i, n in enumerate(job.program.nodes)
                          if n.cap_current()},
           "launches": launches, "epochs_dispatched": epochs,
           "oracle_check_s": time.perf_counter() - t, "card": smi}
    log(f"[main] {name} {json.dumps(rep)}")
    if job.growth_replays < 1:
        raise AssertionError(f"{name} main path made no growth replay")
    missing = [k for k in kernels_needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name} path never launched {missing}")
    return rep


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
    if sys.argv[1:] == ["--merge-side-memory"]:
        print(smi)
        print(json.dumps({"merge_side_memory": merge_side_memory(dev)}))
        return 0

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
    q4["node_ms"], _ = node_times(job)
    log(f"[main] q4 one steady epoch by node (ms): {q4['node_ms']}")
    q4["tres_check"] = check_tres("q4", job)
    q4["telemetry_cost"] = telemetry_cost(job)
    q4["tier_cost"] = tier_cost(job)
    q4["drive_cost"] = drive_cost(lambda on: q4_job(dev, telemetry=on))
    q4["tier_drive_cost"] = drive_cost(lambda on: q4_job(dev, tier=on), 2)
    tele = [telemetry_line("q4", job), telemetry_line("q4_raw_agg", raw_job)]
    tm = timings(dev, job.program.nodes[2].capacity)
    del job, rows, oracle, raw_job, raw_rows

    # ---- q3a: the join path ------------------------------------------
    qjob = q3a_job(dev)
    qrows, qdrive_s, qpull_s, qlaunches, qepochs = drive(qjob)
    t = time.perf_counter()
    q3_oracle = q3a_oracle(dev)
    check_q3a_rows(qrows, q3_oracle)
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
    q3a["node_ms"], _ = node_times(qjob)
    log(f"[main] q3a one steady epoch by node (ms): {q3a['node_ms']}")
    q3a["tres_check"] = check_tres("q3a", qjob)
    q3a["telemetry_cost"] = telemetry_cost(qjob)
    q3a["tier_cost"] = tier_cost(qjob)
    q3a["drive_cost"] = drive_cost(lambda on: q3a_job(dev, telemetry=on))
    q3a["tier_drive_cost"] = drive_cost(lambda on: q3a_job(dev, tier=on), 2)
    tele.append(telemetry_line("q3a", qjob))
    jt = join_timings(dev, qjob)
    tm["sort_cols"]["q3a_jk_pk"] = jt.pop("sort_cols")
    tm.update(jt)

    # ---- q5: hop windows, retractable max, non-equi join ---------------
    job = q5_job(dev)
    q5 = path_phase("q5", job, Q5_EVENTS, Q5_KERNELS,
                    lambda rows: check_q5_rows(rows, q5_oracle(dev)), smi)
    hi = [i for i, n in enumerate(job.program.nodes)
          if isinstance(n, F.HopNode)][0]
    ai = [i for i, n in enumerate(job.program.nodes)
          if isinstance(n, F.AggNode) and n.spec.minputs][0]
    q5["node_ms"], kept = node_times(job, keep=(hi, ai))
    log(f"[main] q5 one steady epoch by node (ms): {q5['node_ms']}")
    q5["tres_check"] = check_tres("q5", job)
    q5["telemetry_cost"] = telemetry_cost(job)
    q5["tier_cost"] = tier_cost(job)
    q5["drive_cost"] = drive_cost(lambda on: q5_job(dev, telemetry=on))
    q5["tier_drive_cost"] = drive_cost(lambda on: q5_job(dev, tier=on), 2)
    tele.append(telemetry_line("q5", job))
    tm.update(window_multiset_timings(job, kept, hi, ai))
    tm["batch_reduce"]["q5_max_agg"] = batch_reduce_few_keys(
        job.program.nodes[ai], kept[ai][0])
    # the raw max agg's epoch_topk: its change stream, masked, sorted
    an, d = job.program.nodes[ai], kept[ai][0]
    mk = torch.where(d.mask & (d.sign != 0),
                     an.pack.pack([d.cols[i] for i in an.group_idx]),
                     EMPTY_KEY)
    (sk,), _ = K.sort_cols([mk], [])
    q5_topk = topk_entry(sk, shape=f"runs B={sk.shape[0]}",
                         live_rows=int((mk != EMPTY_KEY).sum()),
                         sort_ms=median_ms(lambda: K.sort_cols([mk], [])))
    del job, kept, mk, sk

    # ---- q7: tumble window, max, join back, timestamp filter -----------
    job = q7_job(dev)
    q7 = path_phase("q7", job, Q7_EVENTS, Q7_KERNELS,
                    lambda rows: check_q7_rows(rows, q7_oracle(dev)), smi)
    pi = [i for i, n in enumerate(job.program.nodes)
          if isinstance(n, F.PrecombineNode)][0]
    q7["node_ms"], kept = node_times(job, keep=(pi,))
    log(f"[main] q7 one steady epoch by node (ms): {q7['node_ms']}")
    q7["tres_check"] = check_tres("q7", job)
    q7["telemetry_cost"] = telemetry_cost(job)
    q7["tier_cost"] = tier_cost(job)
    q7["drive_cost"] = drive_cost(lambda on: q7_job(dev, telemetry=on))
    q7["tier_drive_cost"] = drive_cost(lambda on: q7_job(dev, tier=on), 2)
    tele.append(telemetry_line("q7", job))
    tm["batch_reduce"]["q7_precombine"] = batch_reduce_few_keys(
        job.program.nodes[pi], kept[pi][0])
    del job, kept

    # ---- q8: two tumble distincts joined, under the default telemetry --
    job = q8_job(dev)
    streams = q8_streams(dev)
    oracle = numpy_q8(*streams[0], *streams[1])
    pool = job.pull.decoders[1][1]
    last = {}
    q8 = path_phase("q8", job, Q8_EVENTS, Q8_KERNELS,
                    lambda rows: check_q8_rows(rows, oracle, pool), smi,
                    last)
    q8["telemetry_check"] = check_q8_telemetry(job, streams)
    log(f"[main] q8 telemetry equals its live groups and routed rows: "
        f"{q8['telemetry_check']}")
    ai, ji = [[i for i, n in enumerate(job.program.nodes)
               if isinstance(n, cls)][0] for cls in (F.AggNode, F.JoinNode)]
    # the last epoch again, from the states before it: the distincts see
    # new groups (an epoch over the final state would change nothing)
    at = last.pop("at")
    q8["node_ms"], kept = node_times(job, keep=(ai, ji), at=at)
    log(f"[main] q8 last epoch by node (ms): {q8['node_ms']}")
    q8["tres_check"] = check_tres("q8", job)
    q8["telemetry_cost"] = telemetry_cost(job, at=at)
    q8["tier_cost"] = tier_cost(job, at=at)
    q8["drive_cost"] = drive_cost(lambda on: q8_job(dev, telemetry=on))
    q8["tier_drive_cost"] = drive_cost(lambda on: q8_job(dev, tier=on), 2)
    tele.append(telemetry_line("q8", job))
    tm.update(skew_timings(job, kept, ai, ji))
    tm["topk_packed"]["q5_max_agg"] = q5_topk
    del job, kept, streams, oracle, at

    # ---- the host-fed tiered paths -------------------------------------
    tjob = q3a_job(dev, epoch_events=TIER_EPOCH_EVENTS, host_fed=True,
                   presize=Q3T_PRESIZE)
    tjob.hbm_budget_mb = clamp_budget_mb(tjob, "2:JoinNode.a", Q3T_CLAMP)

    def check_q3t(rows):
        check_q3a_rows(rows, q3_oracle)
        if rows != qrows:
            raise AssertionError("q3a_tiered rows differ from the device "
                                 "q3a path's")
    q3t = tiered_phase("q3a_tiered", tjob, Q3_EVENTS, Q3T_KERNELS,
                       check_q3t, smi)
    del qrows, q3_oracle
    tm.update(tier_timings(dev, qjob, tjob))
    del qjob, tjob
    ajob = qa_job(dev, epoch_events=TIER_EPOCH_EVENTS, capacity=QA_CLAMP)
    ajob.hbm_budget_mb = clamp_budget_mb(ajob, "2:AggNode.main", QA_CLAMP)
    qa_or = qa_oracle()
    qat = tiered_phase("qa_tiered", ajob, QA_EVENTS, QA_KERNELS,
                       lambda rows: check_qa_rows(rows, qa_or), smi)
    if ajob.tiering.counters["promotions"] <= 0:
        raise AssertionError("qa_tiered: no promotion")
    # the heavy hitters of the agg's telemetry sit in no cold store
    hot = set(hot_key_set(ajob.program.node_stats(
        2, np.maximum(ajob._stat_totals, ajob._last_stats))))
    cold = {int(k) & SK_KEY_MASK for st in ajob.tiering.stores.values()
            for d in st.rows for k in d}
    if not hot or hot & cold:
        raise AssertionError(f"qa_tiered: heavy hitters {sorted(hot)} vs "
                             f"{len(hot & cold)} demoted")
    qat["hot_keys"] = sorted(hot)
    tele.append(telemetry_line("qa_tiered", ajob))
    del ajob, qa_or

    # ---- the device generator under zipf:1.5 (_zipf_ordinal on CUDA) ---
    # its rows against the host generator's group-by, as qa_tiered's
    zjob = qa_job(dev, QZ_EVENTS, capacity=QZ_CAPACITY, host_fed=False)
    qz_or = qa_oracle(QZ_EVENTS)
    qaz = path_phase("qa_zipf_device", zjob, QZ_EVENTS, QZ_KERNELS,
                     lambda rows: check_qa_rows(rows, qz_or), smi)
    del zjob, qz_or

    paths = {"q4": (launches, epochs), "q3a": (qlaunches, qepochs),
             "q5": (q5["launches"], q5["epochs_dispatched"]),
             "q7": (q7["launches"], q7["epochs_dispatched"]),
             "q8": (q8["launches"], q8["epochs_dispatched"]),
             "q3a_tiered": (q3t["launches"], q3t["epochs_dispatched"]),
             "qa_tiered": (qat["launches"], qat["epochs_dispatched"]),
             "qa_zipf_device": (qaz["launches"], qaz["epochs_dispatched"])}
    kernels = []
    for name in REPLACES:
        row = {"name": name, "route": "cuda", "source": SOURCE[name],
               "replaces": REPLACES[name],
               "launches": sum(lc[name] for lc, _ in paths.values()),
               "launches_per_epoch": {p: lc[name] / ep
                                      for p, (lc, ep) in paths.items()},
               "max_abs_err": err[name], "max_abs_diff": err[name]}
        row.update(tm[name])
        kernels.append(row)
        log(f"[timing] {name}: {tm[name]}")
    for line in tele:
        log(f"[telemetry] {json.dumps(line)}")
        print(json.dumps(line))
    print(smi)
    print(json.dumps({"main": {"q4": q4, "q3a": q3a, "q5": q5, "q7": q7,
                               "q8": q8, "q3a_tiered": q3t,
                               "qa_tiered": qat, "qa_zipf_device": qaz}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
