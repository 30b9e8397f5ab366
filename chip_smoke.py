#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py          # from the repository root

Phases (any failure exits non-zero; nothing is caught):
  1. card     — name, power limit, torch and CUDA versions
  2. build    — compile the sorted-run kernels from the sources in
                 risingwave_tpu_torch/kernels/csrc (into build/torch_kernels)
  3. kernels  — each kernel against its plain PyTorch version on the card,
                 at 2^20 rows and on edge cases: exact for integer and bool
                 leaves; a float SUM within 1e-12 of the summed magnitudes
                 (the plain version adds with atomics, in no fixed order)
  4. main     — Nexmark q4 (`SELECT auction, count(*), sum(price),
                 max(price) FROM bid GROUP BY auction`, pre-combine on) over
                 2^24 events in epochs of 2^20 from a 2^16 capacity, with a
                 checkpoint every 4 epochs; rows checked in key order against
                 a numpy group-by of the port generator's bid stream
  5. timings  — each kernel at its main-path shape: median of CUDA-event
                 times over 25 runs, beside its plain version, a PyTorch
                 library composition of the same function, and its
                 device-memory bound at 3.35 TB/s (H100 SXM)
The last two lines are the {"kernels": [...]} line and the {"ok": ...} line.
"""
from __future__ import annotations

import json
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
from risingwave_tpu_torch.device.nexmark_gen import (GenCfg, gen_table,
                                                     table_mask)
from risingwave_tpu_torch.device.sorted_state import (EMPTY_KEY, ReduceKind,
                                                      SortedState, _neutral)
from risingwave_tpu_torch.expr.expression import InputRef

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
SRC = "risingwave_tpu_torch/kernels/csrc/sorted_runs.cu"
REPLACES = {"sort_cols": "risingwave_tpu/device/sorted_state.py:189",
            "batch_reduce": "risingwave_tpu/device/sorted_state.py:108",
            "merge": "risingwave_tpu/device/sorted_state.py:227",
            "compact_rows": "risingwave_tpu/device/sorted_state.py:206"}
MAX_EVENTS = 1 << 24
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


def run_main(dev, max_events=MAX_EVENTS, precombine=True):
    """Drive q4 to the end of its stream, then pull the MV. Returns the
    job, the rows, the drive seconds (dispatch, checkpoint syncs, growth
    replays; ends synced), the pull seconds, the kernel launches and the
    epochs dispatched (replays included)."""
    job = q4_job(dev, max_events, precombine)
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
    return job, rows, t1 - t0, t2 - t1, launches, steps[0]


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
    log(f"[build] sorted-run kernels built in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    err = check_kernels(dev)
    log(f"[kernels] all four kernels equal their plain versions "
        f"({time.perf_counter() - t:.1f} s); max abs err {err}")

    job, rows, drive_s, pull_s, launches, epochs = run_main(dev)
    per_epoch = {k: v / epochs for k, v in launches.items()}
    oracle = q4_oracle(dev)
    check_rows(rows, oracle)
    main = {"events": MAX_EVENTS, "drive_s": drive_s, "pull_s": pull_s,
            "events_per_s": MAX_EVENTS / drive_s,
            "growth_replays": job.growth_replays, "groups": len(rows),
            "agg_capacity": job.program.nodes[2].capacity,
            "mv_capacity": job.program.nodes[3].capacity,
            "launches": launches, "epochs_dispatched": epochs,
            "launches_per_epoch": per_epoch, "card": smi}
    log(f"[main] q4 {json.dumps(main)}")
    if job.growth_replays < 1:
        raise AssertionError("q4 main path made no growth replay")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    # the raw (not pre-combined) agg arm, smaller, outside the counted run
    raw_job, raw_rows, *_ = run_main(dev, 1 << 22, precombine=False)
    check_rows(raw_rows, q4_oracle(dev, 1 << 22))
    log(f"[main] raw agg arm: 2^22 events, {len(raw_rows)} groups, "
        f"{raw_job.growth_replays} growth replays, oracle equal")
    per_node = node_times(job)
    main["node_ms"] = per_node
    log(f"[main] one steady epoch by node (ms): {per_node}")

    tm = timings(dev, job.program.nodes[2].capacity)
    kernels = []
    for name in REPLACES:
        row = {"name": name, "route": "cuda", "source": SRC,
               "replaces": REPLACES[name], "launches": launches[name],
               "launches_per_epoch": per_epoch[name],
               "max_abs_err": err[name], "max_abs_diff": err[name]}
        row.update(tm[name])
        kernels.append(row)
        log(f"[timing] {name}: {tm[name]}")
    print(smi)
    print(json.dumps({"main": main}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
