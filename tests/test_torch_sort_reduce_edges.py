"""Edge shapes of the port's sort_cols and batch_reduce (plain PyTorch
versions, on the CPU) against the JAX package's, leaf by leaf and dtype by
dtype: keys whose live values differ in one byte or not at all, EMPTY_KEY
rows beside negative keys, row counts at a sort tile (4096 rows) and one
row either side, two keys with one constant, and segments that end at a
reduce tile's edge (2048 rows), cross several tiles or cover every row,
with REPLACE, float SUM and NaN MIN / MAX, and bool MIN / MAX (AND / OR).
The same shapes run against the hand kernels on the card in
chip_smoke.py. Inputs from numpy seeds; every
batch has more than 3 x 2048 rows, so segments cross tiles."""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import risingwave_tpu.device.sorted_state as J
import risingwave_tpu_torch.device.sorted_state as P
from torch_parity import (ALL_KINDS, EMPTY, MN, MX, R, S, assert_same,
                          payload)

# the reference cores jitted whole; static kinds as a hashable tuple
_J_SORT = jax.jit(J.sort_cols)
_J_BR = jax.jit(lambda k, m, v, kinds: J.batch_reduce(k, m, v, kinds),
                static_argnums=3)

SORT_TILE = 4096                 # rows per tile of the sort kernel's passes
RED_TILE = 2048                  # rows per tile of the batch_reduce kernel
N = 3 * RED_TILE + 1


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def with_empty(rng, k, p=0.08):
    k = k.copy()
    k[rng.random(len(k)) < p] = EMPTY
    return k


def sort_keys(case):
    rng = _rng(case)
    n = N
    if case.startswith("top_byte_only"):
        k = rng.integers(-128, 128, n) << 56
    elif case.startswith("middle_byte_only"):
        k = (rng.integers(0, 256, n) << 24) + 12345
    elif case.startswith("constant"):
        k = np.full(n, 42)
    elif case == "all_empty":
        k = np.full(n, EMPTY)
    elif case == "negative_next_to_empty":
        k = rng.integers(-5000, 0, n)
        k[:3] = [np.iinfo(np.int64).min, EMPTY - 1, -1]
        k = with_empty(rng, k, 0.3)
    else:                         # "n=<rows>"
        n = int(case[2:])
        k = with_empty(rng, rng.integers(-(1 << 40), 1 << 40, n))
    k = k.astype(np.int64)
    if case.endswith("_with_empty"):
        k = with_empty(rng, k)
    return rng, [k]


def run_sort(rng, keys):
    n = len(keys[0])
    cols = [np.arange(n, dtype=np.int64), payload(rng, n, np.float64)]
    ref = _J_SORT([jnp.asarray(k) for k in keys],
                  [jnp.asarray(c) for c in cols])
    got = P.sort_cols([torch.from_numpy(k) for k in keys],
                      [torch.from_numpy(c) for c in cols])
    assert_same(got, ref)


@pytest.mark.parametrize("case", [
    "top_byte_only", "top_byte_only_with_empty", "middle_byte_only",
    "middle_byte_only_with_empty", "constant", "constant_with_empty",
    "all_empty", "negative_next_to_empty",
    f"n={3 * SORT_TILE - 1}", f"n={3 * SORT_TILE}", f"n={3 * SORT_TILE + 1}",
    "n=10007"])
def test_sort_one_key_edges(case):
    run_sort(*sort_keys(case))


@pytest.mark.parametrize("case", ["k1_constant", "k2_constant",
                                  "q5_pairs"])
def test_sort_two_key_edges(case):
    rng = _rng(case)
    n = 8192
    if case == "k1_constant":
        keys = [np.full(n, 5), with_empty(rng, rng.integers(-999, 999, n))]
    elif case == "k2_constant":
        keys = [with_empty(rng, rng.integers(0, 1000, n)), np.full(n, -9)]
    else:                         # q5's masked (window, count) pairs
        m = rng.random(n) < 0.6
        keys = [np.where(m, rng.integers(0, 424, n), EMPTY),
                np.where(m, rng.integers(1, 60, n), EMPTY)]
    run_sort(rng, [k.astype(np.int64) for k in keys])


def seg_keys(rng, bounds):
    """Shuffled keys whose sorted runs end at `bounds` (exclusive ends):
    run i holds key 7 i - 20."""
    lens = np.diff(np.concatenate([[0], bounds]))
    keys = np.repeat(np.arange(len(lens), dtype=np.int64) * 7 - 20, lens)
    return keys[rng.permutation(len(keys))]


def br_case(case):
    rng = _rng(case)
    t = RED_TILE
    nan_rows = None
    if case.startswith("tile_edges"):
        keys = seg_keys(rng, [t, 2 * t - 1, 2 * t + 1, 3 * t - 1, 3 * t,
                              3 * t + 1, 4 * t, 8 * t - 1, 8 * t + 1])
        mask = (rng.random(len(keys)) < 0.9 if case.endswith("masked")
                else np.ones(len(keys), bool))
    elif case == "one_segment":
        keys, mask = np.full(N, -4, np.int64), np.ones(N, bool)
    elif case == "few_long_segments_nan":
        keys = rng.integers(0, 5, 5 * t + 3).astype(np.int64)
        mask = rng.random(len(keys)) < 0.92
        nan_rows = np.isin(keys, [1, 3]) & (rng.random(len(keys)) < 0.002)
    else:                         # "crossing": one key over > 3 tiles
        keys = rng.integers(0, 300, N + 5 * t).astype(np.int64)
        keys[rng.random(len(keys)) < 0.6] = 77
        mask = rng.random(len(keys)) < 0.95
    n = len(keys)
    spec = ALL_KINDS + [(S, np.int64), (MX, np.float64)]
    vals = [payload(rng, n, dt) for _, dt in spec]
    if nan_rows is not None:
        for v in vals:
            if v.dtype == np.float64:
                v[nan_rows] = np.nan
    return keys, mask, vals, [k for k, _ in spec]


@pytest.mark.parametrize("case", ["tile_edges", "tile_edges_masked",
                                  "one_segment", "few_long_segments_nan",
                                  "crossing"])
def test_batch_reduce_edges(case):
    keys, mask, vals, kinds = br_case(case)
    ref = _J_BR(jnp.asarray(keys), jnp.asarray(mask),
                [jnp.asarray(v) for v in vals], tuple(kinds))
    got = P.batch_reduce(torch.from_numpy(keys), torch.from_numpy(mask),
                         [torch.from_numpy(v) for v in vals], kinds)
    # f64 SUM over non-integral values: summation order may differ; NaN
    # where the reference has NaN
    assert_same(got, ref, float_rtol=1e-12)


@pytest.mark.parametrize("case", ["six_rows", "tile_edges_masked"])
def test_batch_reduce_bool_minmax(case):
    """A bool column reduces as the reference's: MIN is AND, MAX is OR,
    and the padding and the EMPTY_KEY segment hold False."""
    rng = _rng("bool_" + case)
    if case == "six_rows":
        keys = np.array([3, 1, 3, 1, 2, 5], np.int64)
        mask = np.array([1, 1, 1, 1, 1, 0], bool)
    else:
        t = RED_TILE
        keys = seg_keys(rng, [t, 2 * t - 1, 2 * t + 1, 3 * t, 3 * t + 1,
                              4 * t])
        keys[rng.random(len(keys)) < 0.05] = EMPTY
        mask = rng.random(len(keys)) < 0.9
    spec = [(MN, np.bool_), (MX, np.bool_), (R, np.bool_), (MN, np.int64)]
    vals = [payload(rng, len(keys), dt) for _, dt in spec]
    kinds = [k for k, _ in spec]
    ref = _J_BR(jnp.asarray(keys), jnp.asarray(mask),
                [jnp.asarray(v) for v in vals], tuple(kinds))
    got = P.batch_reduce(torch.from_numpy(keys), torch.from_numpy(mask),
                         [torch.from_numpy(v) for v in vals], kinds)
    assert_same(got, ref)
    if case == "six_rows":
        # keys 1, 2, 3 from rows (1, 3), (4,), (0, 2)
        v, w = vals[0], vals[1]
        want_and = [v[1] & v[3], v[4], v[0] & v[2]]
        want_or = [w[1] | w[3], w[4], w[0] | w[2]]
        assert got[1][0][:3].tolist() == want_and
        assert got[1][1][:3].tolist() == want_or
        assert not bool(got[1][0][3:].any() or got[1][1][3:].any())
