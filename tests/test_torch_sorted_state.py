"""The port's sorted-run state (plain PyTorch versions, on the CPU)
against the JAX package's, leaf by leaf and dtype by dtype: batch_reduce,
lookup, sanitize_keys. sort_cols and compact_rows are in
test_torch_sort_compact.py, merge and make/grow_state in
test_torch_merge.py (files of at most 12 tests, so the test workers'
file schedule ahead of them stays as it was)."""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import risingwave_tpu.device.sorted_state as J
import risingwave_tpu_torch.device.sorted_state as P
from torch_parity import (ALL_KINDS, EMPTY, Q4_KINDS, S, assert_same,
                          payload, state_pair)

# the reference core jitted whole (one XLA compile per shape instead of one
# per eager op); the static kinds ride as a hashable tuple
_J_BR = jax.jit(lambda k, m, v, kinds: J.batch_reduce(k, m, v, kinds),
                static_argnums=3)


def br_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n, spec = 700, ALL_KINDS
    mask = rng.random(n) < 0.85
    if name == "random":
        keys = rng.integers(-60, 60, n)
    elif name == "n1":
        n = 1
        keys, mask = np.array([4]), np.array([True])
    elif name == "all_equal":
        keys = np.full(n, 11)
    elif name == "all_masked":
        keys, mask = rng.integers(0, 9, n), np.zeros(n, bool)
    elif name == "empty_key_inside":
        keys = rng.integers(0, 40, n)
        keys[rng.random(n) < 0.15] = EMPTY
    elif name == "negative":
        keys = rng.integers(-(1 << 62), -(1 << 62) + 50, n)
    elif name == "q4_shape":
        keys, spec = rng.integers(0, 300, n), [(S, np.int64)] + Q4_KINDS
    else:
        raise KeyError(name)
    vals = [payload(rng, n, dt) for _, dt in spec]
    return keys.astype(np.int64), mask, vals, [k for k, _ in spec]


@pytest.mark.parametrize("case", ["random", "n1", "all_equal", "all_masked",
                                  "empty_key_inside", "negative",
                                  "q4_shape"])
def test_batch_reduce(case):
    keys, mask, vals, kinds = br_case(case)
    ref = _J_BR(jnp.asarray(keys), jnp.asarray(mask),
                [jnp.asarray(v) for v in vals], tuple(kinds))
    got = P.batch_reduce(torch.from_numpy(keys), torch.from_numpy(mask),
                         [torch.from_numpy(v) for v in vals], kinds)
    # f64 SUM over non-integral values: summation order may differ
    assert_same(got, ref, float_rtol=1e-12)


@pytest.mark.parametrize("case", ["hits_and_misses", "empty_query",
                                  "empty_state"])
def test_lookup(case):
    rng = np.random.default_rng(len(case))
    keys = np.zeros(0, np.int64) if case == "empty_state" \
        else np.unique(rng.integers(-500, 500, 300))
    js, ps = state_pair(rng, 512, keys, Q4_KINDS)
    q = rng.integers(-600, 600, 257).astype(np.int64)
    if case == "empty_query":
        q[::3] = EMPTY
    ref = J.lookup(js, jnp.asarray(q))
    got = P.lookup(ps, torch.from_numpy(q))
    assert_same(got, ref)


def test_sanitize_keys():
    k = np.array([EMPTY, 5, -3, EMPTY - 1], np.int64)
    assert np.array_equal(P.sanitize_keys(k), J.sanitize_keys(k))
