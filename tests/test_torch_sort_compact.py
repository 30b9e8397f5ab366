"""The port's sort_cols and compact_rows (plain PyTorch versions, on the
CPU) against the JAX package's, leaf by leaf and dtype by dtype."""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import risingwave_tpu.device.sorted_state as J
import risingwave_tpu_torch.device.sorted_state as P
from torch_parity import EMPTY, assert_same, payload

# the reference cores jitted whole; static arguments as hashable tuples
_J_SORT = jax.jit(J.sort_cols)
_J_COMPACT = jax.jit(lambda a, k, c, n, f: J.compact_rows(a, k, c, n, f),
                     static_argnums=(3, 4))


@pytest.mark.parametrize("case", ["one_key", "two_keys", "n1", "all_equal",
                                  "empty_and_negative", "three_payloads"])
def test_sort_cols(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    n = 600
    if case == "one_key":
        keys = [rng.integers(-1000, 1000, n)]
    elif case == "two_keys":
        keys = [rng.integers(0, 7, n), rng.integers(-(1 << 62), 1 << 62, n)]
    elif case == "n1":
        n = 1
        keys = [np.array([3])]
    elif case == "all_equal":
        keys = [np.full(n, -5)]
    elif case == "empty_and_negative":
        k = rng.integers(np.iinfo(np.int64).min, 0, n)
        k[rng.random(n) < 0.2] = EMPTY
        keys = [k]
    else:
        keys = [rng.integers(0, 30, n)]
    keys = [k.astype(np.int64) for k in keys]
    cols = [np.arange(n, dtype=np.int32)]
    if case == "three_payloads":
        cols += [payload(rng, n, np.float64), payload(rng, n, np.bool_)]
    ref = _J_SORT([jnp.asarray(k) for k in keys],
                  [jnp.asarray(c) for c in cols])
    got = P.sort_cols([torch.from_numpy(k) for k in keys],
                      [torch.from_numpy(c) for c in cols])
    assert_same(got, ref)


@pytest.mark.parametrize("case,n,frac,out_len", [
    ("random", 500, 0.4, 300), ("truncated", 500, 0.9, 100),
    ("all_alive", 256, 1.0, 256), ("none_alive", 256, 0.0, 256),
    ("n1", 1, 1.0, 1), ("out_len_past_n", 100, 0.5, 140),
    # two 2048-row tiles of the kernel and one row either side, each
    # truncated below its alive count
    ("tile_edge_m1", 4095, 0.7, 2500), ("tile_edge", 4096, 0.7, 2500),
    ("tile_edge_p1", 4097, 0.7, 2500)])
def test_compact_rows(case, n, frac, out_len):
    rng = np.random.default_rng(n + out_len)
    alive = rng.random(n) < frac
    keys = [rng.integers(0, 1 << 40, n)]
    cols = [payload(rng, n, dt) for dt in (np.int64, np.int32, np.float64,
                                           np.bool_)]
    fills = [EMPTY, 0, -1, 0.5, False]
    if case.startswith("tile_edge"):
        assert out_len < alive.sum()
    ref = _J_COMPACT(jnp.asarray(alive), [jnp.asarray(k) for k in keys],
                     [jnp.asarray(c) for c in cols], out_len, tuple(fills))
    got = P.compact_rows(torch.from_numpy(alive),
                         [torch.from_numpy(k) for k in keys],
                         [torch.from_numpy(c) for c in cols], out_len, fills)
    assert_same(got, ref)
