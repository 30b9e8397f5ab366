"""The port's on-device Nexmark generator (on the CPU) is bit-identical to
the JAX package's, including ids near 2^40 where the uint64 emulation
(logical shifts, unsigned remainders, 32x32 partial products) matters."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import risingwave_tpu.device.nexmark_gen as JG
import risingwave_tpu_torch.device.nexmark_gen as PG
from risingwave_tpu.connectors.nexmark import NexmarkConfig
from torch_parity import assert_same

RANGES = {"from_zero": (0, 3000), "near_2^40": ((1 << 40) - 1500, 3000),
          "past_2^40": ((1 << 40) + 12345, 2000)}
_J_GEN = jax.jit(JG.gen_table, static_argnums=(0, 1))


def gen_cfgs():
    base = NexmarkConfig()
    cfgs = {"default": JG.GenCfg.from_config(base)}
    cfgs["seed7_zipf"] = cfgs["default"]._replace(seed=7, key_dist="zipf:1.5")
    return cfgs


@pytest.mark.parametrize("rng_name", sorted(RANGES))
@pytest.mark.parametrize("table", ["person", "auction", "bid"])
def test_gen_table_bit_identical(table, rng_name):
    lo, n = RANGES[rng_name]
    ids = np.arange(lo, lo + n, dtype=np.int64)
    for name, jcfg in gen_cfgs().items():
        if jcfg.key_dist and table != "bid":
            continue
        ref = _J_GEN(jcfg, table, jnp.asarray(ids))
        got = PG.gen_table(PG.GenCfg(*jcfg), table, torch.from_numpy(ids))
        assert_same(got, ref)
        assert_same(PG.table_mask(table, torch.from_numpy(ids)),
                    JG.table_mask(table, jnp.asarray(ids)))


def test_uint64_helpers_match():
    rng = np.random.default_rng(3)
    r = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 4096,
                     dtype=np.int64)
    m = rng.integers(1, 1 << 40, 4096, dtype=np.int64)
    ru = jnp.asarray(r.view(np.uint64))
    assert np.array_equal(
        PG._mulhi_bound(torch.from_numpy(r), torch.from_numpy(m)).numpy(),
        np.asarray(JG._mulhi_bound(ru, jnp.asarray(m))))
    for k in (3, 10, 100, 10_000, 10**16):
        assert np.array_equal(PG._mod(torch.from_numpy(r), k).numpy(),
                              np.asarray(JG._mod(ru, k)))
    assert np.array_equal(
        PG.splitmix64(torch.from_numpy(r)).numpy().view(np.uint64),
        np.asarray(JG.splitmix64(ru)))


def test_column_bounds_and_surrogates_match():
    cfg = JG.GenCfg.from_config(NexmarkConfig())
    for table, cols in JG.SURROGATE.items():
        assert list(PG.SURROGATE[table]) == list(cols)
        for col, spec in cols.items():
            for horizon in (None, 1 << 24):
                assert PG.column_bounds(PG.GenCfg(*cfg), table, col,
                                        horizon) == \
                    JG.column_bounds(cfg, table, col, horizon)
            vals = np.arange(4, dtype=np.int64)
            assert list(PG.decode_column(PG.SURROGATE[table][col], vals)) \
                == list(JG.decode_column(spec, vals))
