"""The port's vnode hash (`risingwave_tpu_torch/core/vnode.py`) against the
JAX package's: the same seeded int64 keys — random, negative, 0,
EMPTY_KEY and INT64_MAX / INT64_MIN — through `crc32_u64` /
`compute_vnodes_dev` (torch, on the CPU) and `crc32_u64_jnp` /
`compute_vnodes_jnp`, and the port's host `vnodes_i64_plain` and
`compute_vnodes` against the reference's `compute_vnodes` (and zlib's
CRC32 of the 8 big-endian bytes). Exact.
"""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from risingwave_tpu.core import vnode as JV
from risingwave_tpu.core.chunk import Column
from risingwave_tpu.core.dtypes import INT64
from risingwave_tpu_torch.core import chunk as PC
from risingwave_tpu_torch.core import dtypes as PT
from risingwave_tpu_torch.core import vnode as PV

I64 = np.iinfo(np.int64)
EMPTY = int(I64.max)


def keys(seed, n=4096):
    rng = np.random.default_rng(seed)
    k = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    k[: n // 4] = rng.integers(-5000, 5000, n // 4)      # small, both signs
    k[:6] = [0, -1, 1, EMPTY, I64.min, (1 << 40) - 1]
    return k


def test_crc_table_equal():
    assert np.array_equal(PV.CRC32_TABLE, JV.CRC32_TABLE)
    assert PV.VNODE_COUNT == JV.VNODE_COUNT


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc32_u64_matches_reference(seed):
    k = keys(seed)
    got = PV.crc32_u64(torch.from_numpy(k)).numpy()
    want = np.asarray(JV.crc32_u64_jnp(jnp.asarray(k))).astype(np.int64)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    zl = [zlib.crc32(int(v).to_bytes(8, "big", signed=True)) for v in k[:64]]
    assert got[:64].tolist() == zl


@pytest.mark.parametrize("vnode_count", [256, 16, 1 << 15])
def test_compute_vnodes_dev_matches_reference(vnode_count):
    k = keys(7)
    got = PV.compute_vnodes_dev(torch.from_numpy(k), vnode_count)
    want = np.asarray(JV.compute_vnodes_jnp(jnp.asarray(k), vnode_count))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [3, 4])
def test_host_compute_vnodes_matches_reference(seed):
    k = keys(seed, 2048)
    got = PV.vnodes_i64_plain(k)
    want = JV.compute_vnodes([Column(INT64, k)])
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(PV.compute_vnodes([PC.Column(PT.INT64, k)]), want)
    assert np.array_equal(got, PV.compute_vnodes_dev(
        torch.from_numpy(k)).numpy())
