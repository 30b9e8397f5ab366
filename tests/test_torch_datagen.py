"""The port's threefry2x32 and bid generator (on the CPU) against
`jax.random` and the JAX package's jitted `gen_bids`, to the bit: the
same seeds go to both, every output word must be equal."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.extend.random import threefry2x32_p

# importing the package turns x64 on, as it runs
from risingwave_tpu.device.datagen import gen_bids as ref_gen_bids
from risingwave_tpu_torch.device.datagen import gen_bids, prng_key
from risingwave_tpu_torch.kernels import datagen as D

SEEDS = (0, 3, 42, (1 << 33) + 7)


def jkey(seed):
    return jax.random.PRNGKey(seed)


def words(a):
    """A uint32 array from JAX as the port's int64 words."""
    return np.asarray(a).astype(np.int64)


def test_threefry_config_is_what_the_port_assumes():
    """The port copies the partitionable threefry (split and bits as fold
    and counter hashes). A JAX that changed either default would change
    the reference's streams: fail here, loudly."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_enable_x64 is True


_J_THREEFRY = jax.jit(lambda k1, k2, x1, x2: threefry2x32_p.bind(
    k1, k2, x1, x2))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry2x32(seed):
    rng = np.random.default_rng(seed % (1 << 32))
    k = rng.integers(0, 1 << 32, 2, dtype=np.uint64).astype(np.uint32)
    x1 = rng.integers(0, 1 << 32, 4099, dtype=np.uint64).astype(np.uint32)
    x2 = rng.integers(0, 1 << 32, 4099, dtype=np.uint64).astype(np.uint32)
    x1[:3] = (0, 0xFFFFFFFF, 1)
    x2[:3] = (0, 0xFFFFFFFF, 0xFFFFFFFF)
    want = _J_THREEFRY(jnp.uint32(k[0]), jnp.uint32(k[1]), x1, x2)
    got = D.threefry2x32(torch.tensor(int(k[0])), torch.tensor(int(k[1])),
                         torch.from_numpy(x1.astype(np.int64)),
                         torch.from_numpy(x2.astype(np.int64)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), words(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert np.array_equal(prng_key(seed, "cpu").numpy(), words(jkey(seed)))


def test_prng_key_without_gpu_raises(monkeypatch):
    """No device given and no GPU: an error, never a key on the CPU (a
    CPU key would send `gen_bids` to its plain version)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prng_key(1)


@pytest.mark.parametrize("num", (2, 3, 7))
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, num):
    got = D.split(prng_key(seed, "cpu"), num)
    assert got.shape == (num, 2)
    assert np.array_equal(got.numpy(), words(jax.random.split(jkey(seed),
                                                              num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits32(seed):
    want = jax.random.bits(jkey(seed), (5003,), jnp.uint32)
    got = D.random_bits32(prng_key(seed, "cpu"), 5003)
    assert np.array_equal(got.numpy(), words(want))


@pytest.mark.parametrize("bounds", ((0.0, 1.0), (-2.0, 3.5)))
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_f32(seed, bounds):
    want = np.asarray(jax.random.uniform(jkey(seed), (5003,), jnp.float32,
                                         *bounds))
    got = D.uniform_f32(prng_key(seed, "cpu"), 5003, *bounds).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# the price bounds, a small span, spans past 2^16 (their multiplier's
# square wraps at 2^32) and the widest int32 span
RANDINT_BOUNDS = ((1, 10_000), (-5, 7), (0, 1 << 20), (0, (1 << 24) + 3),
                  (0, (1 << 31) - 1), (-(1 << 31), (1 << 31) - 1), (9, 3))


@pytest.mark.parametrize("bounds", RANDINT_BOUNDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_i32(seed, bounds):
    want = np.asarray(jax.random.randint(jkey(seed), (5003,), *bounds,
                                         jnp.int32))
    got = D.randint_i32(prng_key(seed, "cpu"), 5003, *bounds).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_auctions", (300, 10_000))
@pytest.mark.parametrize("n", (1, 2048, 65_537))
@pytest.mark.parametrize("seed", (42, (1 << 33) + 7))
def test_gen_bids_key_chain(seed, n, n_auctions):
    """Five epochs down the key chain: auction, price and the next key
    equal the jitted reference's every epoch."""
    jk, pk = jkey(seed), prng_key(seed, "cpu")
    for epoch in range(5):
        ja, jp, jk = ref_gen_bids(jk, n, n_auctions)
        pa, pp, pk = gen_bids(pk, n, n_auctions)
        assert pa.dtype == pp.dtype == pk.dtype == torch.int64
        assert np.array_equal(pa.numpy(), np.asarray(ja)), epoch
        assert np.array_equal(pp.numpy(), np.asarray(jp)), epoch
        assert np.array_equal(pk.numpy(), words(jk)), epoch


@pytest.mark.parametrize("skew", (1.0, 2.0, 0.5))
def test_gen_bids_xla_forms(skew):
    """Skews whose pow XLA's simplifier rewrites (a chain, sqrt): equal
    to the bit."""
    ja, jp, jk = ref_gen_bids(jkey(7), 1 << 16, 10_000, skew)
    pa, pp, pk = gen_bids(prng_key(7, "cpu"), 1 << 16, 10_000, skew)
    assert np.array_equal(pa.numpy(), np.asarray(ja))
    assert np.array_equal(pp.numpy(), np.asarray(jp))
    assert np.array_equal(pk.numpy(), words(jk))


# A skew XLA keeps as a general pow: torch.pow rounds otherwise in some
# rows, and the auction id (a truncation) moves in this many of them
# (seed 42, 2^20 rows, 10,000 auctions; XLA's CPU pow against torch
# 2.13's on the CPU). The prices and the key do not depend on the skew.
RECORDED_POW_ROWS = {1.5: 6}


@pytest.mark.parametrize("skew", sorted(RECORDED_POW_ROWS))
def test_gen_bids_general_pow_recorded(skew):
    n = 1 << 20
    ja, jp, jk = ref_gen_bids(jkey(42), n, 10_000, skew)
    pa, pp, pk = gen_bids(prng_key(42, "cpu"), n, 10_000, skew)
    diff = pa.numpy() != np.asarray(ja)
    assert int(diff.sum()) == RECORDED_POW_ROWS[skew]
    # a row that moves moves by one id: a rounding across an integer
    assert np.all(np.abs(pa.numpy()[diff] - np.asarray(ja)[diff]) == 1)
    assert np.array_equal(pp.numpy(), np.asarray(jp))
    assert np.array_equal(pk.numpy(), words(jk))


def test_gen_bids_zero_rows_moves_the_key():
    ja, jp, jk = ref_gen_bids(jkey(5), 0, 300)
    pa, pp, pk = gen_bids(prng_key(5, "cpu"), 0, 300)
    assert pa.shape == pp.shape == (0,)
    assert np.array_equal(pk.numpy(), words(jk))


def test_gen_bids_cuda_path_raises_without_a_card():
    """A CPU key takes the plain version; the kernel's binding refuses
    a key that is not a CUDA tensor (no fallback)."""
    with pytest.raises(ValueError):
        D.binding.gen_bids(prng_key(1, "cpu"), 4, 300.0, 2, 3.0, 1, 9999,
                           0)
