"""The bid generator of the fused device pipeline: a hand-written CUDA
kernel beside its plain PyTorch version, and the port's own copy of the
part of `jax.random` it draws from.

| core       | replaces (risingwave_tpu/device/datagen.py)                 |
|------------|-------------------------------------------------------------|
| `gen_bids` | `gen_bids` :26 (`jax.random` split / uniform / randint, traced by XLA into the epoch program) |

`jax.random`'s default generator is threefry2x32, a counter-based hash;
torch has none, so parity to the bit means writing it out. The copy
follows JAX 0.9.0 with `jax_threefry_partitionable` on (its default):

* `threefry2x32`: `jax/_src/prng.py:863-930` (`apply_round`,
  `rolled_loop_step`, `_threefry2x32_lowering`): 20 rounds in five
  groups of four, rotations (13, 15, 26, 6) / (17, 29, 16, 24), the
  key schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) injected after each group
  with the group's number added to the second word.
* `prng_key`: `prng.py` `threefry_seed` — the [hi, lo] words of the
  64-bit seed, as `jax.random.PRNGKey` makes them under x64.
* `split`: `prng.py:1156` `_threefry_split_foldlike` — new key i is both
  words of `threefry2x32(key, (0, i))`, the counts from
  `iota_2x32_shape`.
* `random_bits32`: `prng.py:1184-1199`
  `_threefry_random_bits_partitionable` — `bits1 ^ bits2` of
  `threefry2x32(key, (hi(i), lo(i)))`.
* `uniform_f32`: `jax/_src/random.py:435` `_uniform` — the bits' top 23
  as a float32 mantissa of exponent 0 (`bits >> 9 | 0x3F800000`), minus
  1.0, then `* (max - min) + min` (one fused multiply-add under XLA's
  CPU backend) and `max(min, .)`.
* `randint_i32`: `random.py:581` `_randint` — `k1, k2 = split(key)`, the
  higher bits drawn from k1 and the lower from k2, `span = max - min`,
  `multiplier = (2^16 mod span)^2 mod span` (the square wraps at 2^32
  too), `offset = ((hi mod span) *
  multiplier + lo mod span) mod span` in uint32 arithmetic that wraps,
  then `+ min`.

torch on the CPU has no `>>`, `+` or `%` for uint32, so the plain
version holds every 32-bit word in an int64 masked to its low 32 bits
(`_M32`): a sum is masked, a rotation of a value below 2^32 by at most
29 bits fits in int64, and a product keeps its low 32 bits. Keys are
int64 tensors of two such words.

The skew: `n_auctions * u ** skew`, jitted, is what XLA's algebraic
simplifier makes of `pow` — for skew 3.0 (every caller's) the chain
`(u * u) * u`, for 2.0 `u * u`, for 1.0 `u`, for 0.5 `sqrt(u)`. Both
versions compute those forms exactly so; any other skew is a general
pow (`powf` in the kernel, `torch.pow` here), which need not round as
XLA's routine does (tests/test_torch_datagen.py records the rows that
differ).

The dispatch function sends a key on a CUDA device to the kernel
(`csrc/datagen.cu`, bound by `binding.py`) and a CPU key to
`gen_bids_plain`, with no switch and no fallback; every launch adds one
to `LAUNCHES["gen_bids"]`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import LAUNCHES, binding

_M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
# skew forms (csrc/datagen.h RwSkewForm): XLA's own, or a general pow
SKEW_FORMS = {1.0: 0, 2.0: 1, 3.0: 2, 0.5: 3}
SKEW_POW = 4
# the price column: randint(k2, (n,), 1, 10_000, int32)
PRICE_MIN, PRICE_MAX = 1, 10_000


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the count pairs (x1, x2) under the key (k1, k2):
    every word an int64 in [0, 2^32). Keys may be 0-d tensors."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for g in range(5):
        for r in ROTATIONS[g % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(g + 1) % 3]) & _M32
        x2 = (x2 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x1, x2


def prng_key(seed: int, device: torch.device) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` under x64: int64 [2] = [hi, lo] of the
    seed's 64 bits, on `device` (the entry point's `device/datagen.py`
    `prng_key` resolves it)."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                        device=device)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """The low 32 bits of a * b, for a in [0, 2^32) and b < 2^32, with
    no product past 2^49."""
    return ((((a >> 16) * b) & _M32) << 16) + (a & 0xFFFF) * b & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: int64 [num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([b1, b2], dim=1)


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits for each of n rows (int64 in [0, 2^32))."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], i >> 32, i & _M32)
    return b1 ^ b2


def uniform_f32(key: torch.Tensor, n: int, minval: float = 0.0,
                maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, (n,), float32, minval, maxval)`."""
    bits = (random_bits32(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, _fma32(floats, hi - lo, lo))


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """float32 a * b + c as one fused multiply-add, as XLA's CPU backend
    contracts `_uniform`'s scale and shift: the product is exact in
    float64 and the sum is rounded to float64, then to float32 (exact for
    the [0, 1) range the generator draws)."""
    return (a.double() * b.double() + c.double()).float()


def randint_consts(minval: int, maxval: int) -> Tuple[int, int]:
    """randint's (span, multiplier) for int32 bounds: span = max - min as
    uint32 (1 when max <= min), multiplier = (2^16 mod span)^2 mod span
    with the square wrapping at 2^32 as uint32 does."""
    info = np.iinfo(np.int32)
    if not (info.min <= minval <= info.max and info.min <= maxval
            <= info.max):
        raise ValueError("randint: bounds must lie in int32")
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (1 << 16) % span
    return span, (mult * mult & _M32) % span


def randint_i32(key: torch.Tensor, n: int, minval: int, maxval: int
                ) -> torch.Tensor:
    """`jax.random.randint(key, (n,), minval, maxval, int32)`, for int32
    bounds."""
    span, mult = randint_consts(minval, maxval)
    k1, k2 = split(key, 2)
    higher, lower = random_bits32(k1, n), random_bits32(k2, n)
    off = (_mul32(higher % span, mult) + lower % span) & _M32
    off = (off % span + minval) & _M32
    return torch.where(off >= 1 << 31, off - (1 << 32), off).to(torch.int32)


def skew_form(skew: float) -> int:
    """The kernel's code for `u ** skew` (csrc/datagen.h)."""
    return SKEW_FORMS.get(float(skew), SKEW_POW)


def skewed(u: torch.Tensor, skew: float) -> torch.Tensor:
    """`u ** skew` in the form XLA's simplifier gives it under jit."""
    form = skew_form(skew)
    if form == 0:
        return u
    if form == 1:
        return u * u
    if form == 2:
        return (u * u) * u
    if form == 3:
        return torch.sqrt(u)
    return torch.pow(u, torch.tensor(skew, dtype=torch.float32,
                                     device=u.device))


def gen_bids_plain(key: torch.Tensor, n: int, n_auctions: int = 10_000,
                   skew: float = 3.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One epoch of bids: (auction int64 [n], price int64 [n], next key
    int64 [2]), as the reference's `gen_bids`."""
    nxt, k1, k2 = split(key, 3)
    u = uniform_f32(k1, n)
    scale = torch.tensor(float(np.float32(n_auctions)), dtype=torch.float32,
                         device=key.device)
    auction = (scale * skewed(u, skew)).to(torch.int64)
    price = randint_i32(k2, n, PRICE_MIN, PRICE_MAX).to(torch.int64)
    return auction, price, nxt


def gen_bids(key: torch.Tensor, n: int, n_auctions: int = 10_000,
             skew: float = 3.0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One epoch of bids from the key (int64 [2] on the epoch's device):
    `key, k1, k2 = split(key, 3)`, auction = trunc(n_auctions *
    uniform(k1) ** skew), price = randint(k2, 1, 10_000). Returns
    (auction int64 [n], price int64 [n], next key int64 [2]).

    CUDA: one launch, one thread a row. Each block first derives the
    sub-keys from the key in device memory (split(key, 3), then
    randint's split(k2)), so the key never visits the host and the
    launch can be replayed from a CUDA graph; then each thread runs three
    threefry hashes for its row (the uniform's bits, randint's higher and
    lower bits) and writes its auction and price; block 0 writes the
    next key."""
    if not key.is_cuda:
        return gen_bids_plain(key, n, n_auctions, skew)
    span, mult = randint_consts(PRICE_MIN, PRICE_MAX)
    out = binding.gen_bids(key.contiguous(), int(n),
                           float(np.float32(n_auctions)), skew_form(skew),
                           float(skew), PRICE_MIN, span, mult)
    LAUNCHES["gen_bids"] += 1
    return out
