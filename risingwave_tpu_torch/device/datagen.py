"""Device-side bid generation (PyTorch port of
`risingwave_tpu/device/datagen.py`).

Bids are synthesized on the device, not ingested, so the fused pipeline's
source runs at the card's rate instead of the host link's. The reference
draws them with `jax.random`; the port draws the same bits with its own
threefry2x32 (`kernels/datagen.py`), so one seed gives one stream in both
packages, to the bit.

`gen_bids(key, n, n_auctions=10_000, skew=3.0)` -> (auction int64 [n],
price int64 [n], next key): the reference's key chain `key, k1, k2 =
split(key, 3)`, auction = trunc(n_auctions * uniform(k1) ** skew) (small
ids hot: Nexmark's hot-auction shape), price = randint(k2, 1, 10_000).
A key is an int64 [2] tensor of two 32-bit words on the epoch's device;
the next key stays there, so an epoch loop never reads the host.
`prng_key(seed, device=None)` makes the key `jax.random.PRNGKey(seed)`
makes, on `cuda:0` unless a device is given.
"""
from __future__ import annotations

import torch

from ..kernels import datagen as _K
from ..kernels.datagen import gen_bids, split  # noqa: F401
from . import resolve_device


def prng_key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` as the port's key (int64 [2]) on
    `resolve_device(device)`: `cuda:0` when none is given."""
    return _K.prng_key(seed, resolve_device(device))
