"""The port's HopNode (the plain `hop_expand`, on the CPU) against the
JAX package's `HopNode.apply`: HOP (n = 5) and TUMBLE (n = 1) windows,
with and without row identity, on a mask with holes, negative
timestamps included — every leaf and dtype of the output delta and the
stats equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import risingwave_tpu.device.fused as JF
from risingwave_tpu_torch.device import fused as PF
from torch_parity import assert_same

USEC = 1_000_000


@pytest.mark.parametrize("hop,size", [(2 * USEC, 10 * USEC),
                                      (10 * USEC, 10 * USEC),
                                      (3, 7 * 3)])
@pytest.mark.parametrize("with_pk", [True, False])
def test_hop_node_matches_reference(hop, size, with_pk):
    rng = np.random.default_rng(hop + size + with_pk)
    n = 77
    ts = rng.integers(-30 * USEC, 30 * USEC, n)
    ts[:5] = [0, -1, -hop, hop - 1, -hop - 1]      # floor at the edges
    cols = [rng.integers(0, 1000, n), ts, rng.normal(0, 1, n),
            rng.integers(-5, 5, n).astype(np.int32)]
    sign = rng.choice([-1, 1], n).astype(np.int32)
    mask = rng.random(n) < 0.7
    pk = rng.integers(0, 1 << 62, n) if with_pk else None
    jd = JF.Delta([jnp.asarray(c) for c in cols], jnp.asarray(sign),
                  jnp.asarray(mask),
                  pk=None if pk is None else jnp.asarray(pk))
    pd = PF.Delta([torch.from_numpy(c) for c in cols],
                  torch.from_numpy(sign), torch.from_numpy(mask),
                  pk=None if pk is None else torch.from_numpy(pk))
    jn = JF.HopNode(0, 1, hop, size)
    pn = PF.HopNode(0, 1, hop, size, device="cpu")
    _, jo, js, _ = jn.apply(None, [jd], None, n)
    _, po, ps, _ = pn.apply(None, [pd], None, n)
    assert_same((po, ps), (jo, js))
    assert (po.pk is None) == (pk is None)
    k = size // hop
    assert po.cols[-2].shape[0] == k * n
    # every copy's window holds its timestamp
    t = po.cols[1]
    assert bool(((po.cols[-2] <= t) & (t < po.cols[-1])).all())


def test_hop_node_rejects_ragged_windows():
    with pytest.raises(ValueError):
        PF.HopNode(0, 1, 3, 10, device="cpu")
