"""The tile edges of the multiset merge (`chip_smoke.msm_edge_arrays`,
the cases the smoke also holds the one-pass `ms_merge` kernel to on the
card): a multiset pair and its delta twin across every 2048-row tile
edge of the merged order, those twins dying or going below 0, truncation
(needed > capacity) with pairs across the edges, every pair dying, and a
delta of only masked rows. The port's `ms_batch_reduce` + `ms_merge`
(plain on the CPU) against the JAX package's `device/minput.py`, every
leaf and dtype equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import risingwave_tpu.device.minput as J
from risingwave_tpu_torch import kernels as K
from test_torch_minput import multiset_pair
from torch_parity import assert_same

CASES = {case: rest for case, *rest
         in chip_smoke.msm_edge_arrays(np.random.default_rng(98))}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ms_merge_edges(name):
    cap, ms_rows, rows = CASES[name]
    jm, pm = multiset_pair(cap, *ms_rows)
    ju = J.ms_batch_reduce(*(jnp.asarray(x) for x in rows))
    pu = K.ms_batch_reduce(*(torch.from_numpy(np.asarray(x)) for x in rows))
    want = J.ms_merge(jm, *ju)
    got = K.ms_merge(pm, *pu)
    assert_same(got, want)
    new, needed = got
    live = len(ms_rows[0])
    if name == "needed>C_straddle":
        assert int(needed) > cap and int(new.count) == cap
    if name == "every_pair_dies":
        assert int(needed) == 0
    if name == "straddle_below_zero":
        assert bool((new.cnt < 0).any())
    if name == "delta_all_masked":
        assert int(needed) == live
        assert np.array_equal(new.cnt.numpy(), pm.cnt.numpy())
