"""The edges of the multiset lookup (`chip_smoke.msf_edge_arrays`, the
cases the smoke also holds the sampled `ms_find` kernel to on the card):
capacities 1, 2, 3, either side of the kernel's 2047-pair sample, 2^14
and 2^20; present, absent, below-every and above-every pairs; EMPTY q1
and live q1 with EMPTY q2, in random order, q not a multiple of the
queries a thread takes; all queries EMPTY; sorted unique queries with an
EMPTY tail; query columns as views at odd 8-byte offsets. The port's
`ms_find` (plain on the CPU) against the JAX package's
`device/minput.py`, every leaf and dtype equal."""
import numpy as np
import pytest

import jax.numpy as jnp

import chip_smoke
import risingwave_tpu.device.minput as J
from risingwave_tpu_torch import kernels as K
from test_torch_minput import multiset_pair
from torch_parity import EMPTY, assert_same

CASES = {case: rest for case, *rest
         in chip_smoke.msf_edge_arrays(np.random.default_rng(99))}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ms_find_edges(name):
    cap, pairs, q1, q2, (o1, o2) = CASES[name]
    jm, pm = multiset_pair(cap, *pairs)
    want = J.ms_find(jm, jnp.asarray(q1), jnp.asarray(q2))
    got = K.ms_find(pm, chip_smoke.offset_view(q1, o1, "cpu"),
                    chip_smoke.offset_view(q2, o2, "cpu"))
    assert_same(got, want)
    found = got[0].numpy()
    assert not found[q1 == EMPTY].any()
    if name == "all_empty":
        assert not found.any() and not got[1].numpy().any()
    else:
        # each case finds some of its pairs, the one with an EMPTY_KEY
        # k2 included where the multiset holds one
        assert found.any()
        if len(pairs[0]) > 1 and name.startswith("C="):
            assert found[q2 == EMPTY].any()
