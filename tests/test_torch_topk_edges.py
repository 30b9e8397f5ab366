"""The edges of the top-K telemetry (`chip_smoke.tk_edge_arrays`, the
cases the smoke also holds the `topk_packed` kernel to on the card): runs
crossing a thread's 8-row, a warp's 256-row and a tile's 2048-row edge,
runs a tile long, across three tiles, to the last row, against an EMPTY
tail at a tile edge or inside a thread's rows, one run past the count
clip (2^22 + 3 rows), n = 1 .. 7 in both modes, and weighted rows with
counts <= 0. The port's `epoch_topk` / `weighted_topk` (over the plain
`topk_packed` on the CPU) against the JAX package's, exactly."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from risingwave_tpu.device import skew_stats as JS
from risingwave_tpu_torch.device import skew_stats as PS
from torch_parity import EMPTY

CASES = {case: (keys, counts) for case, keys, counts
         in chip_smoke.tk_edge_arrays(np.random.default_rng(15))}


def ref(vals):
    return np.array([int(v) for v in vals], np.int64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_topk_edges(name):
    keys, counts = CASES[name]
    if counts is None:
        live = np.ones(len(keys), bool)
        got = PS.epoch_topk(torch.from_numpy(keys), torch.from_numpy(live),
                            EMPTY)
        want = ref(JS.epoch_topk(jnp.asarray(keys), jnp.asarray(live),
                                 EMPTY))
    else:
        got = PS.weighted_topk(torch.from_numpy(keys),
                               torch.from_numpy(counts), EMPTY)
        want = ref(JS.weighted_topk(jnp.asarray(keys), jnp.asarray(counts),
                                    EMPTY))
    assert got.dtype == torch.int64 and got.shape == (PS.SK_TOPK,)
    assert np.array_equal(got.numpy(), want)
    if name == "runs_past_count_clip":
        assert PS.unpack_hot(int(got[0]))[1] == PS.SK_COUNT_MAX
    if name.startswith("runs_cross") or name == "runs_one_tile_long":
        # four runs of four lengths (two equal in runs_one_tile_long):
        # every one of them ranked, none a singleton
        assert all(PS.unpack_hot(int(v))[1] > 1 for v in got)
