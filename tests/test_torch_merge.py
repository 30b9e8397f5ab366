"""The port's merge, make_state and grow_state (plain PyTorch versions,
on the CPU) against the JAX package's, leaf by leaf and dtype by dtype."""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import risingwave_tpu.device.sorted_state as J
import risingwave_tpu_torch.device.sorted_state as P
from torch_parity import (ALL_KINDS, EMPTY, MN, MX, Q4_KINDS, R, S,
                          assert_same, payload, state_pair)

# the reference merge jitted whole; kinds and drop_dead are static
_J_MERGE = jax.jit(lambda s, k, v, kinds, drop: J.merge(s, k, v, kinds,
                                                         drop_dead=drop),
                   static_argnums=(3, 4))


# REPLACE of every dtype beside f64 and bool MIN / MAX
REPLACE_BOOL_F64 = [(S, np.int64), (R, np.bool_), (R, np.float64),
                    (MN, np.float64), (MX, np.float64), (R, np.int32),
                    (MN, np.bool_), (MX, np.bool_), (R, np.int64)]


def merge_case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    spec, cap, b, drop, kill = ALL_KINDS, 512, 256, True, 0.25
    lo, hi = -400, 400
    if name == "q4":
        spec = Q4_KINDS
    elif name == "mv":
        spec = [(R, np.int32)] + [(R, np.int64), (R, np.bool_)] * 3
    elif name == "no_drop_dead":
        drop = False
    elif name == "needed_gt_c":
        cap, kill = 128, 0.0
    elif name == "negative":
        lo, hi = -(1 << 62), -(1 << 62) + 800
    elif name == "replace_bool_f64":
        spec = REPLACE_BOOL_F64
    n_state = 1 if name == "n1" else (0 if name == "empty_state" else 200)
    if name == "n1":
        cap, b = 1, 1
    skeys = np.unique(rng.integers(lo, hi, n_state))[:cap]
    dkeys = np.unique(rng.integers(lo, hi, 1 if name == "n1" else 180))
    if name == "n1":
        dkeys = skeys.copy()
    elif name == "tile_edges":
        # more than 3 x 2048 merged rows, a state row and its delta twin
        # at every 2048-row tile edge (merged rows 2047 / 2048, 4095 /
        # 4096, ...): the kernel's tiles
        cap, b = 4096, 4096
        kinds = chip_smoke.straddle_items(rng, 3500, 3000, 0.3)
        skeys, dkeys = chip_smoke.merge_runs(rng, kinds)
    elif name == "all_dead":
        dkeys, kill = skeys.copy(), 1.0      # every delta kills its twin
    elif name == "half_empty_state":
        skeys = np.unique(rng.integers(lo, hi, 4 * cap))[:cap // 2]
    js, ps = state_pair(rng, cap, skeys, spec)
    dk = np.full(b, EMPTY, np.int64)
    dk[:len(dkeys)] = dkeys
    dvals = []
    for k, dt in spec:
        v = payload(rng, b, dt)
        v[len(dkeys):] = np.asarray(J._neutral(k, np.dtype(dt)))
        dvals.append(v)
    if len(skeys):
        pos = np.clip(np.searchsorted(skeys, dkeys), 0, len(skeys) - 1)
        kill_m = (skeys[pos] == dkeys) & (rng.random(len(dkeys)) < kill)
        s0 = np.asarray(js.vals[0])[pos]
        dvals[0][:len(dkeys)][kill_m] = \
            -s0[kill_m] if spec[0][0] == S else 0
    return js, ps, dk, dvals, [k for k, _ in spec], drop


@pytest.mark.parametrize("case", ["all_kinds", "q4", "mv", "no_drop_dead",
                                  "needed_gt_c", "n1", "negative",
                                  "empty_state", "tile_edges", "all_dead",
                                  "half_empty_state", "replace_bool_f64"])
def test_merge(case):
    js, ps, dk, dvals, kinds, drop = merge_case(case)
    if case == "tile_edges":
        live = np.sort(np.concatenate([np.asarray(js.keys), dk]))
        assert len(live) > 3 * 2048
        for edge in (2048, 4096):
            assert live[edge - 1] == live[edge] != EMPTY
    elif case == "half_empty_state":
        assert int(js.count) == js.capacity // 2
    ref = _J_MERGE(js, jnp.asarray(dk), [jnp.asarray(v) for v in dvals],
                   tuple(kinds), drop)
    got = P.merge(ps, torch.from_numpy(dk),
                  [torch.from_numpy(v) for v in dvals], kinds,
                  drop_dead=drop)
    if case == "needed_gt_c":
        assert int(ref[1]) > js.capacity
    elif case == "all_dead":
        assert int(ref[1]) == 0
    assert_same(got, ref)


@pytest.mark.parametrize("case", ["unsorted", "empty_hole", "duplicate"])
def test_merge_rejects_delta_out_of_order(case):
    """The kernel merges two sorted runs without re-sorting, so the plain
    version holds every caller to the same order and raises."""
    _, ps, dk, dvals, kinds, drop = merge_case("q4")
    live = int(np.sum(dk != EMPTY))
    if case == "unsorted":
        dk[[0, live - 1]] = dk[[live - 1, 0]]
    elif case == "empty_hole":
        dk[live // 2] = EMPTY
    else:
        dk[1] = dk[0]
    with pytest.raises(ValueError, match="ascending"):
        P.merge(ps, torch.from_numpy(dk),
                [torch.from_numpy(v) for v in dvals], kinds, drop_dead=drop)


@pytest.mark.parametrize("cap,new_cap", [(1, 1), (16, 64), (100, 128)])
def test_make_and_grow_state(cap, new_cap):
    dts = [dt for _, dt in ALL_KINDS]
    kinds = [k for k, _ in ALL_KINDS]
    jst = J.make_state(cap, dts, kinds)
    pst = P.make_state(cap, [torch.from_numpy(np.zeros(0, d)).dtype
                             for d in dts], kinds, "cpu")
    assert_same(pst, jst)
    rng = np.random.default_rng(cap)
    js, ps = state_pair(rng, cap, np.unique(rng.integers(0, 99, cap))[:cap],
                        ALL_KINDS)
    assert_same(P.grow_state(ps, new_cap, kinds),
                J.grow_state(js, new_cap, kinds))
