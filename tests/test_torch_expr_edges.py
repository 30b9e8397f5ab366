"""The edges of the expression kernel (`chip_smoke.expr_edge_specs`, the
cases the smoke also holds the eight-rows-a-thread `expr_eval` kernel to
on the card): row counts 1, one either side of a thread's eight rows and
of a block's 512, and 2^20 + 3, over every type, with literal first
operands, two literals and a CASE; every input column at an odd element
offset with an output of every width; a program at depth 8 whose folded
stack keeps 7 values below its top; 128 instructions; 16 inputs and 16
outputs. The port's lowered program run by `expr_eval` (plain on the
CPU) against the JAX package's trees' `eval_device`, every output and
dtype equal to the bit (NaN where NaN, a zero's sign kept)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import risingwave_tpu.expr as JX
from risingwave_tpu.core import dtypes as JT
from risingwave_tpu_torch import kernels as K

JNS = SimpleNamespace(T=JT, InputRef=JX.InputRef, Literal=JX.Literal,
                      Case=JX.Case, build_func=JX.build_func, cast=JX.cast)
SPECS = {case: rest for case, *rest in chip_smoke.expr_edge_specs()}


def assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if np.issubdtype(got.dtype, np.floating):
        gn, wn = np.isnan(got), np.isnan(want)
        assert np.array_equal(gn, wn)
        g, w = got[~gn], want[~wn]
        assert np.array_equal(g, w)
        assert np.array_equal(np.signbit(g), np.signbit(w))
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_expr_edges(name):
    types, n, offs, mode, build = SPECS[name]
    cols, mask = chip_smoke.expr_edge_arrays(np.random.default_rng(7),
                                             types, n)
    jcols = [jnp.asarray(c) for c in cols]
    pcols = [chip_smoke.offset_view(c, o, "cpu") for c, o in zip(cols, offs)]
    ref, port = build(JNS), build(chip_smoke.expr_ns())
    if mode == "map":
        prog = K.lower_map(port)
        got = K.expr_eval.expr_eval(prog, pcols)
        want = [e.eval_device(jcols)[0] for e in ref]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_bits(g.numpy(), w)
    else:
        prog = K.lower_pred(port)
        got = K.expr_eval.expr_eval(prog, pcols, torch.from_numpy(mask))
        v, ok = ref.eval_device(jcols)
        assert_bits(got.numpy(), mask & np.asarray(v) & np.asarray(ok))
    assert len(prog.code) <= len(prog.ins) <= K.expr_eval.MAX_INS
    if name == "depth_8":
        assert prog.depth == K.expr_eval.MAX_DEPTH and prog.deep() == 7
    if name == "ins_128":
        assert len(prog.ins) == K.expr_eval.MAX_INS
    if name == "in_16_out_16":
        assert len(prog.inputs) == 16 and len(prog.out_types) == 16
