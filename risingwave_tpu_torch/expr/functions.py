"""Device halves of the scalar functions the fused path evaluates (the
port's own copy of part of `risingwave_tpu/expr/functions.py`).

This slice carries the six comparisons (:175-201) and three-valued
and / or / not (:232, :242, :798). Arithmetic comes with the slice that
needs it. `build_device(name, args)` returns an executable FunctionCall.
"""
from __future__ import annotations

from typing import List

import torch

from ..core import dtypes as T
from .expression import Expr, FuncSig, FunctionCall

_CMP = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "less_than": torch.lt,
    "less_than_or_equal": torch.le,
    "greater_than": torch.gt,
    "greater_than_or_equal": torch.ge,
}


def _cmp_device(op):
    def device(ret, vals, valids):
        a, b = vals
        return op(a, b), torch.ones(a.shape, dtype=torch.bool,
                                    device=a.device)
    return device


def _and_device(ret, vals, valids):
    """3VL AND: NULL unless both sides are known, or either is FALSE."""
    a, b = (v.to(torch.bool) for v in vals)
    va, vb = valids
    out = (a & va) & (b & vb)
    valid = (va & vb) | (va & ~a) | (vb & ~b)
    return out, valid


def _or_device(ret, vals, valids):
    """3VL OR: NULL unless both sides are known, or either is TRUE."""
    a, b = (v.to(torch.bool) for v in vals)
    va, vb = valids
    ta, tb = a & va, b & vb
    return ta | tb, (va & vb) | ta | tb


def _not_device(ret, vals, valids):
    return ~vals[0].to(torch.bool), valids[0]


def build_device(name: str, args: List[Expr]) -> FunctionCall:
    """name(args) as a device-evaluable FunctionCall; raises ValueError
    for a function this slice does not carry."""
    name = name.lower()
    if name in _CMP:
        return FunctionCall(name, args, T.BOOLEAN,
                            FuncSig(name, _cmp_device(_CMP[name])))
    if name in ("and", "or"):
        dev = _and_device if name == "and" else _or_device
        return FunctionCall(name, args, T.BOOLEAN,
                            FuncSig(name, dev, strict=False))
    if name == "not":
        return FunctionCall(name, args, T.BOOLEAN, FuncSig(name, _not_device))
    raise ValueError(f"no device function {name!r} in the port yet")
