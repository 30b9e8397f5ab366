"""Device evaluation of expressions (PyTorch port of the `eval_device`
half of `risingwave_tpu/expr/expression.py`).

It carries column references, literals and function calls (whose device
halves live in `functions.py`). `eval_device` takes the input columns as
tensors and returns (values, valid).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from ..core.dtypes import DataType


class Expr:
    """Base expression node."""

    return_type: DataType

    def eval_device(self, cols: List[torch.Tensor]):
        raise NotImplementedError(
            f"{type(self).__name__} has no device lowering")

    def children(self) -> List["Expr"]:
        return []


class InputRef(Expr):
    """Column reference."""

    def __init__(self, index: int, dtype: DataType):
        self.index = index
        self.return_type = dtype

    def eval_device(self, cols):
        c = cols[self.index]
        return c, torch.ones(c.shape, dtype=torch.bool, device=c.device)

    def __repr__(self):
        return f"${self.index}"


class Literal(Expr):
    """Constant."""

    def __init__(self, value: Any, dtype: DataType):
        self.value = value
        self.return_type = dtype

    def eval_device(self, cols):
        n = cols[0].shape[0] if cols else 1
        dev = cols[0].device if cols else None
        dt = torch.from_numpy(
            np.zeros(0, dtype=self.return_type.device_dtype)).dtype
        v = torch.full((n,), self.value, dtype=dt, device=dev)
        return v, torch.ones((n,), dtype=torch.bool, device=dev)

    def __repr__(self):
        return f"{self.value!r}:{self.return_type}"


@dataclass
class FuncSig:
    """A registered scalar function's device half: (return type, values,
    valids) -> (values, valid). Strict functions are NULL wherever any
    input is NULL."""
    name: str
    device: Callable
    strict: bool = True


class FunctionCall(Expr):
    """N-ary scalar function call (the reference's `FunctionCall`)."""

    def __init__(self, name: str, args: Sequence[Expr], return_type: DataType,
                 sig: FuncSig):
        self.name = name
        self.args = list(args)
        self.return_type = return_type
        self.sig = sig

    def children(self) -> List[Expr]:
        return self.args

    def eval_device(self, cols):
        vals, valids = [], []
        for a in self.args:
            v, ok = a.eval_device(cols)
            vals.append(v)
            valids.append(ok)
        out, ok = self.sig.device(self.return_type, vals, valids)
        if self.sig.strict and valids:
            for v in valids:
                ok = ok & v
        return out, ok

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"
