"""Device evaluation of expressions (PyTorch port of the `eval_device`
half of `risingwave_tpu/expr/expression.py`).

This slice carries the two expression classes the q4 projection
evaluates: column references and literals. `eval_device` takes the input
columns as tensors and returns (values, valid).
"""
from __future__ import annotations

from typing import Any, List

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
