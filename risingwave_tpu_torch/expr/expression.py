"""Expression trees with vectorized evaluation (the port's own copy of the
JAX package's `expr/expression.py`).

Re-design of the reference's expression layer (`src/expr/core/src/expr/mod.rs:65`
`Expression::eval(&DataChunk) -> ArrayRef`): an `Expr` evaluates over a whole
chunk at once. Three paths:

* host path (`eval`): numpy-vectorized with exact Postgres semantics
  (NULL propagation, three-valued logic, decimal on objects);
* device path (`eval_device`): torch ops over device columns for
  fixed-width dtypes, the device halves of `kernels/expr_eval.py`.
  `supports_device()` reports lowerability;
* lowering (`lower`): the tree as postfix code for the `expr_eval`
  kernel, which the fused Map / Filter / join nodes run in one launch.

Errors inside streaming expressions degrade to NULL (the reference's
non-strict wrapper, `src/expr/core/src/expr/wrapper/non_strict.rs`) instead of
failing the job.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.chunk import Column, DataChunk
from ..core.dtypes import DataType
from ..core import dtypes as T
from ..kernels import expr_eval as X


class Expr:
    """Base expression node."""

    return_type: DataType

    def eval(self, chunk: DataChunk) -> Column:
        raise NotImplementedError

    # ---- device lowering ----
    def supports_device(self) -> bool:
        return False

    def eval_device(self, cols: List[torch.Tensor]):
        """Evaluate over device columns: cols[i] is the tensor of input
        column i. Returns (values, valid)."""
        raise NotImplementedError(f"{type(self).__name__} has no device lowering")

    def dev_code(self) -> int:
        """The `expr_eval` type code of the return type's device dtype."""
        return X.code_of_np(self.return_type.device_dtype)

    def lower(self, b: "X.Lowering") -> int:
        """Emit the code that leaves this expression's (value, valid) on
        the `expr_eval` stack; returns its type code."""
        raise ValueError(f"expr_eval: no opcode for {self!r}")

    def children(self) -> List["Expr"]:
        return []

    def input_indices(self) -> List[int]:
        out: List[int] = []
        def walk(e: Expr):
            if isinstance(e, InputRef):
                out.append(e.index)
            for c in e.children():
                walk(c)
        walk(self)
        return sorted(set(out))


class InputRef(Expr):
    """Column reference (`src/expr/core/src/expr/expr_input_ref.rs`)."""

    def __init__(self, index: int, dtype: DataType):
        self.index = index
        self.return_type = dtype

    def eval(self, chunk: DataChunk) -> Column:
        return chunk.columns[self.index]

    def supports_device(self) -> bool:
        return self.return_type.is_fixed_width

    def eval_device(self, cols):
        c = cols[self.index]
        return c, X.ones_like(c)

    def lower(self, b):
        return b.col(self.index, self.dev_code())

    def __repr__(self):
        return f"${self.index}"


class Literal(Expr):
    """Constant (`src/expr/core/src/expr/expr_literal.rs`)."""

    def __init__(self, value: Any, dtype: DataType):
        self.value = value
        self.return_type = dtype

    def eval(self, chunk: DataChunk) -> Column:
        n = chunk.capacity
        return Column.from_list(self.return_type, [self.value] * n)

    def supports_device(self) -> bool:
        return self.return_type.is_fixed_width and self.value is not None

    def eval_device(self, cols):
        n = cols[0].shape[0] if cols else 1
        dev = cols[0].device if cols else None
        code = self.dev_code()
        v = torch.full((n,), X.value_of(X.bits_of(self.value, code), code),
                       dtype=X.TORCH_OF[code], device=dev)
        return v, torch.ones((n,), dtype=torch.bool, device=dev)

    def lower(self, b):
        if not self.supports_device():
            return super().lower(b)
        return b.lit(self.value, self.dev_code())

    def __repr__(self):
        return f"{self.value!r}:{self.return_type}"


@dataclass
class FuncSig:
    """Registered scalar function implementation."""
    name: str
    # host impl: (values..., valids..., n) -> (values, valid); vectorized numpy
    host: Callable
    # device impl: (torch values..., torch valids...) -> (values, valid); or None
    device: Optional[Callable]
    # if strict (default), output is NULL wherever any input is NULL and the
    # impl only sees the value arrays (null slots carry dummy values).
    strict: bool = True
    # lowering: (Lowering, return type, argument Exprs) -> the result's
    # type code, having emitted the arguments' code and the op's; None =
    # no opcode
    lower: Optional[Callable] = None


class FunctionCall(Expr):
    """N-ary scalar function call, dispatched through the registry
    (`src/expr/core/src/sig/mod.rs` FUNCTION_REGISTRY analog)."""

    def __init__(self, name: str, args: Sequence[Expr], return_type: DataType,
                 sig: FuncSig):
        self.name = name
        self.args = list(args)
        self.return_type = return_type
        self.sig = sig

    def children(self) -> List[Expr]:
        return self.args

    def eval(self, chunk: DataChunk) -> Column:
        arg_cols = [a.eval(chunk) for a in self.args]
        values = [c.values for c in arg_cols]
        valids = [c.validity for c in arg_cols]
        n = chunk.capacity
        out_vals, out_valid = self.sig.host(self.return_type, values, valids, n)
        if self.sig.strict and valids:
            all_valid = valids[0].copy()
            for v in valids[1:]:
                all_valid &= v
            out_valid = out_valid & all_valid
        return Column(self.return_type, out_vals, out_valid)

    def supports_device(self) -> bool:
        return (self.sig.device is not None
                and self.return_type.is_fixed_width
                and all(a.supports_device() for a in self.args))

    def eval_device(self, cols):
        vals, valids = [], []
        for a in self.args:
            v, ok = a.eval_device(cols)
            vals.append(v)
            valids.append(ok)
        out, ok = self.sig.device(self.return_type, vals, valids)
        if self.sig.strict and valids:
            allv = valids[0]
            for v in valids[1:]:
                allv = allv & v
            ok = ok & allv
        return out, ok

    def lower(self, b):
        if self.sig.lower is None or not self.supports_device():
            return super().lower(b)
        return self.sig.lower(b, self.return_type, self.args)

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


def lower_as(b, e: Expr, code: int) -> None:
    """Lower `e`, then convert its value to type `code` as jnp's `astype`
    or `where` promotion does (a wider type, or bool as != 0) when its own
    type differs. A float to an integer type would truncate there, where
    the cast op rounds, so that raises."""
    got = e.lower(b)
    if got != code:
        if got in X.FLOATS and code in X.INTS:
            raise ValueError(f"expr_eval: no opcode for {e!r} truncated "
                             "to an integer")
        b.op(X.OP_CAST, code, 1, code, imm=got)


class Case(Expr):
    """CASE WHEN ... THEN ... ELSE ... END with lazy branch semantics
    (`src/expr/impl/src/scalar/case.rs`). Vectorized: all branches evaluate,
    selection by mask (branch errors degrade to NULL only where selected)."""

    def __init__(self, whens: Sequence[Tuple[Expr, Expr]],
                 else_expr: Optional[Expr], return_type: DataType):
        self.whens = list(whens)
        self.else_expr = else_expr
        self.return_type = return_type

    def children(self) -> List[Expr]:
        out = []
        for c, r in self.whens:
            out += [c, r]
        if self.else_expr is not None:
            out.append(self.else_expr)
        return out

    def eval(self, chunk: DataChunk) -> Column:
        n = chunk.capacity
        dt = self.return_type
        if dt.np_dtype == np.dtype(object):
            out_vals = np.empty(n, dtype=object)
        else:
            out_vals = np.zeros(n, dtype=dt.np_dtype)
        out_valid = np.zeros(n, dtype=np.bool_)
        decided = np.zeros(n, dtype=np.bool_)
        for cond, result in self.whens:
            c = cond.eval(chunk)
            hit = (~decided) & c.validity & (c.values.astype(np.bool_))
            if hit.any():
                r = result.eval(chunk)
                out_vals[hit] = r.values[hit]
                out_valid[hit] = r.validity[hit]
            decided |= hit
        if self.else_expr is not None:
            rest = ~decided
            if rest.any():
                r = self.else_expr.eval(chunk)
                out_vals[rest] = r.values[rest]
                out_valid[rest] = r.validity[rest]
        return Column(dt, out_vals, out_valid)

    def supports_device(self) -> bool:
        return (self.return_type.is_fixed_width
                and all(c.supports_device() and r.supports_device()
                        for c, r in self.whens)
                and (self.else_expr is None or self.else_expr.supports_device()))

    def eval_device(self, cols):
        n = cols[0].shape[0]
        dev = cols[0].device
        dt = X.TORCH_OF[self.dev_code()]
        out = torch.zeros((n,), dtype=dt, device=dev)
        ok = torch.zeros((n,), dtype=torch.bool, device=dev)
        decided = torch.zeros((n,), dtype=torch.bool, device=dev)
        for cond, result in self.whens:
            cv, cok = cond.eval_device(cols)
            hit = (~decided) & cok & cv.to(torch.bool)
            rv, rok = result.eval_device(cols)
            out = torch.where(hit, rv, out)
            ok = torch.where(hit, rok, ok)
            decided = decided | hit
        if self.else_expr is not None:
            rv, rok = self.else_expr.eval_device(cols)
            out = torch.where(decided, out, rv)
            ok = torch.where(decided, ok, rok)
        return out, ok

    def lower(self, b):
        if not self.supports_device():
            return super().lower(b)
        code = self.dev_code()          # jnp's `where` promotes the arms
        for e in [r for _, r in self.whens] + (
                [] if self.else_expr is None else [self.else_expr]):
            code = X.promote(code, b.type_of(e))
        if self.else_expr is not None:
            lower_as(b, self.else_expr, code)
        else:
            b.lit(0, code, valid=False)
        # c1 ? r1 : (c2 ? r2 : ... : else): the first hit wins
        for cond, result in reversed(self.whens):
            lower_as(b, result, code)
            lower_as(b, cond, X.T_BOOL)
            b.op(X.OP_SELECT, code, 3, code)
        return code


class IsNull(Expr):
    def __init__(self, arg: Expr, negated: bool = False):
        self.arg = arg
        self.negated = negated
        self.return_type = T.BOOLEAN

    def children(self):
        return [self.arg]

    def eval(self, chunk: DataChunk) -> Column:
        c = self.arg.eval(chunk)
        v = ~c.validity if not self.negated else c.validity.copy()
        return Column(T.BOOLEAN, v, np.ones(len(v), dtype=np.bool_))

    def supports_device(self) -> bool:
        return self.arg.supports_device()

    def eval_device(self, cols):
        _, ok = self.arg.eval_device(cols)
        v = ~ok if not self.negated else ok
        return v, X.ones_like(v)

    def lower(self, b):
        if not self.supports_device():
            return super().lower(b)
        self.arg.lower(b)
        return b.op(X.OP_ISNOTNULL if self.negated else X.OP_ISNULL,
                    X.T_BOOL, 1, X.T_BOOL)


class Coalesce(Expr):
    def __init__(self, args: Sequence[Expr], return_type: DataType):
        self.args = list(args)
        self.return_type = return_type

    def children(self):
        return self.args

    def eval(self, chunk: DataChunk) -> Column:
        n = chunk.capacity
        dt = self.return_type
        out_vals = (np.empty(n, dtype=object) if dt.np_dtype == np.dtype(object)
                    else np.zeros(n, dtype=dt.np_dtype))
        out_valid = np.zeros(n, dtype=np.bool_)
        for a in self.args:
            c = a.eval(chunk)
            need = (~out_valid) & c.validity
            out_vals[need] = c.values[need]
            out_valid |= need
        return Column(dt, out_vals, out_valid)

    def supports_device(self) -> bool:
        return (self.return_type.is_fixed_width
                and all(a.supports_device() for a in self.args))

    def eval_device(self, cols):
        v0, ok0 = self.args[0].eval_device(cols)
        out, ok = v0, ok0
        for a in self.args[1:]:
            v, aok = a.eval_device(cols)
            take = (~ok) & aok
            out = torch.where(take, v, out)
            ok = ok | take
        return out, ok

    def lower(self, b):
        if not self.supports_device():
            return super().lower(b)
        code = b.type_of(self.args[0])
        for a in self.args[1:]:
            code = X.promote(code, b.type_of(a))
        lower_as(b, self.args[0], code)
        for a in self.args[1:]:
            lower_as(b, a, code)
            b.op(X.OP_COALESCE, code, 2, code)
        return code
