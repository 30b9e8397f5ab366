"""The expression layer's device pass: a hand-written CUDA kernel beside
its plain PyTorch version, and the lowering between them.

| core        | replaces (risingwave_tpu/expr/)                            |
|-------------|------------------------------------------------------------|
| `expr_eval` | every `eval_device` of `expression.py` (`FunctionCall` :156, `Case` :225, `IsNull` :262, `Coalesce` :294) over the device halves of `functions.py` (arith :113-147, cmp :196, and/or/not :232-242 / :798, cast :331-343, math :737-741, neg :806-809, `tumble_start` :861-866, `power` :881-883): jnp traced into the epoch program, where XLA fuses a node's expressions into one elementwise pass |

Three pieces:

* **The device halves** (`arith`, `compare`, `cast`, `math1`, ...): the
  torch ops of each scalar function, the port's copy of the JAX
  package's jnp halves. `expr/functions.py` wires them into its
  `FuncSig`s, so a tree's own `eval_device` runs them, and the program
  interpreter below runs the same ones.
* **The lowering** (`lower_map`, `lower_pred`): a node's expression list,
  or its predicate, as one flat postfix program, once, when the node is
  built. Each instruction is (opcode, type, 64-bit immediate); an
  operand is an input column or a literal's bit pattern, every value on
  the stack is typed statically (bool, int16/32/64, float32/64: a
  column's or a function's device dtype), and the stack depth is fixed
  at lowering. It raises on an op it has no opcode for, or on a tree
  deeper than the kernel's stack: there is no way back to torch ops.
  As it emits, it folds the program (`ExprProgram.code`): an operand
  that is a column or a literal rides in the instruction that takes it
  (`SRC_*`) instead of being pushed, so `price > 500` is two
  instructions, a comparison of a column with a literal and the mask.
* **The dispatch** (`expr_eval`): CUDA tensors go to the kernel
  (`csrc/expr_eval.cu`, bound by `binding.py`: one launch for the whole
  folded program, eight rows a thread), CPU tensors to
  `expr_eval_plain`, which runs the same folded program with the device
  halves' torch ops. Every launch adds one to `LAUNCHES["expr_eval"]`.

A Map program writes one column per computed output (NULL rows keep the
value the reference computes: a Map drops validity); a predicate program
(Filter, join condition) writes `mask & value & valid` as the new mask.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import LAUNCHES, binding

# ---------------------------------------------------------------------------
# types and opcodes (csrc/expr_eval.h: RwExprType, RwExprOp)
# ---------------------------------------------------------------------------

T_BOOL, T_I16, T_I32, T_I64, T_F32, T_F64 = range(6)
TORCH_OF = {T_BOOL: torch.bool, T_I16: torch.int16, T_I32: torch.int32,
            T_I64: torch.int64, T_F32: torch.float32, T_F64: torch.float64}
CODE_OF = {v: k for k, v in TORCH_OF.items()}
_NP_CODE = {np.dtype(np.bool_): T_BOOL, np.dtype(np.int16): T_I16,
            np.dtype(np.int32): T_I32, np.dtype(np.int64): T_I64,
            np.dtype(np.float32): T_F32, np.dtype(np.float64): T_F64}
INTS = (T_I16, T_I32, T_I64)
FLOATS = (T_F32, T_F64)

(OP_COL, OP_LIT, OP_NULL, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MOD, OP_NEG,
 OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE, OP_AND, OP_OR, OP_NOT, OP_CAST,
 OP_TS2DATE, OP_DATE2TS, OP_ABS, OP_FLOOR, OP_CEIL, OP_ROUND, OP_SQRT,
 OP_EXP, OP_LN, OP_LOG10, OP_SIN, OP_COS, OP_TAN, OP_POW, OP_TUMBLE,
 OP_SELECT, OP_ISNULL, OP_ISNOTNULL, OP_COALESCE, OP_OUT,
 OP_MASK) = range(40)

OP_NAMES = ("col", "lit", "null", "add", "subtract", "multiply", "divide",
            "modulus", "neg", "equal", "not_equal", "less_than",
            "less_than_or_equal", "greater_than", "greater_than_or_equal",
            "and", "or", "not", "cast", "ts_to_date", "date_to_ts", "abs",
            "floor", "ceil", "round", "sqrt", "exp", "ln", "log10", "sin",
            "cos", "tan", "power", "tumble_start", "select", "is_null",
            "is_not_null", "coalesce", "out", "mask")
ARITH_OPS = {"add": OP_ADD, "subtract": OP_SUB, "multiply": OP_MUL,
             "divide": OP_DIV, "modulus": OP_MOD}
CMP_OPS = {"equal": OP_EQ, "not_equal": OP_NE, "less_than": OP_LT,
           "less_than_or_equal": OP_LE, "greater_than": OP_GT,
           "greater_than_or_equal": OP_GE}
# the `_MATH1` functions by their jnp names; floor / ceil / round / abs
# keep an integral type, the rest compute in float64
MATH1_OPS = {"abs": OP_ABS, "floor": OP_FLOOR, "ceil": OP_CEIL,
             "round": OP_ROUND, "sqrt": OP_SQRT, "exp": OP_EXP,
             "log": OP_LN, "log10": OP_LOG10, "sin": OP_SIN, "cos": OP_COS,
             "tan": OP_TAN}

MAX_INS = 128         # RW_EXPR_MAX_INS
MAX_IN = 16           # RW_EXPR_MAX_IN
MAX_OUT = 16          # RW_EXPR_MAX_OUT
MAX_DEPTH = 8         # RW_EXPR_MAX_DEPTH: the kernel's value stack

# an operand's source in the folded program (csrc/expr_eval.h RwExprSrc):
# the stack, an input slot 0 .. MAX_IN - 1, or the instruction's literal
SRC_STACK, SRC_LIT, SRC_NULL = -1, MAX_IN, MAX_IN + 1
_PUSH = (OP_COL, OP_LIT, OP_NULL)
# ops that take their operands from the stack only
_STACK_ONLY = (OP_SELECT, OP_OUT, OP_MASK)
BINARY = frozenset({OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_MOD, OP_EQ, OP_NE,
                    OP_LT, OP_LE, OP_GT, OP_GE, OP_AND, OP_OR, OP_POW,
                    OP_TUMBLE, OP_COALESCE})

DAY_USECS = 86_400_000_000
I64_MIN = -(1 << 63)


def code_of_np(dt) -> int:
    """The type code of a device dtype (numpy)."""
    try:
        return _NP_CODE[np.dtype(dt)]
    except KeyError:
        raise ValueError(f"expr_eval: no device type for {dt}") from None


def promote(a: int, b: int) -> int:
    """jnp's (and torch's) result type of a `where` over two device types:
    the later of bool < int16 < int32 < int64 < float32 < float64."""
    return max(a, b)


# ---------------------------------------------------------------------------
# the device halves (torch ops), shared by eval_device and the interpreter
# ---------------------------------------------------------------------------


def ones_like(a: torch.Tensor) -> torch.Tensor:
    return torch.ones(a.shape, dtype=torch.bool, device=a.device)


def _floor_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer floor division for b != 0 (never INT_MIN // -1 here)."""
    return torch.div(a, b, rounding_mode="floor")


def arith(op: int, dt: torch.dtype, a: torch.Tensor, b: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_make_arith`'s device half (functions.py:113-147) in dtype dt:
    integers wrap; a zero divisor is replaced by 1 and makes the row NULL
    (so `a / 0` carries `a`, `a % 0` carries 0); integer division
    truncates as sign(a)·sign(b)·(|a| // |b|) with `//` flooring and
    |INT_MIN| wrapping to itself; float modulus is a - trunc(a/b)·b."""
    a, b = a.to(dt), b.to(dt)
    ok = ones_like(a)
    if op == OP_ADD:
        return a + b, ok
    if op == OP_SUB:
        return a - b, ok
    if op == OP_MUL:
        return a * b, ok
    zero = b == 0
    safe = torch.where(zero, torch.ones_like(b), b)
    if dt.is_floating_point:
        out = a / safe if op == OP_DIV else a - torch.trunc(a / safe) * safe
        return out, ~zero
    q = torch.sign(a) * torch.sign(safe) * _floor_div(torch.abs(a),
                                                      torch.abs(safe))
    return (q if op == OP_DIV else a - q * safe), ~zero


def compare(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`_make_cmp`'s device half (functions.py:196)."""
    return {OP_EQ: torch.eq, OP_NE: torch.ne, OP_LT: torch.lt,
            OP_LE: torch.le, OP_GT: torch.gt, OP_GE: torch.ge}[op](a, b)


def and3(a, b, va, vb):
    """3VL AND (functions.py:232): NULL unless both sides are known, or
    either is FALSE."""
    a, b = a.to(torch.bool), b.to(torch.bool)
    return (a & va) & (b & vb), (va & vb) | (va & ~a) | (vb & ~b)


def or3(a, b, va, vb):
    """3VL OR (functions.py:242): NULL unless both sides are known, or
    either is TRUE."""
    a, b = a.to(torch.bool), b.to(torch.bool)
    ta, tb = a & va, b & vb
    return ta | tb, (va & vb) | ta | tb


def not1(a):
    return ~a.to(torch.bool)


def cast(dt: torch.dtype, a: torch.Tensor) -> torch.Tensor:
    """The cast device half's `astype` (functions.py:340-342): float to an
    integer type by `rint` (half to even), then XLA's convert, spelled
    out: NaN gives 0 and a value past the type's range its nearest end;
    otherwise a plain conversion (integers wrap, to bool is != 0)."""
    if dt.is_floating_point or dt == torch.bool \
            or not a.dtype.is_floating_point:
        return a.to(dt)
    r = torch.round(a)
    info = torch.iinfo(dt)
    top = float(info.max) + 1.0          # 2^(bits-1), exact in f32 / f64
    nan, hi, lo = torch.isnan(r), r >= top, r < -top
    mid = torch.where(nan | hi | lo, torch.zeros_like(r), r).to(dt)
    return torch.where(nan, torch.zeros_like(mid), torch.where(
        hi, torch.full_like(mid, info.max),
        torch.where(lo, torch.full_like(mid, info.min), mid)))


def ts_to_date(a: torch.Tensor) -> torch.Tensor:
    """TIMESTAMP -> DATE (functions.py:336-337): floored days, int32."""
    return _floor_div(a, torch.full_like(a, DAY_USECS)).to(torch.int32)


def date_to_ts(a: torch.Tensor) -> torch.Tensor:
    """DATE -> TIMESTAMP (functions.py:338-339): days x 86,400,000,000
    µs in int64 (wrapping)."""
    return a.to(torch.int64) * DAY_USECS


_MATH_FN = {OP_ABS: torch.abs, OP_FLOOR: torch.floor, OP_CEIL: torch.ceil,
            OP_ROUND: torch.round, OP_SQRT: torch.sqrt, OP_EXP: torch.exp,
            OP_LN: torch.log, OP_LOG10: torch.log10, OP_SIN: torch.sin,
            OP_COS: torch.cos, OP_TAN: torch.tan}


def math1(op: int, dt: torch.dtype, a: torch.Tensor) -> torch.Tensor:
    """`_make_math1`'s device half (functions.py:737-741) with return
    dtype dt: a float result computes in dt (round is half to even); on an
    integral type floor / ceil / round return the value and abs wraps
    |INT_MIN| to itself."""
    if dt.is_floating_point:
        return _MATH_FN[op](a.to(dt))
    if op == OP_ABS:
        return torch.abs(a).to(dt)
    return a.to(dt)


def power(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`power`'s device half (functions.py:881-883), in float64."""
    return torch.pow(a.to(torch.float64), b.to(torch.float64))


def tumble_start(ts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`(ts // w) * w` (functions.py:861-866) in int64 with XLA's integer
    division where it is not a floor of ordinary values: x // 0 is -1 for
    x == 0 and -2 otherwise (XLA's x / 0 = -1, then the floor step), and
    INT64_MIN // -1 is INT64_MIN."""
    zero = w == 0
    wrap = (ts == I64_MIN) & (w == -1)
    q = _floor_div(ts, torch.where(zero | wrap, torch.ones_like(w), w))
    q = torch.where(zero, torch.where(ts == 0, -1, -2), q)
    q = torch.where(wrap, torch.full_like(q, I64_MIN), q)
    return q * w


def select(c, cv, r, rv, e, ev, dt):
    """One CASE arm: `c ? r : e` where a NULL condition is false (the
    reference's first-hit `where` chain, expression.py:225, evaluated from
    the last arm back)."""
    hit = cv & c.to(torch.bool)
    return (torch.where(hit, r.to(dt), e.to(dt)),
            torch.where(hit, rv, ev))


def coalesce2(x, xv, y, yv, dt):
    """One COALESCE step (expression.py:294): y where x is NULL and y is
    not; x's value stays where both are NULL."""
    take = ~xv & yv
    return torch.where(take, y.to(dt), x.to(dt)), xv | take


# ---------------------------------------------------------------------------
# the lowering
# ---------------------------------------------------------------------------


def bits_of(value, code: int) -> int:
    """A literal as the kernel's 64-bit slot: integers sign-extended,
    bool 0 / 1, float32 widened exactly to a double, float64 as is."""
    if code in FLOATS:
        v = float(np.asarray(value, dtype=np.float32 if code == T_F32
                             else np.float64))
        return struct.unpack("<q", struct.pack("<d", v))[0]
    if code == T_BOOL:
        return int(bool(value))
    dt = {T_I16: np.int16, T_I32: np.int32, T_I64: np.int64}[code]
    return int(np.asarray(value).astype(dt))


def value_of(bits: int, code: int):
    """The Python value of a slot's bits (the inverse of `bits_of`)."""
    if code in FLOATS:
        return struct.unpack("<d", struct.pack("<q", bits))[0]
    return bool(bits) if code == T_BOOL else int(bits)


@dataclass
class ExprProgram:
    """A lowered expression list. `ins` are (op, type, imm), the postfix
    program; `code` the same program folded, the form both the kernel and
    `expr_eval_plain` run: (op, type, a, b, param, lt, imm), where `a` /
    `b` are a binary op's operands' sources (a unary op's is `b`; COL /
    LIT / NULL push theirs, `b`), `imm` the bits of the one literal
    operand and `lt` its type, and `param` CAST's type converted from or
    OUT's output slot. `inputs` the node's column index of each dense
    input slot and `in_types` their types; `out_types` the type of each
    Map output; `mode` "map" or "mask"; `depth` the deepest stack the
    postfix program reaches. `params` is the kernel's parameter block,
    filled at the first launch (`binding.expr_eval`); later launches only
    set its pointers."""
    ins: List[Tuple[int, int, int]] = field(default_factory=list)
    code: List[Tuple[int, int, int, int, int, int, int]] = \
        field(default_factory=list)
    inputs: List[int] = field(default_factory=list)
    in_types: List[int] = field(default_factory=list)
    out_types: List[int] = field(default_factory=list)
    mode: str = "map"
    depth: int = 0
    params: object = field(default=None, repr=False, compare=False)

    def __repr__(self):
        body = " ".join(OP_NAMES[o] for o, _, _ in self.ins)
        return f"ExprProgram({self.mode}: {body})"

    def deep(self) -> int:
        """The most values the folded program keeps below the top of its
        stack (the kernel keeps those in shared memory)."""
        sp = top = 0
        for op, _, a, b, _, _, _ in self.code:
            if op in _PUSH:
                sp += 1
            elif op in (OP_OUT, OP_MASK):
                sp -= 1
            elif op == OP_SELECT:
                sp -= 2
            else:
                sp += 1 - (b == SRC_STACK) - (op in BINARY
                                              and a == SRC_STACK)
            top = max(top, sp)
        return max(0, top - 1)


class Lowering:
    """Builds an ExprProgram. Each `Expr.lower(b)` emits the code that
    leaves its value on the stack and returns that value's type code.
    `col_types` (column index -> type code) overrides the types the
    column references declare: a column is read as the tensor it is."""

    def __init__(self, mode: str, col_types: Optional[dict] = None):
        self.prog = ExprProgram(mode=mode)
        self.col_types = col_types or {}
        self._slot = {}
        self._sp = 0
        # each stack value's push in `prog.code` (its index), or None for
        # an op's result
        self._leaf: List[Optional[int]] = []

    def type_of(self, e) -> int:
        """The type code `e` lowers to (lowered once more, aside)."""
        return e.lower(Lowering(self.prog.mode, self.col_types))

    def _emit(self, op: int, t: int, imm: int, pops: int, pushes: int):
        if len(self.prog.ins) >= MAX_INS:
            raise ValueError(f"expr_eval: more than {MAX_INS} instructions")
        self._sp += pushes - pops
        if self._sp > MAX_DEPTH:
            raise ValueError(f"expr_eval: the expression needs a stack "
                             f"deeper than the kernel's {MAX_DEPTH}")
        self.prog.depth = max(self.prog.depth, self._sp)
        self.prog.ins.append((op, t, int(imm)))
        self._fold(op, t, int(imm), pops, pushes)

    def _fold(self, op: int, t: int, imm: int, pops: int, pushes: int):
        """Append the instruction to the folded program: a push becomes a
        leaf entry; an op other than SELECT / OUT / MASK takes each
        operand that a lone push left on the stack into itself, and the
        push goes (at most one literal an instruction: of two, the first
        stays pushed)."""
        code, leaf = self.prog.code, self._leaf
        if op == OP_COL:
            code.append((op, t, SRC_STACK, imm, 0, t, 0))
        elif op in (OP_LIT, OP_NULL):
            code.append((op, t, SRC_STACK,
                         SRC_LIT if op == OP_LIT else SRC_NULL, 0, t, imm))
        else:
            srcs = [SRC_STACK] * pops
            lt = lit = 0
            if op not in _STACK_ONLY:
                # the last operand first: a literal there keeps the slot
                for k in reversed(range(pops)):
                    at = leaf[len(leaf) - pops + k]
                    if at is None:
                        continue
                    src = code[at][3]
                    if src >= SRC_LIT and any(x >= SRC_LIT for x in srcs):
                        continue
                    srcs[k] = src
                    if src >= SRC_LIT:
                        lt, lit = code[at][5], code[at][6]
                for k in sorted((leaf[len(leaf) - pops + k]
                                 for k in range(pops)
                                 if srcs[k] != SRC_STACK), reverse=True):
                    del code[k]
            a, b = ([SRC_STACK] + srcs)[-2:]
            param = imm if op in (OP_CAST, OP_OUT) else 0
            code.append((op, t, a, b, param, lt, lit))
        del leaf[len(leaf) - pops:]
        leaf.extend([len(code) - 1 if op in _PUSH else None] * pushes)

    def col(self, index: int, code: int) -> int:
        code = self.col_types.get(index, code)
        slot = self._slot.get(index)
        if slot is None:
            if len(self.prog.inputs) >= MAX_IN:
                raise ValueError(f"expr_eval: more than {MAX_IN} input "
                                 "columns")
            slot = self._slot[index] = len(self.prog.inputs)
            self.prog.inputs.append(index)
            self.prog.in_types.append(code)
        elif self.prog.in_types[slot] != code:
            raise ValueError(f"expr_eval: column ${index} read as two types")
        self._emit(OP_COL, code, slot, 0, 1)
        return code

    def lit(self, value, code: int, valid: bool = True) -> int:
        self._emit(OP_LIT if valid else OP_NULL, code, bits_of(value, code),
                   0, 1)
        return code

    def op(self, op: int, t: int, arity: int, out: int, imm: int = 0) -> int:
        """Apply `op` (computing in type t) to the top `arity` values;
        returns the result's type `out`."""
        self._emit(op, t, imm, arity, 1)
        return out

    def out(self, code: int) -> None:
        self._emit(OP_OUT, code, len(self.prog.out_types), 1, 0)
        if len(self.prog.out_types) >= MAX_OUT:
            raise ValueError(f"expr_eval: more than {MAX_OUT} outputs")
        self.prog.out_types.append(code)

    def mask(self, code: int) -> None:
        if code != T_BOOL:
            raise ValueError("expr_eval: a predicate must be boolean")
        self._emit(OP_MASK, T_BOOL, 0, 1, 0)


def lower_map(exprs: Sequence, col_types: Optional[dict] = None
              ) -> ExprProgram:
    """A Map's computed outputs as one program (one OUT each, in order)."""
    b = Lowering("map", col_types)
    for e in exprs:
        b.out(e.lower(b))
    return b.prog


def lower_pred(pred, col_types: Optional[dict] = None) -> ExprProgram:
    """A Filter's predicate or a join condition as one program that
    writes the new row mask."""
    b = Lowering("mask", col_types)
    b.mask(pred.lower(b))
    return b.prog


class Lowered:
    """A node's expressions (a Map's list, or a predicate) lowered once,
    at construction, for the column types they declare. `program(cols)`
    returns that program; should a column's tensor be of another type
    (the reference reads a column as whatever array it is, and `jnp`
    promotes), it lowers once more for the tensors' types and keeps that
    program too."""

    def __init__(self, exprs, mode: str):
        self.exprs, self.mode = exprs, mode
        self.declared = self._lower(None)
        self._by_types = {}

    def _lower(self, col_types):
        return lower_map(self.exprs, col_types) if self.mode == "map" \
            else lower_pred(self.exprs, col_types)

    def program(self, cols: Sequence[torch.Tensor]) -> ExprProgram:
        p = self.declared
        if all(cols[i].dtype == TORCH_OF[c]
               for i, c in zip(p.inputs, p.in_types)):
            return p
        types = {i: CODE_OF[cols[i].dtype] for i in p.inputs}
        key = tuple(sorted(types.items()))
        if key not in self._by_types:
            self._by_types[key] = self._lower(types)
        return self._by_types[key]


# ---------------------------------------------------------------------------
# the plain version: the program run with the device halves' torch ops
# ---------------------------------------------------------------------------


def check_inputs(prog: ExprProgram, cols: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
    """The program's input tensors, each of the type it was lowered for."""
    out = []
    for idx, code in zip(prog.inputs, prog.in_types):
        t = cols[idx]
        if t.dtype != TORCH_OF[code]:
            raise ValueError(f"expr_eval: column ${idx} is {t.dtype}, the "
                             f"program reads {TORCH_OF[code]}")
        out.append(t)
    return out


def expr_eval_plain(prog: ExprProgram, cols: Sequence[torch.Tensor],
                    mask: Optional[torch.Tensor] = None):
    """Run the folded program over columns on any device with torch ops
    (see `expr_eval`)."""
    ins = check_inputs(prog, cols)
    n = cols[0].shape[0] if len(cols) else (0 if mask is None
                                            else mask.shape[0])
    dev = cols[0].device if len(cols) else mask.device
    stack: List[Tuple[torch.Tensor, torch.Tensor]] = []
    outs: List[torch.Tensor] = []

    def operand(src, lt, imm):
        if src == SRC_STACK:
            return stack.pop()
        if src < SRC_LIT:
            return ins[src], ones_like(ins[src])
        v = torch.full((n,), value_of(imm, lt), dtype=TORCH_OF[lt],
                       device=dev)
        return v, torch.full((n,), src == SRC_LIT, dtype=torch.bool,
                             device=dev)

    for op, t, sa, sb, _, lt, imm in prog.code:
        dt = TORCH_OF[t]
        if op in _PUSH:
            stack.append(operand(sb, lt, imm))
            continue
        if op == OP_OUT:
            outs.append(stack.pop()[0])
            continue
        if op == OP_MASK:
            v, ok = stack.pop()
            return mask & v & ok
        if op == OP_SELECT:
            (c, cv), (r, rv), (e, ev) = stack.pop(), stack.pop(), stack.pop()
            stack.append(select(c, cv, r, rv, e, ev, dt))
            continue
        # the last operand first: it is the top when both are on the stack
        b, vb = operand(sb, lt, imm)
        if op in BINARY:
            a, va = operand(sa, lt, imm)
        if op == OP_COALESCE:
            stack.append(coalesce2(a, va, b, vb, dt))
            continue
        if op in (OP_ISNULL, OP_ISNOTNULL):
            stack.append((~vb if op == OP_ISNULL else vb, ones_like(vb)))
            continue
        if op in (OP_AND, OP_OR):
            stack.append((and3 if op == OP_AND else or3)(a, b, va, vb))
            continue
        if op in BINARY:
            valid = va & vb
            if op in CMP_OPS.values():
                v = compare(op, a, b)
            elif op == OP_POW:
                v = power(a, b)
            elif op == OP_TUMBLE:
                v = tumble_start(a, b)
            else:
                v, ok = arith(op, dt, a, b)
                valid = ok & valid
            stack.append((v, valid))
            continue
        if op == OP_NEG:
            v = -b
        elif op == OP_NOT:
            v = not1(b)
        elif op == OP_CAST:
            v = cast(dt, b)
        elif op == OP_TS2DATE:
            v = ts_to_date(b)
        elif op == OP_DATE2TS:
            v = date_to_ts(b)
        elif op in _MATH_FN:
            v = math1(op, dt, b)
        else:
            raise AssertionError(f"expr_eval: unknown opcode {op}")
        stack.append((v, vb))
    return outs


def expr_eval(prog: ExprProgram, cols: Sequence[torch.Tensor],
              mask: Optional[torch.Tensor] = None):
    """Evaluate a lowered program over a node's columns. A "map" program
    returns its output columns (values only: a Map drops validity); a
    "mask" program returns `mask & value & valid`.

    CUDA: one launch of `k_expr_eval` — a thread runs the folded
    program, which rides in the kernel's parameters, over eight rows: the
    top of its stack of (64-bit value, valid) pairs in registers, the
    rest in shared memory; each input column is read once and each
    output written once."""
    dev = cols[0].device if len(cols) else mask.device
    if dev.type != "cuda":
        return expr_eval_plain(prog, cols, mask)
    ins = [t.contiguous() for t in check_inputs(prog, cols)]
    n = cols[0].shape[0] if len(cols) else mask.shape[0]
    outs = binding.expr_eval(prog, ins, n, dev,
                             None if mask is None else mask.contiguous())
    LAUNCHES["expr_eval"] += 1
    return outs[0] if prog.mode == "mask" else outs
