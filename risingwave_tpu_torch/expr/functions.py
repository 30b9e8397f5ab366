"""Scalar function registry + type resolution (the port's own copy of the
JAX package's `expr/functions.py`).

Replaces the reference's `#[function(...)]` linkme registry
(`src/expr/core/src/sig/mod.rs:39`, impls under `src/expr/impl/src/scalar/`).
Registration here is by family with a numeric-promotion resolver; every
function carries a numpy host impl (exact SQL semantics) and, for fixed-width
types, a torch device impl (the device halves in `kernels/expr_eval.py`)
and its lowering to `expr_eval` opcodes.

`build_func(name, args)` is the public entry: resolves the signature, inserts
implicit casts, returns an executable Expr.
"""
from __future__ import annotations

import math
from decimal import Decimal, DivisionByZero, InvalidOperation
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.chunk import Column, DataChunk
from ..core.dtypes import DataType, Interval, TypeKind
from ..core import dtypes as T
from ..kernels import expr_eval as X
from .expression import (Case, Coalesce, Expr, FuncSig, FunctionCall, InputRef,
                         IsNull, Literal, lower_as)

# ---------------------------------------------------------------------------
# Numeric type promotion (Postgres-style)
# ---------------------------------------------------------------------------

_NUM_ORDER = [TypeKind.INT16, TypeKind.INT32, TypeKind.INT64, TypeKind.DECIMAL,
              TypeKind.FLOAT32, TypeKind.FLOAT64]


def promote_numeric(a: DataType, b: DataType) -> DataType:
    ia, ib = _NUM_ORDER.index(a.kind), _NUM_ORDER.index(b.kind)
    # decimal + float => float64 (PG: numeric+float8 -> float8)
    ks = {a.kind, b.kind}
    if TypeKind.DECIMAL in ks and (TypeKind.FLOAT32 in ks or TypeKind.FLOAT64 in ks):
        return T.FLOAT64
    return DataType(_NUM_ORDER[max(ia, ib)])


def _obj_map2(f, av, bv, n):
    out = np.empty(n, dtype=object)
    for i in range(n):
        try:
            out[i] = f(av[i], bv[i])
        except (ArithmeticError, InvalidOperation, TypeError, ValueError):
            out[i] = None
    valid = np.array([x is not None for x in out], dtype=np.bool_)
    return out, valid


def _to_decimal(x):
    if x is None or isinstance(x, Decimal):
        return x
    if isinstance(x, float):
        return Decimal(str(x))
    return Decimal(int(x))


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

_INT_KINDS = (TypeKind.INT16, TypeKind.INT32, TypeKind.INT64, TypeKind.SERIAL)


def _make_arith(opname: str):
    def host(ret: DataType, values, valids, n):
        a, b = values
        if ret.kind == TypeKind.DECIMAL:
            fa = {"add": lambda x, y: x + y, "subtract": lambda x, y: x - y,
                  "multiply": lambda x, y: x * y,
                  "divide": lambda x, y: x / y,
                  "modulus": lambda x, y: x % y}[opname]
            av = [_to_decimal(x) for x in a]
            bv = [_to_decimal(x) for x in b]
            return _obj_map2(fa, av, bv, n)
        av = a.astype(ret.np_dtype, copy=False)
        bv = b.astype(ret.np_dtype, copy=False)
        valid_extra = np.ones(n, dtype=np.bool_)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            if opname == "add":
                out = av + bv
            elif opname == "subtract":
                out = av - bv
            elif opname == "multiply":
                out = av * bv
            elif opname == "divide":
                if ret.kind in _INT_KINDS:
                    zero = bv == 0
                    safe_b = np.where(zero, 1, bv)
                    # Postgres integer division truncates toward zero
                    out = (np.sign(av) * np.sign(safe_b)
                           * (np.abs(av) // np.abs(safe_b))).astype(ret.np_dtype)
                    valid_extra = ~zero
                else:
                    zero = bv == 0
                    out = np.where(zero, np.nan, av / np.where(zero, 1, bv))
                    valid_extra = ~zero
            elif opname == "modulus":
                zero = bv == 0
                safe_b = np.where(zero, 1, bv)
                # Postgres % keeps dividend sign (fmod), numpy % keeps divisor
                out = av - (np.sign(av) * np.sign(safe_b)
                            * (np.abs(av) // np.abs(safe_b))) * safe_b \
                    if ret.kind in _INT_KINDS else np.fmod(av, safe_b)
                valid_extra = ~zero
            else:
                raise AssertionError(opname)
        return out, valid_extra

    op = X.ARITH_OPS[opname]

    def device(ret: DataType, vals, valids):
        a, b = vals
        return X.arith(op, X.TORCH_OF[X.code_of_np(ret.device_dtype)], a, b)

    def lower(b, ret: DataType, args):
        t = X.code_of_np(ret.device_dtype)
        for a in args:
            lower_as(b, a, t)
        return b.op(op, t, 2, t)

    return host, device, lower


def _neg_host(ret, values, valids, n):
    (a,) = values
    if ret.kind == TypeKind.DECIMAL:
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = -_to_decimal(a[i]) if a[i] is not None else None
        return out, np.ones(n, dtype=np.bool_)
    return -a.astype(ret.np_dtype, copy=False), np.ones(n, dtype=np.bool_)


# ---------------------------------------------------------------------------
# Comparison / logic
# ---------------------------------------------------------------------------

_CMP = {
    "equal": lambda a, b: a == b,
    "not_equal": lambda a, b: a != b,
    "less_than": lambda a, b: a < b,
    "less_than_or_equal": lambda a, b: a <= b,
    "greater_than": lambda a, b: a > b,
    "greater_than_or_equal": lambda a, b: a >= b,
}


def _make_cmp(opname: str, operand_kind: TypeKind):
    f = _CMP[opname]

    def host(ret, values, valids, n):
        a, b = values
        if operand_kind in (TypeKind.VARCHAR, TypeKind.DECIMAL, TypeKind.BYTEA,
                            TypeKind.INTERVAL):
            if operand_kind == TypeKind.DECIMAL:
                a = [_to_decimal(x) for x in a]
                b = [_to_decimal(x) for x in b]
            out = np.zeros(n, dtype=np.bool_)
            valid = np.ones(n, dtype=np.bool_)
            for i in range(n):
                try:
                    out[i] = bool(f(a[i], b[i])) if a[i] is not None and b[i] is not None else False
                except TypeError:
                    valid[i] = False
            return out, valid
        with np.errstate(invalid="ignore"):
            return f(a, b).astype(np.bool_), np.ones(n, dtype=np.bool_)

    op = X.CMP_OPS[opname]

    def device(ret, vals, valids):
        a, b = vals
        return X.compare(op, a, b), X.ones_like(a)

    def lower(b, ret, args):
        t = max(b.type_of(a) for a in args)
        for a in args:
            lower_as(b, a, t)
        return b.op(op, t, 2, X.T_BOOL)

    return host, device, lower


def _and_host(ret, values, valids, n):
    a, b = values
    va, vb = valids
    av = a.astype(np.bool_) & va
    bv = b.astype(np.bool_) & vb
    out = av & bv
    # 3VL: NULL unless (false AND x) or both non-null
    false_a = va & ~a.astype(np.bool_)
    false_b = vb & ~b.astype(np.bool_)
    valid = (va & vb) | false_a | false_b
    return out, valid


def _or_host(ret, values, valids, n):
    a, b = values
    va, vb = valids
    true_a = va & a.astype(np.bool_)
    true_b = vb & b.astype(np.bool_)
    out = true_a | true_b
    valid = (va & vb) | true_a | true_b
    return out, valid


def _not_host(ret, values, valids, n):
    (a,) = values
    return ~a.astype(np.bool_), np.ones(n, dtype=np.bool_)


def _and_device(ret, vals, valids):
    return X.and3(*vals, *valids)


def _or_device(ret, vals, valids):
    return X.or3(*vals, *valids)


def _lower_bool(op: int):
    """and / or / not: the arguments as booleans, then the op."""
    def lower(b, ret, args):
        for a in args:
            lower_as(b, a, X.T_BOOL)
        return b.op(op, X.T_BOOL, len(args), X.T_BOOL)
    return lower


# ---------------------------------------------------------------------------
# Casts
# ---------------------------------------------------------------------------

def _cast_host(to: DataType, frm: DataType):
    def host(ret, values, valids, n):
        (a,) = values
        valid = np.ones(n, dtype=np.bool_)
        tk, fk = to.kind, frm.kind
        if tk == TypeKind.VARCHAR:
            out = np.empty(n, dtype=object)
            for i in range(n):
                v = a[i]
                if fk == TypeKind.BOOLEAN:
                    out[i] = "true" if v else "false"
                elif fk in (TypeKind.FLOAT32, TypeKind.FLOAT64):
                    out[i] = repr(float(v))
                elif fk == TypeKind.TIMESTAMP:
                    out[i] = _ts_to_str(int(v))
                elif fk == TypeKind.DATE:
                    out[i] = _date_to_str(int(v))
                else:
                    out[i] = str(v)
            return out, valid
        if tk == TypeKind.DECIMAL:
            out = np.empty(n, dtype=object)
            for i in range(n):
                try:
                    out[i] = _to_decimal(a[i] if fk != TypeKind.VARCHAR
                                         else Decimal(str(a[i]).strip()))
                except (InvalidOperation, TypeError, ValueError):
                    out[i] = None
                    valid[i] = False
            return out, valid
        if fk in (TypeKind.VARCHAR,):
            out_np = np.zeros(n, dtype=to.np_dtype)
            for i in range(n):
                try:
                    s = str(a[i]).strip() if a[i] is not None else None
                    if s is None:
                        valid[i] = False
                    elif tk == TypeKind.BOOLEAN:
                        out_np[i] = s.lower() in ("t", "true", "yes", "on", "1")
                    elif tk in _INT_KINDS:
                        out_np[i] = int(s)
                    elif tk in (TypeKind.FLOAT32, TypeKind.FLOAT64):
                        out_np[i] = float(s)
                    elif tk == TypeKind.TIMESTAMP:
                        out_np[i] = _str_to_ts(s)
                    elif tk == TypeKind.DATE:
                        out_np[i] = _str_to_date(s)
                    else:
                        valid[i] = False
                except (ValueError, TypeError):
                    valid[i] = False
            return out_np, valid
        if fk == TypeKind.DECIMAL:
            out_np = np.zeros(n, dtype=to.np_dtype)
            for i in range(n):
                v = a[i]
                if v is None:
                    continue
                d = _to_decimal(v)
                if tk in _INT_KINDS:
                    out_np[i] = int(d.to_integral_value(rounding="ROUND_HALF_UP"))
                else:
                    out_np[i] = float(d)
            return out_np, valid
        if fk == TypeKind.DATE and tk == TypeKind.TIMESTAMP:
            return a.astype(np.int64) * 86_400_000_000, valid
        if fk == TypeKind.TIMESTAMP and tk == TypeKind.DATE:
            return np.floor_divide(a.astype(np.int64), 86_400_000_000).astype(np.int32), valid
        with np.errstate(invalid="ignore"):
            if tk in _INT_KINDS and fk in (TypeKind.FLOAT32, TypeKind.FLOAT64):
                out = np.rint(a).astype(to.np_dtype)  # PG rounds half away? uses rint
            else:
                out = a.astype(to.np_dtype)
        return out, valid

    ts_date = to.kind == TypeKind.DATE and frm.kind == TypeKind.TIMESTAMP
    date_ts = to.kind == TypeKind.TIMESTAMP and frm.kind == TypeKind.DATE

    def device(ret, vals, valids):
        (a,) = vals
        ok = X.ones_like(a)
        if ts_date:
            return X.ts_to_date(a), ok
        if date_ts:
            return X.date_to_ts(a), ok
        return X.cast(X.TORCH_OF[X.code_of_np(to.device_dtype)], a), ok

    def lower(b, ret, args):
        (a,) = args
        if ts_date:
            lower_as(b, a, X.T_I64)
            return b.op(X.OP_TS2DATE, X.T_I32, 1, X.T_I32)
        got = a.lower(b)
        if date_ts:
            return b.op(X.OP_DATE2TS, X.T_I64, 1, X.T_I64)
        tc = X.code_of_np(to.device_dtype)
        return tc if got == tc else b.op(X.OP_CAST, tc, 1, tc, imm=got)

    fixed = to.is_fixed_width and frm.is_fixed_width
    return FuncSig("cast", host, device if fixed else None,
                   lower=lower if fixed else None)


# ---------------------------------------------------------------------------
# Temporal helpers (host)
# ---------------------------------------------------------------------------

_EPOCH_DAY_USECS = 86_400_000_000


def _ts_to_str(usecs: int) -> str:
    import datetime
    dt = datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(usecs))
    if dt.microsecond:
        return dt.strftime("%Y-%m-%d %H:%M:%S.%f").rstrip("0")
    return dt.strftime("%Y-%m-%d %H:%M:%S")


def _date_to_str(days: int) -> str:
    import datetime
    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))
    return d.isoformat()


def _str_to_ts(s: str) -> int:
    import datetime
    s = s.strip().replace("T", " ")
    for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            dt = datetime.datetime.strptime(s, fmt)
            delta = dt - datetime.datetime(1970, 1, 1)
            return int(delta.total_seconds() * 1_000_000) + 0
        except ValueError:
            continue
    raise ValueError(f"invalid timestamp {s!r}")


def _str_to_date(s: str) -> int:
    import datetime
    d = datetime.date.fromisoformat(s.strip())
    return (d - datetime.date(1970, 1, 1)).days


_EXTRACT_FIELDS = ("epoch", "year", "month", "day", "hour", "minute", "second",
                   "dow", "doy", "quarter", "week", "millennium", "century",
                   "decade", "milliseconds", "microseconds")


def _extract_host(ret, values, valids, n):
    field_arr, ts = values
    out = np.empty(n, dtype=object)
    import datetime
    for i in range(n):
        f = str(field_arr[i]).lower() if field_arr[i] is not None else None
        if f is None:
            out[i] = None
            continue
        dt = datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(ts[i]))
        if f == "epoch":
            out[i] = Decimal(int(ts[i])) / Decimal(1_000_000)
        elif f == "year":
            out[i] = Decimal(dt.year)
        elif f == "month":
            out[i] = Decimal(dt.month)
        elif f == "day":
            out[i] = Decimal(dt.day)
        elif f == "hour":
            out[i] = Decimal(dt.hour)
        elif f == "minute":
            out[i] = Decimal(dt.minute)
        elif f == "second":
            out[i] = Decimal(dt.second) + Decimal(dt.microsecond) / Decimal(1_000_000)
        elif f == "dow":
            out[i] = Decimal((dt.weekday() + 1) % 7)
        elif f == "doy":
            out[i] = Decimal(dt.timetuple().tm_yday)
        elif f == "quarter":
            out[i] = Decimal((dt.month - 1) // 3 + 1)
        elif f == "week":
            out[i] = Decimal(dt.isocalendar()[1])
        else:
            out[i] = None
    valid = np.array([x is not None for x in out], dtype=np.bool_)
    return out, valid


_TRUNC_USECS = {
    "microseconds": 1, "milliseconds": 1_000, "second": 1_000_000,
    "minute": 60_000_000, "hour": 3_600_000_000, "day": _EPOCH_DAY_USECS,
    "week": 7 * _EPOCH_DAY_USECS,
}


def _date_trunc_host(ret, values, valids, n):
    field_arr, ts = values
    out = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=np.bool_)
    import datetime
    for i in range(n):
        f = str(field_arr[i]).lower()
        t = int(ts[i])
        if f in _TRUNC_USECS:
            unit = _TRUNC_USECS[f]
            if f == "week":
                # ISO week starts Monday; epoch (1970-01-01) was a Thursday
                out[i] = ((t + 3 * _EPOCH_DAY_USECS) // unit) * unit - 3 * _EPOCH_DAY_USECS
            else:
                out[i] = (t // unit) * unit
        elif f in ("month", "year", "quarter"):
            dt = datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=t)
            if f == "month":
                dt2 = datetime.datetime(dt.year, dt.month, 1)
            elif f == "quarter":
                dt2 = datetime.datetime(dt.year, (dt.month - 1) // 3 * 3 + 1, 1)
            else:
                dt2 = datetime.datetime(dt.year, 1, 1)
            out[i] = int((dt2 - datetime.datetime(1970, 1, 1)).total_seconds() * 1e6)
        else:
            valid[i] = False
    return out, valid


def _tumble_start_host(ret, values, valids, n):
    ts, win = values
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        w = win[i].total_usecs_approx() if isinstance(win[i], Interval) else int(win[i])
        out[i] = (int(ts[i]) // w) * w
    return out, np.ones(n, dtype=np.bool_)


# ---------------------------------------------------------------------------
# Strings
# ---------------------------------------------------------------------------

def _str1(f):
    def host(ret, values, valids, n):
        (a,) = values
        if ret.np_dtype == np.dtype(object):
            out = np.empty(n, dtype=object)
            for i in range(n):
                out[i] = f(a[i]) if a[i] is not None else None
        else:
            out = np.zeros(n, dtype=ret.np_dtype)
            for i in range(n):
                if a[i] is not None:
                    out[i] = f(a[i])
        return out, np.ones(n, dtype=np.bool_)
    return host


def _like_host(ret, values, valids, n):
    import re
    a, pat = values
    out = np.zeros(n, dtype=np.bool_)
    cache: Dict[str, Any] = {}
    for i in range(n):
        if a[i] is None or pat[i] is None:
            continue
        p = pat[i]
        rx = cache.get(p)
        if rx is None:
            rx = re.compile("^" + re.escape(p).replace("%", ".*").replace("_", ".")
                            .replace("\\%", "%").replace("\\_", "_") + "$", re.S)
            cache[p] = rx
        out[i] = rx.match(a[i]) is not None
    return out, np.ones(n, dtype=np.bool_)


def _substr_host(ret, values, valids, n):
    out = np.empty(n, dtype=object)
    if len(values) == 2:
        a, start = values
        for i in range(n):
            if a[i] is None:
                out[i] = None
            else:
                s = max(int(start[i]) - 1, 0)
                out[i] = a[i][s:]
    else:
        a, start, length = values
        for i in range(n):
            if a[i] is None:
                out[i] = None
            else:
                st = int(start[i]) - 1
                ln = int(length[i])
                end = st + ln
                st = max(st, 0)
                out[i] = a[i][st:max(end, st)]
    return out, np.ones(n, dtype=np.bool_)


def _concat_host(ret, values, valids, n):
    out = np.empty(n, dtype=object)
    for i in range(n):
        parts = [str(v[i]) for v in values if v[i] is not None]
        out[i] = "".join(parts)
    return out, np.ones(n, dtype=np.bool_)


def _concat_op_host(ret, values, valids, n):
    a, b = values
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = (str(a[i]) + str(b[i])) if a[i] is not None and b[i] is not None else None
    return out, np.ones(n, dtype=np.bool_)


def _split_part_host(ret, values, valids, n):
    a, delim, idx = values
    out = np.empty(n, dtype=object)
    for i in range(n):
        if a[i] is None or delim[i] is None:
            out[i] = None
            continue
        parts = str(a[i]).split(str(delim[i])) if delim[i] else [a[i]]
        k = int(idx[i])
        if k < 0:
            k = len(parts) + k + 1
        out[i] = parts[k - 1] if 1 <= k <= len(parts) else ""
    return out, np.ones(n, dtype=np.bool_)


_TO_CHAR_FIELDS = [
    # (pattern, formatter) — longest first; numeric patterns are
    # case-insensitive like Postgres (`to_char` datetime templates)
    ("YYYY", lambda d: f"{d.year:04d}"),
    ("HH24", lambda d: f"{d.hour:02d}"),
    ("HH12", lambda d: f"{(d.hour % 12) or 12:02d}"),
    ("MM", lambda d: f"{d.month:02d}"),
    ("DD", lambda d: f"{d.day:02d}"),
    ("HH", lambda d: f"{(d.hour % 12) or 12:02d}"),
    ("MI", lambda d: f"{d.minute:02d}"),
    ("SS", lambda d: f"{d.second:02d}"),
    ("MS", lambda d: f"{d.microsecond // 1000:03d}"),
    ("US", lambda d: f"{d.microsecond:06d}"),
    ("AM", lambda d: "AM" if d.hour < 12 else "PM"),
    ("PM", lambda d: "AM" if d.hour < 12 else "PM"),
    ("am", lambda d: "am" if d.hour < 12 else "pm"),
    ("pm", lambda d: "am" if d.hour < 12 else "pm"),
]
_TO_CHAR_CACHE: Dict[str, List] = {}


def _to_char_compile(fmt: str):
    prog = _TO_CHAR_CACHE.get(fmt)
    if prog is None:
        prog = []
        i = 0
        while i < len(fmt):
            for pat, f in _TO_CHAR_FIELDS:
                if fmt[i:i + len(pat)].upper() == pat.upper() \
                        and (pat not in ("AM", "PM", "am", "pm")
                             or fmt[i:i + 2] == pat):
                    prog.append(f)
                    i += len(pat)
                    break
            else:
                prog.append(fmt[i])
                i += 1
        _TO_CHAR_CACHE[fmt] = prog
    return prog


def _to_char_host(ret, values, valids, n):
    import datetime
    ts, fmt = values
    out = np.empty(n, dtype=object)
    epoch = datetime.datetime(1970, 1, 1)
    for i in range(n):
        if fmt[i] is None:
            out[i] = None
            continue
        d = epoch + datetime.timedelta(microseconds=int(ts[i]))
        out[i] = "".join(p if isinstance(p, str) else p(d)
                         for p in _to_char_compile(str(fmt[i])))
    return out, np.ones(n, dtype=np.bool_)


def _regexp_match_idx_host(ret, values, valids, n):
    """regexp_match(s, pat)[k] — group k of the match (1-based, like the
    PG array over capture groups); NULL when no match / group empty."""
    import re
    s, pat, idx = values
    out = np.empty(n, dtype=object)
    cache: Dict[str, Any] = {}
    for i in range(n):
        if s[i] is None or pat[i] is None:
            out[i] = None
            continue
        p = str(pat[i])
        rx = cache.get(p)
        if rx is None:
            rx = cache[p] = re.compile(p)
        m = rx.search(str(s[i]))
        k = int(idx[i])
        out[i] = (m.group(k) if m is not None and 0 < k <= rx.groups
                  else None)
    valid = np.array([x is not None for x in out], dtype=np.bool_)
    return out, valid


# ---------------------------------------------------------------------------
# UDFs (the reference's embedded-Python flavor, udf/python.rs): registered
# by CREATE FUNCTION ... LANGUAGE python; host eval is a row loop over the
# chunk. The registry is process-global (DDL-logged, so recovery
# re-registers); CREATE OR REPLACE overwrites.
# ---------------------------------------------------------------------------

class UserFunc:
    def __init__(self, name: str, fn: Callable, arg_types: List[DataType],
                 return_type: DataType):
        self.name = name
        self.fn = fn
        self.arg_types = arg_types
        self.return_type = return_type


UDF_REGISTRY: Dict[str, UserFunc] = {}


def register_python_udf(name: str, body: str, arg_types: List[DataType],
                        return_type: DataType, replace: bool = False) -> None:
    if name.lower() in UDF_REGISTRY and not replace:
        raise ValueError(f"function {name!r} already exists")
    ns: Dict[str, Any] = {}
    exec(body, ns)                      # noqa: S102 — user-supplied UDF body
    fn = ns.get(name)
    if not callable(fn):
        fns = [v for v in ns.values() if callable(v)
               and getattr(v, "__module__", None) is None]
        if len(fns) == 1:
            fn = fns[0]
        else:
            raise ValueError(
                f"LANGUAGE python body must define a function {name!r}")
    UDF_REGISTRY[name.lower()] = UserFunc(name, fn, arg_types, return_type)


def _udf_host(udf: UserFunc):
    def host(ret, values, valids, n):
        out = np.empty(n, dtype=object)
        for i in range(n):
            args = [v[i] for v in values]
            try:
                out[i] = udf.fn(*args)
            except Exception:       # noqa: BLE001 — UDF errors become NULL
                out[i] = None       # (the reference's non-strict wrapper)
        valid = np.array([x is not None for x in out], dtype=np.bool_)
        if ret.np_dtype is not None and ret.np_dtype != np.dtype(object):
            fixed = np.zeros(n, dtype=ret.np_dtype)
            for i in range(n):
                if valid[i]:
                    try:
                        fixed[i] = out[i]
                    except (TypeError, ValueError, OverflowError):
                        valid[i] = False   # uncoercible result -> NULL
            return fixed, valid
        return out, valid
    return host


# ---------------------------------------------------------------------------
# Math (fixed-width, device-capable)
# ---------------------------------------------------------------------------

def _make_math1(np_f, jnp_name):
    def host(ret, values, valids, n):
        (a,) = values
        if ret.kind == TypeKind.DECIMAL:
            out = np.empty(n, dtype=object)
            for i in range(n):
                v = _to_decimal(a[i])
                if v is None:
                    out[i] = None
                elif np_f is np.abs:
                    out[i] = abs(v)
                elif np_f is np.floor:
                    out[i] = v.to_integral_value(rounding="ROUND_FLOOR")
                elif np_f is np.ceil:
                    out[i] = v.to_integral_value(rounding="ROUND_CEILING")
                elif np_f is np.round:
                    out[i] = v.to_integral_value(rounding="ROUND_HALF_UP")
                else:
                    out[i] = _to_decimal(float(np_f(float(v))))
            return out, np.ones(n, dtype=np.bool_)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = np_f(a.astype(np.float64) if not np.issubdtype(a.dtype, np.integer) or np_f not in (np.abs,) else a)
        valid = ~(np.isnan(out) if np.issubdtype(np.asarray(out).dtype, np.floating) else np.zeros(n, dtype=np.bool_))
        return out.astype(ret.np_dtype), valid

    op = X.MATH1_OPS[jnp_name]

    def device(ret, vals, valids):
        (a,) = vals
        return (X.math1(op, X.TORCH_OF[X.code_of_np(ret.device_dtype)], a),
                X.ones_like(a))

    def lower(b, ret, args):
        (a,) = args
        t = X.code_of_np(ret.device_dtype)
        if t in X.FLOATS:
            lower_as(b, a, t)
            return b.op(op, t, 1, t)
        got = a.lower(b)
        if X.T_BOOL in (got, t):
            raise ValueError(f"expr_eval: no opcode for {jnp_name} of a "
                             "boolean")
        if op == X.OP_ABS:
            got = b.op(op, got, 1, got)
        # floor / ceil / round of an integer is the integer
        return got if got == t else b.op(X.OP_CAST, t, 1, t, imm=got)

    return host, device, lower


# ---------------------------------------------------------------------------
# Registry + resolver
# ---------------------------------------------------------------------------

_ARITH_NAMES = {"add": "+", "subtract": "-", "multiply": "*", "divide": "/",
                "modulus": "%"}
_CMP_NAMES = set(_CMP)

_STRING_FUNCS: Dict[str, Tuple[Callable, DataType]] = {}


def _register_strings():
    _STRING_FUNCS.update({
        "lower": (_str1(lambda s: s.lower()), T.VARCHAR),
        "upper": (_str1(lambda s: s.upper()), T.VARCHAR),
        "length": (_str1(len), T.INT32),
        "char_length": (_str1(len), T.INT32),
        "trim": (_str1(lambda s: s.strip()), T.VARCHAR),
        "ltrim": (_str1(lambda s: s.lstrip()), T.VARCHAR),
        "rtrim": (_str1(lambda s: s.rstrip()), T.VARCHAR),
        "initcap": (_str1(lambda s: s.title()), T.VARCHAR),
        "reverse": (_str1(lambda s: s[::-1]), T.VARCHAR),
        "md5": (_str1(lambda s: __import__("hashlib").md5(s.encode()).hexdigest()), T.VARCHAR),
        "bit_length": (_str1(lambda s: len(s.encode()) * 8), T.INT32),
        "octet_length": (_str1(lambda s: len(s.encode())), T.INT32),
        "ascii": (_str1(lambda s: ord(s[0]) if s else 0), T.INT32),
    })


_register_strings()

_MATH1 = {
    "abs": (np.abs, "abs"), "floor": (np.floor, "floor"), "ceil": (np.ceil, "ceil"),
    "ceiling": (np.ceil, "ceil"), "round": (np.round, "round"),
    "sqrt": (np.sqrt, "sqrt"), "exp": (np.exp, "exp"), "ln": (np.log, "log"),
    "log10": (np.log10, "log10"), "sin": (np.sin, "sin"), "cos": (np.cos, "cos"),
    "tan": (np.tan, "tan"),
}


def _lower_neg(b, ret, args):
    got = args[0].lower(b)
    if got == X.T_BOOL:
        raise ValueError("expr_eval: no opcode for neg of a boolean")
    return b.op(X.OP_NEG, got, 1, got)


def _lower_tumble(b, ret, args):
    # jnp promotes (ts, w) to their common type: int64 here
    if max(b.type_of(a) for a in args) != X.T_I64:
        raise ValueError("expr_eval: tumble_start computes in int64 only")
    for a in args:
        lower_as(b, a, X.T_I64)
    return b.op(X.OP_TUMBLE, X.T_I64, 2, X.T_I64)


def _lower_power(b, ret, args):
    for a in args:
        lower_as(b, a, X.T_F64)
    return b.op(X.OP_POW, X.T_F64, 2, X.T_F64)


def build_func(name: str, args: List[Expr]) -> Expr:
    """Resolve name(args) to an executable Expr, inserting implicit casts.
    Raises ValueError for unknown/invalid signatures (binder surface)."""
    name = name.lower()
    ats = [a.return_type for a in args]

    if name in ("and", "or"):
        host = _and_host if name == "and" else _or_host
        dev = _and_device if name == "and" else _or_device
        sig = FuncSig(name, host, dev, strict=False,
                      lower=_lower_bool(X.OP_AND if name == "and"
                                        else X.OP_OR))
        return FunctionCall(name, args, T.BOOLEAN, sig)
    if name == "not":
        return FunctionCall(name, args, T.BOOLEAN, FuncSig(
            name, _not_host, lambda r, v, ok: (X.not1(v[0]), ok[0]),
            lower=_lower_bool(X.OP_NOT)))
    if name in ("is_null", "is_not_null"):
        return IsNull(args[0], negated=(name == "is_not_null"))
    if name == "coalesce":
        ret = next((t for t in ats if t.kind != TypeKind.VARCHAR or True), ats[0])
        return Coalesce(args, ats[0])
    if name == "neg":
        ret = ats[0]
        return FunctionCall(name, args, ret, FuncSig(
            name, _neg_host, lambda r, v, ok: (-v[0], ok[0]), lower=_lower_neg))
    if name in _ARITH_NAMES:
        a, b = ats
        # timestamp/interval arithmetic
        if a.kind == TypeKind.TIMESTAMP and b.kind == TypeKind.INTERVAL:
            return _ts_interval_arith(name, args)
        if a.kind == TypeKind.INTERVAL and b.kind == TypeKind.TIMESTAMP and name == "add":
            return _ts_interval_arith(name, [args[1], args[0]])
        if not (a.is_numeric and b.is_numeric):
            raise ValueError(f"cannot {name} {a} and {b}")
        ret = promote_numeric(a, b)
        if name == "divide" and ret.kind in _INT_KINDS:
            pass  # PG integer division yields integer
        host, dev, low = _make_arith(name)
        cargs = [cast(x, ret) if x.return_type.kind != ret.kind else x for x in args]
        return FunctionCall(name, cargs, ret, FuncSig(name, host, dev, lower=low))
    if name in _CMP_NAMES:
        a, b = ats
        if a.kind == b.kind:
            operand = a
        elif a.is_numeric and b.is_numeric:
            operand = promote_numeric(a, b)
        elif {a.kind, b.kind} <= {TypeKind.TIMESTAMP, TypeKind.DATE}:
            operand = T.TIMESTAMP
        elif TypeKind.VARCHAR in (a.kind, b.kind):
            operand = a if b.kind == TypeKind.VARCHAR else b
        else:
            raise ValueError(f"cannot compare {a} and {b}")
        cargs = [cast(x, operand) if x.return_type.kind != operand.kind else x
                 for x in args]
        host, dev, low = _make_cmp(name, operand.kind)
        if not operand.is_fixed_width:
            dev = low = None
        return FunctionCall(name, cargs, T.BOOLEAN, FuncSig(name, host, dev, lower=low))
    if name in _STRING_FUNCS and len(args) == 1:
        host, ret = _STRING_FUNCS[name]
        return FunctionCall(name, args, ret, FuncSig(name, host, None))
    if name == "substr" or name == "substring":
        return FunctionCall(name, args, T.VARCHAR, FuncSig(name, _substr_host, None))
    if name == "like":
        return FunctionCall(name, args, T.BOOLEAN, FuncSig(name, _like_host, None))
    if name == "concat":
        return FunctionCall(name, args, T.VARCHAR,
                            FuncSig(name, _concat_host, None, strict=False))
    if name == "concat_op":
        return FunctionCall(name, args, T.VARCHAR, FuncSig(name, _concat_op_host, None))
    if name == "split_part":
        return FunctionCall(name, args, T.VARCHAR, FuncSig(name, _split_part_host, None))
    if name == "extract":
        return FunctionCall(name, args, T.DECIMAL, FuncSig(name, _extract_host, None))
    if name == "date_trunc":
        return FunctionCall(name, args, T.TIMESTAMP, FuncSig(name, _date_trunc_host, None))
    if name == "tumble_start":
        def dev(ret, vals, ok):
            ts, w = vals
            return X.tumble_start(ts, w), ok[0]
        fixed = args[1].return_type.is_fixed_width
        return FunctionCall(name, args, T.TIMESTAMP,
                            FuncSig(name, _tumble_start_host,
                                    dev if fixed else None,
                                    lower=_lower_tumble if fixed else None))
    if name in _MATH1 and len(args) == 1:
        np_f, jnp_name = _MATH1[name]
        ret = ats[0]
        if name in ("sqrt", "exp", "ln", "log10", "sin", "cos", "tan"):
            ret = T.FLOAT64
        host, dev, low = _make_math1(np_f, jnp_name)
        return FunctionCall(name, args, ret, FuncSig(name, host, dev, lower=low))
    if name == "power" or name == "pow":
        def host(ret, values, valids, n):
            a, b = values
            with np.errstate(invalid="ignore", over="ignore"):
                out = np.power(a.astype(np.float64), b.astype(np.float64))
            return out, ~np.isnan(out)
        def dev(ret, vals, ok):
            return X.power(*vals), ok[0] & ok[1]
        return FunctionCall(name, args, T.FLOAT64,
                            FuncSig(name, host, dev, lower=_lower_power))
    if name == "to_char":
        return FunctionCall(name, args, T.VARCHAR,
                            FuncSig(name, _to_char_host, None))
    if name == "regexp_match_idx":
        return FunctionCall(name, args, T.VARCHAR,
                            FuncSig(name, _regexp_match_idx_host, None,
                                    strict=False))
    if name in UDF_REGISTRY:
        udf = UDF_REGISTRY[name]
        if len(args) != len(udf.arg_types):
            raise ValueError(f"function {name} takes {len(udf.arg_types)} "
                             f"arguments, got {len(args)}")
        return FunctionCall(name, args, udf.return_type,
                            FuncSig(name, _udf_host(udf), None))
    if name in ("greatest", "least"):
        op = "greater_than" if name == "greatest" else "less_than"
        expr = args[0]
        for nxt in args[1:]:
            cond = build_func(op, [nxt, expr])
            expr = Case([(cond, nxt)], expr, promote_numeric(expr.return_type, nxt.return_type)
                        if expr.return_type.is_numeric and nxt.return_type.is_numeric
                        else expr.return_type)
        return expr
    raise ValueError(f"unknown function {name}({', '.join(map(str, ats))})")


def _ts_interval_arith(name: str, args: List[Expr]) -> Expr:
    def host(ret, values, valids, n):
        ts, iv = values
        out = np.zeros(n, dtype=np.int64)
        import datetime
        for i in range(n):
            v = iv[i]
            if v is None:
                continue
            if v.months == 0:
                delta = (v.days * _EPOCH_DAY_USECS + v.usecs)
                out[i] = int(ts[i]) + (delta if name == "add" else -delta)
            else:
                dt = datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(ts[i]))
                months = v.months if name == "add" else -v.months
                y, m = divmod(dt.month - 1 + months, 12)
                try:
                    dt = dt.replace(year=dt.year + y, month=m + 1)
                except ValueError:
                    import calendar
                    last = calendar.monthrange(dt.year + y, m + 1)[1]
                    dt = dt.replace(year=dt.year + y, month=m + 1, day=last)
                delta = v.days * _EPOCH_DAY_USECS + v.usecs
                base = int((dt - datetime.datetime(1970, 1, 1)).total_seconds() * 1e6)
                out[i] = base + (delta if name == "add" else -delta)
        return out, np.ones(n, dtype=np.bool_)
    return FunctionCall(f"ts_{name}_interval", args, T.TIMESTAMP,
                        FuncSig(name, host, None))


def cast(expr: Expr, to: DataType) -> Expr:
    """Explicit/implicit cast node."""
    frm = expr.return_type
    if frm.kind == to.kind:
        return expr
    if isinstance(expr, Literal):
        # constant-fold simple literal casts for device-friendliness
        col = Column.from_list(frm, [expr.value])
        sig = _cast_host(to, frm)
        out, valid = sig.host(to, [col.values], [col.validity], 1)
        if valid[0] and expr.value is not None:
            v = out[0]
            return Literal(v.item() if isinstance(v, np.generic) else v, to)
    return FunctionCall("cast", [expr], to, _cast_host(to, frm))
