"""Aggregate functions with retractable state.

Re-design of `AggregateFunction` (`src/expr/core/src/aggregate/mod.rs:39`) and
the retractable builder (`:136`): every aggregate consumes `(sign, value)`
pairs where sign ∈ {+1, -1} from the Op tag, so deletions/updates retract.

min/max keep a value→count multiset (the host analog of the reference's
`MaterializedInput` ordered state, `src/stream/src/executor/aggregate/minput.rs`)
so retraction of the current extremum recovers the next one exactly.

The port's own copy of the JAX package's `expr/agg.py` (host state; the
device path's aggregates are `device/agg_step.py` over sorted runs).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from decimal import Decimal
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.dtypes import DataType, TypeKind
from ..core import dtypes as T
from .expression import Expr


@dataclass
class AggCall:
    """One aggregate call in a plan: kind(args) [DISTINCT] [FILTER]."""
    kind: str                       # count/sum/min/max/avg/...
    arg: Optional[Expr] = None      # None for count(*)
    distinct: bool = False
    filter: Optional[Expr] = None
    return_type: DataType = T.INT64
    # ordered-set direct args (approx_percentile: (quantile, rel_error))
    direct_args: tuple = ()

    def __post_init__(self):
        if self.kind == "approx_percentile":
            self.return_type = T.FLOAT64
        elif self.kind == "count":
            self.return_type = T.INT64
        elif self.arg is not None:
            at = self.arg.return_type
            if self.kind == "sum0":
                # type-preserving sum (the reference's `sum0`): merges
                # partial counts/sums in 2-phase aggregation without PG's
                # sum widening (sum of partial bigint counts stays bigint)
                self.return_type = at
            elif self.kind == "sum":
                # PG: sum(int) -> bigint, sum(bigint) -> numeric
                if at.kind in (TypeKind.INT16, TypeKind.INT32):
                    self.return_type = T.INT64
                elif at.kind == TypeKind.INT64:
                    self.return_type = T.DECIMAL
                elif at.kind == TypeKind.FLOAT32:
                    self.return_type = T.FLOAT32
                else:
                    self.return_type = at
            elif self.kind == "avg":
                self.return_type = (T.FLOAT64 if at.kind in
                                    (TypeKind.FLOAT32, TypeKind.FLOAT64) else T.DECIMAL)
            elif self.kind in ("min", "max", "first_value", "last_value"):
                self.return_type = at
            elif self.kind in ("bool_and", "bool_or"):
                self.return_type = T.BOOLEAN
            elif self.kind == "string_agg":
                self.return_type = T.VARCHAR


class AggState:
    """Per-group state; apply() consumes one (sign, value)."""

    def apply(self, sign: int, value: Any) -> None:
        raise NotImplementedError

    def output(self) -> Any:
        raise NotImplementedError


class CountState(AggState):
    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def apply(self, sign, value):
        # count(*) passes value=NOT_NULL sentinel; count(x) skips nulls upstream
        self.n += sign

    def output(self):
        return self.n


class SumState(AggState):
    __slots__ = ("acc", "n", "is_decimal")

    def __init__(self, is_decimal: bool):
        self.acc = Decimal(0) if is_decimal else 0
        self.n = 0
        self.is_decimal = is_decimal

    def apply(self, sign, value):
        if self.is_decimal and not isinstance(value, Decimal):
            value = Decimal(str(value)) if isinstance(value, float) else Decimal(int(value))
        self.acc += sign * value
        self.n += sign

    def output(self):
        return self.acc if self.n > 0 else None


class AvgState(SumState):
    def output(self):
        if self.n <= 0:
            return None
        if self.is_decimal:
            return self.acc / Decimal(self.n)
        return self.acc / self.n


class MinMaxState(AggState):
    """Multiset value→count; exact under retraction."""
    __slots__ = ("counts", "is_max")

    def __init__(self, is_max: bool):
        self.counts: Dict[Any, int] = {}
        self.is_max = is_max

    def apply(self, sign, value):
        c = self.counts.get(value, 0) + sign
        if c <= 0:
            self.counts.pop(value, None)
        else:
            self.counts[value] = c

    def output(self):
        if not self.counts:
            return None
        return max(self.counts) if self.is_max else min(self.counts)


class BoolState(AggState):
    __slots__ = ("true_n", "false_n", "is_and")

    def __init__(self, is_and: bool):
        self.true_n = 0
        self.false_n = 0
        self.is_and = is_and

    def apply(self, sign, value):
        if value:
            self.true_n += sign
        else:
            self.false_n += sign

    def output(self):
        if self.true_n + self.false_n <= 0:
            return None
        return self.false_n == 0 if self.is_and else self.true_n > 0


class FirstLastState(AggState):
    """first_value/last_value ordered by insertion seq (append-only exact;
    retractions drop matching value)."""
    __slots__ = ("items", "is_last", "seq")

    def __init__(self, is_last: bool):
        self.items: List[Tuple[int, Any]] = []
        self.is_last = is_last
        self.seq = 0

    def apply(self, sign, value):
        if sign > 0:
            self.items.append((self.seq, value))
            self.seq += 1
        else:
            for i, (_, v) in enumerate(self.items):
                if v == value:
                    del self.items[i]
                    break

    def output(self):
        if not self.items:
            return None
        return self.items[-1][1] if self.is_last else self.items[0][1]


class StringAggState(AggState):
    __slots__ = ("items", "sep", "seq")

    def __init__(self, sep: str = ","):
        self.items: List[Tuple[int, str]] = []
        self.sep = sep
        self.seq = 0

    def apply(self, sign, value):
        if sign > 0:
            self.items.append((self.seq, value))
            self.seq += 1
        else:
            for i, (_, v) in enumerate(self.items):
                if v == value:
                    del self.items[i]
                    break

    def output(self):
        if not self.items:
            return None
        return self.sep.join(v for _, v in self.items)


class ApproxCountDistinctState(AggState):
    """Exact multiset impl of approx_count_distinct (superset of the
    reference's accuracy contract)."""
    __slots__ = ("counts",)

    def __init__(self):
        self.counts: Dict[Any, int] = {}

    def apply(self, sign, value):
        c = self.counts.get(value, 0) + sign
        if c <= 0:
            self.counts.pop(value, None)
        else:
            self.counts[value] = c

    def output(self):
        return len(self.counts)


class ApproxPercentileState(AggState):
    """Log-bucket histogram percentile, exact to a relative error bound
    (`approx_percentile/local.rs:68` bucket = ceil(log_base |v|) with
    base = (1+e)/(1-e); `global_state.rs:305` output walk: negative
    buckets descending, zeros, positive ascending; approx value =
    ±2·base^i/(base+1)). Retraction = bucket-count decrement."""
    __slots__ = ("quantile", "base", "neg", "pos", "zeros", "total")

    def __init__(self, quantile: float, relative_error: float):
        if not 0.0 <= quantile <= 1.0:
            raise ValueError("approx_percentile quantile must be in [0, 1]")
        if not 0.0 < relative_error < 1.0:
            raise ValueError("approx_percentile relative_error must be "
                             "in (0, 1)")
        self.quantile = quantile
        self.base = (1.0 + relative_error) / (1.0 - relative_error)
        self.neg: Dict[int, int] = {}
        self.pos: Dict[int, int] = {}
        self.zeros = 0
        self.total = 0

    def _bucket(self, mag: float) -> int:
        import math
        return math.ceil(math.log(mag, self.base))

    def apply(self, sign, value):
        v = float(value)
        self.total += sign
        if v == 0.0:
            self.zeros += sign
            return
        side = self.neg if v < 0 else self.pos
        b = self._bucket(abs(v))
        c = side.get(b, 0) + sign
        if c <= 0:
            side.pop(b, None)
        else:
            side[b] = c

    def output(self):
        if self.total <= 0:
            return None
        want = int((self.total - 1) * self.quantile)
        acc = 0
        for b in sorted(self.neg, reverse=True):    # most negative first
            acc += self.neg[b]
            if acc > want:
                return -2.0 * self.base ** b / (self.base + 1.0)
        acc += self.zeros
        if acc > want:
            return 0.0
        for b in sorted(self.pos):
            acc += self.pos[b]
            if acc > want:
                return 2.0 * self.base ** b / (self.base + 1.0)
        return None


def create_agg_state(call: AggCall) -> AggState:
    k = call.kind
    if k == "count":
        return CountState()
    if k in ("sum", "sum0"):
        return SumState(call.return_type.kind == TypeKind.DECIMAL)
    if k == "avg":
        return AvgState(call.return_type.kind == TypeKind.DECIMAL)
    if k == "min":
        return MinMaxState(is_max=False)
    if k == "max":
        return MinMaxState(is_max=True)
    if k == "bool_and":
        return BoolState(is_and=True)
    if k == "bool_or":
        return BoolState(is_and=False)
    if k == "first_value":
        return FirstLastState(is_last=False)
    if k == "last_value":
        return FirstLastState(is_last=True)
    if k == "string_agg":
        return StringAggState()
    if k == "approx_count_distinct":
        return ApproxCountDistinctState()
    if k == "approx_percentile":
        q = call.direct_args[0] if call.direct_args else 0.5
        e = call.direct_args[1] if len(call.direct_args) > 1 else 0.01
        return ApproxPercentileState(q, e)
    raise ValueError(f"unknown aggregate {k}")


AGG_KINDS = {"count", "sum", "sum0", "avg", "min", "max", "bool_and",
             "bool_or", "first_value", "last_value", "string_agg",
             "approx_count_distinct", "approx_percentile"}

# Aggregates whose device (HBM slot) implementation is exact under retraction.
DEVICE_RETRACTABLE = {"count", "sum", "avg"}
# Aggregates exact on device only for append-only inputs.
DEVICE_APPEND_ONLY = {"min", "max"}


class DistinctDedup:
    """Per-(group, value) dedup for DISTINCT aggregates — the analog of
    `src/stream/src/executor/aggregate/distinct.rs`: forwards only the first
    insert / last delete of each value to the inner state."""

    __slots__ = ("counts",)

    def __init__(self):
        self.counts: Dict[Any, int] = {}

    def apply(self, sign: int, value: Any) -> int:
        """Returns the sign to forward to the inner agg state, or 0."""
        old = self.counts.get(value, 0)
        new = old + sign
        if new <= 0:
            self.counts.pop(value, None)
        else:
            self.counts[value] = new
        if old == 0 and new > 0:
            return 1
        if old > 0 and new == 0:
            return -1
        return 0
