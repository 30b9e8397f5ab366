"""Device-lowered expressions the fuse planner introduces (the port's own
copy of part of `risingwave_tpu/device/fuse_planner.py`).

Only `_TsShift` for now: `ts +/- INTERVAL const`, which the planner
rewrites from `ts_*_interval` calls because the host registers those
without a device half (Nexmark q7's `date_time BETWEEN window_end -
INTERVAL '10' SECOND AND window_end`). The planner itself — SQL plan to
fused node graph — is still to be ported.
"""
from __future__ import annotations

from ..core import dtypes as T
from ..expr.expression import Expr


class _TsShift(Expr):
    """ts +/- a constant number of microseconds, evaluated on device."""

    def __init__(self, arg: Expr, delta_usecs: int):
        self.arg = arg
        self.delta = int(delta_usecs)
        self.return_type = T.TIMESTAMP

    def children(self):
        return [self.arg]

    def eval_device(self, cols):
        v, ok = self.arg.eval_device(cols)
        return v + self.delta, ok

    def __repr__(self):
        return f"ts_shift({self.arg!r}, {self.delta})"
