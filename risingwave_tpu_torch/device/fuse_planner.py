"""What the fuse planner adds to a node graph (the port's own copy of part
of `risingwave_tpu/device/fuse_planner.py`):

* `_TsShift`: `ts +/- INTERVAL const`, which the planner rewrites from
  `ts_*_interval` calls because the host registers those without a
  device half (Nexmark q7's `date_time BETWEEN window_end - INTERVAL '10'
  SECOND AND window_end`);
* `arm_telemetry`: the key-skew and flow telemetry the planner arms on
  every keyed node, on by default as in the reference's `DeviceConfig`.

The planner itself — SQL plan to fused node graph — is still to be
ported.
"""
from __future__ import annotations

from typing import Sequence

from ..core import dtypes as T
from ..expr.expression import Expr


def arm_telemetry(nodes: Sequence, skew: bool = True,
                  flow: bool = True) -> None:
    """Arm skew (occupancy + heavy hitters) and flow (traffic) telemetry
    on every keyed node, before the FusedProgram is built: the slots
    extend the stat layout, skew's before flow's. Un-keyed nodes ignore
    it."""
    for node in nodes:
        if skew:
            node.enable_skew()
        if flow:
            node.enable_flow()


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
