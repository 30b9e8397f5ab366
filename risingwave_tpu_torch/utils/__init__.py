"""Utilities: the failpoint registry, the metrics registry
(`metrics.py`) and the process-wide pressure board (`overload.py`). The
JAX package's trace, profile and the rest of its overload plumbing are
still to port."""
from .failpoint import (FailpointError, arm, armed, declare, disarm,
                        failpoint, reset)
from .metrics import (REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry)

__all__ = ["FailpointError", "arm", "armed", "declare", "disarm",
           "failpoint", "reset", "REGISTRY", "Counter", "Gauge",
           "Histogram", "MetricsRegistry"]
