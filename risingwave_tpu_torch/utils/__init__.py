"""Utilities (the port's own copies of the JAX package's `utils/`):

  failpoint.py  the failpoint registry
  metrics.py    the metrics registry (`REGISTRY`) and its cluster plane
  overload.py   pressure sensing (`PRESSURE`), the degradation ladder,
                source admission, the shed log, the SELECT gate and the
                per-database overload manager
  trace.py      the barrier tracer (`barrier_trace.jsonl`, `diagnose`)
  blackbox.py   the flight recorder (`RECORDER`) and its bundles
  profile.py    the fused jobs' epoch profiler (`epoch_profile.jsonl`)
  freshness.py  source-to-MV freshness (`mv_freshness_seconds`)
  export.py     the Chrome trace-event export of a data directory
"""
from .metrics import (REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry)

# `failpoint` stays the submodule, as in the JAX package:
# `from risingwave_tpu_torch.utils import failpoint as fp; fp.arm(...)`
__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry"]
