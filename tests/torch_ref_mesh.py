"""The JAX package's mesh path, runnable as an oracle for the port.

`risingwave_tpu/device/shard_exec.py` calls `shard_map(...,
check_rep=False)`; the installed jax (0.9) names that argument
`check_vma`, so every sharded fused program of the reference raises a
TypeError at trace time. `ref_mesh()` is a context manager that, for its
duration only, replaces the module attribute
`risingwave_tpu.device.shard_exec._shard_map` with a wrapper renaming the
argument. No file of the JAX package changes.

For the same duration `shard_exec.prewarm_exchange`, which a staged skew
policy calls on a background thread to compile the re-routed exchange
ahead of its switch, does nothing: XLA compiling on that thread beside
the main thread's sharded programs has crashed a worker process here
(a segmentation fault in the thread's `backend_compile_and_load`). The
pre-warm is advisory, so the reference then traces the re-routed
exchange inline at the switch, and its policy adopts at the checkpoint
after the stage, as the port's does; rows and routing are unchanged.

On exit it puts everything back as it was on entry: the attribute, and
every reference cache that can hold a program traced under the wrapper
(`_EXCH_JIT`, `_EXCH_AOT`, `_STEP_JIT`, `_GATHER_JIT`, the set of
inline-traced exchange keys, and the compile service's entries made for
a mesh; a compile service first made inside the block is shut down and
forgotten). The policy's background pre-warm threads and the compile
service's queue are drained first, so nothing traced under the wrapper
lands after it is gone. A JAX-package mesh test run later in the same
process therefore meets exactly the state it would have met without the
shim (its own `check_rep` failure included).

Use it around one test or one mirror case, or as a module-scoped
fixture around one test module's cases (pytest ends the block before it
runs a test of another module), never at import time and never from
`tests/conftest.py`: either would change the JAX package's own mesh
tests in the same worker process.
"""
from __future__ import annotations

import contextlib

CACHES = ("_EXCH_JIT", "_EXCH_AOT", "_STEP_JIT", "_GATHER_JIT",
          "_EXCH_INLINE")


def _rename(orig):
    def shard_map(f=None, /, *args, check_rep=None, **kw):
        if check_rep is not None:
            kw.setdefault("check_vma", check_rep)
        return orig(f, *args, **kw)
    shard_map.__wrapped__ = orig
    return shard_map


def _no_prewarm(*args, **kw) -> None:
    """The policy's exchange pre-warm, skipped (see the module
    docstring)."""


def _service():
    """The reference's compile service if one was made, else None (the
    shim never makes one)."""
    from risingwave_tpu.device import compile_service as cs
    return cs._SERVICE


def snapshot():
    """What the shim must leave as it found it: the attribute and a copy
    of each cache and of the compile service's entry keys."""
    import risingwave_tpu.device.shard_exec as SE
    svc = _service()
    return {"_shard_map": SE._shard_map,
            "prewarm_exchange": SE.prewarm_exchange,
            "caches": {n: (getattr(SE, n), type(getattr(SE, n))(
                getattr(SE, n))) for n in CACHES},
            "service": (svc, set(svc._entries) if svc is not None
                        else None)}


def _restore(snap) -> None:
    import risingwave_tpu.device.shard_exec as SE
    from risingwave_tpu.device.fused import join_prewarm_threads
    # nothing traced under the wrapper may land after it is gone
    join_prewarm_threads(timeout=120.0)
    svc = _service()
    if svc is not None:
        svc.wait_idle(120.0)
    SE._shard_map = snap["_shard_map"]
    SE.prewarm_exchange = snap["prewarm_exchange"]
    for name, (obj, saved) in snap["caches"].items():
        obj.clear()
        obj.update(saved)
    old_svc, old_keys = snap["service"]
    if svc is not None and svc is not old_svc:
        # made inside the block: stop its workers and forget it, as the
        # process had none before
        from risingwave_tpu.device import compile_service as cs
        svc.shutdown(join=True, timeout=120.0)
        with cs._SERVICE_LOCK:
            cs._SERVICE = old_svc
    elif svc is not None:
        with svc._lock:
            for k in [k for k, e in svc._entries.items()
                      if k not in old_keys and e.mesh is not None]:
                del svc._entries[k]


@contextlib.contextmanager
def ref_mesh():
    """The JAX package's sharded programs traceable under the installed
    jax for the duration of the block (see the module docstring)."""
    import risingwave_tpu.device.shard_exec as SE
    snap = snapshot()
    SE._shard_map = _rename(snap["_shard_map"])
    SE.prewarm_exchange = _no_prewarm
    try:
        yield
    finally:
        _restore(snap)
