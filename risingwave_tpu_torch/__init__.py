"""risingwave_tpu_torch — the streaming engine's device path on PyTorch/CUDA.

A port of `risingwave_tpu` (JAX) to PyTorch on one NVIDIA H100. It keeps
the JAX package's layout and names so each module's counterpart is easy
to find, and imports neither `jax` nor `risingwave_tpu`: importing any
module of the JAX package configures JAX, so what the port needs from
there it keeps as its own copy.

  core/        types, columnar chunks (a torch DeviceChunk), schema,
               epochs, encodings, vnode hashing, the Arrow seam
  connectors/  Nexmark generator constants and string pools
  expr/        expression trees (host eval, device halves, lowering),
               the function resolver, aggregate host state
  device/      sorted-run state, the agg, join and MV steps, the
               on-device Nexmark generator, state tiering, host ingest,
               and the fused epoch program
  kernels/     hand-written CUDA kernels, each beside its plain PyTorch
               version
  native/      the C++ host kernels (the vnode CRC32, the memcomparable
               int64), built by g++ at first use and loaded with ctypes
  ops/, state/, runtime/, parallel/
               host and device executors, state stores, stream jobs,
               worker-process placement (the socket exchange, the
               workers, their supervisor), the mesh of shards
  config.py    node, device, robustness and session configuration
  utils/       failpoints, metrics, the overload plane, and the
               observability planes: barrier trace, flight recorder,
               epoch profile, freshness, trace export
  serving/     the epoch-versioned MV read cache

Entry points run on `cuda:0` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
