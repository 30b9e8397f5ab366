"""Device execution path on PyTorch.

State lives in device memory as sorted runs (`sorted_state.py`); every
epoch's delta is applied as sort + segment-reduce + merge + compact. The
four sorted-run cores run as hand-written CUDA kernels on the card
(`risingwave_tpu_torch/kernels`).

Integers are int64 keys and accumulators, int32 counts and signs, bool
masks and null flags, f64 for avg — the JAX package's x64 dtypes.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda:0` when none is given.

    There is no silent CPU fallback: with no argument and no GPU this
    raises. The CPU is used only when the caller passes `device="cpu"`.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "risingwave_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU explicitly")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev
