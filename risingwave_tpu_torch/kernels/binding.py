"""Build and bind the sorted-run kernels (`csrc/sorted_runs.cu`).

The source has a plain C interface (`csrc/sorted_runs.h`) and no PyTorch
headers, so `nvcc` compiles it into a shared library in seconds; it is
loaded with ctypes. This module is the binding: it checks device, dtype,
contiguity and shape, allocates every output and the scratch with
`torch.empty` on the input's device, launches on the current stream and
raises when a launch is refused. Nothing here synchronises.

The library is built at first use, once per process, into
`build/torch_kernels/` at the repository root.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_kernels")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
MAX_COLS = 16
_MAX_ROWS = 1 << 31

_DTYPE = {torch.int64: 0, torch.int32: 1, torch.float64: 2, torch.bool: 3}


class RwCols(ctypes.Structure):
    """Mirror of `RwCols` in csrc/sorted_runs.h (passed by value)."""
    _fields_ = [("n", ctypes.c_int32),
                ("dtype", ctypes.c_int32 * MAX_COLS),
                ("kind", ctypes.c_int32 * MAX_COLS),
                ("fill", ctypes.c_int64 * MAX_COLS),
                ("a", ctypes.c_void_p * MAX_COLS),
                ("b", ctypes.c_void_p * MAX_COLS),
                ("out", ctypes.c_void_p * MAX_COLS)]


_LIB = None


def build() -> ctypes.CDLL:
    """Compile (once per process) and load the kernel library."""
    global _LIB
    if _LIB is None:
        from torch.utils.cpp_extension import CUDA_HOME
        nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, "librw_sorted_runs.so")
        subprocess.run([nvcc, *CUDA_FLAGS, "-std=c++17", "-shared",
                        "-Xcompiler", "-fPIC", "-I", CSRC, "-o", so,
                        os.path.join(CSRC, "sorted_runs.cu")], check=True)
        lib = ctypes.CDLL(so)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for fn in ("rw_sort_scratch_bytes", "rw_scan_scratch_bytes"):
            getattr(lib, fn).argtypes = [i64]
            getattr(lib, fn).restype = i64
        lib.rw_sort_perm.argtypes = [p, p, i64, p, p, p, p]
        lib.rw_batch_reduce.argtypes = [p, p, i64, RwCols, p, p, p, p]
        lib.rw_merge_combine.argtypes = [p, i64, p, i64, RwCols, i32, i32,
                                         p, p, p, p]
        lib.rw_compact_rows.argtypes = [p, i64, RwCols, i64, p, p, p]
        for fn in ("rw_sort_perm", "rw_batch_reduce", "rw_merge_combine",
                   "rw_compact_rows"):
            getattr(lib, fn).restype = i32
        _LIB = lib
    return _LIB


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# Launch sites, in the order of `RwSite` in csrc/sorted_runs.h (from 1).
SITES = ("k_flip_gather", "k_radix_hist", "k_tile_sums", "k_scan_sums",
         "k_tile_apply", "k_radix_scatter", "k_sort_out", "k_segments",
         "k_merge_place", "k_merge_combine", "k_compact_fill")
_SITE_STRIDE = 1024


def _check_rc(rc: int, what: str) -> None:
    """Raise for a refused launch, naming the kernel that was refused."""
    if rc != 0:
        site, err = divmod(rc, _SITE_STRIDE)
        kernel = SITES[site - 1] if 1 <= site <= len(SITES) else "?"
        raise RuntimeError(f"{what}: launch of {kernel} failed with "
                           f"cudaError {err}")


def _check_keys(k: torch.Tensor, what: str) -> None:
    if not k.is_cuda or k.dtype != torch.int64 or k.dim() != 1 \
            or not k.is_contiguous():
        raise ValueError(f"{what}: keys must be a contiguous 1-D int64 "
                         "CUDA tensor")
    if k.shape[0] >= _MAX_ROWS:
        raise ValueError(f"{what}: at most 2^31 rows")


def _check_col(t: torch.Tensor, n: int, like: torch.Tensor,
               what: str) -> None:
    if t.device != like.device:
        raise ValueError(f"{what}: on {t.device}, expected {like.device}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{what}: expected shape [{n}], got "
                         f"{list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if t.dtype not in _DTYPE:
        raise ValueError(f"{what}: dtype {t.dtype} is not one of int64, "
                         "int32, float64, bool")


def _cols(a: Sequence[torch.Tensor], kinds: Sequence[int],
          fills: Sequence[int]) -> RwCols:
    if len(a) > MAX_COLS:
        raise ValueError(f"at most {MAX_COLS} columns, got {len(a)}")
    c = RwCols()
    c.n = len(a)
    for j, t in enumerate(a):
        c.dtype[j] = _DTYPE[t.dtype]
        c.kind[j] = int(kinds[j])
        c.fill[j] = int(fills[j])
        c.a[j] = t.data_ptr()
    return c


def _scratch(nbytes: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(max(1, nbytes), dtype=torch.uint8, device=like.device)


def sort_perm(k1: torch.Tensor, k2: Optional[torch.Tensor]):
    """-> (perm int64[n], k1 in sorted order)."""
    _check_keys(k1, "sort_cols")
    n = k1.shape[0]
    if k2 is not None:
        _check_keys(k2, "sort_cols")
        _check_col(k2, n, k1, "sort_cols key 2")
    lib = build()
    perm = torch.empty(n, dtype=torch.int64, device=k1.device)
    sk = torch.empty(n, dtype=torch.int64, device=k1.device)
    ws = _scratch(lib.rw_sort_scratch_bytes(n), k1)
    _check_rc(lib.rw_sort_perm(k1.data_ptr(),
                               k2.data_ptr() if k2 is not None else None, n,
                               perm.data_ptr(), sk.data_ptr(), ws.data_ptr(),
                               _stream(k1)), "sort_cols")
    return perm, sk


def batch_reduce(sk: torch.Tensor, perm: torch.Tensor,
                 vals: Sequence[torch.Tensor], kinds: Sequence[int],
                 fills: Sequence[int]) -> List[torch.Tensor]:
    """Sorted keys + permutation + columns in original row order ->
    [ukeys, ucount, reduced columns...]."""
    _check_keys(sk, "batch_reduce")
    n = sk.shape[0]
    _check_col(perm, n, sk, "batch_reduce perm")
    if perm.dtype != torch.int64:
        raise ValueError("batch_reduce: perm must be int64")
    for v in vals:
        _check_col(v, n, sk, "batch_reduce column")
    lib = build()
    cols = _cols(vals, kinds, fills)
    ukeys = torch.empty(n, dtype=torch.int64, device=sk.device)
    ucount = torch.empty((), dtype=torch.int32, device=sk.device)
    outs = [torch.empty(n, dtype=v.dtype, device=v.device) for v in vals]
    for j, o in enumerate(outs):
        cols.out[j] = o.data_ptr()
    ws = _scratch(n * 4 + 256 + lib.rw_scan_scratch_bytes(n), sk)
    _check_rc(lib.rw_batch_reduce(sk.data_ptr(), perm.data_ptr(), n, cols,
                                  ukeys.data_ptr(), ucount.data_ptr(),
                                  ws.data_ptr(), _stream(sk)),
              "batch_reduce")
    return [ukeys, ucount] + outs


def merge_combine(skeys: torch.Tensor, svals: Sequence[torch.Tensor],
                  dkeys: torch.Tensor, dvals: Sequence[torch.Tensor],
                  kinds: Sequence[int], drop_dead: bool,
                  dead_col: int) -> List[torch.Tensor]:
    """-> [merged keys [c+b], alive flags, combined columns...]."""
    _check_keys(skeys, "merge state")
    _check_keys(dkeys, "merge delta")
    c, b = skeys.shape[0], dkeys.shape[0]
    n = c + b
    if n >= _MAX_ROWS:
        raise ValueError("merge: at most 2^31 rows")
    if dkeys.device != skeys.device:
        raise ValueError("merge: state and delta on different devices")
    if len(svals) != len(dvals):
        raise ValueError("merge: column count mismatch")
    if drop_dead and not 0 <= dead_col < len(svals):
        raise ValueError("merge: dead_col out of range")
    for sv, dv in zip(svals, dvals):
        _check_col(sv, c, skeys, "merge state column")
        _check_col(dv, b, skeys, "merge delta column")
        if dv.dtype != sv.dtype:
            raise ValueError("merge: delta column dtype differs from the "
                             "state's")
    lib = build()
    cols = _cols(svals, kinds, [0] * len(svals))
    for j, dv in enumerate(dvals):
        cols.b[j] = dv.data_ptr()
    dev = skeys.device
    mk = torch.empty(n, dtype=torch.int64, device=dev)
    alive = torch.empty(n, dtype=torch.bool, device=dev)
    src = torch.empty(n, dtype=torch.int32, device=dev)
    outs = [torch.empty(n, dtype=sv.dtype, device=dev) for sv in svals]
    for j, o in enumerate(outs):
        cols.out[j] = o.data_ptr()
    _check_rc(lib.rw_merge_combine(skeys.data_ptr(), c, dkeys.data_ptr(), b,
                                   cols, int(bool(drop_dead)), int(dead_col),
                                   mk.data_ptr(), alive.data_ptr(),
                                   src.data_ptr(), _stream(skeys)), "merge")
    return [mk, alive] + outs


def compact_rows(alive: torch.Tensor, cols_in: Sequence[torch.Tensor],
                 out_len: int, fills: Sequence[int]) -> List[torch.Tensor]:
    """-> [compacted columns [min(n, out_len)]..., total alive int32]."""
    if not alive.is_cuda or alive.dtype != torch.bool or alive.dim() != 1 \
            or not alive.is_contiguous():
        raise ValueError("compact_rows: alive must be a contiguous 1-D "
                         "CUDA bool tensor")
    n = alive.shape[0]
    if n >= _MAX_ROWS:
        raise ValueError("compact_rows: at most 2^31 rows")
    if out_len < 0:
        raise ValueError("compact_rows: out_len must be >= 0")
    for t in cols_in:
        _check_col(t, n, alive, "compact_rows column")
    lib = build()
    cols = _cols(cols_in, [0] * len(cols_in), fills)   # kinds unused
    length = min(n, out_len)
    outs = [torch.empty(length, dtype=t.dtype, device=t.device)
            for t in cols_in]
    for j, o in enumerate(outs):
        cols.out[j] = o.data_ptr()
    total = torch.empty((), dtype=torch.int32, device=alive.device)
    ws = _scratch(lib.rw_scan_scratch_bytes(n), alive)
    _check_rc(lib.rw_compact_rows(alive.data_ptr(), n, cols, out_len,
                                  total.data_ptr(), ws.data_ptr(),
                                  _stream(alive)), "compact_rows")
    return outs + [total]
