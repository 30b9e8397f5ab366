"""Build and bind the hand-written kernels: the sorted-run cores
(`csrc/sorted_runs.cu`), the join-side cores (`csrc/join_runs.cu`), the
multiset cores (`csrc/multiset_runs.cu`), the hop-window expansion
(`csrc/window_runs.cu`), the key-skew telemetry cores
(`csrc/skew_runs.cu`), the state-tiering cores (`csrc/tier_runs.cu`),
the expression pass (`csrc/expr_eval.cu`), the unpack of the
per-operator agg step's packed flags (`csrc/agg_pack.cu`), the bucket
exchange of the sharded paths (`csrc/exchange.cu`) and the bid generator
of the fused device pipeline (`csrc/datagen.cu`).

The sources have a plain C interface (`csrc/*.h`) and no PyTorch
headers, so `nvcc` compiles each in seconds — all of them at once, one
process per source — and links them into one shared library, loaded
with ctypes. This module is the binding:
it checks device, dtype, contiguity and shape, allocates every output and
the scratch with `torch.empty` on the input's device, launches on the
current stream and raises when a launch is refused. Nothing here
synchronises.

The library is built at first use, once per process, into
`build/torch_kernels/` at the repository root.
"""
from __future__ import annotations

import ctypes
import os
import struct
import subprocess
from typing import Any, List, Optional, Sequence

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_kernels")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
MAX_COLS = 32
_MAX_ROWS = 1 << 31

_DTYPE = {torch.int64: 0, torch.int32: 1, torch.float64: 2, torch.bool: 3}
_SUM, _REPLACE = 0, 3              # RwKind in csrc/sorted_runs.h


class RwCols(ctypes.Structure):
    """Mirror of `RwCols` in csrc/sorted_runs.h (passed by value)."""
    _fields_ = [("n", ctypes.c_int32),
                ("dtype", ctypes.c_int32 * MAX_COLS),
                ("kind", ctypes.c_int32 * MAX_COLS),
                ("fill", ctypes.c_int64 * MAX_COLS),
                ("a", ctypes.c_void_p * MAX_COLS),
                ("b", ctypes.c_void_p * MAX_COLS),
                ("out", ctypes.c_void_p * MAX_COLS)]


HIST_SEGS, HIST_BUCKETS = 4, 16      # RW_HIST_SEGS, RW_HIST_BUCKETS


class RwHistSeg(ctypes.Structure):
    """Mirror of `RwHistSeg` in csrc/skew_runs.h."""
    _fields_ = [("keys", ctypes.c_void_p), ("live", ctypes.c_void_p),
                ("weights", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("row", ctypes.c_int32)]


class RwHistArgs(ctypes.Structure):
    """Mirror of `RwHistArgs` in csrc/skew_runs.h (passed by value)."""
    _fields_ = [("nseg", ctypes.c_int32), ("rows", ctypes.c_int32),
                ("add", ctypes.c_int32), ("seg", RwHistSeg * HIST_SEGS),
                ("mask", ctypes.c_uint64 * 4), ("flip", ctypes.c_uint32),
                ("empty_key", ctypes.c_int64)]


EXPR_MAX_INS, EXPR_MAX_IN, EXPR_MAX_OUT = 128, 16, 16   # csrc/expr_eval.h


class RwExprIns(ctypes.Structure):
    """Mirror of `RwExprIns` in csrc/expr_eval.h (16 bytes)."""
    _fields_ = [("op", ctypes.c_uint8), ("t", ctypes.c_uint8),
                ("a", ctypes.c_int8), ("b", ctypes.c_int8),
                ("param", ctypes.c_int16), ("lt", ctypes.c_uint8),
                ("pad", ctypes.c_uint8), ("imm", ctypes.c_int64)]


class RwExprProg(ctypes.Structure):
    """Mirror of `RwExprProg` in csrc/expr_eval.h (passed by pointer, then
    to the kernel by value)."""
    _fields_ = [("n_ins", ctypes.c_int32), ("n_in", ctypes.c_int32),
                ("n_out", ctypes.c_int32), ("deep", ctypes.c_int32),
                ("in_type", ctypes.c_int32 * EXPR_MAX_IN),
                ("out_type", ctypes.c_int32 * EXPR_MAX_OUT),
                ("in_", ctypes.c_void_p * EXPR_MAX_IN),
                ("out", ctypes.c_void_p * EXPR_MAX_OUT),
                ("mask_in", ctypes.c_void_p), ("mask_out", ctypes.c_void_p),
                ("ins", RwExprIns * EXPR_MAX_INS),
                ("magic", ctypes.c_uint64 * EXPR_MAX_INS)]


EXCH_MAX_SHARDS, EXCH_MAX_SOURCES, EXCH_MAX_HOT = 64, 64, 16   # exchange.h
# a kernel's parameters on sm_90 (CUDA 12.1+): the exchange's RwExchArgs
# rides as one __grid_constant__ parameter
MAX_PARAM_BYTES = 32764


class RwExchArgs(ctypes.Structure):
    """Mirror of `RwExchArgs` in csrc/exchange.h (passed by pointer; the
    launch copies it into the place kernel's parameters)."""
    _fields_ = [("n", ctypes.c_int32), ("n_src", ctypes.c_int32),
                ("route", ctypes.c_int32), ("hot", ctypes.c_int32),
                ("n_hot", ctypes.c_int32), ("ncols", ctypes.c_int32),
                ("bounds", ctypes.c_int32 * (EXCH_MAX_SHARDS + 1)),
                ("hot_keys", ctypes.c_int64 * EXCH_MAX_HOT),
                ("hot_mask", ctypes.c_int64),
                ("vmask", ctypes.c_uint64 * 8), ("vflip", ctypes.c_uint32),
                ("vbits", ctypes.c_int32), ("cap", ctypes.c_int64),
                ("b", ctypes.c_int64),
                ("dtype", ctypes.c_int32 * MAX_COLS),
                ("fill", ctypes.c_int64 * MAX_COLS),
                ("out", ctypes.c_void_p * MAX_COLS),
                ("key", ctypes.c_void_p * EXCH_MAX_SOURCES),
                ("mask", ctypes.c_void_p * EXCH_MAX_SOURCES),
                ("sign", ctypes.c_void_p * EXCH_MAX_SOURCES),
                ("pk", ctypes.c_void_p * EXCH_MAX_SOURCES),
                ("col", (ctypes.c_void_p * MAX_COLS) * EXCH_MAX_SOURCES)]


if ctypes.sizeof(RwExchArgs) > MAX_PARAM_BYTES:
    raise RuntimeError(f"RwExchArgs is {ctypes.sizeof(RwExchArgs)} bytes, "
                       f"above a kernel's {MAX_PARAM_BYTES}: lower "
                       "EXCH_MAX_SOURCES here and RW_EXCH_MAX_SOURCES in "
                       "csrc/exchange.h")


_LIB = None
SOURCES = ("sorted_runs.cu", "join_runs.cu", "multiset_runs.cu",
           "window_runs.cu", "skew_runs.cu", "tier_runs.cu", "expr_eval.cu",
           "agg_pack.cu", "exchange.cu", "datagen.cu")


def _mtime(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return -1.0


def build() -> ctypes.CDLL:
    """Compile (once per process; every source at once) and load the
    kernel library. An object newer than its source and every header of
    `csrc/`, and a library newer than its objects, are reused: a second
    process on the same checkout (`risectl` beside a running server)
    loads the library the first one built."""
    global _LIB
    if _LIB is None:
        from torch.utils.cpp_extension import CUDA_HOME
        nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
        os.makedirs(BUILD_DIR, exist_ok=True)
        headers = max(_mtime(os.path.join(CSRC, f))
                      for f in os.listdir(CSRC) if not f.endswith(".cu"))
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(BUILD_DIR, src.replace(".cu", ".o"))
            objs.append(obj)
            if _mtime(obj) > max(headers, _mtime(os.path.join(CSRC, src))):
                continue
            procs.append((src, subprocess.Popen(
                [nvcc, *CUDA_FLAGS, "-std=c++17", "-Xcompiler", "-fPIC",
                 "-I", CSRC, "-c", "-o", obj, os.path.join(CSRC, src)])))
        failed = [src for src, pr in procs if pr.wait() != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        so = os.path.join(BUILD_DIR, "librw_kernels.so")
        if procs or _mtime(so) <= max(_mtime(o) for o in objs):
            # the linker writes a new file: a process that loaded the old
            # library keeps its mapping
            tmp = f"{so}.{os.getpid()}"
            subprocess.run([nvcc, *CUDA_FLAGS, "-shared", "-o", tmp, *objs],
                           check=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for fn in ("rw_sort_scratch_bytes", "rw_sweep_scratch_bytes",
                   "rw_reduce_scratch_bytes", "rw_rows_scratch_bytes",
                   "rw_ms_scratch_bytes", "rw_tier_scratch_bytes"):
            getattr(lib, fn).argtypes = [i64]
            getattr(lib, fn).restype = i64
        lib.rw_probe_scratch_bytes.argtypes = [i64, i64]
        lib.rw_probe_scratch_bytes.restype = i64
        lib.rw_touch_scratch_bytes.argtypes = [i64, i64, i64]
        lib.rw_touch_scratch_bytes.restype = i64
        lib.rw_sort_perm.argtypes = [p, p, i64, p, p, p, p]
        lib.rw_batch_reduce.argtypes = [p, p, i64, RwCols, p, p, p, p]
        lib.rw_merge.argtypes = [p, i64, p, i64, RwCols, i32, i32, p, p, p,
                                 p]
        lib.rw_compact_rows.argtypes = [p, i64, RwCols, i64, p, p, p]
        lib.rw_reduce_rows.argtypes = [p, p, p, i64, RwCols, p, p, p, p]
        lib.rw_side_merge.argtypes = [p, p, i64, p, p, p, i64, RwCols, p, p,
                                      p, p, p]
        lib.rw_probe.argtypes = [p, i64, p, p, i64, i64, p, p, p, p, p, p]
        lib.rw_ms_reduce.argtypes = [p, p, p, p, i64, p, p, p, p, p]
        lib.rw_ms_merge.argtypes = [p, p, p, i64, p, p, p, i64, p, p, p, p,
                                    p, p]
        lib.rw_ms_find.argtypes = [p, p, p, i64, p, p, i64, p, p, p]
        lib.rw_hop_expand.argtypes = [RwCols, i64, i32, p, i64, i64, p, p,
                                      p, p, p, p, p, p, p]
        lib.rw_vnode_hists.argtypes = [RwHistArgs, i32, p, p, p]
        lib.rw_topk_packed.argtypes = [p, p, i64, i64, i32, p, p, p]
        lib.rw_touch_stamp.argtypes = [p, i64, p, p, i64, p, p, i64, p,
                                       i64, i64, p, p, p, p]
        lib.rw_tier_partition.argtypes = [p, i64, p, i64, RwCols, i32, i64,
                                          p, p, p]
        lib.rw_expr_eval.argtypes = [ctypes.POINTER(RwExprProg), i64, p]
        lib.rw_agg_unpack.argtypes = [p, i64, i32, i32, p, p, p, p]
        lib.rw_exchange_work_bytes.argtypes = [i64, ctypes.c_int32,
                                               ctypes.c_int32]
        lib.rw_exchange_work_bytes.restype = i64
        lib.rw_bucket_exchange.argtypes = [ctypes.POINTER(RwExchArgs), p, p]
        f32, u32 = ctypes.c_float, ctypes.c_uint32
        lib.rw_gen_bids.argtypes = [p, i64, f32, i32, f32, ctypes.c_int32,
                                    u32, u32, p, p, p, p]
        for fn in ("rw_sort_perm", "rw_batch_reduce", "rw_merge",
                   "rw_compact_rows", "rw_reduce_rows", "rw_side_merge",
                   "rw_probe", "rw_ms_reduce", "rw_ms_merge", "rw_ms_find",
                   "rw_hop_expand", "rw_vnode_hists", "rw_topk_packed",
                   "rw_touch_stamp", "rw_tier_partition", "rw_expr_eval",
                   "rw_agg_unpack", "rw_bucket_exchange", "rw_gen_bids"):
            getattr(lib, fn).restype = i32
        _LIB = lib
    return _LIB


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device (the call
    torch's own generated kernels make: no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


# Launch sites, in the order of `RwSite` in csrc/sorted_runs.h (from 1)
# then `RwJoinSite`, `RwMultisetSite`, `RwWindowSite`, `RwSkewSite` and
# `RwTierSite` in the other headers, then `RwSortedSite2`, `RwExprSite`,
# `RwAggPackSite`, `RwExchangeSite`, `RwDatagenSite` and
# `RwMultisetSite2`.
SITES = ("k_sort_upsweep", "k_sort_plan", "k_tile_sums", "k_scan_sums",
         "k_tile_apply", "k_sort_pass", "k_reduce_tiles", "k_reduce_carry",
         "k_merge_cuts", "k_merge_tiles", "k_compact_fill",
         "k_reduce_tiles (rows)", "k_reduce_carry (rows)",
         "k_reduce_gather (rows)", "k_side_cuts",
         "k_side_merge", "k_side_fill", "k_probe_tiles",
         "k_probe_expand", "k_reduce_tiles (ms)", "k_reduce_carry (ms)",
         "k_ms_cuts", "k_ms_merge_tiles", "k_ms_find",
         "k_hop_expand", "k_vnode_hists", "k_topk", "(unused)",
         "k_touch_stamp", "k_partition_fill", "k_ts_cuts", "k_merge_fill",
         "k_compact_tiles", "k_expr_eval", "k_agg_unpack",
         "memset (exchange)", "k_exch_place", "k_exch_fill", "k_gen_bids",
         "k_ms_fill")
_SITE_STRIDE = 1024


class KernelLaunchError(RuntimeError):
    """A kernel launch the CUDA runtime refused (the return code of a
    binding's C entry point): a device-path fault, which a fused job's
    in-place recovery may absorb (`device/fused._is_device_fault`). The
    argument checks raise `ValueError` instead: those are bugs, never
    replayed."""


def _check_rc(rc: int, what: str) -> None:
    """Raise for a refused launch, naming the kernel that was refused."""
    if rc != 0:
        site, err = divmod(rc, _SITE_STRIDE)
        kernel = SITES[site - 1] if 1 <= site <= len(SITES) else "?"
        raise KernelLaunchError(f"{what}: launch of {kernel} failed with "
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
    ws = _scratch(lib.rw_reduce_scratch_bytes(n), sk)
    _check_rc(lib.rw_batch_reduce(sk.data_ptr(), perm.data_ptr(), n, cols,
                                  ukeys.data_ptr(), ucount.data_ptr(),
                                  ws.data_ptr(), _stream(sk)),
              "batch_reduce")
    return [ukeys, ucount] + outs


def merge(skeys: torch.Tensor, svals: Sequence[torch.Tensor],
          dkeys: torch.Tensor, dvals: Sequence[torch.Tensor],
          kinds: Sequence[int], fills: Sequence[int], drop_dead: bool,
          dead_col: int) -> List[torch.Tensor]:
    """-> [new keys [c], combined columns [c]..., needed int32]."""
    _check_keys(skeys, "merge state")
    _check_keys(dkeys, "merge delta")
    c, b = skeys.shape[0], dkeys.shape[0]
    if c + b >= _MAX_ROWS:
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
    cols = _cols(svals, kinds, fills)
    for j, dv in enumerate(dvals):
        cols.b[j] = dv.data_ptr()
    dev = skeys.device
    keys = torch.empty(c, dtype=torch.int64, device=dev)
    outs = [torch.empty(c, dtype=sv.dtype, device=dev) for sv in svals]
    for j, o in enumerate(outs):
        cols.out[j] = o.data_ptr()
    # the kernel writes `needed`; with no rows at all it launches nothing
    needed = (torch.empty if c + b else torch.zeros)((), dtype=torch.int32,
                                                     device=dev)
    ws = _scratch(lib.rw_sweep_scratch_bytes(c + b), skeys)
    _check_rc(lib.rw_merge(skeys.data_ptr(), c, dkeys.data_ptr(), b, cols,
                           int(bool(drop_dead)), int(dead_col),
                           keys.data_ptr(), needed.data_ptr(), ws.data_ptr(),
                           _stream(skeys)), "merge")
    return [keys] + outs + [needed]


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
    ws = _scratch(lib.rw_sweep_scratch_bytes(n), alive)
    _check_rc(lib.rw_compact_rows(alive.data_ptr(), n, cols, out_len,
                                  total.data_ptr(), ws.data_ptr(),
                                  _stream(alive)), "compact_rows")
    return outs + [total]


def reduce_rows(sk: torch.Tensor, pk: torch.Tensor, perm: torch.Tensor,
                sign: torch.Tensor, vals: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Sorted jk + permutation, and pk / int32 signs / columns in
    original row order -> [ujk, upk, usign, payload columns...]."""
    _check_keys(sk, "batch_reduce_rows")
    n = sk.shape[0]
    _check_col(pk, n, sk, "batch_reduce_rows pk")
    _check_col(perm, n, sk, "batch_reduce_rows perm")
    _check_col(sign, n, sk, "batch_reduce_rows sign")
    if pk.dtype != torch.int64 or perm.dtype != torch.int64 \
            or sign.dtype != torch.int32:
        raise ValueError("batch_reduce_rows: pk and perm must be int64, "
                         "sign int32")
    for v in vals:
        _check_col(v, n, sk, "batch_reduce_rows column")
    lib = build()
    # the sign sums (fill 0); the payload takes the last arrival (REPLACE)
    # and pads from the first sorted row
    cols_in = [sign] + list(vals)
    cols = _cols(cols_in, [_SUM] + [_REPLACE] * len(vals), [0] * len(cols_in))
    dev = sk.device
    ujk = torch.empty(n, dtype=torch.int64, device=dev)
    upk = torch.empty(n, dtype=torch.int64, device=dev)
    outs = [torch.empty(n, dtype=v.dtype, device=dev) for v in cols_in]
    for j, o in enumerate(outs):
        cols.out[j] = o.data_ptr()
    ws = _scratch(lib.rw_rows_scratch_bytes(n), sk)
    _check_rc(lib.rw_reduce_rows(sk.data_ptr(), pk.data_ptr(),
                                 perm.data_ptr(), n, cols, ujk.data_ptr(),
                                 upk.data_ptr(), ws.data_ptr(), _stream(sk)),
              "batch_reduce_rows")
    return [ujk, upk] + outs


def side_merge(s_jk: torch.Tensor, s_pk: torch.Tensor,
               svals: Sequence[torch.Tensor], d_jk: torch.Tensor,
               d_pk: torch.Tensor, d_sign: torch.Tensor,
               dvals: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """-> [new jk [c], new pk, payload columns..., needed int32]."""
    _check_keys(s_jk, "merge_side state")
    _check_keys(d_jk, "merge_side delta")
    c, b = s_jk.shape[0], d_jk.shape[0]
    if c + b >= _MAX_ROWS:
        raise ValueError("merge_side: at most 2^31 rows")
    _check_col(s_pk, c, s_jk, "merge_side state pk")
    _check_col(d_pk, b, s_jk, "merge_side delta pk")
    _check_col(d_sign, b, s_jk, "merge_side delta sign")
    if s_pk.dtype != torch.int64 or d_pk.dtype != torch.int64 \
            or d_sign.dtype != torch.int32:
        raise ValueError("merge_side: pk must be int64, sign int32")
    if len(svals) != len(dvals):
        raise ValueError("merge_side: column count mismatch")
    for sv, dv in zip(svals, dvals):
        _check_col(sv, c, s_jk, "merge_side state column")
        _check_col(dv, b, s_jk, "merge_side delta column")
        if dv.dtype != sv.dtype:
            raise ValueError("merge_side: delta column dtype differs from "
                             "the state's")
    lib = build()
    cols = _cols(svals, [0] * len(svals), [0] * len(svals))  # kinds unused
    for j, dv in enumerate(dvals):
        cols.b[j] = dv.data_ptr()
    dev = s_jk.device
    o_jk = torch.empty(c, dtype=torch.int64, device=dev)
    o_pk = torch.empty(c, dtype=torch.int64, device=dev)
    outs = [torch.empty(c, dtype=sv.dtype, device=dev) for sv in svals]
    for j, o in enumerate(outs):
        cols.out[j] = o.data_ptr()
    # the kernel writes `needed`; with no rows at all it launches nothing
    needed = (torch.empty if c + b else torch.zeros)((), dtype=torch.int32,
                                                     device=dev)
    ws = _scratch(lib.rw_sweep_scratch_bytes(c + b), s_jk)
    _check_rc(lib.rw_side_merge(s_jk.data_ptr(), s_pk.data_ptr(), c,
                                d_jk.data_ptr(), d_pk.data_ptr(),
                                d_sign.data_ptr(), b, cols, o_jk.data_ptr(),
                                o_pk.data_ptr(), needed.data_ptr(),
                                ws.data_ptr(), _stream(s_jk)), "merge_side")
    return [o_jk, o_pk] + outs + [needed]


def _al256(nbytes: int) -> int:
    return (nbytes + 255) & ~255


def probe(side_jk: torch.Tensor, qjk: torch.Tensor, qmask: torch.Tensor,
          m: int) -> List[torch.Tensor]:
    """-> [row int32 [m], sidx int64 [m], mask bool [m], total int64].

    The outputs and the scratch are views of one allocation."""
    _check_keys(side_jk, "probe side")
    _check_keys(qjk, "probe queries")
    q = qjk.shape[0]
    if q == 0:
        raise ValueError("probe: at least one query row")
    if m < 0:
        raise ValueError("probe: m must be >= 0")
    _check_col(qmask, q, side_jk, "probe mask")
    if qmask.dtype != torch.bool or qjk.device != side_jk.device:
        raise ValueError("probe: the mask must be bool, the queries on the "
                         "side's device")
    lib = build()
    o_row = _al256(8 * m)
    o_mask = o_row + _al256(4 * m)
    o_total = o_mask + _al256(m)
    o_ws = o_total + 256
    buf = torch.empty(o_ws + lib.rw_probe_scratch_bytes(q, int(m)),
                      dtype=torch.uint8, device=side_jk.device)
    sidx = buf[:8 * m].view(torch.int64)
    row = buf[o_row:o_row + 4 * m].view(torch.int32)
    mask = buf[o_mask:o_mask + m].view(torch.bool)
    total = buf[o_total:o_total + 8].view(torch.int64)[0]
    base = buf.data_ptr()
    _check_rc(lib.rw_probe(side_jk.data_ptr(), side_jk.shape[0],
                           qjk.data_ptr(), qmask.data_ptr(), q, int(m),
                           base + o_row, base, base + o_mask,
                           base + o_total, base + o_ws, _stream(side_jk)),
              "probe")
    return [row, sidx, mask, total]


def ms_reduce(sk1: torch.Tensor, k2: torch.Tensor, perm: torch.Tensor,
              delta: torch.Tensor) -> List[torch.Tensor]:
    """Sorted k1 + permutation, and k2 / int64 deltas in original row
    order -> [u1, u2, ud]."""
    _check_keys(sk1, "ms_batch_reduce")
    n = sk1.shape[0]
    for t, what in ((k2, "k2"), (perm, "perm"), (delta, "delta")):
        _check_col(t, n, sk1, f"ms_batch_reduce {what}")
        if t.dtype != torch.int64:
            raise ValueError(f"ms_batch_reduce: {what} must be int64")
    lib = build()
    u1, u2, ud = (torch.empty(n, dtype=torch.int64, device=sk1.device)
                  for _ in range(3))
    ws = _scratch(lib.rw_ms_scratch_bytes(n), sk1)
    _check_rc(lib.rw_ms_reduce(sk1.data_ptr(), k2.data_ptr(), perm.data_ptr(),
                               delta.data_ptr(), n, u1.data_ptr(),
                               u2.data_ptr(), ud.data_ptr(), ws.data_ptr(),
                               _stream(sk1)), "ms_batch_reduce")
    return [u1, u2, ud]


def ms_merge(s1: torch.Tensor, s2: torch.Tensor, s_cnt: torch.Tensor,
             d1: torch.Tensor, d2: torch.Tensor, d_cnt: torch.Tensor
             ) -> List[torch.Tensor]:
    """-> [k1 [c], k2 [c], count [c], needed int32, min(needed, c) int32]:
    views of one allocation."""
    _check_keys(s1, "ms_merge state")
    _check_keys(d1, "ms_merge delta")
    c, b = s1.shape[0], d1.shape[0]
    n = c + b
    if n >= _MAX_ROWS:
        raise ValueError("ms_merge: at most 2^31 rows")
    for t, m, what in ((s2, c, "state k2"), (s_cnt, c, "state count"),
                       (d2, b, "delta k2"), (d_cnt, b, "delta count")):
        _check_col(t, m, s1, f"ms_merge {what}")
        if t.dtype != torch.int64:
            raise ValueError(f"ms_merge: {what} must be int64")
    lib = build()
    # with no rows at all the kernel launches nothing: the counts are 0
    buf = (torch.empty if n else torch.zeros)(3 * c + 1, dtype=torch.int64,
                                              device=s1.device)
    needed = buf[3 * c:].view(torch.int32)
    ws = _scratch(lib.rw_sweep_scratch_bytes(n), s1)
    base = buf.data_ptr()
    _check_rc(lib.rw_ms_merge(s1.data_ptr(), s2.data_ptr(), s_cnt.data_ptr(),
                              c, d1.data_ptr(), d2.data_ptr(),
                              d_cnt.data_ptr(), b, base, base + 8 * c,
                              base + 16 * c, base + 24 * c, ws.data_ptr(),
                              _stream(s1)), "ms_merge")
    return [buf[:c], buf[c:2 * c], buf[2 * c:3 * c], needed[0], needed[1]]


def ms_find(k1: torch.Tensor, k2: torch.Tensor, cnt: torch.Tensor,
            q1: torch.Tensor, q2: torch.Tensor) -> List[torch.Tensor]:
    """-> [found bool [q], count int64 [q]], views of one allocation."""
    _check_keys(k1, "ms_find multiset")
    _check_keys(q1, "ms_find queries")
    c, q = k1.shape[0], q1.shape[0]
    if c == 0:
        raise ValueError("ms_find: the multiset needs a capacity >= 1")
    for t, m, what in ((k2, c, "k2"), (cnt, c, "count"), (q2, q, "query k2")):
        _check_col(t, m, k1, f"ms_find {what}")
        if t.dtype != torch.int64:
            raise ValueError(f"ms_find: {what} must be int64")
    _check_col(q1, q, k1, "ms_find queries")
    lib = build()
    buf = torch.empty(9 * q, dtype=torch.uint8, device=k1.device)
    out = buf[:8 * q].view(torch.int64)
    found = buf[8 * q:].view(torch.bool)
    _check_rc(lib.rw_ms_find(k1.data_ptr(), k2.data_ptr(), cnt.data_ptr(), c,
                             q1.data_ptr(), q2.data_ptr(), q,
                             found.data_ptr(), out.data_ptr(), _stream(k1)),
              "ms_find")
    return [found, out]


def hop_expand(cols_in: Sequence[torch.Tensor], ts: torch.Tensor, hop: int,
               size: int, n: int, pk: Optional[torch.Tensor],
               sign: torch.Tensor, mask: torch.Tensor) -> List[Any]:
    """-> [columns [rows*n]..., start, end, pk (or None), sign, mask]."""
    _check_keys(ts, "hop_expand time column")
    rows = ts.shape[0]
    if hop <= 0 or n < 1:
        raise ValueError("hop_expand: hop must be > 0 and n >= 1")
    if rows * n >= _MAX_ROWS:
        raise ValueError("hop_expand: at most 2^31 output rows")
    for t in cols_in:
        _check_col(t, rows, ts, "hop_expand column")
    _check_col(sign, rows, ts, "hop_expand sign")
    _check_col(mask, rows, ts, "hop_expand mask")
    if sign.dtype != torch.int32 or mask.dtype != torch.bool:
        raise ValueError("hop_expand: sign must be int32, mask bool")
    if pk is not None:
        _check_col(pk, rows, ts, "hop_expand pk")
        if pk.dtype != torch.int64:
            raise ValueError("hop_expand: pk must be int64")
    lib = build()
    dev = ts.device
    m = rows * n
    cols = _cols(cols_in, [0] * len(cols_in), [0] * len(cols_in))
    outs = [torch.empty(m, dtype=t.dtype, device=dev) for t in cols_in]
    for j, o in enumerate(outs):
        cols.out[j] = o.data_ptr()
    start, end = (torch.empty(m, dtype=torch.int64, device=dev)
                  for _ in range(2))
    pk_out = None if pk is None else torch.empty(m, dtype=torch.int64,
                                                 device=dev)
    sign_out = torch.empty(m, dtype=torch.int32, device=dev)
    mask_out = torch.empty(m, dtype=torch.bool, device=dev)
    _check_rc(lib.rw_hop_expand(
        cols, rows, int(n), ts.data_ptr(), int(hop), int(size),
        None if pk is None else pk.data_ptr(), sign.data_ptr(),
        mask.data_ptr(), start.data_ptr(), end.data_ptr(),
        None if pk_out is None else pk_out.data_ptr(), sign_out.data_ptr(),
        mask_out.data_ptr(), _stream(ts)), "hop_expand")
    return outs + [start, end, pk_out, sign_out, mask_out]


_HIST_STATE = {}
_PARITY = []


def hist_parity():
    """(masks, flip) of the 16-bucket parity form that `hist_args` hands
    the kernel, derived once from the CRC (`core.vnode.bucket_parity`)."""
    if not _PARITY:
        from ..core.vnode import bucket_parity
        _PARITY.append(bucket_parity(HIST_BUCKETS))
    return _PARITY[0]


# RwHistArgs packed field by field (from_buffer_copy of one pack is a
# tenth of the cost of building the nested ctypes arrays)
_HIST_PACK = struct.Struct("<iii4x" + "QQQqi4x" * HIST_SEGS + "4QI4xq")
assert _HIST_PACK.size == ctypes.sizeof(RwHistArgs)


def hist_args(segments: Sequence[Any], rows: int, empty_key: int,
              add: bool):
    """The kernel's argument block for `vnode_hists` (checked): each
    segment (keys, live or None, int64 weights or None, row), and the
    bucket masks (`hist_parity`) -> (args, rows in all, non-empty
    segments)."""
    if not 1 <= len(segments) <= HIST_SEGS:
        raise ValueError(f"vnode_hists: 1 to {HIST_SEGS} segments")
    if not 1 <= rows <= HIST_SEGS:
        raise ValueError(f"vnode_hists: 1 to {HIST_SEGS} rows")
    vals = [len(segments), rows, int(bool(add))]
    total = nonempty = 0
    dev = segments[0][0].device
    for keys, live, weights, row in segments:
        n = keys.shape[0]
        bad = keys.dtype != torch.int64 or keys.dim() != 1 \
            or not keys.is_contiguous() or keys.device != dev \
            or not keys.is_cuda or not 0 <= row < rows
        for col, dt in ((live, torch.bool), (weights, torch.int64)):
            bad = bad or col is not None and (
                col.dtype != dt or col.shape != keys.shape
                or not col.is_contiguous() or col.device != dev)
        if bad:
            raise ValueError(
                "vnode_hists: a segment is contiguous 1-D int64 CUDA keys, "
                "bool live and int64 weights of their shape on their "
                f"device or None, and a row in [0, {rows})")
        vals += [keys.data_ptr(), 0 if live is None else live.data_ptr(),
                 0 if weights is None else weights.data_ptr(), n, row]
        total += n
        nonempty += n > 0
    vals += [0] * (5 * (HIST_SEGS - len(segments)))
    masks, flip = hist_parity()
    args = RwHistArgs.from_buffer_copy(
        _HIST_PACK.pack(*vals, *masks, flip, int(empty_key)))
    return args, total, nonempty


def vnode_hists(segments: Sequence[Any], rows: int, empty_key: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> int64 [rows, 16]: the segments' weighted vnode buckets, each
    into its row; written, or added into `out` when given."""
    args, n, nonempty = hist_args(segments, rows, empty_key,
                                  out is not None)
    dev = segments[0][0].device
    if out is None:
        out = torch.empty((rows, HIST_BUCKETS), dtype=torch.int64,
                          device=dev)
    elif out.device != dev or out.dtype != torch.int64 \
            or out.shape != (rows, HIST_BUCKETS) or not out.is_contiguous():
        raise ValueError(f"vnode_hists: out must be a contiguous int64 "
                         f"[{rows}, {HIST_BUCKETS}] tensor on {dev}")
    lib = build()
    state = _HIST_STATE.get(dev)
    if state is None:
        # the blocks' counter and the rows' accumulator, zero between calls
        # (the last block resets them); two blocks an SM at most
        most = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
        state = _HIST_STATE[dev] = (torch.zeros(
            1 + HIST_BUCKETS * HIST_SEGS, dtype=torch.int64, device=dev),
            most)
    # 16 rows a thread at least, at least one block for each table
    blocks = max(nonempty, 1, min(-(-n // (16 * 256)), state[1]))
    _check_rc(lib.rw_vnode_hists(args, blocks, out.data_ptr(),
                                 state[0].data_ptr(),
                                 _stream(segments[0][0])), "vnode_hists")
    return out


TOPK_STATE_WORDS = 1 + 4 * 1024       # RW_TOPK_STATE_WORDS
_TOPK_STATE = {}


def topk_state(dev: torch.device):
    """(state, most blocks) of `topk_packed` on `dev`, made once: the
    blocks' ticket, zero between calls (the last block resets it), then
    a 4-list per block; two blocks an SM at most."""
    st = _TOPK_STATE.get(dev)
    if st is None:
        most = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
        st = _TOPK_STATE[dev] = (torch.zeros(TOPK_STATE_WORDS,
                                             dtype=torch.int64, device=dev),
                                 most)
    return st


def topk_packed(keys: torch.Tensor, counts: Optional[torch.Tensor],
                empty_key: int) -> torch.Tensor:
    """-> the four largest packed (count, key) values, int64 [4]: one
    launch, `out` its one allocation."""
    _check_keys(keys, "topk_packed")
    n = keys.shape[0]
    if counts is not None:
        _check_col(counts, n, keys, "topk_packed counts")
        if counts.dtype != torch.int64:
            raise ValueError("topk_packed: counts must be int64")
    lib = build()
    state, most = topk_state(keys.device)
    out = torch.empty(4, dtype=torch.int64, device=keys.device)
    _check_rc(lib.rw_topk_packed(
        keys.data_ptr(), None if counts is None else counts.data_ptr(), n,
        int(empty_key), most, out.data_ptr(), state.data_ptr(),
        _stream(keys)), "topk_packed")
    return out


def touch_stamp(keys: torch.Tensor, old_keys: torch.Tensor,
                old_touch: torch.Tensor, src_keys: torch.Tensor,
                src_vals: Optional[torch.Tensor], tick: torch.Tensor,
                ttl: int, empty_key: int):
    """-> (stamps int64[n], (live, cold) int64[2])."""
    _check_keys(keys, "touch_stamp")
    _check_keys(old_keys, "touch_stamp old keys")
    _check_keys(src_keys, "touch_stamp touched keys")
    n, n_old, n_src = keys.shape[0], old_keys.shape[0], src_keys.shape[0]
    _check_col(old_touch, n_old, keys, "touch_stamp old touch")
    if old_touch.dtype != torch.int64:
        raise ValueError("touch_stamp: old touch must be int64")
    if src_vals is not None:
        _check_col(src_vals, n_src, keys, "touch_stamp promoted touch")
        if src_vals.dtype != torch.int64:
            raise ValueError("touch_stamp: promoted touch must be int64")
    if tick.device != keys.device or tick.dtype != torch.int64 \
            or tick.numel() != 1:
        raise ValueError("touch_stamp: tick must be one int64 on the keys' "
                         "device")
    lib = build()
    out = torch.empty(n, dtype=torch.int64, device=keys.device)
    counts = torch.zeros(2, dtype=torch.int64, device=keys.device)
    ws = _scratch(lib.rw_touch_scratch_bytes(n, n_old, n_src), keys)
    _check_rc(lib.rw_touch_stamp(
        keys.data_ptr(), n, old_keys.data_ptr(), old_touch.data_ptr(), n_old,
        src_keys.data_ptr(), None if src_vals is None else src_vals.data_ptr(),
        n_src, tick.data_ptr(), int(ttl), int(empty_key), out.data_ptr(),
        counts.data_ptr(), ws.data_ptr(), _stream(keys)), "touch_stamp")
    return out, counts


def tier_partition(keys: torch.Tensor, cols_in: Sequence[torch.Tensor],
                   fills: Sequence[int], dkeys: torch.Tensor, hits: bool,
                   empty_key: int):
    """-> (kept columns [n]..., hit columns [n]... (with `hits`),
    (kept, hits) int32[2])."""
    _check_keys(keys, "tier_partition")
    _check_keys(dkeys, "tier_partition demoted keys")
    n = keys.shape[0]
    for t in cols_in:
        _check_col(t, n, keys, "tier_partition column")
    lib = build()
    cols = _cols(cols_in, [0] * len(cols_in), fills)   # kinds unused
    kept = [torch.empty(n, dtype=t.dtype, device=t.device) for t in cols_in]
    hit = [torch.empty(n, dtype=t.dtype, device=t.device)
           for t in cols_in] if hits else []
    for j, o in enumerate(kept):
        cols.out[j] = o.data_ptr()
    for j, o in enumerate(hit):
        cols.b[j] = o.data_ptr()
    counts = torch.empty(2, dtype=torch.int32, device=keys.device)
    ws = _scratch(lib.rw_tier_scratch_bytes(n), keys)
    _check_rc(lib.rw_tier_partition(
        keys.data_ptr(), n, dkeys.data_ptr(), dkeys.shape[0], cols,
        int(bool(hits)), int(empty_key), counts.data_ptr(), ws.data_ptr(),
        _stream(keys)), "tier_partition")
    return kept, hit, counts


def expr_eval(prog, ins: Sequence[torch.Tensor], n: int, dev: torch.device,
              mask: Optional[torch.Tensor]) -> List[torch.Tensor]:
    """Run a lowered program (`kernels.expr_eval.ExprProgram`, its folded
    `code`) over n rows of its input tensors -> its output columns
    ("map") or [the new mask] ("mask")."""
    from .expr_eval import TORCH_OF
    if len(prog.code) > EXPR_MAX_INS or len(ins) > EXPR_MAX_IN \
            or len(prog.out_types) > EXPR_MAX_OUT:
        raise ValueError("expr_eval: program exceeds the kernel's limits")
    if n >= _MAX_ROWS:
        raise ValueError("expr_eval: at most 2^31 rows")
    for t, code in zip(ins, prog.in_types):
        _check_in(t, n, dev, TORCH_OF[code])
    pr = prog.params
    if pr is None:
        pr = prog.params = RwExprProg()
        pr.n_ins, pr.n_in, pr.n_out = (len(prog.code), len(ins),
                                       len(prog.out_types))
        pr.deep = prog.deep()
        for j, (op, t, a, b, param, lt, imm) in enumerate(prog.code):
            magic = _div_magic(op, t, b, lt, imm)
            if magic is not None:
                param, pr.magic[j] = magic
            x = pr.ins[j]
            x.op, x.t, x.a, x.b, x.param, x.lt, x.imm = (op, t, a, b, param,
                                                         lt, imm)
        for j, code in enumerate(prog.in_types):
            pr.in_type[j] = code
        for j, code in enumerate(prog.out_types):
            pr.out_type[j] = code
    for j, t in enumerate(ins):
        pr.in_[j] = t.data_ptr()
    if prog.mode == "mask":
        if mask is None:
            raise ValueError("expr_eval: a predicate program needs a mask")
        _check_in(mask, n, dev, torch.bool)
        outs = [torch.empty(n, dtype=torch.bool, device=dev)]
        pr.mask_in, pr.mask_out = mask.data_ptr(), outs[0].data_ptr()
    else:
        outs = [torch.empty(n, dtype=TORCH_OF[c], device=dev)
                for c in prog.out_types]
        for j, o in enumerate(outs):
            pr.out[j] = o.data_ptr()
    if n:
        _check_rc(build().rw_expr_eval(
            ctypes.byref(pr), n, torch._C._cuda_getCurrentRawStream(
                dev.index)), "expr_eval")
    return outs


def _div_magic(op: int, t: int, b: int, lt: int, imm: int):
    """(l + 1, floor(2^(63 + l) / d) + 1) for an integer DIV / MOD by a
    literal of magnitude d, l = ceil(log2 d), the kernel's multiply in
    place of the division (csrc/expr_eval.cu `magicdiv`); None where it
    divides (no literal, 0, or the type's minimum, whose magnitude
    wraps)."""
    from .expr_eval import OP_DIV, OP_MOD, SRC_LIT, T_I16, T_I32, T_I64
    bits = {T_I16: 16, T_I32: 32, T_I64: 64}.get(t)
    if op not in (OP_DIV, OP_MOD) or bits is None or b != SRC_LIT \
            or lt != t:
        return None
    d = abs(imm)
    if d == 0 or d >= 1 << (bits - 1):
        return None
    lg = (d - 1).bit_length()
    return lg + 1, (1 << (63 + lg)) // d + 1


def _check_in(t: torch.Tensor, n: int, dev: torch.device,
              dtype: torch.dtype) -> None:
    if t.device != dev or t.dtype != dtype or t.dim() != 1 \
            or t.shape[0] != n or not t.is_contiguous():
        raise ValueError(f"expr_eval: expected a contiguous [{n}] {dtype} "
                         f"tensor on {dev}, got {list(t.shape)} {t.dtype} "
                         f"on {t.device}")


def agg_unpack(p8: torch.Tensor, n_calls: int):
    """-> (signs int32 [B], mask bool [B], valid bool [n_calls, B]) of the
    int8 flag matrix p8 [2 + n_calls, B]."""
    if not p8.is_cuda or p8.dtype != torch.int8 or p8.dim() != 2 \
            or not p8.is_contiguous():
        raise ValueError("agg_unpack: p8 must be a contiguous 2-D int8 "
                         "CUDA tensor")
    if n_calls < 0 or p8.shape[0] != 2 + n_calls:
        raise ValueError(f"agg_unpack: p8 has {p8.shape[0]} rows, "
                         f"expected 2 + {n_calls}")
    b = p8.shape[1]
    if b >= _MAX_ROWS:
        raise ValueError("agg_unpack: at most 2^31 columns")
    lib = build()
    dev = p8.device
    signs = torch.empty(b, dtype=torch.int32, device=dev)
    mask = torch.empty(b, dtype=torch.bool, device=dev)
    valid = torch.empty((n_calls, b), dtype=torch.bool, device=dev)
    aligned = int(b % 4 == 0 and p8.data_ptr() % 4 == 0)
    _check_rc(lib.rw_agg_unpack(p8.data_ptr(), b, int(n_calls), aligned,
                                signs.data_ptr(), mask.data_ptr(),
                                valid.data_ptr(), _stream(p8)),
              "agg_unpack")
    return signs, mask, valid


_VNODE_PARITY = []


def vnode_parity():
    """(masks, flip) of the vnode as eight key parities (256 vnodes),
    derived once from the CRC (`core.vnode.bucket_parity`)."""
    if not _VNODE_PARITY:
        from ..core.vnode import VNODE_COUNT, bucket_parity
        _VNODE_PARITY.append(bucket_parity(VNODE_COUNT))
    return _VNODE_PARITY[0]


def bucket_exchange(keys: Sequence[torch.Tensor],
                    masks: Sequence[torch.Tensor],
                    signs: Optional[Sequence[torch.Tensor]],
                    pks: Optional[Sequence[torch.Tensor]], n: int, cap: int,
                    cols: Sequence[Sequence[torch.Tensor]],
                    fills: Sequence[int],
                    route_bounds: Optional[Sequence[int]],
                    hot_keys: Sequence[int], hot_mode: int, hot_mask: int,
                    outs: Sequence[torch.Tensor]):
    """Place every source shard's rows into the receiver-major buffers
    `outs` (one per column, contiguous [n, n_src, cap], the column's
    dtype) in one call -> (counts int64 [n_src, n], need int64 [n_src]),
    views of the call's work buffer. Every source has the same row count;
    `cols[s]` are source s's columns. `fills` are raw bits (see
    `_bits`)."""
    n_src = len(keys)
    if not 1 <= n_src <= EXCH_MAX_SOURCES:
        raise ValueError(f"bucket_exchange: 1 to {EXCH_MAX_SOURCES} source "
                         f"shards, got {n_src}")
    if not 1 <= n <= EXCH_MAX_SHARDS:
        raise ValueError(f"bucket_exchange: 1 to {EXCH_MAX_SHARDS} shards, "
                         f"got {n}")
    if len(hot_keys) > EXCH_MAX_HOT:
        raise ValueError(f"bucket_exchange: at most {EXCH_MAX_HOT} hot keys")
    if hot_mode == 2 and pks is None:
        raise ValueError("bucket_exchange: salted hot keys need pk")
    if len(masks) != n_src or len(cols) != n_src \
            or (signs is not None and len(signs) != n_src) \
            or (pks is not None and len(pks) != n_src):
        raise ValueError("bucket_exchange: one key, mask, sign, pk and "
                         "column list per source shard")
    ncols = len(outs)
    if ncols > MAX_COLS or len(fills) != ncols:
        raise ValueError(f"bucket_exchange: at most {MAX_COLS} columns, one "
                         "fill and one buffer each")
    _check_keys(keys[0], "bucket_exchange")
    b, dev = keys[0].shape[0], keys[0].device
    # one cheap test a tensor (the call takes 8 x 13 of them on the sharded
    # paths); the detailed checks only name what failed
    shape, didx = (b,), keys[0].get_device()
    dts = [o.dtype for o in outs]

    def bad(t, dtype):
        return t.dtype is not dtype or t.shape != shape \
            or t.get_device() != didx or not t.is_contiguous()
    ins = [(keys, torch.int64, "key"), (masks, torch.bool, "mask")]
    if signs is not None:
        ins.append((signs, torch.int32, "sign"))
    if pks is not None:
        ins.append((pks, torch.int64, "pk"))
    for s in range(n_src):
        for ts, dtype, what in ins:
            if bad(ts[s], dtype):
                _check_in_dt(ts[s], b, dev, dtype,
                             f"bucket_exchange source {s} {what}")
        if len(cols[s]) != ncols:
            raise ValueError(f"bucket_exchange: source {s} has "
                             f"{len(cols[s])} columns, expected {ncols}")
        for j, c in enumerate(cols[s]):
            if bad(c, dts[j]):
                _check_col(c, b, keys[0], f"bucket_exchange source {s} "
                           f"column {j}")
                raise ValueError(f"bucket_exchange: source {s} column {j} "
                                 f"is {c.dtype}, its buffer {dts[j]}")
    for j, o in enumerate(outs):
        if o.device != dev or tuple(o.shape) != (n, n_src, cap) \
                or not o.is_contiguous() or o.dtype not in _DTYPE:
            raise ValueError(f"bucket_exchange: buffer {j} must be a "
                             f"contiguous [{n}, {n_src}, {cap}] tensor on "
                             f"{dev}")
    masks_p, flip = vnode_parity()
    a = RwExchArgs()
    a.n, a.n_src, a.hot, a.n_hot = int(n), n_src, int(hot_mode), \
        len(hot_keys)
    a.ncols = ncols
    if route_bounds is not None:
        if len(route_bounds) != n + 1:
            raise ValueError(f"bucket_exchange: {len(route_bounds)} bounds "
                             f"for {n} shards")
        a.route = 1
        for s, v in enumerate(route_bounds):
            a.bounds[s] = int(v)
    for h, k in enumerate(hot_keys):
        a.hot_keys[h] = int(k)
    a.hot_mask = int(hot_mask)
    for j, m in enumerate(masks_p):
        a.vmask[j] = int(m)
    a.vflip, a.vbits = int(flip), len(masks_p)
    a.cap, a.b = int(cap), int(b)
    a.dtype[:ncols] = [_DTYPE[dt] for dt in dts]
    a.fill[:ncols] = [int(f) for f in fills]
    a.out[:ncols] = [o.data_ptr() for o in outs]
    a.key[:n_src] = [k.data_ptr() for k in keys]
    a.mask[:n_src] = [m.data_ptr() for m in masks]
    if signs is not None:
        a.sign[:n_src] = [t.data_ptr() for t in signs]
    if pks is not None:
        a.pk[:n_src] = [t.data_ptr() for t in pks]
    for s in range(n_src):
        a.col[s][:ncols] = [c.data_ptr() for c in cols[s]]
    lib = build()
    work = _scratch(lib.rw_exchange_work_bytes(b, n_src, n), keys[0])
    _check_rc(lib.rw_bucket_exchange(ctypes.byref(a), work.data_ptr(),
                                     _stream(keys[0])), "bucket_exchange")
    res = work[:8 * (n_src * n + n_src)].view(torch.int64)
    return res[:n_src * n].view(n_src, n), res[n_src * n:]


def _check_in_dt(t: torch.Tensor, n: int, dev: torch.device,
                 dtype: torch.dtype, what: str) -> None:
    if t.device != dev or t.dtype != dtype or t.dim() != 1 \
            or t.shape[0] != n or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous [{n}] {dtype} "
                         f"tensor on {dev}, got {list(t.shape)} {t.dtype} "
                         f"on {t.device}")


def gen_bids(key: torch.Tensor, n: int, scale: float, form: int,
             skew: float, minval: int, span: int, mult: int):
    """-> (auction int64 [n], price int64 [n], next key int64 [2]) from
    the key int64 [2] on the card (see `kernels.datagen.gen_bids`)."""
    if not key.is_cuda or key.dtype != torch.int64 or key.dim() != 1 \
            or key.shape[0] != 2 or not key.is_contiguous():
        raise ValueError("gen_bids: the key must be a contiguous int64 [2] "
                         "CUDA tensor")
    if not 0 <= n < _MAX_ROWS:
        raise ValueError("gen_bids: n must lie in [0, 2^31)")
    if not 1 <= span < 1 << 32 or not 0 <= mult < span:
        raise ValueError("gen_bids: span / multiplier out of range")
    lib = build()
    dev = key.device
    auction = torch.empty(n, dtype=torch.int64, device=dev)
    price = torch.empty(n, dtype=torch.int64, device=dev)
    nxt = torch.empty(2, dtype=torch.int64, device=dev)
    _check_rc(lib.rw_gen_bids(key.data_ptr(), n, float(scale), int(form),
                              float(skew), int(minval), int(span), int(mult),
                              auction.data_ptr(), price.data_ptr(),
                              nxt.data_ptr(), _stream(key)), "gen_bids")
    return auction, price, nxt
