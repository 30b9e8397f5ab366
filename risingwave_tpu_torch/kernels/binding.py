"""Build and bind the hand-written kernels: the sorted-run cores
(`csrc/sorted_runs.cu`), the join-side cores (`csrc/join_runs.cu`), the
multiset cores (`csrc/multiset_runs.cu`), the hop-window expansion
(`csrc/window_runs.cu`), the key-skew telemetry cores
(`csrc/skew_runs.cu`) and the state-tiering cores (`csrc/tier_runs.cu`).

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


_LIB = None
SOURCES = ("sorted_runs.cu", "join_runs.cu", "multiset_runs.cu",
           "window_runs.cu", "skew_runs.cu", "tier_runs.cu")


def build() -> ctypes.CDLL:
    """Compile (once per process; every source at once) and load the
    kernel library."""
    global _LIB
    if _LIB is None:
        from torch.utils.cpp_extension import CUDA_HOME
        nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
        os.makedirs(BUILD_DIR, exist_ok=True)
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(BUILD_DIR, src.replace(".cu", ".o"))
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *CUDA_FLAGS, "-std=c++17", "-Xcompiler", "-fPIC",
                 "-I", CSRC, "-c", "-o", obj, os.path.join(CSRC, src)]))
        failed = [src for src, pr in zip(SOURCES, procs) if pr.wait() != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        so = os.path.join(BUILD_DIR, "librw_kernels.so")
        subprocess.run([nvcc, *CUDA_FLAGS, "-shared", "-o", so, *objs],
                       check=True)
        lib = ctypes.CDLL(so)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for fn in ("rw_sort_scratch_bytes", "rw_scan_scratch_bytes",
                   "rw_reduce_scratch_bytes",
                   "rw_rows_scratch_bytes", "rw_side_scratch_bytes",
                   "rw_probe_scratch_bytes",
                   "rw_ms_scratch_bytes", "rw_topk_scratch_bytes",
                   "rw_tier_scratch_bytes"):
            getattr(lib, fn).argtypes = [i64]
            getattr(lib, fn).restype = i64
        lib.rw_sort_perm.argtypes = [p, p, i64, p, p, p, p]
        lib.rw_batch_reduce.argtypes = [p, p, i64, RwCols, p, p, p, p]
        lib.rw_merge_combine.argtypes = [p, i64, p, i64, RwCols, i32, i32,
                                         p, p, p, p]
        lib.rw_compact_rows.argtypes = [p, i64, RwCols, i64, p, p, p]
        lib.rw_reduce_rows.argtypes = [p, p, p, i64, RwCols, p, p, p, p]
        lib.rw_side_merge.argtypes = [p, p, i64, p, p, p, i64, RwCols, p, p,
                                      p, p, p]
        lib.rw_probe.argtypes = [p, i64, p, p, i64, i64, p, p, p, p, p, p]
        lib.rw_ms_reduce.argtypes = [p, p, p, p, i64, p, p, p, p, p]
        lib.rw_ms_combine.argtypes = [p, p, p, i64, p, p, p, i64, p, p, p,
                                      p, p, p]
        lib.rw_ms_find.argtypes = [p, p, p, i64, p, p, i64, p, p, p]
        lib.rw_hop_expand.argtypes = [RwCols, i64, i32, p, i64, i64, p, p,
                                      p, p, p, p, p, p, p]
        lib.rw_vnode_hist.argtypes = [p, p, p, i64, i64, p, p]
        lib.rw_topk_packed.argtypes = [p, p, i64, i64, p, p, p]
        lib.rw_touch_stamp.argtypes = [p, i64, p, p, i64, p, p, i64, p,
                                       i64, i64, p, p, p]
        lib.rw_tier_partition.argtypes = [p, i64, p, i64, RwCols, i32, i64,
                                          p, p, p]
        for fn in ("rw_sort_perm", "rw_batch_reduce", "rw_merge_combine",
                   "rw_compact_rows", "rw_reduce_rows", "rw_side_merge",
                   "rw_probe", "rw_ms_reduce", "rw_ms_combine", "rw_ms_find",
                   "rw_hop_expand", "rw_vnode_hist", "rw_topk_packed",
                   "rw_touch_stamp", "rw_tier_partition"):
            getattr(lib, fn).restype = i32
        _LIB = lib
    return _LIB


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# Launch sites, in the order of `RwSite` in csrc/sorted_runs.h (from 1)
# then `RwJoinSite`, `RwMultisetSite`, `RwWindowSite`, `RwSkewSite` and
# `RwTierSite` in the other headers.
SITES = ("k_sort_upsweep", "k_sort_plan", "k_tile_sums", "k_scan_sums",
         "k_tile_apply", "k_sort_pass", "k_reduce_tiles", "k_reduce_carry",
         "k_merge_place", "k_merge_combine", "k_compact_fill",
         "k_reduce_tiles (rows)", "k_reduce_carry (rows)",
         "k_reduce_gather (rows)", "k_side_cuts",
         "k_side_merge", "k_side_fill", "k_probe_bounds",
         "k_probe_expand", "k_ms_gather_k2", "k_ms_segments",
         "k_place2 (ms_merge)", "k_ms_combine", "k_ms_find",
         "k_hop_expand", "k_vnode_hist", "k_topk (rows)", "k_topk (merge)",
         "k_touch_stamp", "k_partition_fill")
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
    ws = _scratch(lib.rw_reduce_scratch_bytes(n), sk)
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
    ws = _scratch(lib.rw_side_scratch_bytes(c + b), s_jk)
    _check_rc(lib.rw_side_merge(s_jk.data_ptr(), s_pk.data_ptr(), c,
                                d_jk.data_ptr(), d_pk.data_ptr(),
                                d_sign.data_ptr(), b, cols, o_jk.data_ptr(),
                                o_pk.data_ptr(), needed.data_ptr(),
                                ws.data_ptr(), _stream(s_jk)), "merge_side")
    return [o_jk, o_pk] + outs + [needed]


def probe(side_jk: torch.Tensor, qjk: torch.Tensor, qmask: torch.Tensor,
          m: int) -> List[torch.Tensor]:
    """-> [row int32 [m], sidx int64 [m], mask bool [m], total int64]."""
    _check_keys(side_jk, "probe side")
    _check_keys(qjk, "probe queries")
    q = qjk.shape[0]
    _check_col(qjk, q, side_jk, "probe queries")
    if q == 0:
        raise ValueError("probe: at least one query row")
    if m < 0:
        raise ValueError("probe: m must be >= 0")
    _check_col(qmask, q, side_jk, "probe mask")
    if qmask.dtype != torch.bool:
        raise ValueError("probe: mask must be bool")
    lib = build()
    dev = side_jk.device
    row = torch.empty(m, dtype=torch.int32, device=dev)
    sidx = torch.empty(m, dtype=torch.int64, device=dev)
    mask = torch.empty(m, dtype=torch.bool, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    ws = _scratch(lib.rw_probe_scratch_bytes(q), side_jk)
    _check_rc(lib.rw_probe(side_jk.data_ptr(), side_jk.shape[0],
                           qjk.data_ptr(), qmask.data_ptr(), q, int(m),
                           row.data_ptr(), sidx.data_ptr(), mask.data_ptr(),
                           total.data_ptr(), ws.data_ptr(),
                           _stream(side_jk)), "probe")
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


def ms_combine(s1: torch.Tensor, s2: torch.Tensor, s_cnt: torch.Tensor,
               d1: torch.Tensor, d2: torch.Tensor, d_cnt: torch.Tensor
               ) -> List[torch.Tensor]:
    """-> [merged k1 [c+b], merged k2, alive flags, combined counts]."""
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
    dev = s1.device
    m1, m2, m_cnt = (torch.empty(n, dtype=torch.int64, device=dev)
                     for _ in range(3))
    alive = torch.empty(n, dtype=torch.bool, device=dev)
    src = torch.empty(n, dtype=torch.int32, device=dev)
    _check_rc(lib.rw_ms_combine(s1.data_ptr(), s2.data_ptr(), s_cnt.data_ptr(),
                                c, d1.data_ptr(), d2.data_ptr(),
                                d_cnt.data_ptr(), b, m1.data_ptr(),
                                m2.data_ptr(), m_cnt.data_ptr(),
                                alive.data_ptr(), src.data_ptr(),
                                _stream(s1)), "ms_merge")
    return [m1, m2, alive, m_cnt]


def ms_find(k1: torch.Tensor, k2: torch.Tensor, cnt: torch.Tensor,
            q1: torch.Tensor, q2: torch.Tensor) -> List[torch.Tensor]:
    """-> [found bool [q], count int64 [q]]."""
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
    found = torch.empty(q, dtype=torch.bool, device=k1.device)
    out = torch.empty(q, dtype=torch.int64, device=k1.device)
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


def vnode_hist(keys: torch.Tensor, live: Optional[torch.Tensor],
               weights: Optional[torch.Tensor], empty_key: int,
               out: torch.Tensor) -> None:
    """Adds the rows' weighted vnode buckets into `out` (int64 [16])."""
    _check_keys(keys, "vnode_hist")
    n = keys.shape[0]
    if live is not None:
        _check_col(live, n, keys, "vnode_hist live")
        if live.dtype != torch.bool:
            raise ValueError("vnode_hist: live must be bool")
    if weights is not None:
        _check_col(weights, n, keys, "vnode_hist weights")
        if weights.dtype != torch.int64:
            raise ValueError("vnode_hist: weights must be int64")
    _check_col(out, 16, keys, "vnode_hist out")
    if out.dtype != torch.int64:
        raise ValueError("vnode_hist: out must be int64")
    lib = build()
    _check_rc(lib.rw_vnode_hist(
        keys.data_ptr(), None if live is None else live.data_ptr(),
        None if weights is None else weights.data_ptr(), n, int(empty_key),
        out.data_ptr(), _stream(keys)), "vnode_hist")


def topk_packed(keys: torch.Tensor, counts: Optional[torch.Tensor],
                empty_key: int) -> torch.Tensor:
    """-> the four largest packed (count, key) values, int64 [4]."""
    _check_keys(keys, "topk_packed")
    n = keys.shape[0]
    if counts is not None:
        _check_col(counts, n, keys, "topk_packed counts")
        if counts.dtype != torch.int64:
            raise ValueError("topk_packed: counts must be int64")
    lib = build()
    out = torch.empty(4, dtype=torch.int64, device=keys.device)
    ws = _scratch(lib.rw_topk_scratch_bytes(n), keys)
    _check_rc(lib.rw_topk_packed(
        keys.data_ptr(), None if counts is None else counts.data_ptr(), n,
        int(empty_key), out.data_ptr(), ws.data_ptr(), _stream(keys)),
        "topk_packed")
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
    _check_rc(lib.rw_touch_stamp(
        keys.data_ptr(), n, old_keys.data_ptr(), old_touch.data_ptr(), n_old,
        src_keys.data_ptr(), None if src_vals is None else src_vals.data_ptr(),
        n_src, tick.data_ptr(), int(ttl), int(empty_key), out.data_ptr(),
        counts.data_ptr(), _stream(keys)), "touch_stamp")
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
