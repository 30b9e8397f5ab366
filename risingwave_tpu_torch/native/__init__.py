"""The port's C++ host kernels (`rw_native.cpp`, the port's own copy of
the JAX package's `native/`), loaded with ctypes.

The host hot loops of the executors go through here: the vnode of a
single non-null integral key (`core.vnode.compute_vnodes`' fast path,
`parallel.rescale`, `bucket_parity`), CRC32 over byte rows and the int64
memcomparable encoding.

The library is built at first use, with g++, from the source beside this
file into `BUILD_DIR` (git-ignored), under a name keyed on a hash of the
source and the compiler command (a tree unpacked by `git archive` carries
arbitrary mtimes). The build writes a temporary file and renames it into
place, so a process or thread that loads the library never sees a
half-written one, whichever of several building at once wins. There is
no fallback: a missing compiler or a failed build raises with the
command and its stderr. The numpy versions (`core.vnode.vnodes_i64_plain`,
`core.vnode.crc32_bytes_matrix`, `memcmp_i64_plain` here) are what the
tests and `chip_smoke.py` hold the wrappers to.

Every wrapper adds one to `CALLS[name]` each time it calls its kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "rw_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_native")
CXX = "g++"
CXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

CALLS: Dict[str, int] = {"crc32_rows": 0, "vnodes_i64": 0, "memcmp_i64": 0}

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()           # the build and load
_calls_lock = threading.Lock()


def reset_calls() -> None:
    with _calls_lock:
        for k in CALLS:
            CALLS[k] = 0


def _count(name: str) -> None:
    with _calls_lock:
        CALLS[name] += 1


def library_path() -> str:
    """Where the library for this source and compiler command lives."""
    with open(SRC, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join([CXX, *CXX_FLAGS]).encode())
    return os.path.join(BUILD_DIR, f"librw_native-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native: `{' '.join(cmd)}` failed: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"native: `{' '.join(cmd)}` exited "
                           f"{res.returncode}:\n{res.stderr}")
    os.replace(tmp, so)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if this source has none yet."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.rw_crc32_rows.argtypes = [u8p, i64, i64, u32p]
        lib.rw_crc32_i64_be.argtypes = [i64p, i64, u32p]
        lib.rw_vnodes_i64.argtypes = [i64p, i64, ctypes.c_int32, i32p]
        lib.rw_fnv1a64_rows.argtypes = [u8p, i64p, i64, i64, u64p]
        lib.rw_memcmp_i64.argtypes = [i64p, i64, u8p]
        for fn in ("rw_crc32_rows", "rw_crc32_i64_be", "rw_vnodes_i64",
                   "rw_fnv1a64_rows", "rw_memcmp_i64"):
            getattr(lib, fn).restype = None
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here (the wrappers raise
    where it does not)."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _i64(vals: np.ndarray) -> np.ndarray:
    """Integral keys as contiguous int64 (the reference's upcast; an
    object array of Python ints converts too)."""
    vals = np.asarray(vals)
    if vals.ndim != 1 or vals.dtype.kind not in "biuO":
        raise ValueError(f"native: want a 1-d integral array, got "
                         f"{vals.dtype} of shape {vals.shape}")
    return np.ascontiguousarray(vals.astype(np.int64, copy=False))


def crc32_rows(data: np.ndarray) -> np.ndarray:
    """CRC32 (zlib's) of each row of a (n, k) uint8 matrix: uint32 [n]."""
    data = np.asarray(data)
    if data.ndim != 2 or data.dtype != np.uint8:
        raise ValueError(f"crc32_rows: want uint8 [n, k], got {data.dtype} "
                         f"of shape {data.shape}")
    lib = get_lib()
    data = np.ascontiguousarray(data)
    n, k = data.shape
    out = np.empty(n, dtype=np.uint32)
    lib.rw_crc32_rows(data, n, k, out)
    _count("crc32_rows")
    return out


def vnodes_i64(vals: np.ndarray, vnode_count: int) -> np.ndarray:
    """vnode of each integral key: CRC32 of its 8 big-endian bytes mod
    `vnode_count`, int32 [n]."""
    if not 0 < vnode_count < 1 << 31:
        raise ValueError(f"vnodes_i64: vnode_count {vnode_count}")
    lib = get_lib()
    vals = _i64(vals)
    out = np.empty(len(vals), dtype=np.int32)
    lib.rw_vnodes_i64(vals, len(vals), vnode_count, out)
    _count("vnodes_i64")
    return out


def memcmp_i64(vals: np.ndarray) -> np.ndarray:
    """Memcomparable encoding of each int64 (big-endian, sign bit
    flipped): uint8 [n, 8], byte order equal to numeric order."""
    lib = get_lib()
    vals = _i64(vals)
    out = np.empty((len(vals), 8), dtype=np.uint8)
    lib.rw_memcmp_i64(vals, len(vals), out)
    _count("memcmp_i64")
    return out


def memcmp_i64_plain(vals: np.ndarray) -> np.ndarray:
    """`memcmp_i64` in numpy."""
    u = _i64(vals).view(np.uint64) ^ np.uint64(1 << 63)
    return u.astype(">u8").view(np.uint8).reshape(len(u), 8)
