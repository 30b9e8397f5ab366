"""The port's C++ host kernels (`risingwave_tpu_torch/native/`) on the CPU,
where g++ builds them: each wrapper against the JAX package's native
wrapper on the same seeded inputs, against its numpy plain version
(`vnodes_i64_plain`, `crc32_bytes_matrix` over `_int_key_bytes`,
`memcmp_i64_plain`) and `crc32_rows` against zlib, all to the bit; the
sign edges, n = 0, strided views and every integral column type through
`compute_vnodes` against the reference's; the callers that go through
the library (`compute_vnodes`' one-integral-key path, `rescale`,
`bucket_parity`) and those that do not; and the build: two processes
building into one fresh directory, eight threads on first use, and a
missing compiler, which raises with no fallback."""
import subprocess
import sys
import threading
import zlib

import numpy as np
import pytest

from risingwave_tpu import native as RN
from risingwave_tpu.core import chunk as RC
from risingwave_tpu.core import dtypes as RT
from risingwave_tpu.core import vnode as RV
from risingwave_tpu_torch import native as N
from risingwave_tpu_torch.core import chunk as PC
from risingwave_tpu_torch.core import dtypes as PT
from risingwave_tpu_torch.core import vnode as PV
from risingwave_tpu_torch.core.encoding import encode_datum_memcomparable
from risingwave_tpu_torch.parallel import rescale as PR

I64 = np.iinfo(np.int64)
EDGES = [int(I64.min), -1, 0, int(I64.max)]


def keys(seed, n):
    rng = np.random.default_rng(seed)
    k = rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True)
    k[:min(n, 4)] = EDGES[:min(n, 4)]
    return k


def ref(fn, *args):
    out = fn(*args)
    assert out is not None, "the reference's native library did not load"
    return out


@pytest.mark.parametrize("n", [0, 1, 513])
@pytest.mark.parametrize("vnode_count", [256, 1000])
def test_vnodes_i64(n, vnode_count):
    k = keys(n + vnode_count, n)
    got = N.vnodes_i64(k, vnode_count)
    assert got.dtype == np.int32 and got.shape == (n,)
    assert np.array_equal(got, ref(RN.vnodes_i64, k, vnode_count))
    assert np.array_equal(got, PV.vnodes_i64_plain(k, vnode_count))
    zl = [zlib.crc32(int(v).to_bytes(8, "big", signed=True)) % vnode_count
          for v in k[:64]]
    assert got[:64].tolist() == zl


@pytest.mark.parametrize("k", [0, 1, 7, 8, 9, 13, 64])
@pytest.mark.parametrize("n", [0, 1, 513])
def test_crc32_rows(n, k):
    data = np.random.default_rng(k * 1000 + n).integers(
        0, 256, (n, k), dtype=np.uint8)
    got = N.crc32_rows(data)
    assert got.dtype == np.uint32 and got.shape == (n,)
    assert np.array_equal(got, ref(RN.crc32_rows, data))
    assert np.array_equal(got, PV.crc32_bytes_matrix(data))
    assert got.tolist() == [zlib.crc32(r.tobytes()) for r in data]


@pytest.mark.parametrize("n", [0, 1, 513])
def test_crc32_rows_int_keys(n):
    """`crc32_rows` over keys' big-endian bytes (`_int_key_bytes`), the
    vnode hash before its mod."""
    b = PV._int_key_bytes(keys(n + 7, n))
    assert np.array_equal(N.crc32_rows(b), PV.crc32_bytes_matrix(b))


@pytest.mark.parametrize("n", [0, 1, 513])
def test_memcmp_i64(n):
    k = keys(n + 11, n)
    got = N.memcmp_i64(k)
    assert got.dtype == np.uint8 and got.shape == (n, 8)
    assert np.array_equal(got, ref(RN.memcmp_i64, k))
    assert np.array_equal(got, N.memcmp_i64_plain(k))
    for v, row in zip(k[:64].tolist(), got):
        assert row.tobytes() == encode_datum_memcomparable(
            v, PT.INT64)[1:]
    # byte order is numeric order
    order = sorted(range(n), key=lambda i: got[i].tobytes())
    assert np.array_equal(k[order], np.sort(k))


def test_entry_points_beside_the_wrapped_ones():
    """The two C entries no wrapper calls: `rw_crc32_i64_be` against the
    reference's library and numpy, `rw_fnv1a64_rows` against numpy's
    FNV-1a (`_fnv1a64_bytes_matrix`). The reference's C entry starts
    from 1469598103934665603, FNV's offset basis with its last digit
    lost, and so differs from its own numpy FNV; the port's starts from
    the basis, and no caller of either package reaches the entry."""
    lib, rlib = N.get_lib(), RN.get_lib()
    assert rlib is not None
    k = keys(5, 513)
    a, b = np.empty(513, np.uint32), np.empty(513, np.uint32)
    lib.rw_crc32_i64_be(k, 513, a)
    rlib.rw_crc32_i64_be(k, 513, b)
    assert np.array_equal(a, b)
    assert np.array_equal(a, PV.crc32_bytes_matrix(PV._int_key_bytes(k)))
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, (513, 13), dtype=np.uint8)
    lens = rng.integers(0, 14, 513).astype(np.int64)
    h = np.empty(513, np.uint64)
    lib.rw_fnv1a64_rows(data, lens, 513, 13, h)
    assert np.array_equal(h, PV._fnv1a64_bytes_matrix(data, lens))
    empty = lens == 0
    assert empty.any() and (h[empty] == PV.FNV_OFFSET).all()


TYPES = [("INT16", np.int16), ("INT32", np.int32), ("INT64", np.int64),
         ("DATE", np.int32), ("TIMESTAMP", np.int64)]


@pytest.mark.parametrize("name,dt", TYPES)
@pytest.mark.parametrize("stride", [1, 3])
def test_compute_vnodes_integral_columns(name, dt, stride):
    """One non-null integral column of each type, contiguous and as a
    strided view: the port's `compute_vnodes` goes through the library
    once and equals the reference's and the plain version after the
    int64 upcast."""
    info = np.iinfo(dt)
    base = np.random.default_rng(len(name) * stride).integers(
        info.min, info.max, 1539, dtype=dt, endpoint=True)
    base[:4] = [info.min, -1, 0, info.max]
    vals = base[::stride]
    before = N.CALLS["vnodes_i64"]
    got = PV.compute_vnodes([PC.Column(getattr(PT, name), vals)],
                            vnode_count=1000)
    assert N.CALLS["vnodes_i64"] == before + 1
    want = RV.compute_vnodes([RC.Column(getattr(RT, name), vals)],
                             vnode_count=1000)
    assert np.array_equal(got, want)
    assert np.array_equal(got, PV.vnodes_i64_plain(vals, 1000))


def test_compute_vnodes_other_keys_stay_numpy():
    """Two columns, a nullable column, a float and a string key take the
    numpy CRC in both packages: no library call, the same vnodes."""
    k = keys(8, 257)
    valid = np.arange(257) % 5 != 0
    cases = [
        ([(PT.INT64, k, None), (PT.INT32, k.astype(np.int32), None)],
         [(RT.INT64, k, None), (RT.INT32, k.astype(np.int32), None)]),
        ([(PT.INT64, k, valid)], [(RT.INT64, k, valid)]),
        ([(PT.FLOAT64, k.astype(np.float64), None)],
         [(RT.FLOAT64, k.astype(np.float64), None)]),
        ([(PT.VARCHAR, np.array([str(v) for v in k], object), None)],
         [(RT.VARCHAR, np.array([str(v) for v in k], object), None)]),
    ]
    for port, refc in cases:
        before = N.CALLS["vnodes_i64"]
        got = PV.compute_vnodes([PC.Column(t, v, m) for t, v, m in port])
        assert N.CALLS["vnodes_i64"] == before
        want = RV.compute_vnodes([RC.Column(t, v, m) for t, v, m in refc])
        assert np.array_equal(got, want)


def test_rescale_and_bucket_parity_call_the_library():
    k = keys(9, 4096)
    before = N.CALLS["vnodes_i64"]
    got = PR._vnode_of_keys(k, 256)
    assert N.CALLS["vnodes_i64"] == before + 1
    assert np.array_equal(got, PV.vnodes_i64_plain(k))
    masks, flip = PV.bucket_parity(16)
    assert N.CALLS["vnodes_i64"] == before + 2
    # the parities give vnode * 16 // 256 of every key
    bits = [np.array([bin(int(v) & m).count("1") & 1 for v in k[:256]])
            ^ (flip >> j & 1) for j, m in enumerate(masks)]
    bucket = sum(b << j for j, b in enumerate(bits))
    assert np.array_equal(bucket, got[:256] >> 4)


def test_reset_calls():
    N.vnodes_i64(keys(1, 4), 256)
    assert N.CALLS["vnodes_i64"] > 0
    N.reset_calls()
    assert N.CALLS == {"crc32_rows": 0, "vnodes_i64": 0, "memcmp_i64": 0}


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """The module as before its first use, building into tmp_path."""
    monkeypatch.setattr(N, "_LIB", None)
    monkeypatch.setattr(N, "BUILD_DIR", str(tmp_path / "build"))
    return tmp_path


CHILD = """
import sys
import numpy as np
from risingwave_tpu_torch import native as N
N.BUILD_DIR = sys.argv[1]
k = np.arange(-5000, 5000, dtype=np.int64) * 7919
print(int(N.vnodes_i64(k, 256).astype(np.int64).sum()), N.library_path())
"""


def test_two_processes_build_at_once(fresh):
    """Two processes start on one fresh build directory together: both
    build or load a whole library and agree."""
    d = str(fresh / "build")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, d],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    k = np.arange(-5000, 5000, dtype=np.int64) * 7919
    want = int(PV.vnodes_i64_plain(k).astype(np.int64).sum())
    assert [o.split() for o, _ in outs] == [[str(want),
                                            N.library_path()]] * 2
    # no temporary file is left beside the library
    assert sorted(p.name for p in (fresh / "build").iterdir()) == [
        N.library_path().rsplit("/", 1)[1]]


def test_eight_threads_on_first_use(fresh):
    k = keys(12, 1 << 14)
    want = PV.vnodes_i64_plain(k)
    out, errs = [None] * 8, []
    barrier = threading.Barrier(8)

    def work(i):
        try:
            barrier.wait(timeout=60)
            out[i] = N.vnodes_i64(k, 256)
        except Exception as e:          # reported below
            errs.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errs and not any(t.is_alive() for t in ts)
    assert all(np.array_equal(o, want) for o in out)


def test_missing_compiler_raises(fresh, monkeypatch):
    """No compiler: the wrappers and `compute_vnodes` raise, naming the
    command; nothing falls back to numpy."""
    monkeypatch.setattr(N, "CXX", str(fresh / "no-such-g++"))
    col = PC.Column(PT.INT64, keys(13, 64))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+ -std=c\\+\\+17"):
        N.vnodes_i64(col.values, 256)
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        PV.compute_vnodes([col])
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        PR._vnode_of_keys(col.values, 256)
    assert not N.available()
    assert N._LIB is None


def test_failed_build_reports_stderr(fresh, monkeypatch):
    """A compile error raises with the compiler's stderr."""
    monkeypatch.setattr(N, "CXX_FLAGS", N.CXX_FLAGS + [
        "-include", str(fresh / "missing.h")])
    with pytest.raises(RuntimeError, match="(?s)exited 1.*missing.h"):
        N.memcmp_i64(keys(14, 8))


@pytest.mark.parametrize("bad", [np.zeros((2, 2), np.int64),
                                 np.zeros(3, np.float64)])
def test_rejects_bad_keys(bad):
    with pytest.raises(ValueError):
        N.vnodes_i64(bad, 256)


def test_rejects_bad_vnode_count():
    with pytest.raises(ValueError):
        N.vnodes_i64(keys(15, 4), 0)
