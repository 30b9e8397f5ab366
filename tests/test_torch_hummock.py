"""The port's `SpillStateStore` against the JAX package's: the six cases
of the reference's tests/test_durable_state.py run in both packages (each
in a directory of its own: a directory is locked by the process that
opens it, per package) with every read, file listing, count and cache
size held equal; then the directories themselves: written by one
package and read by the other, both ways, a reference run file whose
filter has the legacy ver-0 layout read by both, and the block cache's
hits and the `state_filter_negative_skips` counter equal."""
import os
import pickle
import shutil
import struct
import zlib

import pytest

from host_parity import (I, PKGS, PORT, REF, assert_same, drive_job,
                         dump_store, fixed_epochs, sources)  # noqa: F401


def pkg_dir(tmp_path, P, name="d"):
    d = tmp_path / P.root / name
    d.mkdir(parents=True, exist_ok=True)
    return str(d)


def runs_of(d):
    return sorted(os.listdir(os.path.join(d, "runs")))


def both(fn, tmp_path):
    ref, port = (fn(P, pkg_dir(tmp_path, P)) for P in PKGS)
    assert_same(ref, port)
    return ref


def _roundtrip(P, d):
    S = P.state.SpillStateStore
    st = S(d)
    st.ingest_batch(1, [(b"a", (1, 2)), (b"b", (3, 4))], epoch=100)
    st.commit_epoch(100)
    st.ingest_batch(1, [(b"a", None), (b"c", (5, 6))], epoch=200)
    st.commit_epoch(200)
    st2 = S(d)
    return [st2.committed_epoch, st2.get(1, b"a"), st2.get(1, b"b"),
            st2.get(1, b"c"), dump_store(st2), runs_of(d)]


def _uncommitted_lost(P, d):
    S = P.state.SpillStateStore
    st = S(d)
    st.ingest_batch(1, [(b"a", (1,))], epoch=100)
    st.commit_epoch(100)
    st.ingest_batch(1, [(b"b", (2,))], epoch=200)
    before = dump_store(st)
    st2 = S(d)
    return [before, st2.get(1, b"a"), st2.get(1, b"b"), dump_store(st2)]


def _compaction(P, d):
    S = P.state.SpillStateStore
    st = S(d)
    out = []
    for e in range(1, 24):
        st.ingest_batch(3, [(f"k{e}".encode(), (e,))], epoch=e * 10)
        st.commit_epoch(e * 10)
        out.append(runs_of(d))
    st2 = S(d)
    out += [st2.table_len(3), [st2.get(3, f"k{e}".encode())
                               for e in range(1, 24)],
            [m["committed_epoch"] for m in st2.history_versions()],
            dump_store(st2)]
    return out


def _agg_recovery(P, d):
    """test_agg_job_recovery_over_spill_store: a HashAgg job over the
    store, "crashed", then a second job over the reopened store."""
    out = []
    for rows in ([(I, (1, 10)), (I, (2, 20))], [(I, (1, 5))]):
        store = P.state.SpillStateStore(d)
        inj = P.ops.BarrierInjector()
        readers, (src,) = sources(P, inj, [["INT64", "INT64"]])
        st = P.state.StateTable(store, 10, [P.T.INT64, P.T.BYTEA], [0])
        agg = P.ops.HashAggExecutor(src, [0], [P.agg("count"),
                                               P.agg("sum", 1)],
                                    state_table=st)
        mv = P.state.StateTable(store, 11, agg.schema.dtypes, [0])
        mat = P.ops.MaterializeExecutor(agg, mv,
                                        P.ops.ConflictBehavior.OVERWRITE)
        out += drive_job(P, mat, inj, [store], readers,
                         [[[P.chunk(["INT64", "INT64"], rows)]]])
        out.append(sorted(P.ops.BatchScan(mv, None).rows()))
    return out


def _larger_than_cache(P, d):
    S = P.state.SpillStateStore
    n_block = P.hummock.BLOCK_ROWS
    st = S(d, cache_blocks=4)
    n = n_block * 40
    per = n // 4
    for c in range(4):
        st.ingest_batch(7, [(b"k%08d" % i, (i, i * 2))
                            for i in range(c * per, (c + 1) * per)],
                        epoch=(c + 1) * 10)
        st.commit_epoch((c + 1) * 10)
    st2 = S(d, cache_blocks=4)
    out = [len(st2.cache)]
    for i in [0, 1, per - 1, per, n // 2, n - 1, n]:
        out.append((st2.get(7, b"k%08d" % i), len(st2.cache),
                     st2.cache.hits, st2.cache.misses))
    lo, hi = per - 5, per + 5
    out.append(list(st2.iter_range(7, b"k%08d" % lo, b"k%08d" % hi)))
    out.append((len(st2.cache), st2.cache.hits, st2.cache.misses))
    out.append(sum(1 for _ in st2.iter_range(7, None, None)))
    return out


def _tombstones(P, d):
    S = P.state.SpillStateStore
    st = S(d)
    st.ingest_batch(5, [(b"a", (1,)), (b"b", (1,)), (b"c", (1,))], epoch=10)
    st.commit_epoch(10)
    st.ingest_batch(5, [(b"a", (2,)), (b"b", None)], epoch=20)
    st.commit_epoch(20)
    out = [st.get(5, b"a"), st.get(5, b"b"),
           list(st.iter_range(5, None, None))]
    st.ingest_batch(5, [(b"a", None), (b"d", (9,))], epoch=30)
    out += [st.get(5, b"a"), st.get(5, b"d"),
            list(st.iter_range(5, None, None)), st.table_len(5)]
    st2 = S(d)
    out += [st2.get(5, b"a"), st2.get(5, b"d"), dump_store(st2),
            st2.compact_all(), dump_store(st2), runs_of(d)]
    return out


CASES = {"roundtrip_across_reopen": _roundtrip,
         "uncommitted_epoch_lost": _uncommitted_lost,
         "compaction_prunes_files": _compaction,
         "agg_job_recovery": _agg_recovery,
         "state_larger_than_cache": _larger_than_cache,
         "overwrites_and_tombstones": _tombstones}


@pytest.mark.parametrize("case", list(CASES))
def test_durable_state(fixed_epochs, tmp_path, case):
    both(CASES[case], tmp_path)


def test_no_xor8_of_its_own():
    """The port's spill store reads and writes the one Xor8 copy in
    `state/xor8.py` (which the cold tier shares)."""
    from risingwave_tpu_torch.state import hummock, xor8
    assert hummock.Xor8 is xor8.Xor8
    assert "class Xor8" not in open(hummock.__file__).read()


# ---------------------------------------------------------------------------
# one package's directory, read by the other
# ---------------------------------------------------------------------------


def _write_history(P, d):
    """Three tables over 12 epochs: overwrites, tombstones, a compaction
    (past COMPACT_THRESHOLD runs), rows of ints, strings, Decimals,
    floats, bytes and NULLs."""
    from decimal import Decimal
    st = P.state.SpillStateStore(d)
    for e in range(1, 13):
        st.ingest_batch(1, [(b"k%04d" % (e * 7 % 13), (e, f"s{e}", None))],
                        epoch=e)
        st.ingest_batch(2, [(b"g%02d" % (e % 5),
                             (Decimal(e) / 4, e * 0.1, b"\x00" * e))],
                        epoch=e)
        if e % 4 == 0:
            st.ingest_batch(1, [(b"k%04d" % (e % 13), None)], epoch=e)
        st.ingest_batch(3, [(b"z%05d" % i, (i,)) for i in range(e * 50)],
                        epoch=e)
        st.commit_epoch(e)
    return st


def _read_all(P, d):
    st = P.state.SpillStateStore(d)
    keys = [b"k%04d" % i for i in range(14)] + [b"g%02d" % i
                                                for i in range(6)]
    return [st.committed_epoch, dump_store(st),
            [(t, k, st.get(t, k)) for t in (1, 2) for k in keys],
            [st.table_len(t) for t in (1, 2, 3)]]


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref_to_port", "port_to_ref"])
def test_directory_read_across_packages(tmp_path, writer, reader):
    """A directory one package wrote reads back equal in the other (a
    copy: the writer's process holds the original's lock), and the
    reader's further commits and compaction read back in the writer."""
    d = pkg_dir(tmp_path, writer, "w")
    _write_history(writer, d)
    want = _read_all(writer, d)
    cp = str(tmp_path / "copy")
    shutil.copytree(d, cp)
    assert _read_all(reader, cp) == want
    st = reader.state.SpillStateStore(cp)
    st.ingest_batch(1, [(b"k0001", (99, "x", None))], epoch=20)
    st.commit_epoch(20)
    st.compact_all()
    after = _read_all(reader, cp)
    cp2 = str(tmp_path / "copy2")
    shutil.copytree(cp, cp2)
    assert _read_all(writer, cp2) == after
    assert after[0] == 20 and after != want


# ---------------------------------------------------------------------------
# a legacy ver-0 filter
# ---------------------------------------------------------------------------


def _xor8_ver0(keys):
    """A filter in the legacy ver-0 layout (20-bit hash slices), peeled as
    the reference once built them: (seed, seg, fp)."""
    X = REF.hummock.Xor8
    n = len(keys)
    seg = (int(1.23 * n) + 32 + 2) // 3
    for seed in range(8):
        hs = [X._h(k, seed) for k in keys]
        m = 3 * seg
        count, hxor = [0] * m, [0] * m
        for h in hs:
            for p in X._positions(h, seg, 0)[1:]:
                count[p] += 1
                hxor[p] ^= h
        stack, queue = [], [p for p in range(m) if count[p] == 1]
        while queue:
            p = queue.pop()
            if count[p] != 1:
                continue
            h = hxor[p]
            stack.append((p, h))
            for q in X._positions(h, seg, 0)[1:]:
                count[q] -= 1
                hxor[q] ^= h
                if count[q] == 1:
                    queue.append(q)
        if len(stack) == n:
            fp = bytearray(m)
            for p, h in reversed(stack):
                f, p0, p1, p2 = X._positions(h, seg, 0)
                fp[p] = f ^ fp[p0] ^ fp[p1] ^ fp[p2] ^ fp[p]
            return seed, seg, bytes(fp)
    raise AssertionError("ver-0 filter did not peel")


def _legacy_dir(d, n=1000):
    """A data directory with one table (id 4) in one run file whose
    footer carries a 3-tuple (ver-0) filter — the reference's run format
    before the full-width filter layout."""
    os.makedirs(os.path.join(d, "runs"), exist_ok=True)
    rows = [(b"r%06d" % (2 * i), (i, f"v{i}")) for i in range(n)]
    blob, index, off, br = b"", [], 0, REF.hummock.BLOCK_ROWS
    for lo in range(0, n, br):
        blk = zlib.compress(pickle.dumps(rows[lo:lo + br], protocol=4), 1)
        index.append((rows[lo][0], off, len(blk)))
        blob += blk
        off += len(blk)
    filt = _xor8_ver0([k for k, _ in rows])
    name = "t4_e5_1.run"
    with open(os.path.join(d, "runs", name), "wb") as f:
        f.write(blob + pickle.dumps((index, n, filt), protocol=4)
                + struct.pack(">Q", off))
    with open(os.path.join(d, "MANIFEST.json"), "w") as f:
        f.write('{"committed_epoch": 5, "tables": {"4": ["%s"]}, '
                '"counts": {"4": %d}}' % (name, n))


def _skips(P):
    reg = P.mod("utils.metrics").REGISTRY
    return reg.counter("state_filter_negative_skips",
                       "point reads skipped by run xor filters"
                       ).labels().value


def _probe(P, d):
    """Point reads of every live key and as many absent ones; the block
    cache's hits and misses and the filter's negative skips."""
    st = P.state.SpillStateStore(d, cache_blocks=2)
    s0 = _skips(P)
    got = [st.get(4, b"r%06d" % i) for i in range(2000)]
    reader = st._run_readers(4)[0]
    return [got, (type(reader.filter).__name__, reader.filter.ver),
            st.cache.hits, st.cache.misses, _skips(P) - s0,
            list(st.iter_range(4, b"r000100", b"r000140"))]


def test_legacy_ver0_filter_is_read(tmp_path):
    out = []
    for P in PKGS:
        d = pkg_dir(tmp_path, P, "legacy")
        _legacy_dir(d)
        out.append(_probe(P, d))
    assert_same(out[0], out[1])
    got, (kind, ver), hits, misses, skips, _ = out[1]
    assert kind == "Xor8" and ver == 0
    assert got[0] == (0, "v0") and got[1] is None and got[1998] == (999,
                                                                     "v999")
    assert skips > 900 and hits > 0 and misses > 0


def test_cache_hits_and_negative_skips_match(tmp_path):
    """Runs written by each package's own writer (full-width filters):
    the same reads give the same cache hits and misses and the same
    negative-skip count."""
    out = []
    for P in PKGS:
        d = pkg_dir(tmp_path, P, "filters")
        st = P.state.SpillStateStore(d, cache_blocks=3)
        for e in range(1, 5):
            st.ingest_batch(4, [(b"r%06d" % (2 * i), (i, f"v{i}"))
                                for i in range((e - 1) * 250, e * 250)],
                            epoch=e)
            st.commit_epoch(e)
        out.append(_probe(P, d)[2:])
    assert out[0] == out[1]
    assert out[1][2] > 1000            # absent keys skipped run by run
