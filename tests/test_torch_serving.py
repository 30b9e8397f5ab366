"""The port's serving cache (`serving/read_cache.py`), dead-letter queue
(`runtime/remote_fragments.DeadLetterQueue`) and freshness tracker
(`utils/freshness.py`) against the JAX package's: the same reads,
quarantines and commits in, the same snapshots, pulls, rows and
histograms out. Rows compare exactly with the `ts` column left out;
freshness values are computed from explicit stamps, so they are exact
too (tolerance 0).
"""
import threading
import time

import numpy as np
import pytest

import risingwave_tpu.utils.freshness as RF
import risingwave_tpu_torch.utils.freshness as PF
from risingwave_tpu.runtime.remote_fragments import \
    DeadLetterQueue as RDLQ
from risingwave_tpu.serving import MVReadCache as RCache
from risingwave_tpu.state import MemoryStateStore as RStore
from risingwave_tpu.state.state_table import StateTable as RTable
from risingwave_tpu.utils.metrics import REGISTRY as RREG
from risingwave_tpu_torch.runtime.remote_fragments import \
    DeadLetterQueue as PDLQ
from risingwave_tpu_torch.serving import MVReadCache as PCache
from risingwave_tpu_torch.state import MemoryStateStore as PStore
from risingwave_tpu_torch.state.state_table import StateTable as PTable
from risingwave_tpu_torch.utils.metrics import REGISTRY as PREG


def cache_script(cache):
    """test_serving's fill / hit / staleness walk over one cache class."""
    c = cache()
    pulls = []

    def fill_at(e):
        def fill():
            pulls.append(e)
            return e, [("rows", e)]
        return fill

    out = [c.get("mv", 5, 0, fill_at(5)), c.get("mv", 5, 0, fill_at(5)),
           list(pulls), c.get("mv", 7, 0, fill_at(7)), list(pulls)]
    c2 = cache()
    c2.get("mv", 5, 0, fill_at(5))
    out += [c2.get("mv", 7, 2, fill_at(7)), c2.get("mv", 8, 2, fill_at(8)),
            c2.peek("mv", 8), c2.peek("mv", 9), c2.peek("other", 0)]
    out += [c2.stats(), c2.report(), c2.fill_time("mv") is not None]
    c2.invalidate("mv")
    out += [c2.peek("mv", 0), c2.fill_time("mv")]
    c.invalidate()
    out += [c.report(), c.stats()]
    return out


def test_cache_fill_hit_and_staleness_bound():
    got, want = cache_script(PCache), cache_script(RCache)
    assert got == want
    assert got[2] == [5] and got[4] == [5, 7]
    assert got[5] == (5, [("rows", 5)]) and got[6] == (8, [("rows", 8)])
    assert got[9] is None and got[13] is None


def single_flight(cache):
    c = cache()
    fills = []
    gate = threading.Event()

    def slow_fill():
        fills.append(1)
        gate.wait(5.0)          # hold all other readers on the cond
        return 3, [("v",)]

    results = []

    def reader():
        results.append(c.get("mv", 3, 0, slow_fill))

    threads = [threading.Thread(target=reader) for _ in range(16)]
    for t in threads:
        t.start()
    deadline = time.time() + 5.0
    while len(fills) < 1 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    gate.set()
    for t in threads:
        t.join(10.0)
    st = c.stats()
    return len(fills), results, st["fills"], st["misses"], st["hits"], \
        st["coalesced"] >= 1


def test_cache_single_flight_coalesces_concurrent_readers():
    got = single_flight(PCache)
    assert got == single_flight(RCache)
    assert got == (1, [(3, [("v",)])] * 16, 1, 1, 15, True)


def dlq_script(dlq_cls, store, table_cls):
    """Quarantine two windows, list them, requeue one entry, purge
    another, reopen the table (ids continue)."""
    rng = np.random.default_rng(11)

    def table():
        return table_cls(store, 7, list(dlq_cls.DTYPES), list(dlq_cls.PK))
    dlq = dlq_cls(table())
    out = []
    for job, slot, epoch in (("q4", 0, 3), ("q5", 1, 4)):
        ents = [(int(rng.integers(0, 2)), epoch, int(rng.choice([-1, 1])),
                 (int(rng.integers(0, 1 << 40)), f"s{int(k)}"),
                 bytes(rng.integers(0, 256, 8).astype(np.uint8)))
                for k in range(3)]
        out.append(dlq.quarantine(job, slot, ents, f"fp{epoch}", epoch))
    strip = lambda rows: [r[:10] for r in rows]
    out += [strip(dlq.entries()), strip(dlq.entries("q5")),
            strip(dlq.entries(status="quarantined"))]
    out.append(dlq.mark([1, 4, 99], "requeued", 5))
    out.append(dlq.mark([2], None, 6))
    out += [strip(dlq.entries(status="requeued")), strip(dlq.entries())]
    dlq2 = dlq_cls(table())
    out.append(dlq2.quarantine("q4", 0, [(0, 9, 1, (1, "x"), b"p")], "f", 7))
    out.append(strip(dlq2.entries()))
    return out


def test_dead_letter_queue_quarantine_entries_requeue():
    got = dlq_script(PDLQ, PStore(), PTable)
    assert got == dlq_script(RDLQ, RStore(), RTable)
    assert got[0] == got[1] == 3
    assert len(got[2]) == 6 and got[5] == 2 and got[6] == 1
    assert [r[0] for r in got[-1]] == [0, 1, 3, 4, 5, 6]


def freshness_script(mod, reg, mv):
    """Seeded commits with explicit stamps into one tracker; a served-
    staleness note; the rows at a fixed `now`; the per-MV histogram."""
    rng = np.random.default_rng(5)
    tr = mod.FreshnessTracker()
    t = 1_000.0
    out = []
    for e in range(1, 40):
        ing = t + float(rng.random())
        t = ing + float(rng.integers(1, 4000)) / 1000.0
        out.append(tr.commit(mv, e, ing, t))
        if e % 7 == 0:
            tr.commit(mv + "_b", e, ing - 1.0, t)
    tr.note_served(mv, 30, 39, 1_020.0)
    out += [tr.rows(now=t + 2.0), tr.history(mv)[:5], tr.summary()]
    tr.note_served(mv, 39, 39, None)                # an up-to-date serve
    out.append(tr.rows(now=t + 3.0))
    tr.forget(mv + "_b")
    out.append(tr.rows(now=t + 3.0))
    ch = reg.histogram("mv_freshness_seconds", labels=("mv",)).labels(mv)
    out.append((list(ch.counts), ch.total, ch.sum, ch.buckets))
    return out


def test_freshness_tracker_rows_and_histogram():
    tag = f"fresh_parity_{time.monotonic_ns()}"
    got = freshness_script(PF, PREG, tag)
    want = freshness_script(RF, RREG, tag)
    assert got == want
    assert PF.FRESHNESS_BUCKETS == RF.FRESHNESS_BUCKETS
    assert got[-1][1] == 39 and len(got[-2]) == 1 and len(got[-4]) == 2
