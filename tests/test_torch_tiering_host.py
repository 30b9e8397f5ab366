"""The host half of the port's state tiering (`device/tiering.py`,
`state/xor8.py`) against the JAX package's (`risingwave_tpu/device/
tiering.py`, `Xor8` of `risingwave_tpu/state/hummock.py`) on seeded
inputs: `select_cold`, the Xor8 filter (the same answers for the same
keys, its build failure and the store's fallback), `ColdStore` moves,
probes and snapshots, `derive_recipe` over the port's node classes, and
the journal's `events_between`.
"""
import zlib

import numpy as np
import pytest

import risingwave_tpu.device.fused as JF
import risingwave_tpu.device.tiering as JT
from risingwave_tpu.expr import expression as JE
from risingwave_tpu.expr.functions import build_func
from risingwave_tpu.core import dtypes as JD
from risingwave_tpu.state import hummock
import risingwave_tpu_torch.device.fused as PF
import risingwave_tpu_torch.device.tiering as PT
from risingwave_tpu_torch.state import xor8 as PX
from risingwave_tpu_torch.device.nexmark_gen import GenCfg
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
from torch_parity import port_dtype, port_expr, store_dump


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


@pytest.mark.parametrize("high,low", [("0.85", "0.60"), ("0.5", "0.2"),
                                      ("0.35", "0.15")])
@pytest.mark.parametrize("hot", [False, True])
def test_select_cold_matches_reference(monkeypatch, high, low, hot):
    monkeypatch.setenv("RW_TIER_HIGH_WATER", high)
    monkeypatch.setenv("RW_TIER_LOW_WATER", low)
    rng = _rng(f"cold{high}{hot}")
    cap = 4096
    for count in (0, 1000, 3000, 3500, 4096):
        keys = np.sort(rng.choice(1 << 45, cap, replace=False))
        touch = rng.integers(0, 30, cap).astype(np.int64)
        hot_keys = tuple(int(k) & ((1 << 40) - 1)
                         for k in rng.choice(keys[:max(count, 1)], 4)) \
            if hot else ()
        want = JT.select_cold(keys, touch, count, cap, hot_keys,
                              (1 << 40) - 1)
        got = PT.select_cold(keys, touch, count, cap, hot_keys,
                             (1 << 40) - 1)
        assert (got is None) == (want is None)
        if want is not None:
            assert got.dtype == want.dtype
            assert np.array_equal(got, want)


def test_np_pack_and_pad_pow2_match_reference():
    rng = _rng("pack")
    fields = (PF.PackField(1000, 1, 12), PF.PackField(-5, 100, 9))
    ref_fields = (JF.PackField(1000, 1, 12), JF.PackField(-5, 100, 9))
    cols = [rng.integers(1000, 5000, 64), -5 + 100 * rng.integers(0, 500, 64)]
    assert np.array_equal(PT.np_pack(fields, cols),
                          JT.np_pack(ref_fields, cols))
    for n in (0, 1, 63, 64, 65, 1000, 1 << 20):
        assert PT._pad_pow2(n) == JT._pad_pow2(n)
    assert PT.key_bytes(-3) == JT.key_bytes(-3)


def test_xor8_same_answers_as_reference():
    rng = _rng("xor8")
    keys = [PT.key_bytes(k) for k in rng.choice(1 << 40, 3000,
                                                replace=False)]
    keys += keys[:5]                       # duplicates must not fail it
    f, g = PX.Xor8.build(keys), hummock.Xor8.build(keys)
    assert (f.seed, f.seg, f.fp, f.ver) == (g.seed, g.seg, g.fp, g.ver)
    probes = keys[:200] + [PT.key_bytes(k) for k in
                           rng.choice(1 << 40, 20000) + (1 << 41)]
    got = [f.may_contain(k) for k in probes]
    assert got == [g.may_contain(k) for k in probes]
    assert all(got[:200])                  # no false negatives
    assert 0 < sum(got[200:]) < 400        # some false positives, ~0.4%
    assert PX.Xor8.build([]).may_contain(b"x") is False


def test_xor8_build_none_and_store_fallback(monkeypatch):
    st = PT.ColdStore(1)
    st.rows[0] = {k: ((k,), 0) for k in range(64)}
    st.rebuild_filter(0)
    assert st.filter_live[0]
    hits, probes, pos = st.probe(0, np.arange(32, 96, dtype=np.int64))
    assert sorted(hits) == list(range(32, 64)) and probes == 64
    assert pos >= len(hits)
    monkeypatch.setattr(PX.Xor8, "build",
                        staticmethod(lambda keys, seed=0: None))
    st2 = PT.ColdStore(1)
    st2.rows[0] = dict(st.rows[0])
    st2.rebuild_filter(0)
    assert not st2.filter_live[0] and st2.filters[0] is None
    hits2, probes2, pos2 = st2.probe(0, np.arange(32, 96, dtype=np.int64))
    assert sorted(hits2) == sorted(hits)
    assert pos2 == len(hits2) and probes2 == 64


def _store_ops(mod, rng):
    """The same sequence of cold-store moves in one package's module:
    agg, MV and join stores filled, probed, partly taken back, snapshot
    and restored. Returns (dumps, probe results, taken rows)."""
    agg, mv, join = (mod.ColdStore(1, "agg"), mod.ColdStore(1, "mv"),
                     mod.ColdStore(1, "join"))
    keys = np.sort(rng.choice(1 << 30, 500, replace=False))
    vals = [rng.integers(-99, 99, 500), rng.normal(0, 1, 500)]
    touch = rng.integers(0, 20, 500).astype(np.int64)
    agg.put_agg_rows(0, keys[:300], [v[:300] for v in vals], touch[:300])
    agg.put_agg_rows(0, keys[300:], [v[300:] for v in vals], touch[300:])
    mv.put_flat_rows(0, keys[::2], [np.ones(250, np.int32),
                                    vals[0][::2], np.zeros(250, bool)])
    jk = np.sort(rng.integers(0, 200, 800))
    pk = rng.choice(1 << 30, 800, replace=False)
    join.extend_join_rows(0, jk, pk, [rng.integers(-9, 9, 800)],
                          rng.integers(0, 9, 800))
    for st in (agg, mv, join):
        st.rebuild_filter(0)
    out = []
    cand = np.concatenate([keys[::7], rng.choice(1 << 30, 300) + (1 << 31)])
    hits, probes, pos = agg.probe(0, cand)
    out.append((sorted(hits), probes, pos))
    hk = np.asarray(sorted(hits)[:40], np.int64)
    cols, tch = agg.take_agg_rows(0, hk)
    out.append(([c.tolist() for c in cols], tch.tolist()))
    found, mcols = mv.take_flat_rows(0, hk)
    out.append((found.tolist(), [c.tolist() for c in mcols]))
    jhits, jp, jpos = join.probe(0, np.arange(0, 260, dtype=np.int64))
    out.append((sorted(jhits), jp, jpos))
    taken = join.take_join_rows(0, sorted(jhits)[:25])
    out.append([np.asarray(c).tolist() for c in taken[:2]]
               + [[c.tolist() for c in taken[2]], taken[3].tolist()])
    k2, c2 = mv.flat_columns(0)
    out.append((sorted(k2.tolist()), len(c2)))
    snap = agg.snapshot()
    fresh = mod.ColdStore(1, "agg")
    fresh.restore(snap)
    out.append(fresh.probe(0, cand)[1:])
    tm = SimpleTM(agg, mv, join)
    return store_dump(tm), out, (len(agg), len(mv), len(join))


class SimpleTM:
    def __init__(self, agg, mv, join):
        self.stores = {(0, -1): agg, (0, "mv"): mv, (1, 0): join}


def test_cold_store_moves_match_reference():
    got = _store_ops(PT, _rng("stores"))
    want = _store_ops(JT, _rng("stores"))
    assert got == want


def test_tiering_manager_journal_and_snapshot():
    plans = [PT.TierPlan(2, "agg", (), 3), PT.TierPlan(5, "join", ())]
    ref_plans = [JT.TierPlan(2, "agg", (), 3), JT.TierPlan(5, "join", ())]
    tm, ref = PT.TieringManager(plans), JT.TieringManager(ref_plans, 1)
    assert sorted(tm.stores, key=str) == sorted(ref.stores, key=str)
    for c, n, k in ((4096, 2, [5, 1]), (4096, 5, [7]), (8192, 2, [9]),
                    (16384, 5, [3, 4])):
        tm.record(c, n, -1, k)
        ref.record(c, n, -1, k)
    for lo, hi in ((0, 4096), (0, 8192), (4096, 16384), (8192, 8192),
                   (-1, 1 << 20)):
        assert tm.events_between(lo, hi) == ref.events_between(lo, hi)
    assert tm.journal == ref.journal
    tm.store(2, -1).put_agg_rows(0, np.array([11, 12]),
                                 [np.array([1, 2])], np.array([3, 4]))
    assert tm.any_cold()
    snap = tm.snapshot()
    tm.counters["demotions"] = 9
    tm.store(2, -1).take_agg_rows(0, np.array([11]))
    tm.restore(snap)
    assert len(tm.store(2, -1)) == 2 and tm.counters["demotions"] == 0
    assert tm.report_rows({2: PF.AggCall("count"), 5: PF.AggCall("count")},
                          {2: 7})[0][2:] == (7, 2, False, False)


def _ingest_graphs():
    """The same node graph in both packages: Ingest(bid) -> Map(InputRef
    and a computed column) -> Filter -> Agg, and a device Source twin."""
    gc = GenCfg.from_config(NexmarkConfig())
    names = ["auction", "bidder", "price", "_row_id"]
    ref_dt = [JD.INT64] * 4
    out = {}
    for mod, ex, dt, cfg in ((JF, JE, ref_dt, gc),
                             (PF, None, [port_dtype(d) for d in ref_dt],
                              GenCfg(*gc))):
        kw = {} if mod is JF else {"device": "cpu"}
        ing = mod.IngestNode("bid", cfg, names, 3, 1 << 14, dt, **kw)
        ing.set_live([0, 2, 3])
        src = mod.SourceNode("bid", cfg, names, 3, 1 << 14, dt, **kw)
        out[mod] = (ing, src)
    return out


def test_derive_recipe_over_port_nodes():
    g = _ingest_graphs()
    ref_refs = [JE.InputRef(2, JD.INT64), JE.InputRef(0, JD.INT64),
                JE.InputRef(3, JD.INT64)]
    pred = build_func("greater_than", [JE.InputRef(1, JD.INT64),
                                       JE.Literal(5, JD.INT64)])
    res = {}
    for mod in (JF, PF):
        ing, src = g[mod]
        kw = {} if mod is JF else {"device": "cpu"}
        exprs = ref_refs if mod is JF else [port_expr(e) for e in ref_refs]
        mp = mod.MapNode(0, exprs, **kw)
        p = pred if mod is JF else port_expr(pred)
        nodes = [ing, mp, mod.FilterNode(1, p, **kw)]
        fields = (mod.PackField(1000, 1, 20),)
        tm = JT if mod is JF else PT
        last = len(nodes) - 1
        r = [tm.derive_recipe(nodes, last, [1], fields, {0: 0}),
             tm.derive_recipe(nodes, last, [2], fields, {0: 0}),
             tm.derive_recipe(nodes, last, [0], fields, {0: 0}),
             # the source is not an ingest one
             tm.derive_recipe(nodes, last, [1], fields, {}),
             tm.derive_recipe([src, mp] + nodes[2:], last, [1], fields,
                              {0: 0})]
        res[mod] = [None if x is None else
                    (x.source_ord, x.col_pos,
                     [(f.offset, f.stride, f.bits) for f in x.fields])
                    for x in r]
    assert res[PF] == res[JF]
    assert res[PF][0] == (0, (0,), [(1000, 1, 20)])
    assert res[PF][1] == (0, (-1,), [(1000, 1, 20)])   # the row id column
    assert res[PF][2] == (0, (1,), [(1000, 1, 20)])
    assert res[PF][3] is None and res[PF][4] is None
