"""Nexmark event generator — the benchmark workload source (the port's
own copy of the JAX package's `connectors/nexmark.py`: the host reader
stack, and the constants, string pools and surrogate generator that the
device generator `device/nexmark_gen.py` and the host-ingest feed
`device/ingest.py` read).

Reference: `src/connector/src/source/nexmark/` (which wraps the external
`nexmark` crate) and the e2e source definitions at
`e2e_test/nexmark/create_sources.slt.part`. This is an independent,
vectorized re-implementation of the standard Nexmark generator semantics:

* one global event sequence; event n is a Person if n % 50 == 0, an Auction
  if n % 50 in 1..=3, else a Bid (1:3:46 proportions);
* ids are dense per entity type with the standard offsets;
* bids reference recent "hot" auctions/people with the standard 90% skew;
* event timestamps advance at a configurable inter-event gap.

Fully deterministic given a seed; all columns generated with numpy
(vectorized splitmix64) so the generator itself never bottlenecks the
benchmark.

Schemas (matching the reference's CREATE SOURCE):
  person(id, name, email_address, credit_card, city, state, date_time, extra)
  auction(id, item_name, description, initial_bid, reserve, date_time,
          expires, seller, category, extra)
  bid(auction, bidder, price, channel, url, date_time, extra)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.chunk import Column, StreamChunk
from ..core.schema import Field, Schema
from ..core import dtypes as T
from ..ops.source import SourceReader
from .datagen import splitmix64

PERSON_PROPORTION = 1
AUCTION_PROPORTION = 3
TOTAL_PROPORTION = 50  # 46 bids per 50 events

FIRST_PERSON_ID = 1000
FIRST_AUCTION_ID = 1000
FIRST_CATEGORY_ID = 10

HOT_AUCTION_RATIO = 100
HOT_BIDDER_RATIO = 100
HOT_SELLER_RATIO = 100

US_STATES = ["az", "ca", "id", "or", "wa", "wy"]
US_CITIES = ["phoenix", "los angeles", "san francisco", "boise", "portland",
             "bend", "redmond", "seattle", "kent", "cheyenne"]
FIRST_NAMES = ["peter", "paul", "luke", "john", "saul", "vicky", "kate",
               "julie", "sarah", "deiter", "walter"]
LAST_NAMES = ["shultz", "abrams", "spencer", "white", "bartels", "walton",
              "smith", "jones", "noris"]
CHANNELS = ["apple", "google", "facebook", "baidu"]

# Precomputed object-dtype pools: string columns are produced by fancy
# indexing (C speed), never per-row Python. NAME/EMAIL pools are the
# first x last cross product, indexed fi * len(LAST_NAMES) + li.
_CH_POOL = np.array(CHANNELS, dtype=object)
_URL_POOL = np.array([f"https://www.nexmark.com/{c}/item.htm?query=1"
                      for c in CHANNELS], dtype=object)
_CITY_POOL = np.array(US_CITIES, dtype=object)
_STATE_POOL = np.array(US_STATES, dtype=object)
_NAME_POOL = np.array([f"{a} {b}" for a in FIRST_NAMES for b in LAST_NAMES],
                      dtype=object)
_EMAIL_POOL = np.array([f"{a}@{b}.com" for a in FIRST_NAMES
                        for b in LAST_NAMES], dtype=object)


def _obj_col(values: np.ndarray) -> Column:
    """VARCHAR column from an all-valid object array (skips the per-row
    null scan Column would otherwise do)."""
    return Column(T.VARCHAR, values, np.ones(len(values), dtype=np.bool_))


def _empty_strings(n: int) -> Column:
    return _obj_col(np.full(n, "", dtype=object))

PERSON_SCHEMA = Schema.of(
    ("id", T.INT64), ("name", T.VARCHAR), ("email_address", T.VARCHAR),
    ("credit_card", T.VARCHAR), ("city", T.VARCHAR), ("state", T.VARCHAR),
    ("date_time", T.TIMESTAMP), ("extra", T.VARCHAR))

AUCTION_SCHEMA = Schema.of(
    ("id", T.INT64), ("item_name", T.VARCHAR), ("description", T.VARCHAR),
    ("initial_bid", T.INT64), ("reserve", T.INT64), ("date_time", T.TIMESTAMP),
    ("expires", T.TIMESTAMP), ("seller", T.INT64), ("category", T.INT64),
    ("extra", T.VARCHAR))

BID_SCHEMA = Schema.of(
    ("auction", T.INT64), ("bidder", T.INT64), ("price", T.INT64),
    ("channel", T.VARCHAR), ("url", T.VARCHAR), ("date_time", T.TIMESTAMP),
    ("extra", T.VARCHAR))


@dataclass
class NexmarkConfig:
    seed: int = 42
    base_time_usecs: int = 1_500_000_000_000_000  # 2017-07-14-ish, like nexmark
    inter_event_gap_usecs: int = 100  # matches min.event.gap.in.ns=100 in e2e
    # auctions stay open for this many events' worth of time
    auction_duration_events: int = 200
    strings_on: bool = True  # generating varchar columns costs host time
    # "" = nexmark's hot/cold picks; "zipf:<s>" (s > 1, e.g. "zipf:1.5",
    # SQL: WITH (nexmark.key.dist='zipf:1.5')) reshapes the bid
    # auction/bidder picks into a power law — reproducible Zipfian
    # workloads for skew tests/bench. Device twin: device/nexmark_gen.py
    # (bit-identical streams).
    key_dist: str = ""


def _event_kinds(event_ids: np.ndarray) -> np.ndarray:
    """0=person, 1=auction, 2=bid."""
    m = event_ids % TOTAL_PROPORTION
    return np.where(m == 0, 0, np.where(m <= AUCTION_PROPORTION, 1, 2))


def _person_count_before(event_ids: np.ndarray) -> np.ndarray:
    """Number of person events among events [0, n)."""
    full, rem = np.divmod(event_ids, TOTAL_PROPORTION)
    return full * PERSON_PROPORTION + (rem > 0)


def _mulhi_bound(r: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Uniform u64 `r` -> [0, m): high 64 bits of r*m (Lemire reduce).
    Mirrors `device/nexmark_gen.py::_mulhi_bound` EXACTLY — the device
    generator avoids 64-bit vector division (XLA-compile-pathological),
    and host/device surrogate streams must stay bit-identical."""
    mask = np.uint64(0xFFFFFFFF)
    r = r.astype(np.uint64)
    m = m.astype(np.uint64)
    a0, a1 = r & mask, r >> np.uint64(32)
    b0, b1 = m & mask, m >> np.uint64(32)
    m00 = a0 * b0
    m01 = a0 * b1
    m10 = a1 * b0
    m11 = a1 * b1
    sh = np.uint64(32)
    carry = (m00 >> sh) + (m01 & mask) + (m10 & mask)
    return (m11 + (m01 >> sh) + (m10 >> sh)
            + (carry >> sh)).astype(np.int64)


def _zipf_ordinal(rand_pick: np.ndarray, n_entities: np.ndarray,
                  s: float) -> np.ndarray:
    """Power-law entity ordinal (pmf ~ rank^-s): bounded-Pareto inverse
    CDF, rank = floor((1-u)^(-1/(s-1))) clipped to [1, n]; ordinal 0 =
    the hottest entity, stationary as n grows. Mirrors
    `device/nexmark_gen.py::_zipf_ordinal` EXACTLY (same f64 expression
    over the same rand draws) — host/device streams stay bit-identical."""
    u = (rand_pick.astype(np.uint64) >> np.uint64(11)
         ).astype(np.float64) * (2.0 ** -53)
    rank = np.floor(np.power(1.0 - u, -1.0 / (s - 1.0)))
    rank = np.minimum(rank, n_entities.astype(np.float64))
    return np.maximum(rank, 1.0).astype(np.int64) - 1


def _auction_count_before(event_ids: np.ndarray) -> np.ndarray:
    full, rem = np.divmod(event_ids, TOTAL_PROPORTION)
    return full * AUCTION_PROPORTION + np.clip(rem - PERSON_PROPORTION, 0,
                                               AUCTION_PROPORTION)


class NexmarkGenerator:
    """Vectorized generator over a contiguous range of event ids."""

    def __init__(self, config: Optional[NexmarkConfig] = None):
        self.cfg = config or NexmarkConfig()

    def _rand(self, ids: np.ndarray, salt: int) -> np.ndarray:
        return splitmix64(ids.astype(np.uint64)
                          + np.uint64((self.cfg.seed << 20) + salt))

    def _timestamps(self, event_ids: np.ndarray) -> np.ndarray:
        return (self.cfg.base_time_usecs
                + event_ids * self.cfg.inter_event_gap_usecs).astype(np.int64)

    def _strings(self, r: np.ndarray, pool: np.ndarray) -> np.ndarray:
        """Pool lookup via fancy indexing -> object array (no Python loop)."""
        idx = (r % np.uint64(len(pool))).astype(np.int64)
        return pool[idx]

    def gen_persons(self, event_ids: np.ndarray) -> StreamChunk:
        n = len(event_ids)
        person_idx = _person_count_before(event_ids)  # dense person ordinal
        ids = (FIRST_PERSON_ID + person_idx).astype(np.int64)
        ts = self._timestamps(event_ids)
        cols = [Column(T.INT64, ids)]
        if self.cfg.strings_on:
            fi = (self._rand(ids, 1) % np.uint64(len(FIRST_NAMES)))
            li = (self._rand(ids, 2) % np.uint64(len(LAST_NAMES)))
            combo = (fi * np.uint64(len(LAST_NAMES)) + li).astype(np.int64)
            cc = np.char.zfill(
                (self._rand(ids, 3) % np.uint64(10**16)).astype("U16"), 16)
            cols += [_obj_col(_NAME_POOL[combo]),
                     _obj_col(_EMAIL_POOL[combo]),
                     _obj_col(cc.astype(object)),
                     _obj_col(self._strings(self._rand(ids, 4), _CITY_POOL)),
                     _obj_col(self._strings(self._rand(ids, 5), _STATE_POOL))]
        else:
            cols += [_empty_strings(n)] * 5
        cols.append(Column(T.TIMESTAMP, ts))
        cols.append(_empty_strings(n))
        return StreamChunk(np.zeros(n, dtype=np.int8), cols)

    def gen_auctions(self, event_ids: np.ndarray) -> StreamChunk:
        n = len(event_ids)
        auction_idx = _auction_count_before(event_ids)
        ids = (FIRST_AUCTION_ID + auction_idx).astype(np.int64)
        ts = self._timestamps(event_ids)
        n_person = np.maximum(_person_count_before(event_ids), 1)
        r_seller = self._rand(ids, 10)
        # hot sellers: 90% pick from the most recent 1/HOT_SELLER_RATIO people
        hot = (r_seller % np.uint64(10)) != 0
        hot_span = np.maximum(n_person // HOT_SELLER_RATIO, 1)
        r2 = self._rand(ids, 11)
        seller_ord = np.where(
            hot,
            n_person - 1 - _mulhi_bound(r2, hot_span),
            _mulhi_bound(r2, n_person))
        seller = (FIRST_PERSON_ID + seller_ord).astype(np.int64)
        category = (FIRST_CATEGORY_ID
                    + (self._rand(ids, 12) % np.uint64(5)).astype(np.int64))
        initial_bid = 100 + (self._rand(ids, 13) % np.uint64(1000)).astype(np.int64)
        reserve = initial_bid + (self._rand(ids, 14) % np.uint64(1000)).astype(np.int64)
        expires = ts + (self.cfg.auction_duration_events
                        * self.cfg.inter_event_gap_usecs)
        cols = [Column(T.INT64, ids)]
        if self.cfg.strings_on:
            item = np.char.add("item-", ids.astype("U20"))
            desc = np.char.add(
                "desc-", (self._rand(ids, 15) % np.uint64(1000)).astype("U4"))
            cols += [_obj_col(item.astype(object)),
                     _obj_col(desc.astype(object))]
        else:
            empty = _empty_strings(n)
            cols += [empty, empty]
        cols += [Column(T.INT64, initial_bid), Column(T.INT64, reserve),
                 Column(T.TIMESTAMP, ts), Column(T.TIMESTAMP, expires),
                 Column(T.INT64, seller), Column(T.INT64, category),
                 _empty_strings(n)]
        return StreamChunk(np.zeros(n, dtype=np.int8), cols)

    def gen_bids(self, event_ids: np.ndarray) -> StreamChunk:
        n = len(event_ids)
        ts = self._timestamps(event_ids)
        n_auction = np.maximum(_auction_count_before(event_ids), 1)
        n_person = np.maximum(_person_count_before(event_ids), 1)
        if self.cfg.key_dist:
            # power-law picks (device twin: nexmark_gen._zipf_ordinal,
            # identical f64 expression over the same rand draws — the
            # streams stay bit-identical across host/device paths)
            from ..device.nexmark_gen import key_dist_s
            s = key_dist_s(self.cfg.key_dist)
            auction_ord = _zipf_ordinal(self._rand(event_ids, 21),
                                        n_auction, s)
            bidder_ord = _zipf_ordinal(self._rand(event_ids, 23),
                                       n_person, s)
        else:
            r = self._rand(event_ids, 20)
            hot_a = (r % np.uint64(100)) < np.uint64(90)
            r2 = self._rand(event_ids, 21)
            hot_span = np.maximum(n_auction // HOT_AUCTION_RATIO, 1)
            auction_ord = np.where(
                hot_a,
                n_auction - 1 - _mulhi_bound(r2, hot_span),
                _mulhi_bound(r2, n_auction))
            r3 = self._rand(event_ids, 22)
            hot_b = (r3 % np.uint64(100)) < np.uint64(90)
            r4 = self._rand(event_ids, 23)
            bspan = np.maximum(n_person // HOT_BIDDER_RATIO, 1)
            bidder_ord = np.where(
                hot_b,
                n_person - 1 - _mulhi_bound(r4, bspan),
                _mulhi_bound(r4, n_person))
        auction = (FIRST_AUCTION_ID + auction_ord).astype(np.int64)
        bidder = (FIRST_PERSON_ID + bidder_ord).astype(np.int64)
        price = 100 + (self._rand(event_ids, 24) % np.uint64(10_000)).astype(np.int64)
        cols = [Column(T.INT64, auction), Column(T.INT64, bidder),
                Column(T.INT64, price)]
        if self.cfg.strings_on:
            ci = (self._rand(event_ids, 25)
                  % np.uint64(len(_CH_POOL))).astype(np.int64)
            cols += [_obj_col(_CH_POOL[ci]), _obj_col(_URL_POOL[ci])]
        else:
            empty = _empty_strings(n)
            cols += [empty, empty]
        cols += [Column(T.TIMESTAMP, ts), _empty_strings(n)]
        return StreamChunk(np.zeros(n, dtype=np.int8), cols)

    def gen_range(self, start_event: int, end_event: int
                  ) -> Dict[str, StreamChunk]:
        """All events in [start, end), split per entity stream."""
        ids = np.arange(start_event, end_event, dtype=np.int64)
        kinds = _event_kinds(ids)
        out = {}
        p = ids[kinds == 0]
        a = ids[kinds == 1]
        b = ids[kinds == 2]
        if len(p):
            out["person"] = self.gen_persons(p)
        if len(a):
            out["auction"] = self.gen_auctions(a)
        if len(b):
            out["bid"] = self.gen_bids(b)
        return out


class NexmarkReader(SourceReader):
    """Reader for one entity stream; all three readers share one event clock
    (same event-id sequence) so cross-stream joins line up like the reference's
    single nexmark datagen."""

    def __init__(self, table: str, generator: NexmarkGenerator,
                 events_per_poll: int = 8192, max_events: Optional[int] = None,
                 columns: Optional[Sequence[str]] = None):
        assert table in ("person", "auction", "bid")
        self.table = table
        self.gen = generator
        self.events_per_poll = events_per_poll
        self.max_events = max_events
        self.next_event = 0
        self.schema = {"person": PERSON_SCHEMA, "auction": AUCTION_SCHEMA,
                       "bid": BID_SCHEMA}[table]
        # CREATE SOURCE may declare a column subset/reorder: project the
        # generated chunks onto the declared names
        self._proj: Optional[List[int]] = None
        if columns is not None:
            names = [f.name for f in self.schema.fields]
            missing = [c for c in columns if c not in names]
            if missing:
                raise ValueError(
                    f"nexmark table {table!r} has no columns {missing}; "
                    f"available: {names}")
            idx = [names.index(c) for c in columns]
            if idx != list(range(len(names))):
                self._proj = idx

    def poll(self) -> Optional[StreamChunk]:
        if self.max_events is not None and self.next_event >= self.max_events:
            return None
        end = self.next_event + self.events_per_poll
        if self.max_events is not None:
            end = min(end, self.max_events)
        chunks = self.gen.gen_range(self.next_event, end)
        self.next_event = end
        ch = chunks.get(self.table)
        if ch is not None and self._proj is not None:
            ch = ch.project(self._proj)
        return ch

    def split_states(self) -> Dict[str, Any]:
        return {f"nexmark-{self.table}": self.next_event}

    def seek(self, states: Dict[str, Any]) -> None:
        k = f"nexmark-{self.table}"
        if k in states:
            self.next_event = int(states[k])


# ---------------------------------------------------------------------------
# host-side SURROGATE generation (the fused host-ingest feed)
# ---------------------------------------------------------------------------


def _hot_pick_np(rand_hot: np.ndarray, rand_pick: np.ndarray,
                 n_entities: np.ndarray, hot_ratio: int,
                 hot_mod: int) -> np.ndarray:
    """numpy twin of `device/nexmark_gen._hot_pick` (same draws, same
    Lemire reduce) — shared by the surrogate generator below."""
    if hot_mod == 10:
        hot = (rand_hot % np.uint64(10)) != 0
    else:
        hot = (rand_hot % np.uint64(100)) < np.uint64(90)
    span = np.maximum(n_entities // hot_ratio, 1)
    ord_hot = n_entities - 1 - _mulhi_bound(rand_pick, span)
    ord_cold = _mulhi_bound(rand_pick, n_entities)
    return np.where(hot, ord_hot, ord_cold)


def gen_surrogates(cfg: NexmarkConfig, table: str,
                   event_ids: np.ndarray,
                   cols: Optional[Sequence[str]] = None
                   ) -> Dict[str, np.ndarray]:
    """Columns of `table` for these event ids as int64 SURROGATE
    arrays — the numpy twin of `device/nexmark_gen.gen_table`, value-
    identical by construction (same splitmix64 draws, same Lemire/zipf
    reduces, same pool-index encoding). This is what the host-ingest
    staging path (`device/ingest.py`) ships over the Arrow seam: the
    fused program consumes surrogate int64 columns either way, so a
    host-fed job is bit-identical to a device-datagen one, and string
    materialization cost never enters the ingest hot path (pull-time
    `decode_column` reconstructs the exact strings, as it always has).

    `cols` restricts generation to the named columns (feed-column
    pruning: the staging pipeline only pays for columns the fused
    program actually reads — the host-side twin of the XLA dead-code
    elimination the device generator gets for free). Per-column salts
    make every column's draws independent, so a pruned generation is
    value-identical to the corresponding slice of a full one."""
    seed = np.uint64((cfg.seed << 20))
    rand = lambda ids, salt: splitmix64(
        ids.astype(np.uint64) + (seed + np.uint64(salt)))
    mod = lambda r, k: (r % np.uint64(k)).astype(np.int64)
    _memo: Dict[str, Any] = {}

    def once(key, fn):
        # shared intermediates (ts, entity ordinals, initial_bid, pool
        # combos) compute at most once per call even when several
        # requested columns read them
        if key not in _memo:
            _memo[key] = fn()
        return _memo[key]

    ts = lambda: once("ts", lambda: (
        cfg.base_time_usecs + event_ids * cfg.inter_event_gap_usecs
    ).astype(np.int64))
    if table == "person":
        ids = (FIRST_PERSON_ID
               + _person_count_before(event_ids)).astype(np.int64)
        combo = lambda: once("combo", lambda: mod(
            rand(ids, 1), len(_NAME_POOL) // 9) * 9 + mod(rand(ids, 2),
                                                          9))
        thunks = {
            "id": lambda: ids,
            "name": combo, "email_address": combo,
            "credit_card": lambda: mod(rand(ids, 3), 10**16),
            "city": lambda: mod(rand(ids, 4), len(_CITY_POOL)),
            "state": lambda: mod(rand(ids, 5), len(_STATE_POOL)),
            "date_time": ts,
            "extra": lambda: np.zeros_like(ids),
        }
    elif table == "auction":
        ids = (FIRST_AUCTION_ID
               + _auction_count_before(event_ids)).astype(np.int64)

        def seller():
            n_person = np.maximum(_person_count_before(event_ids), 1)
            return (FIRST_PERSON_ID + _hot_pick_np(
                rand(ids, 10), rand(ids, 11), n_person,
                HOT_SELLER_RATIO, hot_mod=10)).astype(np.int64)

        initial_bid = lambda: once(
            "ib", lambda: 100 + mod(rand(ids, 13), 1000))
        thunks = {
            "id": lambda: ids, "item_name": lambda: ids,
            "description": lambda: mod(rand(ids, 15), 1000),
            "initial_bid": initial_bid,
            "reserve": lambda: initial_bid() + mod(rand(ids, 14), 1000),
            "date_time": ts,
            "expires": lambda: ts() + (cfg.auction_duration_events
                                       * cfg.inter_event_gap_usecs),
            "seller": seller,
            "category": lambda: FIRST_CATEGORY_ID + mod(rand(ids, 12), 5),
            "extra": lambda: np.zeros_like(ids),
        }
    elif table == "bid":
        def _ords():
            n_auction = np.maximum(_auction_count_before(event_ids), 1)
            n_person = np.maximum(_person_count_before(event_ids), 1)
            if cfg.key_dist:
                from ..device.nexmark_gen import key_dist_s
                s = key_dist_s(cfg.key_dist)
                return (_zipf_ordinal(rand(event_ids, 21), n_auction, s),
                        _zipf_ordinal(rand(event_ids, 23), n_person, s))
            return (_hot_pick_np(rand(event_ids, 20), rand(event_ids, 21),
                                 n_auction, HOT_AUCTION_RATIO,
                                 hot_mod=100),
                    _hot_pick_np(rand(event_ids, 22), rand(event_ids, 23),
                                 n_person, HOT_BIDDER_RATIO, hot_mod=100))

        ords = lambda: once("ords", _ords)
        ch = lambda: once("ch", lambda: mod(rand(event_ids, 25),
                                            len(_CH_POOL)))
        thunks = {
            "auction": lambda: (FIRST_AUCTION_ID
                                + ords()[0]).astype(np.int64),
            "bidder": lambda: (FIRST_PERSON_ID
                               + ords()[1]).astype(np.int64),
            "price": lambda: 100 + mod(rand(event_ids, 24), 10_000),
            "channel": ch, "url": ch, "date_time": ts,
            "extra": lambda: np.zeros_like(event_ids),
        }
    else:
        raise ValueError(f"unknown nexmark table {table!r}")
    want = list(thunks) if cols is None else list(cols)
    return {c: thunks[c]() for c in want}
