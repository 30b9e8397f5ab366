"""Nexmark generator constants: what the device generator needs.

A by-value copy of the proportions, first ids, hot ratios, config and
string pools of `risingwave_tpu/connectors/nexmark.py`, and of its host
surrogate generator `gen_surrogates` (with the numpy helpers it reads):
the numpy twin of the device generator (`device/nexmark_gen.gen_table`),
value-identical to it, which the host-ingest feed (`device/ingest.py`)
ships to the card. The host reader stack stays in the JAX package; the
device path decodes string surrogates with these pools.

Event n is a Person if n % 50 == 0, an Auction if n % 50 in 1..=3, else
a Bid (1:3:46 proportions).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np

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

# Object-dtype pools: string columns decode by fancy indexing. NAME/EMAIL
# pools are the first x last cross product, indexed fi * len(LAST_NAMES)
# + li.
_CH_POOL = np.array(CHANNELS, dtype=object)
_URL_POOL = np.array([f"https://www.nexmark.com/{c}/item.htm?query=1"
                      for c in CHANNELS], dtype=object)
_CITY_POOL = np.array(US_CITIES, dtype=object)
_STATE_POOL = np.array(US_STATES, dtype=object)
_NAME_POOL = np.array([f"{a} {b}" for a in FIRST_NAMES for b in LAST_NAMES],
                      dtype=object)
_EMAIL_POOL = np.array([f"{a}@{b}.com" for a in FIRST_NAMES
                        for b in LAST_NAMES], dtype=object)


@dataclass
class NexmarkConfig:
    seed: int = 42
    base_time_usecs: int = 1_500_000_000_000_000
    inter_event_gap_usecs: int = 100
    # auctions stay open for this many events' worth of time
    auction_duration_events: int = 200
    strings_on: bool = True
    # "" = nexmark's hot/cold picks; "zipf:<s>" (s > 1) reshapes the bid
    # auction/bidder picks into a power law
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


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic stateless PRNG (public splitmix64 constants)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    with np.errstate(over="ignore"):
        z = x
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return z


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
