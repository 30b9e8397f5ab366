"""Device-side exact Nexmark generation on PyTorch — bit-identical to
`risingwave_tpu/device/nexmark_gen.py` and so to the host connector.

Every column is a pure function of the event id via splitmix64, so the
fused program generates its epoch's events in device memory. String
columns are int64 surrogates (pool indices / raw randoms) that
`decode_column` turns back into the host strings at pull time.

The reference works on uint64. PyTorch has no `>>`, `%` or `+` for
uint64 on every backend, so the arithmetic runs on int64 bit patterns:
wrapping `*`, `+` and `^` are the same bits; a logical shift is an
arithmetic shift plus a mask; an unsigned remainder adds back 2^64 mod k
for the values at or above 2^63 (negative as int64).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..connectors.nexmark import (AUCTION_PROPORTION, FIRST_AUCTION_ID,
                                  FIRST_CATEGORY_ID, FIRST_PERSON_ID,
                                  HOT_AUCTION_RATIO, HOT_BIDDER_RATIO,
                                  HOT_SELLER_RATIO, PERSON_PROPORTION,
                                  TOTAL_PROPORTION, _CH_POOL, _CITY_POOL,
                                  _EMAIL_POOL, _NAME_POOL, _STATE_POOL,
                                  _URL_POOL, NexmarkConfig)

_MASK32 = 0xFFFFFFFF


def _s64(v: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> k) & ((1 << (64 - k)) - 1)


_C1 = _s64(0x9E3779B97F4A7C15)
_C2 = _s64(0xBF58476D1CE4E5B9)
_C3 = _s64(0x94D049BB133111EB)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 over int64 bit patterns (wrapping u64 semantics)."""
    x = x + _C1
    z = (x ^ _shr(x, 30)) * _C2
    z = (z ^ _shr(z, 27)) * _C3
    return z ^ _shr(z, 31)


class GenCfg(NamedTuple):
    """Hashable static twin of NexmarkConfig."""
    seed: int
    base_time_usecs: int
    inter_event_gap_usecs: int
    auction_duration_events: int
    # "" = the nexmark hot/cold entity picks; "zipf:<s>" (s > 1) reshapes
    # the bid auction/bidder picks into a power law
    key_dist: str = ""

    @staticmethod
    def from_config(cfg: NexmarkConfig) -> "GenCfg":
        return GenCfg(cfg.seed, cfg.base_time_usecs,
                      cfg.inter_event_gap_usecs,
                      cfg.auction_duration_events,
                      getattr(cfg, "key_dist", ""))


def key_dist_s(key_dist: str) -> float:
    """Parse 'zipf:<s>' -> s. Only s > 1 is supported."""
    kind, _, sv = key_dist.partition(":")
    if kind != "zipf":
        raise ValueError(f"unknown key_dist {key_dist!r} "
                         "(supported: 'zipf:<s>', s > 1)")
    s = float(sv) if sv else 1.5
    if s <= 1.0:
        raise ValueError(f"zipf exponent must be > 1, got {s}")
    return s


def _rand(cfg: GenCfg, ids: torch.Tensor, salt: int) -> torch.Tensor:
    return splitmix64(ids + _s64((cfg.seed << 20) + salt))


def _mod(r: torch.Tensor, k: int) -> torch.Tensor:
    """Unsigned remainder of the u64 bit pattern `r` by k (< 2^62)."""
    rem = torch.remainder(r, k)
    wrap = (1 << 64) % k
    return torch.remainder(rem + torch.where(r < 0, wrap, 0), k)


def _mulhi_bound(r: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Uniform u64 `r` -> [0, m) via the high 64 bits of r*m (Lemire's
    multiply-shift) from four 32x32 partial products; each product
    wraps in int64 and every `>> 32` is logical."""
    a0, a1 = r & _MASK32, _shr(r, 32)
    b = m.to(torch.int64)
    b0, b1 = b & _MASK32, _shr(b, 32)
    m00 = a0 * b0
    m01 = a0 * b1
    m10 = a1 * b0
    m11 = a1 * b1
    carry = _shr(m00, 32) + (m01 & _MASK32) + (m10 & _MASK32)
    return m11 + _shr(m01, 32) + _shr(m10, 32) + _shr(carry, 32)


def event_kinds(event_ids: torch.Tensor) -> torch.Tensor:
    """0=person, 1=auction, 2=bid."""
    m = torch.remainder(event_ids, TOTAL_PROPORTION)
    return torch.where(m == 0, 0, torch.where(m <= AUCTION_PROPORTION, 1, 2))


def _divmod(x: torch.Tensor, k: int):
    return (torch.div(x, k, rounding_mode="floor"), torch.remainder(x, k))


def _person_count_before(event_ids: torch.Tensor) -> torch.Tensor:
    full, rem = _divmod(event_ids, TOTAL_PROPORTION)
    return full * PERSON_PROPORTION + (rem > 0).to(torch.int64)


def _auction_count_before(event_ids: torch.Tensor) -> torch.Tensor:
    full, rem = _divmod(event_ids, TOTAL_PROPORTION)
    return full * AUCTION_PROPORTION + torch.clamp(
        rem - PERSON_PROPORTION, 0, AUCTION_PROPORTION)


def _timestamps(cfg: GenCfg, event_ids: torch.Tensor) -> torch.Tensor:
    return cfg.base_time_usecs + event_ids * cfg.inter_event_gap_usecs


def _hot_pick(rand_hot, rand_pick, n_entities, hot_ratio: int,
              hot_mod: int):
    """Shared hot-entity ordinal logic (host gen_auctions/gen_bids)."""
    hot = _mod(rand_hot, hot_mod) != 0 if hot_mod == 10 \
        else _mod(rand_hot, 100) < 90
    span = torch.clamp(torch.div(n_entities, hot_ratio,
                                 rounding_mode="floor"), min=1)
    ord_hot = n_entities - 1 - _mulhi_bound(rand_pick, span)
    ord_cold = _mulhi_bound(rand_pick, n_entities)
    return torch.where(hot, ord_hot, ord_cold)


def _zipf_ordinal(rand_pick, n_entities, s: float):
    """Power-law entity ordinal (pmf ~ rank^-s, bounded-Pareto inverse
    CDF): rank = floor((1-u)^(-1/(s-1))) clipped to [1, n]."""
    u = _shr(rand_pick, 11).to(torch.float64) * (2.0 ** -53)
    rank = torch.floor(torch.pow(1.0 - u, -1.0 / (s - 1.0)))
    rank = torch.minimum(rank, n_entities.to(torch.float64))
    return torch.clamp(rank, min=1.0).to(torch.int64) - 1


def gen_table(cfg: GenCfg, table: str,
              event_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All columns of `table` for these int64 event ids, as int64 tensors.

    Every event id gets a row regardless of its kind — callers mask rows
    with `table_mask`. String columns are surrogates (see SURROGATE).
    """
    ts = _timestamps(cfg, event_ids)
    if table == "person":
        ids = FIRST_PERSON_ID + _person_count_before(event_ids)
        fi = _mod(_rand(cfg, ids, 1), len(_NAME_POOL) // 9)   # 11 firsts
        li = _mod(_rand(cfg, ids, 2), 9)                      # 9 lasts
        combo = fi * 9 + li
        return {
            "id": ids,
            "name": combo,
            "email_address": combo,
            "credit_card": _mod(_rand(cfg, ids, 3), 10**16),
            "city": _mod(_rand(cfg, ids, 4), len(_CITY_POOL)),
            "state": _mod(_rand(cfg, ids, 5), len(_STATE_POOL)),
            "date_time": ts,
            "extra": torch.zeros_like(ids),
        }
    if table == "auction":
        ids = FIRST_AUCTION_ID + _auction_count_before(event_ids)
        n_person = torch.clamp(_person_count_before(event_ids), min=1)
        seller_ord = _hot_pick(_rand(cfg, ids, 10), _rand(cfg, ids, 11),
                               n_person, HOT_SELLER_RATIO, hot_mod=10)
        initial_bid = 100 + _mod(_rand(cfg, ids, 13), 1000)
        return {
            "id": ids,
            "item_name": ids,                 # "item-{id}": derived from id
            "description": _mod(_rand(cfg, ids, 15), 1000),
            "initial_bid": initial_bid,
            "reserve": initial_bid + _mod(_rand(cfg, ids, 14), 1000),
            "date_time": ts,
            "expires": ts + (cfg.auction_duration_events
                             * cfg.inter_event_gap_usecs),
            "seller": FIRST_PERSON_ID + seller_ord,
            "category": FIRST_CATEGORY_ID + _mod(_rand(cfg, ids, 12), 5),
            "extra": torch.zeros_like(ids),
        }
    if table == "bid":
        n_auction = torch.clamp(_auction_count_before(event_ids), min=1)
        n_person = torch.clamp(_person_count_before(event_ids), min=1)
        if cfg.key_dist:
            s = key_dist_s(cfg.key_dist)
            auction_ord = _zipf_ordinal(_rand(cfg, event_ids, 21),
                                        n_auction, s)
            bidder_ord = _zipf_ordinal(_rand(cfg, event_ids, 23),
                                       n_person, s)
        else:
            auction_ord = _hot_pick(_rand(cfg, event_ids, 20),
                                    _rand(cfg, event_ids, 21),
                                    n_auction, HOT_AUCTION_RATIO,
                                    hot_mod=100)
            bidder_ord = _hot_pick(_rand(cfg, event_ids, 22),
                                   _rand(cfg, event_ids, 23),
                                   n_person, HOT_BIDDER_RATIO, hot_mod=100)
        ch = _mod(_rand(cfg, event_ids, 25), len(_CH_POOL))
        return {
            "auction": FIRST_AUCTION_ID + auction_ord,
            "bidder": FIRST_PERSON_ID + bidder_ord,
            "price": 100 + _mod(_rand(cfg, event_ids, 24), 10_000),
            "channel": ch,
            "url": ch,
            "date_time": ts,
            "extra": torch.zeros_like(event_ids),
        }
    raise ValueError(f"unknown nexmark table {table!r}")


_KIND = {"person": 0, "auction": 1, "bid": 2}


def table_mask(table: str, event_ids: torch.Tensor) -> torch.Tensor:
    return event_kinds(event_ids) == _KIND[table]


# ---------------------------------------------------------------------------
# surrogate metadata: how the host decodes device int64 columns
# ---------------------------------------------------------------------------

# column -> ("num",) exact int64 | ("ts",) timestamp usecs |
#           ("pool", pool) index into object pool | ("zfill16",) |
#           ("item_name",) "item-{v}" | ("desc",) "desc-{v}" | ("empty",)
SURROGATE: Dict[str, Dict[str, Tuple]] = {
    "person": {
        "id": ("num",), "name": ("pool", _NAME_POOL),
        "email_address": ("pool", _EMAIL_POOL), "credit_card": ("zfill16",),
        "city": ("pool", _CITY_POOL), "state": ("pool", _STATE_POOL),
        "date_time": ("ts",), "extra": ("empty",),
    },
    "auction": {
        "id": ("num",), "item_name": ("item_name",), "description": ("desc",),
        "initial_bid": ("num",), "reserve": ("num",), "date_time": ("ts",),
        "expires": ("ts",), "seller": ("num",), "category": ("num",),
        "extra": ("empty",),
    },
    "bid": {
        "auction": ("num",), "bidder": ("num",), "price": ("num",),
        "channel": ("pool", _CH_POOL), "url": ("pool", _URL_POOL),
        "date_time": ("ts",), "extra": ("empty",),
    },
}


def decode_column(spec: Tuple, vals: np.ndarray) -> np.ndarray:
    """Surrogate int64s -> the exact host-generator column values."""
    kind = spec[0]
    if kind in ("num", "ts"):
        return vals
    if kind == "pool":
        return spec[1][vals]
    if kind == "zfill16":
        return np.char.zfill(vals.astype("U16"), 16).astype(object)
    if kind == "item_name":
        return np.char.add("item-", vals.astype("U20")).astype(object)
    if kind == "desc":
        return np.char.add("desc-", vals.astype("U4")).astype(object)
    if kind == "empty":
        return np.full(len(vals), "", dtype=object)
    raise ValueError(f"unknown surrogate spec {spec!r}")


def column_bounds(cfg: GenCfg, table: str, col: str,
                  max_events: Optional[int]) -> Tuple[int, int]:
    """Inclusive (lo, hi) value bounds for a column given the event
    horizon — the interval analysis the fused key packer builds on.
    Unbounded sources assume a 2^40-event horizon (device-side bounds
    checks still back this up)."""
    n = max_events if max_events is not None else 1 << 40
    ts_lo = cfg.base_time_usecs
    ts_hi = cfg.base_time_usecs + n * cfg.inter_event_gap_usecs
    n_person = n // TOTAL_PROPORTION * PERSON_PROPORTION + 2
    n_auction = n // TOTAL_PROPORTION * AUCTION_PROPORTION + 4
    b: Dict[Tuple[str, str], Tuple[int, int]] = {
        ("person", "id"): (FIRST_PERSON_ID, FIRST_PERSON_ID + n_person),
        ("person", "name"): (0, len(_NAME_POOL) - 1),
        ("person", "email_address"): (0, len(_EMAIL_POOL) - 1),
        ("person", "credit_card"): (0, 10**16),
        ("person", "city"): (0, len(_CITY_POOL) - 1),
        ("person", "state"): (0, len(_STATE_POOL) - 1),
        ("person", "date_time"): (ts_lo, ts_hi),
        ("person", "extra"): (0, 0),
        ("auction", "id"): (FIRST_AUCTION_ID, FIRST_AUCTION_ID + n_auction),
        ("auction", "item_name"): (FIRST_AUCTION_ID,
                                   FIRST_AUCTION_ID + n_auction),
        ("auction", "description"): (0, 999),
        ("auction", "initial_bid"): (100, 1099),
        ("auction", "reserve"): (100, 2198),
        ("auction", "date_time"): (ts_lo, ts_hi),
        ("auction", "expires"): (ts_lo, ts_hi + cfg.auction_duration_events
                                 * cfg.inter_event_gap_usecs),
        ("auction", "seller"): (FIRST_PERSON_ID, FIRST_PERSON_ID + n_person),
        ("auction", "category"): (FIRST_CATEGORY_ID, FIRST_CATEGORY_ID + 4),
        ("auction", "extra"): (0, 0),
        ("bid", "auction"): (FIRST_AUCTION_ID, FIRST_AUCTION_ID + n_auction),
        ("bid", "bidder"): (FIRST_PERSON_ID, FIRST_PERSON_ID + n_person),
        ("bid", "price"): (100, 10_099),
        ("bid", "channel"): (0, len(_CH_POOL) - 1),
        ("bid", "url"): (0, len(_URL_POOL) - 1),
        ("bid", "date_time"): (ts_lo, ts_hi),
        ("bid", "extra"): (0, 0),
    }
    return b[(table, col)]
