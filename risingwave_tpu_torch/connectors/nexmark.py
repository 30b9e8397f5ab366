"""Nexmark generator constants: what the device generator needs.

A by-value copy of the proportions, first ids, hot ratios, config and
string pools of `risingwave_tpu/connectors/nexmark.py`. The host reader
stack stays in the JAX package; the port generates events on the device
(`device/nexmark_gen.py`) and decodes string surrogates with these pools.

Event n is a Person if n % 50 == 0, an Auction if n % 50 in 1..=3, else
a Bid (1:3:46 proportions).
"""
from __future__ import annotations

from dataclasses import dataclass

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
