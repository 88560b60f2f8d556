"""YSB's event generator (yahoo/streaming-benchmarks, data/src/setup/core.clj)
with every field at its published width, drawn from the seed into a host
pool.

A YSB event is JSON of user_id, page_id and ad_id (UUIDs), ad_type and
event_type (strings), event_time (ms) and ip_address. Here each field
keeps its bytes in fixed-width binary, as a columnar source would carry
them: a UUID as its 16 bytes, a string as its ASCII bytes padded with
NULs to the longest value of its field ("sponsored-search", 16 bytes;
"purchase", 8; "1.2.3.4", 8). A record is 80 bytes, 20 int32 words in
the columns below; its event_time travels beside it as the batch's int64
timestamp (the source's record timestamp), as the feed stamps it.

The UUIDs come from fixed sets drawn from the seed: 100 users, 100 pages,
100 campaigns of 10 ads each. `ads` holds the 1000 ad UUIDs and
`campaign_of_ad` the static ad -> campaign table (YSB's Redis), which
the job joins through and the reference reads. Ad types and event types
are drawn uniformly; the address is a constant. Record i is pool row i
mod P; P is a multiple of the batch, so every batch is a view.
"""

from __future__ import annotations

import numpy as np

from streambench.core.seeds import rng_of

#: (field, first int32 word, words)
FIELDS = (("user_id", 0, 4), ("page_id", 4, 4), ("ad_id", 8, 4), ("ad_type", 12, 4),
          ("event_type", 16, 2), ("ip_address", 18, 2))
WORDS = 20
AD, AD_TYPE, EVENT_TYPE, IP = 8, 12, 16, 18
AD_TYPES = ("banner", "modal", "sponsored-search", "mail", "mobile")
EVENT_TYPES = ("view", "click", "purchase")
IP_ADDRESS = "1.2.3.4"


def words(text: str, width: int) -> np.ndarray:
    """`text`'s ASCII bytes padded with NULs to `width` bytes, as int32
    words (little-endian, as the record holds them)."""
    raw = text.encode("ascii")
    if len(raw) > width:
        raise ValueError(f"{text!r} is wider than {width} bytes")
    return np.frombuffer(raw.ljust(width, b"\0"), "<i4").astype(np.int32)


def uuids(rng: np.random.Generator, n: int) -> np.ndarray:
    """n random (version 4) UUIDs, [n, 16] uint8."""
    b = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    b[:, 6] = (b[:, 6] & 0x0F) | 0x40
    b[:, 8] = (b[:, 8] & 0x3F) | 0x80
    return b


class Gen:
    def __init__(self, seed: int, cfg: dict, traffic: dict):
        job = cfg["job"]
        rng = rng_of(seed)
        n_ads = job["campaigns"] * job["ads_per_campaign"]
        self.campaign_of_ad = (rng.permutation(n_ads) // job["ads_per_campaign"]).astype(np.int32)
        users, pages = uuids(rng, job["users"]), uuids(rng, job["pages"])
        ads = uuids(rng, n_ads)
        # the job finds an ad by the first word of its UUID, then checks all
        # four: draw again until those words differ
        while len(np.unique(ads[:, :4].view("<i4"))) < n_ads:
            ads = uuids(rng, n_ads)
        self.ads = ads
        self.P = int(traffic["pool_records"])
        if self.P % int(traffic["batch_size"]):
            raise ValueError("pool_records must be a multiple of batch_size")
        ad_types = np.stack([words(t, 16) for t in AD_TYPES])
        event_types = np.stack([words(t, 8) for t in EVENT_TYPES])
        pool = np.empty((self.P, WORDS), np.int32)
        for lo, table in ((0, users), (4, pages), (AD, ads)):
            pool[:, lo:lo + 4] = table.view("<i4")[rng.integers(0, len(table), self.P)]
        pool[:, AD_TYPE:AD_TYPE + 4] = ad_types[rng.integers(0, len(AD_TYPES), self.P)]
        pool[:, EVENT_TYPE:EVENT_TYPE + 2] = event_types[
            rng.integers(0, len(EVENT_TYPES), self.P)]
        pool[:, IP:IP + 2] = words(IP_ADDRESS, 8)
        pool.setflags(write=False)
        self.pool = pool

    def batch(self, lo: int, n: int) -> np.ndarray:
        """Records lo .. lo+n-1 ([n, 20] int32)."""
        p = lo % self.P
        if p + n <= self.P:
            return self.pool[p:p + n]
        idx = (np.arange(lo, lo + n, dtype=np.int64) % self.P)
        return self.pool[idx]


def make(seed: int, cfg: dict, traffic: dict) -> Gen:
    return Gen(seed, cfg, traffic)
