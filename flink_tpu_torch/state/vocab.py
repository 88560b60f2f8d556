"""Dynamic key vocabulary: unbounded raw keys over a bounded dense-id space.

Counterpart of `flink_tpu/state/vocab.py`, copied: the order of dict
iteration and every tie-break are the JAX package's, since victim choice
decides which device rows move. One repair: `would_evict` counts the
doorkeeper-failing keys that take free ids (the JAX package's misses an
eviction that follows them, ROADMAP.md Queue C).

The grow-only :class:`~flink_tpu_torch.state.columnar.KeyDictionary`
couples key cardinality to the device key capacity ``K``: every distinct
key ever seen owns a ring row forever. This vocabulary decouples them: at
most ``capacity`` keys are RESIDENT (own a dense hot id, i.e. a device ring
row) at any instant; every other known key is COLD (owns a cold id
addressing rows in the host/disk tier, state/cold_tier.py). Admission,
eviction and id recycling are host-side policy:

- **admission**: a key's first ``admission_min_count - 1`` sightings while
  the hot tier is full stay cold (tiny-LFU-style doorkeeper — one-touch
  keys in a heavy tail must not churn hot rows); with the default of 1
  every new key is admitted, evicting the coldest resident.
- **eviction**: the victim is the least-recently-used resident
  (``policy="lru"``, frequency as the tiebreak) or the least-frequently
  -used (``policy="lfu"``, recency tiebreak). Keys touched by the batch
  being routed are pinned — the operator is about to write their rows.
- **recycling**: an evicted key's hot id is reused by the admitted key
  (its device row is demoted to the cold tier first, by the caller); a
  promoted key's cold id returns to the cold free list one batch later
  (the demote/promote data movement of the SAME batch must never alias a
  just-freed cold id).

The vocabulary is pure host bookkeeping — it decides WHAT moves between
tiers; the tier manager (state/tier_manager.py) moves the bytes. Every
structural mutation is journaled (``drain_ops``/``apply_ops``) so the
incremental changelog checkpoint replays vocabulary state from per-interval
deltas instead of re-pickling the whole directory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RoutedBatch:
    """The routing decision for one batch of raw keys.

    ``ids[i]`` is the record's dense hot id, or -1 when the record stays
    cold; ``cold_ids[i]`` is its cold-tier id (-1 for resident records).
    ``demotions``/``promotions`` are the data movements the caller must
    perform BEFORE dispatching the batch: demote = read the hot row of
    ``hot_id`` into the cold tier under ``cold_id`` and clear it; promote
    = move ``cold_id``'s live cold rows into the (freshly identity) hot
    row ``hot_id``."""

    ids: np.ndarray                                 # int32[n]
    cold_ids: np.ndarray                            # int64[n]
    demotions: List[Tuple[Any, int, int]]           # (key, hot_id, cold_id)
    promotions: List[Tuple[Any, int, int]]          # (key, hot_id, cold_id)


def _plain(k):
    """numpy scalars hash/compare fine but leak into user-facing emissions;
    store plain Python keys like KeyDictionary does."""
    return k.item() if isinstance(k, np.generic) else k


class DynamicKeyVocabulary:
    """Bounded raw-key -> dense-hot-id map with cold-id overflow."""

    def __init__(self, capacity: int, *, policy: str = "lru",
                 admission_min_count: int = 1):
        if capacity < 1:
            raise ValueError("vocabulary capacity must be >= 1")
        if policy not in ("lru", "lfu"):
            raise ValueError(f"unknown eviction policy {policy!r} "
                             "(valid: lru, lfu)")
        self.capacity = int(capacity)
        self.policy = policy
        self.admission_min_count = max(int(admission_min_count), 1)
        self._resident: Dict[Any, int] = {}         # key -> hot id
        self._ids: List[Any] = []                   # hot id -> key (grow-once)
        self._free: List[int] = []                  # recycled hot ids
        self._cold: Dict[Any, int] = {}             # key -> cold id
        self._cold_keys: List[Any] = []             # cold id -> key
        self._cold_free: List[int] = []             # recycled cold ids
        self._pending_cold_free: List[int] = []     # freed NEXT batch
        # doorkeeper sightings of currently-cold keys (admission policy)
        self._cold_freq: Dict[Any, int] = {}
        # heat, indexed by hot id
        self._tick = 0
        self._last = np.zeros(self.capacity, dtype=np.int64)
        self._freq = np.zeros(self.capacity, dtype=np.int64)
        self.num_admissions = 0
        self.num_evictions = 0
        self.num_promotions = 0
        # structural-mutation journal for the changelog checkpoint
        self._ops: List[tuple] = []

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._resident)

    @property
    def resident_count(self) -> int:
        return len(self._resident)

    @property
    def vocab_size(self) -> int:
        """Distinct keys currently tracked (resident + cold directory)."""
        return len(self._resident) + len(self._cold)

    def key_of_id(self, hot_id: int):
        return self._ids[hot_id]

    def key_of_cold_id(self, cold_id: int):
        return self._cold_keys[cold_id]

    def resident_id(self, key) -> Optional[int]:
        return self._resident.get(_plain(key))

    def cold_id(self, key) -> Optional[int]:
        return self._cold.get(_plain(key))

    # -- routing ------------------------------------------------------------
    def would_evict(self, keys: np.ndarray) -> bool:
        """Cheap pre-check: could routing this batch evict a resident key?
        The caller uses it to flush in-flight device work BEFORE ids are
        reassigned (a resolved emission must map old ids to old keys).
        Over-approximates (admission may still deny every candidate)."""
        slack = len(self._free) + (self.capacity - len(self._ids))
        if slack >= len(keys):
            return False
        min_count = self.admission_min_count
        # per-key occurrence counts: with a doorkeeper, a key's LAST
        # occurrence in this batch may cross the admission threshold even
        # though its first cannot — project the full batch's sightings
        occ: Dict[Any, int] = {}
        for k in keys:
            k = _plain(k)
            if k not in self._resident:
                occ[k] = occ.get(k, 0) + 1
        if len(occ) <= slack:
            return False    # every new key fits a free id: nothing moves
        # the free ids go to new keys in batch order whether or not they
        # pass the doorkeeper (it gates only a full tier), so once they are
        # taken any key that passes it evicts. The JAX package counts only
        # the keys that pass against the free ids, and so misses an
        # eviction that follows doorkeeper-failing admissions (ROADMAP.md
        # Queue C): its in-flight rows then resolve under the new ids.
        return min_count <= 1 or any(
            self._cold_freq.get(k, 0) + c >= min_count for k, c in occ.items())

    def observe_batch(self, keys: np.ndarray) -> RoutedBatch:
        """Route one batch: assign hot ids (admitting/evicting per policy)
        or cold ids, update heat, and return the data movements due."""
        self._tick += 1
        # cold ids freed by the PREVIOUS batch's promotions become reusable
        if self._pending_cold_free:
            self._cold_free.extend(self._pending_cold_free)
            self._pending_cold_free = []
        n = len(keys)
        ids = np.full(n, -1, dtype=np.int32)
        cold_out = np.full(n, -1, dtype=np.int64)
        demotions: List[Tuple[Any, int, int]] = []
        promotions: List[Tuple[Any, int, int]] = []
        pinned: set = set()
        self._victim_order: Optional[np.ndarray] = None
        self._victim_pos = 0
        for i in range(n):
            k = _plain(keys[i])
            hid = self._resident.get(k)
            if hid is None:
                hid = self._admit(k, pinned, demotions, promotions)
            if hid is None:
                cold_out[i] = self._cold_id_for(k)
                self._cold_freq[k] = self._cold_freq.get(k, 0) + 1
            else:
                ids[i] = hid
                self._freq[hid] += 1
                self._last[hid] = self._tick
                pinned.add(hid)
        return RoutedBatch(ids, cold_out, demotions, promotions)

    # -- internals ----------------------------------------------------------
    def _cold_id_for(self, k) -> int:
        cid = self._cold.get(k)
        if cid is None:
            if self._cold_free:
                cid = self._cold_free.pop()
                self._cold_keys[cid] = k
            else:
                cid = len(self._cold_keys)
                self._cold_keys.append(k)
            self._cold[k] = cid
            self._ops.append(("cold", k, cid))
        return cid

    def _admit(self, k, pinned: set, demotions: list,
               promotions: list) -> Optional[int]:
        if self._free:
            hid = self._free.pop()
        elif len(self._ids) < self.capacity:
            hid = len(self._ids)
            self._ids.append(None)
        else:
            # full: the doorkeeper gates admission, then a victim pays
            sightings = self._cold_freq.get(k, 0) + 1
            if sightings < self.admission_min_count:
                return None
            victim = self._pick_victim(pinned)
            if victim is None:
                return None           # every resident is pinned this batch
            vk = self._ids[victim]
            cid = self._cold_id_for(vk)
            del self._resident[vk]
            # an evicted key re-enters the doorkeeper with its hot
            # frequency as credit (a genuinely hot key evicted by a burst
            # must not be locked out by the admission gate)
            self._cold_freq[vk] = int(self._freq[victim])
            demotions.append((vk, victim, cid))
            self.num_evictions += 1
            self._ops.append(("evict", vk, victim, cid))
            hid = victim
        self._resident[k] = hid
        self._ids[hid] = k
        self._freq[hid] = 0
        self._last[hid] = self._tick
        self.num_admissions += 1
        self._ops.append(("admit", k, hid))
        prior_cid = self._cold.pop(k, None)
        self._cold_freq.pop(k, None)
        if prior_cid is not None:
            # re-admission: the caller promotes the cold rows; the cold id
            # frees one batch later (see _pending_cold_free)
            promotions.append((k, hid, prior_cid))
            self._cold_keys[prior_cid] = None
            self._pending_cold_free.append(prior_cid)
            self.num_promotions += 1
            self._ops.append(("promote", k, hid, prior_cid))
        return hid

    def _pick_victim(self, pinned: set) -> Optional[int]:
        """Coldest unpinned resident. The ordering is computed once per
        batch (heat changes within the batch only make victims warmer,
        never colder, so a stale order still evicts a valid cold key)."""
        if self._victim_order is None:
            if self.policy == "lru":
                self._victim_order = np.lexsort((self._freq, self._last))
            else:
                self._victim_order = np.lexsort((self._last, self._freq))
            self._victim_pos = 0
        order = self._victim_order
        while self._victim_pos < len(order):
            cand = int(order[self._victim_pos])
            self._victim_pos += 1
            if cand in pinned or cand >= len(self._ids):
                continue
            if self._ids[cand] is None or self._ids[cand] not in self._resident:
                continue
            if self._resident.get(self._ids[cand]) != cand:
                continue
            return cand
        return None

    # -- changelog journal ---------------------------------------------------
    def drain_ops(self) -> List[tuple]:
        ops, self._ops = self._ops, []
        return ops

    def apply_ops(self, ops: List[tuple]) -> None:
        """Replay a drained journal onto this vocabulary (restore path).
        Heat is not journaled — replayed entries restore structure exactly
        and heat approximately (eviction decisions after restore may
        differ; tier placement is semantically transparent, so results
        cannot)."""
        for op in ops:
            kind = op[0]
            if kind == "cold":
                _, k, cid = op
                while len(self._cold_keys) <= cid:
                    self._cold_keys.append(None)
                self._cold_keys[cid] = k
                self._cold[k] = cid
                if cid in self._cold_free:
                    self._cold_free.remove(cid)
            elif kind == "admit":
                _, k, hid = op
                while len(self._ids) <= hid:
                    self._ids.append(None)
                self._ids[hid] = k
                self._resident[k] = hid
                self._cold_freq.pop(k, None)
                if hid in self._free:
                    self._free.remove(hid)
                self._last[hid] = self._tick
                self._freq[hid] = 0
                self.num_admissions += 1
            elif kind == "evict":
                _, k, hid, cid = op
                if self._resident.get(k) == hid:
                    del self._resident[k]
                while len(self._cold_keys) <= cid:
                    self._cold_keys.append(None)
                self._cold_keys[cid] = k
                self._cold[k] = cid
                if cid in self._cold_free:
                    self._cold_free.remove(cid)
                self.num_evictions += 1
            elif kind == "promote":
                _, k, hid, cid = op
                if self._cold.get(k) == cid:
                    del self._cold[k]
                if cid < len(self._cold_keys):
                    self._cold_keys[cid] = None
                if cid not in self._cold_free:
                    self._cold_free.append(cid)
                self.num_promotions += 1
            else:
                raise ValueError(f"unknown vocabulary op {kind!r}")

    # -- snapshot ------------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "capacity": self.capacity,
            "policy": self.policy,
            "admission_min_count": self.admission_min_count,
            "ids": list(self._ids),
            "free": list(self._free),
            "cold_keys": list(self._cold_keys),
            "cold_free": list(self._cold_free) + list(self._pending_cold_free),
            "cold_freq": dict(self._cold_freq),
            "tick": self._tick,
            "last": self._last.tolist(),
            "freq": self._freq.tolist(),
            "counters": [self.num_admissions, self.num_evictions,
                         self.num_promotions],
        }

    @staticmethod
    def restore(snap: dict) -> "DynamicKeyVocabulary":
        v = DynamicKeyVocabulary(
            snap["capacity"], policy=snap["policy"],
            admission_min_count=snap["admission_min_count"])
        v._ids = list(snap["ids"])
        v._free = list(snap["free"])
        v._resident = {k: i for i, k in enumerate(v._ids)
                       if k is not None and i not in set(snap["free"])}
        v._cold_keys = list(snap["cold_keys"])
        v._cold_free = list(snap["cold_free"])
        v._cold = {k: i for i, k in enumerate(v._cold_keys)
                   if k is not None and i not in set(snap["cold_free"])}
        v._cold_freq = dict(snap["cold_freq"])
        v._tick = snap["tick"]
        v._last = np.asarray(snap["last"], dtype=np.int64)
        v._freq = np.asarray(snap["freq"], dtype=np.int64)
        (v.num_admissions, v.num_evictions, v.num_promotions) = \
            snap["counters"]
        return v
