"""Columnar device state: the host key dictionary and the per-(key, slice)
accumulator rings of the per-batch window operator.

Counterpart of `flink_tpu/state/columnar.py`. `KeyDictionary`: raw keys
map to dense row ids, handed out in order of first appearance. Batches of
integer keys take a vectorized numpy path (np.unique, then a merge into a
sorted key array) where the JAX package calls its native C++ table; other
keys take a Python dict. Both give the ids the JAX dictionary gives, so
snapshots cross between the packages.

`ColumnarWindowState`: the accumulator fields and the count as rings on
the device, slice-major `[S, K]` (a fire reads `spw` contiguous rows, a
purge rewrites whole rows), the key dictionary, and the host-tracked ring
frontiers. Snapshots hold the JAX package's `[K, S]` numpy arrays, so a
snapshot taken in either package restores in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.ops import segment_ops
from flink_tpu_torch.ops.aggregators import DeviceAggregator
from flink_tpu_torch.ops.sorted_ingest import sorted_ingest
from flink_tpu_torch.utils.device import resolve_device


def _int_column(keys: np.ndarray) -> bool:
    return keys.dtype != object and (
        keys.dtype.kind == "i" or (keys.dtype.kind == "u" and keys.dtype.itemsize < 8))


def _all_ints(keys: List[Any]) -> bool:
    return all(isinstance(k, (int, np.integer)) and not isinstance(k, (bool, np.bool_))
               for k in keys)


class KeyDictionary:
    """Raw key -> dense row id. `dense_int` mode skips the dictionary for
    pre-densified integer keys (the traced chain's device keys)."""

    def __init__(self, dense_int: bool = False):
        self.dense_int = dense_int
        self._keys: List[Any] = []
        # integer mode: sorted keys and their ids; None once a non-integer
        # key arrived (the dict then holds every key)
        self._sorted: Optional[np.ndarray] = np.empty(0, np.int64)
        self._sorted_ids = np.empty(0, np.int32)
        self._map: Dict[Any, int] = {}

    def __len__(self) -> int:
        return len(self._keys)

    def _leave_int_mode(self) -> None:
        self._map = {k: i for i, k in enumerate(self._keys)}
        self._sorted = None

    def _lookup_or_insert_ints(self, keys: np.ndarray) -> np.ndarray:
        k64 = keys.astype(np.int64, copy=False)
        uniq, first, inverse = np.unique(k64, return_index=True, return_inverse=True)
        pos = np.searchsorted(self._sorted, uniq)
        found = pos < len(self._sorted)
        found[found] = self._sorted[pos[found]] == uniq[found]
        uniq_ids = np.empty(len(uniq), np.int32)
        uniq_ids[found] = self._sorted_ids[pos[found]]
        new = np.flatnonzero(~found)
        if new.size:
            # new keys get ids in order of their first appearance
            new = new[np.argsort(first[new], kind="stable")]
            ids = np.arange(len(self._keys), len(self._keys) + new.size, dtype=np.int32)
            uniq_ids[new] = ids
            self._keys.extend(keys[first[new]].tolist())
            order = np.sort(new)          # uniq is sorted, so is uniq[order]
            at = np.searchsorted(self._sorted, uniq[order])
            self._sorted = np.insert(self._sorted, at, uniq[order])
            self._sorted_ids = np.insert(self._sorted_ids, at, uniq_ids[order])
        return uniq_ids[inverse.reshape(-1)]

    def lookup_or_insert(self, keys: np.ndarray) -> Tuple[np.ndarray, int]:
        """Map a batch of raw keys to dense ids, inserting unseen keys.
        Returns (ids int32[B], required_capacity)."""
        keys = np.asarray(keys)
        if self.dense_int:
            ids = keys.astype(np.int32)
            hi = int(ids.max()) + 1 if ids.size else 0
            if hi > len(self._keys):
                self._keys.extend(range(len(self._keys), hi))
            return ids, len(self._keys)
        if self._sorted is not None:
            if _int_column(keys):
                return self._lookup_or_insert_ints(keys), len(self._keys)
            self._leave_int_mode()
        m = self._map
        out = np.empty(len(keys), dtype=np.int32)
        for i, k in enumerate(keys):
            kid = m.get(k)
            if kid is None:
                kid = len(self._keys)
                m[k] = kid
                self._keys.append(k)
            out[i] = kid
        return out, len(self._keys)

    def key_at(self, kid: int):
        return self._keys[kid]

    def keys_for(self, kids: np.ndarray) -> List:
        ks = self._keys
        return [ks[int(i)] for i in kids]

    def snapshot(self) -> dict:
        return {"dense_int": self.dense_int, "keys": list(self._keys)}

    @staticmethod
    def restore(snap: dict) -> "KeyDictionary":
        """Restore a snapshot of either package's dictionary."""
        d = KeyDictionary(snap["dense_int"])
        d._keys = list(snap["keys"])
        if d.dense_int:
            return d
        if _all_ints(d._keys):
            keys = np.asarray(d._keys, np.int64)
            order = np.argsort(keys, kind="stable")
            d._sorted = keys[order]
            d._sorted_ids = order.astype(np.int32)
        else:
            d._leave_int_mode()
        return d


@dataclasses.dataclass
class RingFrontiers:
    """Host-tracked slice-ring accounting (all in absolute slice indices)."""

    purged_to: Optional[int] = None     # slices < purged_to are recycled
    min_used: Optional[int] = None      # smallest slice ever written
    max_used: Optional[int] = None      # largest slice ever written


class ColumnarWindowState:
    """Device rings + key dictionary + ring accounting for one shard."""

    PURGE_CHUNK = 8

    def __init__(
        self,
        agg: DeviceAggregator,
        *,
        key_capacity: int = 1 << 12,
        num_slices: int = 64,
        dense_int_keys: bool = False,
        ingest_kernel: str = "scatter",
        device=None,
    ):
        if ingest_kernel not in ("scatter", "sort"):
            raise ValueError(f"ingest_kernel {ingest_kernel!r}: 'scatter' or 'sort'")
        self.agg = agg
        self.K = key_capacity
        self.S = num_slices
        self.device = resolve_device(device)
        self.keydict = KeyDictionary(dense_int_keys)
        self.frontiers = RingFrontiers()
        self.acc, self.count = segment_ops.init_state_arrays(agg, self.K, self.S, self.device)
        self._ingest = sorted_ingest if ingest_kernel == "sort" else segment_ops.ingest
        # the lanes of the most recent ingest: the masked re-fire's touch
        self.last_touch: Optional[segment_ops.Lanes] = None

    # ------------------------------------------------------------------
    def ensure_key_capacity(self, required: int) -> None:
        if required <= self.K:
            return
        new_k = self.K
        while new_k < required:
            new_k *= 2
        self.acc, self.count = segment_ops.grow_keys(self.acc, self.count, self.agg, new_k)
        self.K = new_k

    def ring_pos(self, slices: np.ndarray) -> np.ndarray:
        return (slices % self.S).astype(np.int32)

    def ingest(self, kid: np.ndarray, slices_abs: np.ndarray, vals: np.ndarray) -> None:
        """Scatter a prepared batch into the rings.
        kid == INVALID_INDEX lanes are dropped."""
        f = self.frontiers
        valid = kid != segment_ops.INVALID_INDEX
        live = slices_abs[valid]
        if live.size:
            lo, hi = int(live.min()), int(live.max())
            f.min_used = lo if f.min_used is None else min(f.min_used, lo)
            f.max_used = hi if f.max_used is None else max(f.max_used, hi)
        spos = np.where(valid, slices_abs % self.S, segment_ops.INVALID_INDEX).astype(np.int32)
        lanes = segment_ops.stage_lanes(kid, spos, vals, self.K, self.S, self.device)
        self._ingest(self.agg, self.acc, self.count, lanes)
        self.last_touch = lanes

    def fire(self, slice_range: range, *, touch_mask: bool = False):
        """Combine the window's slices: (result, counts, mask) on the device."""
        positions = [s % self.S for s in slice_range]
        return segment_ops.fire(self.agg, self.acc, self.count, positions,
                                self.last_touch if touch_mask else None)

    def purge_slices(self, slices_abs: List[int]) -> None:
        """Reset the rows of expired absolute slices (chunked)."""
        for i in range(0, len(slices_abs), self.PURGE_CHUNK):
            chunk = slices_abs[i : i + self.PURGE_CHUNK]
            segment_ops.purge(self.agg, self.acc, self.count, [s % self.S for s in chunk])

    def reset_all(self) -> None:
        self.acc, self.count = segment_ops.init_state_arrays(self.agg, self.K, self.S,
                                                             self.device)
        self.last_touch = None

    def state_bytes(self) -> int:
        """Device bytes of the resident rings and the last batch's lanes
        (the key dictionary's host memory not included)."""
        n = sum(a.numel() * a.element_size() for a in self.acc.values())
        n += self.count.numel() * self.count.element_size()
        if self.last_touch is not None:
            n += sum(t.numel() * t.element_size() for t in self.last_touch)
        return n

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """The JAX package's form: [K, S] numpy arrays."""
        def host(t):
            return t.t().contiguous().cpu().numpy()

        return {
            "acc": {k: host(v) for k, v in self.acc.items()},
            "count": host(self.count),
            "keydict": self.keydict.snapshot(),
            "frontiers": dataclasses.asdict(self.frontiers),
            "K": self.K,
            "S": self.S,
        }

    def restore(self, snap: dict) -> None:
        """Restore a snapshot of either package's state."""
        def ring(a):
            return torch.from_numpy(np.ascontiguousarray(np.asarray(a).T)).to(self.device)

        self.K = snap["K"]
        self.S = snap["S"]
        self.acc = {k: ring(v) for k, v in snap["acc"].items()}
        self.count = ring(snap["count"])
        self.keydict = KeyDictionary.restore(snap["keydict"])
        self.frontiers = RingFrontiers(**snap["frontiers"])
        self.last_touch = None
