"""Columnar device state: the host key dictionary and the per-(key, slice)
accumulator rings of the per-batch window operator.

Counterpart of `flink_tpu/state/columnar.py`. `KeyDictionary`: raw keys
map to dense row ids, handed out in order of first appearance, with the
JAX package's key identity: where the JAX package calls its native C++
table, the port keeps the same table in numpy and a dict (an integer batch
by its int64 value, any other batch by its fixed-width bytes form) and
falls back to a dict over the raw keys where the JAX package does. The ids
and the stored keys are the JAX package's, so snapshots cross between the
packages.

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


def _bytes_width(itemsize: int) -> int:
    """The fixed key width of a bytes table: whole 8-byte words, at least 24."""
    return max(((itemsize + 7) // 8) * 8, 24)


class KeyDictionary:
    """Raw key -> dense row id. `dense_int` mode skips the dictionary for
    pre-densified integer keys (the traced chain's device keys).

    Other batches follow `flink_tpu/state/columnar.py::_try_native`. The
    first batch sets the table's mode: an integer column is keyed by its
    int64 value ('i64'), anything else by `np.asarray(keys, dtype=np.bytes_)`
    NUL-padded to a width fixed for the dictionary's life ('bytes'). So
    `1.0` and `1` are two keys (b'1.0', b'1'), as are `True` and `1`, while
    `"1"` and `1` are one: the reference's identity, kept for parity. A
    batch of the other mode, or one that does not convert (tuples), takes a
    dict over its raw elements; a key wider than the width turns the table
    off for good. New keys are stored as `.tolist()` scalars (plain Python
    values); the dict path stores the raw elements, as the JAX package
    does."""

    def __init__(self, dense_int: bool = False):
        self.dense_int = dense_int
        self._keys: List[Any] = []
        self._map: Dict[Any, int] = {}
        self._mode = ""       # '', 'i64', 'bytes', 'off' (dict only)
        self._width: Optional[int] = None
        # the table: i64 mode keeps sorted keys and their ids, bytes mode a
        # dict; ids count from the table's own size, as the native one does
        self._sorted = np.empty(0, np.int64)
        self._sorted_ids = np.empty(0, np.int32)
        self._bytes: Dict[bytes, int] = {}
        self._size = 0

    def __len__(self) -> int:
        return len(self._keys)

    # -- the table ----------------------------------------------------------
    def _insert_i64(self, k64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, positions of the batch's new keys in order)."""
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
            uniq_ids[new] = np.arange(self._size, self._size + new.size, dtype=np.int32)
            self._size += new.size
            order = np.sort(new)          # uniq is sorted, so is uniq[order]
            at = np.searchsorted(self._sorted, uniq[order])
            self._sorted = np.insert(self._sorted, at, uniq[order])
            self._sorted_ids = np.insert(self._sorted_ids, at, uniq_ids[order])
        return uniq_ids[inverse.reshape(-1)], first[new]

    def _insert_bytes(self, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, positions of the batch's new keys in order) of a fixed-width
        bytes column."""
        uniq, first, inverse = np.unique(b, return_index=True, return_inverse=True)
        ukeys = uniq.tolist()
        uniq_ids = np.empty(len(uniq), np.int32)
        table, new = self._bytes, []
        for j in np.argsort(first, kind="stable").tolist():
            kid = table.get(ukeys[j])
            if kid is None:
                kid = table[ukeys[j]] = self._size
                self._size += 1
                new.append(first[j])
            uniq_ids[j] = kid
        return uniq_ids[inverse.reshape(-1)], np.asarray(new, np.int64)

    def _try_table(self, keys: np.ndarray):
        """(ids, size) through the table, or None for the dict path."""
        if self._mode == "off":
            return None
        if keys.dtype != object and np.issubdtype(keys.dtype, np.integer):
            mode, conv = "i64", np.ascontiguousarray(keys, dtype=np.int64)
        else:
            try:
                mode, conv = "bytes", np.asarray(keys, dtype=np.bytes_)
            except (TypeError, UnicodeEncodeError, ValueError):
                return None
        if self._mode and self._mode != mode:
            return None           # mixed key types: this batch takes the dict
        if not self._mode:
            self._mode = mode
            if self._keys:        # restored: seed the table in id order
                if mode == "i64":
                    self._insert_i64(np.asarray(self._keys, dtype=np.int64))
                else:
                    seed = np.asarray(self._keys, dtype=np.bytes_)
                    self._width = _bytes_width(seed.dtype.itemsize)
                    self._insert_bytes(seed.astype(f"S{self._width}"))
        if mode == "i64":
            ids, new = self._insert_i64(conv)
        else:
            if self._width is None:
                self._width = _bytes_width(conv.dtype.itemsize)
            if conv.dtype.itemsize > self._width:
                self._mode = "off"
                return None
            ids, new = self._insert_bytes(conv.astype(f"S{self._width}"))
        if len(new):
            self._keys.extend(keys[new].tolist())
        return ids, self._size

    # -----------------------------------------------------------------------
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
        table = self._try_table(keys)
        if table is not None:
            return table
        m = self._map
        if not m and self._keys:  # left the table: build the dict once
            m = self._map = {k: i for i, k in enumerate(self._keys)}
        out = np.empty(len(keys), dtype=np.int32)
        for i, k in enumerate(keys):
            kid = m.get(k)
            if kid is None:
                kid = len(self._keys)
                m[k] = kid
                self._keys.append(k)
            out[i] = kid
        return out, len(self._keys)

    def lookup(self, key) -> Optional[int]:
        """Dense id for a key, or None if never seen (read-only)."""
        if self.dense_int:
            k = int(key)
            return k if 0 <= k < len(self._keys) else None
        kid = self._map.get(key)
        if kid is None and self._keys and not self._map:
            # the table modes keep _map empty: scan the keys in id order
            try:
                kid = self._keys.index(key)
            except ValueError:
                kid = None
        return kid

    def key_at(self, kid: int):
        return self._keys[kid]

    def keys_for(self, kids: np.ndarray) -> List:
        ks = self._keys
        return [ks[int(i)] for i in kids]

    def snapshot(self) -> dict:
        return {"dense_int": self.dense_int, "keys": list(self._keys)}

    @staticmethod
    def restore(snap: dict) -> "KeyDictionary":
        """Restore a snapshot of either package's dictionary: the keys in id
        order; the next batch seeds the table, as in the JAX package."""
        d = KeyDictionary(snap["dense_int"])
        d._keys = list(snap["keys"])
        d._map = {} if d.dense_int else {k: i for i, k in enumerate(d._keys)}
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
