"""The host key dictionary of the fused window path.

Counterpart of `flink_tpu/state/columnar.py::KeyDictionary` (the rest of
that module is ROADMAP item 11). Raw keys map to dense row ids, handed out
in order of first appearance. Batches of integer keys take a vectorized
numpy path (np.unique, then a merge into a sorted key array) where the JAX
package calls its native C++ table; other keys take a Python dict. Both
give the ids the JAX dictionary gives, so snapshots cross between the
packages.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


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
