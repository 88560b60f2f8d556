"""Record representations: per-record stream elements and columnar batches.

Counterpart of `flink_tpu/core/records.py`, copied: `hash_keys` must stay
bit-equal to the JAX package's, because it routes keys to key groups.

The reference moves individual serialized records through a tagged-union
stream (StreamElementSerializer.java:45: record/watermark/latency-marker/
status). The TPU-native design instead moves *columnar batches*: the host
ingest loop accumulates records into struct-of-arrays `RecordBatch`es that
map 1:1 onto device arrays, and watermarks/latency markers travel out-of-band
as scalars attached to the batch (there is exactly one combined watermark per
step, see core/watermarks.py).

Per-record `StreamRecord` objects still exist for the pure-Python oracle
operators (parity testing, sessions) and for user process functions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.core.keygroups import key_hash, key_groups_for_hashes
from flink_tpu_torch.core.time import MIN_TIMESTAMP


@dataclasses.dataclass
class StreamRecord:
    """A single value + event timestamp (StreamRecord.java)."""

    value: Any
    timestamp: int = MIN_TIMESTAMP

    def has_timestamp(self) -> bool:
        return self.timestamp != MIN_TIMESTAMP


@dataclasses.dataclass
class LatencyMarker:
    """Source-injected marker for end-to-end latency tracking
    (streamrecord/LatencyMarker.java:32)."""

    marked_time_ms: int
    source_id: int
    subtask_index: int


class RecordBatch:
    """Struct-of-arrays batch: the unit of work of a device step.

    Columns:
      timestamps : int64[n]  event-time ms
      keys       : object[n] raw keys (host only; never shipped to device)
      key_hashes : int32[n]  java-hashCode-parity hashes
      key_groups : int32[n]  murmur(key_hash) % max_parallelism
      values     : {name: np.ndarray[n]} numeric payload columns
    """

    __slots__ = ("timestamps", "keys", "key_hashes", "key_groups", "values")

    def __init__(
        self,
        timestamps: np.ndarray,
        keys: np.ndarray,
        key_hashes: np.ndarray,
        key_groups: np.ndarray,
        values: Dict[str, np.ndarray],
    ):
        self.timestamps = timestamps
        self.keys = keys
        self.key_hashes = key_hashes
        self.key_groups = key_groups
        self.values = values

    def __len__(self) -> int:
        return int(self.timestamps.shape[0])

    @staticmethod
    def from_columns(
        timestamps: np.ndarray,
        keys: Sequence[Any],
        values: Dict[str, np.ndarray],
        max_parallelism: int,
        key_hashes: Optional[np.ndarray] = None,
    ) -> "RecordBatch":
        keys_arr = np.asarray(keys, dtype=object)
        if key_hashes is None:
            key_hashes = hash_keys(keys_arr)
        key_groups = key_groups_for_hashes(key_hashes, max_parallelism)
        return RecordBatch(
            np.asarray(timestamps, dtype=np.int64), keys_arr, key_hashes, key_groups, values
        )

    @staticmethod
    def from_records(
        records: Sequence[StreamRecord],
        key_selector: Callable[[Any], Any],
        value_selector: Callable[[Any], float],
        max_parallelism: int,
        value_dtype=np.float32,
    ) -> "RecordBatch":
        ts = np.fromiter((r.timestamp for r in records), dtype=np.int64, count=len(records))
        keys = [key_selector(r.value) for r in records]
        vals = np.fromiter(
            (value_selector(r.value) for r in records), dtype=value_dtype, count=len(records)
        )
        return RecordBatch.from_columns(ts, keys, {"value": vals}, max_parallelism)

    def select(self, mask: np.ndarray) -> "RecordBatch":
        return RecordBatch(
            self.timestamps[mask],
            self.keys[mask],
            self.key_hashes[mask],
            self.key_groups[mask],
            {k: v[mask] for k, v in self.values.items()},
        )

    def concat(self, other: "RecordBatch") -> "RecordBatch":
        return RecordBatch(
            np.concatenate([self.timestamps, other.timestamps]),
            np.concatenate([self.keys, other.keys]),
            np.concatenate([self.key_hashes, other.key_hashes]),
            np.concatenate([self.key_groups, other.key_groups]),
            {k: np.concatenate([v, other.values[k]]) for k, v in self.values.items()},
        )

    @staticmethod
    def empty(value_dtypes: Dict[str, Any] = None) -> "RecordBatch":
        value_dtypes = value_dtypes or {"value": np.float32}
        return RecordBatch(
            np.empty(0, dtype=np.int64),
            np.empty(0, dtype=object),
            np.empty(0, dtype=np.int32),
            np.empty(0, dtype=np.int32),
            {k: np.empty(0, dtype=dt) for k, dt in value_dtypes.items()},
        )


def hash_keys(keys: np.ndarray) -> np.ndarray:
    """Java-parity hashes for a batch of keys. Integer arrays vectorize;
    object/string keys fall back to a per-element loop (the C++ codec in
    native/ is the fast path for string keys, see native/README)."""
    if keys.dtype != object and np.issubdtype(keys.dtype, np.integer):
        v = keys.astype(np.int64)
        small = (v >= -(1 << 31)) & (v < (1 << 31))
        folded = (v.view(np.uint64) ^ (v.view(np.uint64) >> np.uint64(32))).astype(np.uint32)
        out = np.where(small, v.astype(np.int64), folded.astype(np.int64))
        out = np.where(out >= (1 << 31), out - (1 << 32), out)
        return out.astype(np.int32)
    return np.fromiter((key_hash(k) for k in keys), dtype=np.int32, count=len(keys))
