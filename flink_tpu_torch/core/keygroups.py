"""Key-group assignment with exact reference parity.

Counterpart of `flink_tpu/core/keygroups.py`, copied: the hash must be
bit-equal to the JAX package's, because it orders keyed state and timers.

Key groups are the unit of state sharding and rescaling: every key maps to a
key group via a murmur-style finalizer over the key's hash, and each parallel
operator instance (here: each device shard) owns a contiguous range of key
groups. Parity targets (semantics reproduced exactly, per SURVEY.md §2.10):

- key group = murmur(keyHash) % maxParallelism
  (flink-runtime .../state/KeyGroupRangeAssignment.java:75,
   flink-core .../util/MathUtils.java:137 murmurHash)
- operator i owns [ceil(i*max/p), floor(((i+1)*max - 1)/p)]
  (KeyGroupRangeAssignment.java:93-106)
- key hash parity with java.lang hashCode for int/long/str keys so identical
  inputs land in identical key groups as the reference.

All functions have vectorized numpy forms (used on the host ingest path for
whole record batches).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Union

import numpy as np

DEFAULT_MAX_PARALLELISM = 128
UPPER_BOUND_MAX_PARALLELISM = 1 << 15  # Short.MAX_VALUE + 1, reference bound


# ---------------------------------------------------------------------------
# Java-compatible hashes (int32 wraparound arithmetic)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _to_i32(x: int) -> int:
    x &= _U32
    return x - (1 << 32) if x >= (1 << 31) else x


def java_hash_int(v: int) -> int:
    """Integer.hashCode / Long.hashCode((int)(v ^ (v >>> 32))) for wide ints."""
    if -(1 << 31) <= v < (1 << 31):
        return v
    v64 = v & 0xFFFFFFFFFFFFFFFF
    return _to_i32(v64 ^ (v64 >> 32))


def java_hash_string(s: Union[str, bytes]) -> int:
    """String.hashCode: s[0]*31^(n-1) + ... + s[n-1], int32 wraparound."""
    if isinstance(s, bytes):
        s = s.decode("utf-8", "surrogatepass")
    h = 0
    for ch in s:
        h = (h * 31 + ord(ch)) & _U32
    return _to_i32(h)


def key_hash(key) -> int:
    """hashCode-equivalent for supported key types; tuples combine like
    java.util.Arrays.hashCode."""
    if isinstance(key, bool):
        return 1231 if key else 1237
    if isinstance(key, (int, np.integer)):
        return java_hash_int(int(key))
    if isinstance(key, (str, bytes)):
        return java_hash_string(key)
    if isinstance(key, tuple):
        h = 1
        for item in key:
            h = (h * 31 + (key_hash(item) & _U32)) & _U32
        return _to_i32(h)
    if isinstance(key, float):
        # Double.hashCode over IEEE bits
        bits = np.float64(key).view(np.uint64)
        return _to_i32(int(bits) ^ (int(bits) >> 32))
    raise TypeError(f"Unsupported key type for key-group assignment: {type(key)}")


def murmur_finalize(code: int) -> int:
    """MathUtils.murmurHash(int): murmur3-32 body over one int + fmix,
    then absolute value (MathUtils.java:137-155). Returns non-negative."""
    c = code & _U32
    c = (c * 0xCC9E2D51) & _U32
    c = ((c << 15) | (c >> 17)) & _U32  # rotl 15
    c = (c * 0x1B873593) & _U32
    c = ((c << 13) | (c >> 19)) & _U32  # rotl 13
    c = (c * 5 + 0xE6546B64) & _U32
    c ^= 4  # length in bytes
    # fmix / bitMix (MathUtils.java:194)
    c ^= c >> 16
    c = (c * 0x85EBCA6B) & _U32
    c ^= c >> 13
    c = (c * 0xC2B2AE35) & _U32
    c ^= c >> 16
    signed = _to_i32(c)
    if signed >= 0:
        return signed
    if signed != -(1 << 31):
        return -signed
    return 0


def compute_key_group_for_key_hash(key_hash_val: int, max_parallelism: int) -> int:
    """KeyGroupRangeAssignment.computeKeyGroupForKeyHash:75."""
    return murmur_finalize(key_hash_val) % max_parallelism


def assign_to_key_group(key, max_parallelism: int = DEFAULT_MAX_PARALLELISM) -> int:
    """KeyGroupRangeAssignment.assignToKeyGroup:63."""
    return compute_key_group_for_key_hash(key_hash(key), max_parallelism)


# ---------------------------------------------------------------------------
# Vectorized (host batch path)
# ---------------------------------------------------------------------------

def murmur_finalize_np(codes: np.ndarray) -> np.ndarray:
    """Vectorized murmur_finalize over an int array -> non-negative int32."""
    c = codes.astype(np.uint32)
    c = c * np.uint32(0xCC9E2D51)
    c = (c << np.uint32(15)) | (c >> np.uint32(17))
    c = c * np.uint32(0x1B873593)
    c = (c << np.uint32(13)) | (c >> np.uint32(19))
    c = c * np.uint32(5) + np.uint32(0xE6546B64)
    c = c ^ np.uint32(4)
    c = c ^ (c >> np.uint32(16))
    c = c * np.uint32(0x85EBCA6B)
    c = c ^ (c >> np.uint32(13))
    c = c * np.uint32(0xC2B2AE35)
    c = c ^ (c >> np.uint32(16))
    signed = c.astype(np.int64)
    signed = np.where(signed >= (1 << 31), signed - (1 << 32), signed)
    out = np.where(signed >= 0, signed, np.where(signed != -(1 << 31), -signed, 0))
    return out.astype(np.int32)


def key_groups_for_hashes(key_hashes: np.ndarray, max_parallelism: int) -> np.ndarray:
    """Vectorized key-group assignment for a batch of java-style key hashes."""
    return (murmur_finalize_np(key_hashes).astype(np.int64) % max_parallelism).astype(np.int32)


# ---------------------------------------------------------------------------
# Ranges
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KeyGroupRange:
    """Inclusive [start, end] range of key groups owned by one parallel instance
    (reference: runtime/state/KeyGroupRange.java:31)."""

    start: int
    end: int

    def __post_init__(self):
        if self.start > self.end:
            object.__setattr__(self, "start", 0)
            object.__setattr__(self, "end", -1)  # empty range convention

    @property
    def num_key_groups(self) -> int:
        return max(0, self.end - self.start + 1)

    def contains(self, key_group: int) -> bool:
        return self.start <= key_group <= self.end

    def __iter__(self) -> Iterable[int]:
        return iter(range(self.start, self.end + 1))

    def __len__(self) -> int:
        return self.num_key_groups


def key_group_range_for_operator(
    max_parallelism: int, parallelism: int, operator_index: int
) -> KeyGroupRange:
    """KeyGroupRangeAssignment.computeKeyGroupRangeForOperatorIndex:93-106."""
    if parallelism > max_parallelism:
        raise ValueError(
            f"parallelism {parallelism} > maxParallelism {max_parallelism}"
        )
    if max_parallelism > UPPER_BOUND_MAX_PARALLELISM:
        raise ValueError(f"maxParallelism must be <= {UPPER_BOUND_MAX_PARALLELISM}")
    start = (operator_index * max_parallelism + parallelism - 1) // parallelism
    end = ((operator_index + 1) * max_parallelism - 1) // parallelism
    return KeyGroupRange(start, end)


def operator_index_for_key_group(
    max_parallelism: int, parallelism: int, key_group: int
) -> int:
    """KeyGroupRangeAssignment.computeOperatorIndexForKeyGroup."""
    return key_group * parallelism // max_parallelism


def shard_for_key_groups_np(
    key_groups: np.ndarray, max_parallelism: int, parallelism: int
) -> np.ndarray:
    """Vectorized operator/shard index for a batch of key groups — this is the
    host-side half of the keyBy shuffle (the device half is the all-to-all)."""
    return (key_groups.astype(np.int64) * parallelism // max_parallelism).astype(np.int32)
