"""Array helpers (counterpart of `flink_tpu/utils/arrays.py`)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def obj_array(items: Sequence) -> np.ndarray:
    """1-D object ndarray of arbitrary Python values. (np.asarray(...,
    dtype=object) would build a 2-D array from a list of equal-length
    tuples — records must stay scalar elements.)"""
    arr = np.empty(len(items), dtype=object)
    if len(items):
        arr[:] = list(items)
    return arr


def as_device_column(arr):
    """Normalize a numeric column for device staging without copying when
    avoidable: a contiguous numeric ndarray (read-only views included)
    passes through untouched, and only a non-contiguous view pays one
    compaction copy. Object arrays are returned unchanged (record-mode
    data; columnarized downstream)."""
    if not isinstance(arr, np.ndarray) or arr.dtype == object:
        return arr
    if arr.flags.c_contiguous:
        return arr
    return np.ascontiguousarray(arr)

# 64-bit numeric dtypes narrow to their 32-bit form, as the JAX package's
# canonical (x64-off) dtypes do; every other dtype is already canonical
_CANONICAL = {
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}


def canonical_dtype(dtype) -> np.dtype:
    """The canonical 32-bit form of a dtype (int64→int32, float64→float32)."""
    dt = np.dtype(dtype)
    return _CANONICAL.get(dt, dt)


def canonical_column(arr, where: str = "column"):
    """Cast a numeric column to the canonical 32-bit dtype (int64→int32,
    float64→float32), refusing LOUDLY when the values don't survive the
    narrowing: a value that would silently wrap (ints) or overflow to inf
    (floats) is an error, never a silent divergence from the JAX package,
    whose device programs stage the same canonical buffers."""
    arr = np.asarray(arr)
    dt = _CANONICAL.get(arr.dtype, arr.dtype)
    if dt == arr.dtype:
        return arr
    if arr.size and np.issubdtype(arr.dtype, np.integer):
        info = np.iinfo(dt)
        lo, hi = int(arr.min()), int(arr.max())
        if lo < info.min or hi > info.max:
            raise TypeError(
                f"{where}: values in [{lo}, {hi}] do not fit the canonical "
                f"{dt} and would silently wrap; re-encode the column"
            )
        return arr.astype(dt)
    with np.errstate(over="ignore", invalid="ignore"):
        out = arr.astype(dt)  # overflow checked explicitly below
    if arr.size and np.issubdtype(arr.dtype, np.floating):
        bad = ~np.isfinite(out) & np.isfinite(arr)
        if bad.any():
            raise TypeError(
                f"{where}: {int(bad.sum())} value(s) overflow the canonical "
                f"{dt}; re-scale the column"
            )
    return out
