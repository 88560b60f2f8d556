"""Evictors: remove elements from the window buffer before/after the window
function (flink-runtime .../api/windowing/evictors/Evictor.java,
CountEvictor.java, TimeEvictor.java). Counterpart of
`flink_tpu/api/windowing/evictors.py`, copied.

Evicting windows buffer the full element list per (key, window) — the
EvictingWindowOperator path (EvictingWindowOperator.java:63) — which is
incompatible with pre-aggregation; the device operator falls back to the
oracle operator when an evictor is present (same as the reference, where
evicting windows use ListState instead of a single ACC).
"""

from __future__ import annotations

from typing import List, Tuple


class Evictor:
    """Elements are (timestamp, value) pairs in insertion order."""

    def evict_before(self, elements: List[Tuple[int, object]], size: int, window) -> List[Tuple[int, object]]:
        return elements

    def evict_after(self, elements: List[Tuple[int, object]], size: int, window) -> List[Tuple[int, object]]:
        return elements


class CountEvictor(Evictor):
    """Keeps only the last max_count elements (CountEvictor.java)."""

    def __init__(self, max_count: int, do_evict_after: bool = False):
        self.max_count = max_count
        self.do_evict_after = do_evict_after

    @staticmethod
    def of(max_count: int, do_evict_after: bool = False) -> "CountEvictor":
        return CountEvictor(max_count, do_evict_after)

    def _evict(self, elements, size, window):
        if size <= self.max_count:
            return elements
        return elements[size - self.max_count:]

    def evict_before(self, elements, size, window):
        return elements if self.do_evict_after else self._evict(elements, size, window)

    def evict_after(self, elements, size, window):
        return self._evict(elements, size, window) if self.do_evict_after else elements


class TimeEvictor(Evictor):
    """Evicts elements older than max_ts - window_size_ms (TimeEvictor.java)."""

    def __init__(self, window_size_ms: int, do_evict_after: bool = False):
        self.window_size = window_size_ms
        self.do_evict_after = do_evict_after

    @staticmethod
    def of(window_size_ms: int, do_evict_after: bool = False) -> "TimeEvictor":
        return TimeEvictor(window_size_ms, do_evict_after)

    def _evict(self, elements, size, window):
        if not elements:
            return elements
        has_ts = any(ts is not None for ts, _ in elements)
        if not has_ts:
            return elements
        max_ts = max(ts for ts, _ in elements if ts is not None)
        cutoff = max_ts - self.window_size
        return [(ts, v) for ts, v in elements if ts is None or ts >= cutoff]

    def evict_before(self, elements, size, window):
        return elements if self.do_evict_after else self._evict(elements, size, window)

    def evict_after(self, elements, size, window):
        return self._evict(elements, size, window) if self.do_evict_after else elements
