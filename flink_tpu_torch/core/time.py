"""Event-time primitives: TimeWindow and window-start math at exact parity.

Counterpart of `flink_tpu/core/time.py` (the parts the fused window path
needs). Parity targets:
- window start: start = ts - ((ts - offset) mod size) with negative-remainder
  correction (TimeWindow.getWindowStartWithOffset);
- windows are [start, end); a window may fire when
  watermark >= maxTimestamp() = end - 1;
- sliding assignment walks start in {lastStart, lastStart - slide, ...} while
  start > ts - size (SlidingEventTimeWindows.assignWindows).
"""

from __future__ import annotations

import dataclasses
from typing import List

MIN_TIMESTAMP = -(1 << 63)          # Long.MIN_VALUE: "no timestamp"
MAX_WATERMARK = (1 << 63) - 1       # Watermark.MAX_WATERMARK: end of stream
MIN_WATERMARK = -(1 << 63)


def _java_mod(a: int, b: int) -> int:
    """Java % (truncated toward zero), unlike Python's floored %."""
    r = abs(a) % abs(b)
    return -r if a < 0 else r


def window_start_with_offset(timestamp: int, offset: int, window_size: int) -> int:
    """TimeWindow.getWindowStartWithOffset (exact semantics)."""
    remainder = _java_mod(timestamp - offset, window_size)
    if remainder < 0:
        return timestamp - (remainder + window_size)
    return timestamp - remainder


@dataclasses.dataclass(frozen=True, order=True)
class TimeWindow:
    """Half-open [start, end) event-time window (TimeWindow.java)."""

    start: int
    end: int

    def max_timestamp(self) -> int:
        return self.end - 1

    def intersects(self, other: "TimeWindow") -> bool:
        return self.start <= other.end and self.end >= other.start

    def cover(self, other: "TimeWindow") -> "TimeWindow":
        return TimeWindow(min(self.start, other.start), max(self.end, other.end))

    def __repr__(self) -> str:
        return f"TimeWindow[{self.start}, {self.end})"


def assign_tumbling(timestamp: int, size: int, offset: int = 0) -> List[TimeWindow]:
    if timestamp <= MIN_TIMESTAMP:
        raise ValueError("Record has no timestamp; assign timestamps & watermarks first.")
    start = window_start_with_offset(timestamp, offset, size)
    return [TimeWindow(start, start + size)]


def assign_sliding(timestamp: int, size: int, slide: int, offset: int = 0) -> List[TimeWindow]:
    """SlidingEventTimeWindows.assignWindows (newest window first)."""
    if timestamp <= MIN_TIMESTAMP:
        raise ValueError("Record has no timestamp; assign timestamps & watermarks first.")
    windows = []
    start = window_start_with_offset(timestamp, offset, slide)
    while start > timestamp - size:
        windows.append(TimeWindow(start, start + size))
        start -= slide
    return windows


def cleanup_time(window: TimeWindow, allowed_lateness: int) -> int:
    """WindowOperator.cleanupTime: state retained until maxTimestamp +
    allowedLateness (saturating)."""
    ct = window.max_timestamp() + allowed_lateness
    # Java long overflow check: wrapped sum < maxTimestamp => Long.MAX_VALUE
    if ct > MAX_WATERMARK:
        ct -= 1 << 64
    return ct if ct >= window.max_timestamp() else MAX_WATERMARK


def is_window_late(window: TimeWindow, allowed_lateness: int, current_watermark: int) -> bool:
    """WindowOperator.isWindowLate: the drop-on-assignment condition."""
    return cleanup_time(window, allowed_lateness) <= current_watermark
