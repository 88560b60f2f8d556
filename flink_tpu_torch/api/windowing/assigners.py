"""Window assigners: the grid assigners with their slice decomposition,
session windows and the global window.

Counterpart of `TumblingEventTimeWindows`, `SlidingEventTimeWindows`,
`EventTimeSessionWindows`, `ProcessingTimeSessionWindows`, `GlobalWindow`
(:44) and `GlobalWindows` (:252) in `flink_tpu/api/windowing/assigners.py`. A grid assigner exposes the slice
decomposition the fused planner reads: slice = gcd-granule of (size,
slide), a window is a contiguous run of `slices_per_window` slices, and
consecutive windows start `slide_slices` slices apart. Session windows
merge and have no slice decomposition. GlobalWindows puts every element
into one window that fires only by a count trigger (the device
global-window operator).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from flink_tpu_torch.api.windowing.triggers import EventTimeTrigger
from flink_tpu_torch.core.time import MAX_WATERMARK, TimeWindow, assign_sliding, assign_tumbling
from flink_tpu_torch.utils import deferred


@dataclasses.dataclass(frozen=True)
class GlobalWindow:
    """The singleton namespace of GlobalWindows (GlobalWindow.java)."""

    def max_timestamp(self) -> int:
        return MAX_WATERMARK

    def __repr__(self) -> str:
        return "GlobalWindow"


class WindowAssigner:
    """Base contract: assign windows per element, provide the default
    trigger, declare event-time-ness, and (for grid assigners) the slice
    decomposition (None = not sliceable)."""

    is_event_time: bool = True
    is_merging: bool = False

    def assign_windows(self, element, timestamp: int) -> List:
        raise NotImplementedError

    def get_default_trigger(self):
        raise NotImplementedError

    @property
    def slice_ms(self) -> Optional[int]:
        return None

    @property
    def slices_per_window(self) -> Optional[int]:
        return None

    @property
    def slide_slices(self) -> Optional[int]:
        """Slices between consecutive window starts."""
        return None

    @property
    def offset_ms(self) -> int:
        return 0


class TumblingEventTimeWindows(WindowAssigner):
    def __init__(self, size_ms: int, offset_ms: int = 0):
        if abs(offset_ms) >= size_ms or size_ms <= 0:
            raise ValueError(
                f"TumblingEventTimeWindows requires size > 0 and |offset| < size, got size={size_ms} offset={offset_ms}"
            )
        self.size = size_ms
        self.offset = offset_ms

    @staticmethod
    def of(size_ms: int, offset_ms: int = 0) -> "TumblingEventTimeWindows":
        return TumblingEventTimeWindows(size_ms, offset_ms)

    def assign_windows(self, element, timestamp: int) -> List[TimeWindow]:
        return assign_tumbling(timestamp, self.size, self.offset)

    def get_default_trigger(self) -> EventTimeTrigger:
        return EventTimeTrigger()

    @property
    def slice_ms(self) -> int:
        return self.size

    @property
    def slices_per_window(self) -> int:
        return 1

    @property
    def slide_slices(self) -> int:
        return 1

    @property
    def offset_ms(self) -> int:
        return self.offset

    def __repr__(self) -> str:
        return f"TumblingEventTimeWindows(size={self.size}, offset={self.offset})"


class SlidingEventTimeWindows(WindowAssigner):
    def __init__(self, size_ms: int, slide_ms: int, offset_ms: int = 0):
        if abs(offset_ms) >= slide_ms or size_ms <= 0:
            raise ValueError(
                f"SlidingEventTimeWindows requires size > 0 and |offset| < slide, got size={size_ms} slide={slide_ms} offset={offset_ms}"
            )
        self.size = size_ms
        self.slide = slide_ms
        self.offset = offset_ms

    @staticmethod
    def of(size_ms: int, slide_ms: int, offset_ms: int = 0) -> "SlidingEventTimeWindows":
        return SlidingEventTimeWindows(size_ms, slide_ms, offset_ms)

    def assign_windows(self, element, timestamp: int) -> List[TimeWindow]:
        return assign_sliding(timestamp, self.size, self.slide, self.offset)

    def get_default_trigger(self) -> EventTimeTrigger:
        return EventTimeTrigger()

    # slice granule = gcd(size, slide): a window of `size` covers size/g
    # consecutive slices, and windows start every slide/g slices
    @property
    def slice_ms(self) -> int:
        return math.gcd(self.size, self.slide)

    @property
    def slices_per_window(self) -> int:
        return self.size // self.slice_ms

    @property
    def slide_slices(self) -> int:
        return self.slide // self.slice_ms

    @property
    def offset_ms(self) -> int:
        return self.offset

    def __repr__(self) -> str:
        return f"SlidingEventTimeWindows(size={self.size}, slide={self.slide}, offset={self.offset})"


class EventTimeSessionWindows(WindowAssigner):
    """Each element gets [ts, ts + gap); overlapping windows merge
    (EventTimeSessionWindows.java + MergingWindowSet). Not sliceable
    (`slice_ms` is None): the session operator runs it, never the fused
    grid path."""

    is_merging = True

    def __init__(self, gap_ms: int):
        if gap_ms <= 0:
            raise ValueError("Session gap must be positive")
        self.gap = gap_ms

    @staticmethod
    def with_gap(gap_ms: int) -> "EventTimeSessionWindows":
        return EventTimeSessionWindows(gap_ms)

    def assign_windows(self, element, timestamp: int) -> List[TimeWindow]:
        return [TimeWindow(timestamp, timestamp + self.gap)]

    def get_default_trigger(self) -> EventTimeTrigger:
        return EventTimeTrigger()

    def merge_windows(self, windows: List[TimeWindow]):
        """Returns list of (merged_window, [source_windows]) for overlapping
        runs (MergingWindowAssigner.mergeWindows semantics)."""
        if not windows:
            return []
        sorted_ws = sorted(windows, key=lambda w: (w.start, w.end))
        merged = []
        cur_cover = sorted_ws[0]
        cur_members = [sorted_ws[0]]
        for w in sorted_ws[1:]:
            # session merge: touching windows ([a,b) and [b,c)) DO merge
            if w.start <= cur_cover.end:
                cur_cover = cur_cover.cover(w)
                cur_members.append(w)
            else:
                merged.append((cur_cover, cur_members))
                cur_cover, cur_members = w, [w]
        merged.append((cur_cover, cur_members))
        return merged

    def __repr__(self) -> str:
        return f"EventTimeSessionWindows(gap={self.gap})"


class ProcessingTimeSessionWindows(EventTimeSessionWindows):
    """Processing-time sessions: the JAX package runs them on its per-record
    oracle operator, which the port does not carry (ROADMAP item 18)."""

    is_event_time = False

    def get_default_trigger(self):
        raise deferred.not_ported("ProcessingTimeSessionWindows' ProcessingTimeTrigger",
                                  deferred.ORACLE)


class GlobalWindows(WindowAssigner):
    """All elements into one global window; it fires only by a custom
    trigger (GlobalWindows.java). With CountTrigger or
    PurgingTrigger(CountTrigger) the device global-window operator runs it;
    its default NeverTrigger and any other trigger need the per-record
    oracle operator, which the port does not carry (ROADMAP item 18)."""

    _WINDOW = GlobalWindow()

    def assign_windows(self, element, timestamp: int) -> List[GlobalWindow]:
        return [self._WINDOW]

    @staticmethod
    def create() -> "GlobalWindows":
        return GlobalWindows()

    def get_default_trigger(self):
        raise deferred.not_ported("GlobalWindows' NeverTrigger", deferred.ORACLE)

    def __repr__(self) -> str:
        return "GlobalWindows()"
