"""Internal timer service: per-key, per-namespace event/processing-time timers.

Counterpart of `flink_tpu/runtime/timers.py`, copied.

Reference: InternalTimerServiceImpl.java:45 — priority queues of
InternalTimer(key, namespace, time); event-time timers fire when the
watermark advances past them (advanceWatermark:314); timers are exact-once
per (key, namespace, time) (set semantics).
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, List, Set, Tuple

from flink_tpu_torch.core.time import MIN_WATERMARK

Timer = Tuple[int, Any, Any]  # (time, key, namespace)


class _TimerQueue:
    """Min-heap on time with insertion-order tiebreak (keys/namespaces need
    not be orderable); set-dedup per (time, key, namespace)."""

    def __init__(self):
        self._heap: List[Tuple[int, int, Timer]] = []
        self._set: Set[Timer] = set()
        self._seq = 0

    def add(self, timer: Timer) -> None:
        if timer not in self._set:
            self._set.add(timer)
            heapq.heappush(self._heap, (timer[0], self._seq, timer))
            self._seq += 1

    def remove(self, timer: Timer) -> None:
        self._set.discard(timer)  # lazily skipped on pop

    def peek_time(self):
        while self._heap and self._heap[0][2] not in self._set:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None

    def pop_until(self, time_inclusive: int) -> List[Timer]:
        out = []
        while True:
            t = self.peek_time()
            if t is None or t > time_inclusive:
                break
            _, _, timer = heapq.heappop(self._heap)
            self._set.discard(timer)
            out.append(timer)
        return out

    def all_timers(self) -> List[Timer]:
        return list(self._set)

    def restore(self, timers: List[Timer]) -> None:
        self._heap = []
        self._set = set()
        self._seq = 0
        for t in timers:
            self.add(t)


class InternalTimerService:
    """Timers keyed by (time, key, namespace); callbacks receive (time, key, ns)."""

    def __init__(
        self,
        on_event_time: Callable[[int, Any, Any], None],
        on_processing_time: Callable[[int, Any, Any], None],
    ):
        self._event = _TimerQueue()
        self._proc = _TimerQueue()
        self._on_event_time = on_event_time
        self._on_processing_time = on_processing_time
        self.current_watermark = MIN_WATERMARK

    # -- registration (key must be provided by caller: operator fixes it) --
    def register_event_time_timer(self, key, namespace, time: int) -> None:
        self._event.add((time, key, namespace))

    def delete_event_time_timer(self, key, namespace, time: int) -> None:
        self._event.remove((time, key, namespace))

    def register_processing_time_timer(self, key, namespace, time: int) -> None:
        self._proc.add((time, key, namespace))

    def delete_processing_time_timer(self, key, namespace, time: int) -> None:
        self._proc.remove((time, key, namespace))

    # -- advance ----------------------------------------------------------
    def advance_watermark(self, watermark: int) -> None:
        """Fires all event-time timers with time <= watermark, in time order
        (InternalTimerServiceImpl.advanceWatermark:314)."""
        self.current_watermark = watermark
        # timers registered while firing (e.g. by trigger re-registration)
        # must also fire if eligible — loop until drained
        while True:
            due = self._event.pop_until(watermark)
            if not due:
                break
            for time, key, ns in due:
                self._on_event_time(time, key, ns)

    def advance_processing_time(self, time: int) -> None:
        while True:
            due = self._proc.pop_until(time)
            if not due:
                break
            for t, key, ns in due:
                self._on_processing_time(t, key, ns)

    def next_event_time_timer(self):
        return self._event.peek_time()

    def next_processing_time_timer(self):
        return self._proc.peek_time()

    # -- snapshot ---------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "event": self._event.all_timers(),
            "proc": self._proc.all_timers(),
            "watermark": self.current_watermark,
        }

    def restore(self, snap: dict) -> None:
        self._event.restore(list(map(tuple, snap["event"])))
        self._proc.restore(list(map(tuple, snap["proc"])))
        self.current_watermark = snap["watermark"]
