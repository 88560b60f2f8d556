"""Triggers: decide when a window's contents are emitted.

Counterpart of `flink_tpu/api/windowing/triggers.py` (copied, with reprs),
plus the continuous and delta triggers of the reference, which the JAX
package does not have. Reference semantics (flink-runtime
.../api/windowing/triggers/):
- TriggerResult in {CONTINUE, FIRE, PURGE, FIRE_AND_PURGE};
- EventTimeTrigger / ProcessingTimeTrigger: FIRE at the window's max
  timestamp (EventTimeTrigger.java, ProcessingTimeTrigger.java);
- CountTrigger: FIRE when the per-(key, window) count reaches max_count,
  clearing the count (CountTrigger.java);
- PurgingTrigger wraps any trigger, turning FIRE into FIRE_AND_PURGE;
- NeverTrigger: GlobalWindows' default, never fires;
- ContinuousEventTimeTrigger / ContinuousProcessingTimeTrigger: FIRE every
  `interval` (aligned to multiples of it) and at the window's end
  (ContinuousEventTimeTrigger.java, ContinuousProcessingTimeTrigger.java);
- DeltaTrigger: FIRE when delta(last fired element, element) exceeds a
  threshold (DeltaTrigger.java).

The TriggerContext gives triggers per-(key, window) partitioned state and
timer registration, the contract of Trigger.TriggerContext. The device
global-window operator runs GlobalWindows with CountTrigger or
PurgingTrigger(CountTrigger); every other trigger runs on the per-record
oracle operator (runtime/oracle_window_operator.py).
"""

from __future__ import annotations

import enum
from typing import Any, Callable


class TriggerResult(enum.Flag):
    CONTINUE = 0
    FIRE = enum.auto()
    PURGE = enum.auto()
    FIRE_AND_PURGE = FIRE | PURGE

    # the flag bits read off the value: the per-record oracle asks both of
    # every trigger result, and Flag's `&` builds a new member each time
    @property
    def is_fire(self) -> bool:
        return bool(self._value_ & 1)

    @property
    def is_purge(self) -> bool:
        return bool(self._value_ & 2)


class TriggerContext:
    """Per-invocation context: current key/window fixed by the operator."""

    def get_current_watermark(self) -> int:
        raise NotImplementedError

    def register_event_time_timer(self, time: int) -> None:
        raise NotImplementedError

    def delete_event_time_timer(self, time: int) -> None:
        raise NotImplementedError

    def register_processing_time_timer(self, time: int) -> None:
        raise NotImplementedError

    def delete_processing_time_timer(self, time: int) -> None:
        raise NotImplementedError

    def get_trigger_state(self, name: str, default=None) -> Any:
        """Partitioned per-(key, window) trigger state (ValueState analogue)."""
        raise NotImplementedError

    def set_trigger_state(self, name: str, value) -> None:
        raise NotImplementedError

    def clear_trigger_state(self, name: str) -> None:
        raise NotImplementedError


class Trigger:
    def on_element(self, element, timestamp: int, window, ctx: TriggerContext) -> TriggerResult:
        raise NotImplementedError

    def on_event_time(self, time: int, window, ctx: TriggerContext) -> TriggerResult:
        raise NotImplementedError

    def on_processing_time(self, time: int, window, ctx: TriggerContext) -> TriggerResult:
        raise NotImplementedError

    def can_merge(self) -> bool:
        return False

    def on_merge(self, window, ctx: TriggerContext) -> None:
        raise NotImplementedError(f"{type(self).__name__} cannot merge")

    def clear(self, window, ctx: TriggerContext) -> None:
        pass


class EventTimeTrigger(Trigger):
    """EventTimeTrigger.java exact semantics."""

    def on_element(self, element, timestamp, window, ctx) -> TriggerResult:
        if window.max_timestamp() <= ctx.get_current_watermark():
            return TriggerResult.FIRE
        ctx.register_event_time_timer(window.max_timestamp())
        return TriggerResult.CONTINUE

    def on_event_time(self, time, window, ctx) -> TriggerResult:
        return TriggerResult.FIRE if time == window.max_timestamp() else TriggerResult.CONTINUE

    def on_processing_time(self, time, window, ctx) -> TriggerResult:
        return TriggerResult.CONTINUE

    def can_merge(self) -> bool:
        return True

    def on_merge(self, window, ctx) -> None:
        # only re-register if the merged window's timer is still in the future
        if window.max_timestamp() > ctx.get_current_watermark():
            ctx.register_event_time_timer(window.max_timestamp())

    def clear(self, window, ctx) -> None:
        ctx.delete_event_time_timer(window.max_timestamp())

    def __repr__(self):
        return "EventTimeTrigger()"


class ProcessingTimeTrigger(Trigger):
    def on_element(self, element, timestamp, window, ctx) -> TriggerResult:
        ctx.register_processing_time_timer(window.max_timestamp())
        return TriggerResult.CONTINUE

    def on_event_time(self, time, window, ctx) -> TriggerResult:
        return TriggerResult.CONTINUE

    def on_processing_time(self, time, window, ctx) -> TriggerResult:
        return TriggerResult.FIRE

    def can_merge(self) -> bool:
        return True

    def on_merge(self, window, ctx) -> None:
        ctx.register_processing_time_timer(window.max_timestamp())

    def clear(self, window, ctx) -> None:
        ctx.delete_processing_time_timer(window.max_timestamp())


class CountTrigger(Trigger):
    """Fires once the per-(key, window) element count reaches max_count
    (CountTrigger.java: ReducingState sum; fire clears the count)."""

    def __init__(self, max_count: int):
        self.max_count = max_count

    @staticmethod
    def of(max_count: int) -> "CountTrigger":
        return CountTrigger(max_count)

    def on_element(self, element, timestamp, window, ctx) -> TriggerResult:
        count = (ctx.get_trigger_state("count") or 0) + 1
        if count >= self.max_count:
            ctx.clear_trigger_state("count")
            return TriggerResult.FIRE
        ctx.set_trigger_state("count", count)
        return TriggerResult.CONTINUE

    def on_event_time(self, time, window, ctx) -> TriggerResult:
        return TriggerResult.CONTINUE

    def on_processing_time(self, time, window, ctx) -> TriggerResult:
        return TriggerResult.CONTINUE

    def can_merge(self) -> bool:
        return True

    def on_merge(self, window, ctx) -> None:
        pass  # counts were merged by state merge

    def clear(self, window, ctx) -> None:
        ctx.clear_trigger_state("count")

    def __repr__(self):
        return f"CountTrigger({self.max_count})"


class PurgingTrigger(Trigger):
    """Wraps a trigger, upgrading FIRE to FIRE_AND_PURGE (PurgingTrigger.java)."""

    def __init__(self, inner: Trigger):
        self.inner = inner

    @staticmethod
    def of(inner: Trigger) -> "PurgingTrigger":
        return PurgingTrigger(inner)

    def _wrap(self, result: TriggerResult) -> TriggerResult:
        return TriggerResult.FIRE_AND_PURGE if result.is_fire else result

    def on_element(self, element, timestamp, window, ctx) -> TriggerResult:
        return self._wrap(self.inner.on_element(element, timestamp, window, ctx))

    def on_event_time(self, time, window, ctx) -> TriggerResult:
        return self._wrap(self.inner.on_event_time(time, window, ctx))

    def on_processing_time(self, time, window, ctx) -> TriggerResult:
        return self._wrap(self.inner.on_processing_time(time, window, ctx))

    def can_merge(self) -> bool:
        return self.inner.can_merge()

    def on_merge(self, window, ctx) -> None:
        self.inner.on_merge(window, ctx)

    def clear(self, window, ctx) -> None:
        self.inner.clear(window, ctx)

    def __repr__(self):
        return f"PurgingTrigger({self.inner!r})"


class NeverTrigger(Trigger):
    """GlobalWindows' default: never fires (GlobalWindows.java NeverTrigger)."""

    def on_element(self, element, timestamp, window, ctx) -> TriggerResult:
        return TriggerResult.CONTINUE

    def on_event_time(self, time, window, ctx) -> TriggerResult:
        return TriggerResult.CONTINUE

    def on_processing_time(self, time, window, ctx) -> TriggerResult:
        return TriggerResult.CONTINUE

    def can_merge(self) -> bool:
        return True

    def on_merge(self, window, ctx) -> None:
        pass


def _java_rem(a: int, b: int) -> int:
    """Java's `%` on longs: the remainder takes the dividend's sign."""
    r = abs(a) % abs(b)
    return -r if a < 0 else r


class ContinuousEventTimeTrigger(Trigger):
    """Fires every `interval` ms of event time, at multiples of it, and at
    the window's end (ContinuousEventTimeTrigger.java). The next fire time
    is trigger state, merged by min when session windows merge."""

    STATE = "fire-time"

    def __init__(self, interval: int):
        self.interval = int(interval)

    @staticmethod
    def of(interval: int) -> "ContinuousEventTimeTrigger":
        return ContinuousEventTimeTrigger(interval)

    def on_element(self, element, timestamp, window, ctx) -> TriggerResult:
        if window.max_timestamp() <= ctx.get_current_watermark():
            # the watermark is already past the window: fire at once
            return TriggerResult.FIRE
        ctx.register_event_time_timer(window.max_timestamp())
        if ctx.get_trigger_state(self.STATE) is None:
            self._register_next(timestamp - _java_rem(timestamp, self.interval), window, ctx)
        return TriggerResult.CONTINUE

    def on_event_time(self, time, window, ctx) -> TriggerResult:
        if time == window.max_timestamp():
            return TriggerResult.FIRE
        if ctx.get_trigger_state(self.STATE) == time:
            ctx.clear_trigger_state(self.STATE)
            self._register_next(time, window, ctx)
            return TriggerResult.FIRE
        return TriggerResult.CONTINUE

    def on_processing_time(self, time, window, ctx) -> TriggerResult:
        return TriggerResult.CONTINUE

    def can_merge(self) -> bool:
        return True

    def on_merge(self, window, ctx) -> None:
        ctx.merge_trigger_state(window, ctx.merged_windows, (self.STATE,), min)
        nxt = ctx.get_trigger_state(self.STATE)
        if nxt is not None:
            ctx.register_event_time_timer(nxt)

    def clear(self, window, ctx) -> None:
        nxt = ctx.get_trigger_state(self.STATE)
        if nxt is not None:
            ctx.delete_event_time_timer(nxt)
            ctx.clear_trigger_state(self.STATE)

    def _register_next(self, time: int, window, ctx) -> None:
        nxt = min(time + self.interval, window.max_timestamp())
        prev = ctx.get_trigger_state(self.STATE)
        ctx.set_trigger_state(self.STATE, nxt if prev is None else min(prev, nxt))
        ctx.register_event_time_timer(nxt)

    def __repr__(self):
        return f"ContinuousEventTimeTrigger({self.interval})"


class ContinuousProcessingTimeTrigger(Trigger):
    """Fires every `interval` ms of processing time, at multiples of it,
    and at the window's end (ContinuousProcessingTimeTrigger.java)."""

    STATE = "fire-time"

    def __init__(self, interval: int):
        self.interval = int(interval)

    @staticmethod
    def of(interval: int) -> "ContinuousProcessingTimeTrigger":
        return ContinuousProcessingTimeTrigger(interval)

    def on_element(self, element, timestamp, window, ctx) -> TriggerResult:
        now = ctx.get_current_processing_time()
        if ctx.get_trigger_state(self.STATE) is None:
            self._register_next(now - _java_rem(now, self.interval), window, ctx)
        return TriggerResult.CONTINUE

    def on_event_time(self, time, window, ctx) -> TriggerResult:
        return TriggerResult.CONTINUE

    def on_processing_time(self, time, window, ctx) -> TriggerResult:
        if time == window.max_timestamp():
            return TriggerResult.FIRE
        if ctx.get_trigger_state(self.STATE) == time:
            ctx.clear_trigger_state(self.STATE)
            self._register_next(time, window, ctx)
            return TriggerResult.FIRE
        return TriggerResult.CONTINUE

    def can_merge(self) -> bool:
        return True

    def on_merge(self, window, ctx) -> None:
        ctx.merge_trigger_state(window, ctx.merged_windows, (self.STATE,), min)
        nxt = ctx.get_trigger_state(self.STATE)
        if nxt is not None:
            ctx.register_processing_time_timer(nxt)

    def clear(self, window, ctx) -> None:
        nxt = ctx.get_trigger_state(self.STATE)
        if nxt is not None:
            ctx.delete_processing_time_timer(nxt)
            ctx.clear_trigger_state(self.STATE)

    def _register_next(self, time: int, window, ctx) -> None:
        nxt = min(time + self.interval, window.max_timestamp())
        prev = ctx.get_trigger_state(self.STATE)
        ctx.set_trigger_state(self.STATE, nxt if prev is None else min(prev, nxt))
        ctx.register_processing_time_timer(nxt)

    def __repr__(self):
        return f"ContinuousProcessingTimeTrigger({self.interval})"


class DeltaTrigger(Trigger):
    """Fires when `delta_fn(last fired element, element)` exceeds
    `threshold`; the first element of a window only becomes the reference
    (DeltaTrigger.java)."""

    STATE = "last-element"

    def __init__(self, threshold: float, delta_fn: Callable[[Any, Any], float]):
        self.threshold = threshold
        self.delta_fn = delta_fn

    @staticmethod
    def of(threshold: float, delta_fn: Callable[[Any, Any], float]) -> "DeltaTrigger":
        return DeltaTrigger(threshold, delta_fn)

    def on_element(self, element, timestamp, window, ctx) -> TriggerResult:
        last = ctx.get_trigger_state(self.STATE)
        if last is None:
            ctx.set_trigger_state(self.STATE, element)
            return TriggerResult.CONTINUE
        if self.delta_fn(last, element) > self.threshold:
            ctx.set_trigger_state(self.STATE, element)
            return TriggerResult.FIRE
        return TriggerResult.CONTINUE

    def on_event_time(self, time, window, ctx) -> TriggerResult:
        return TriggerResult.CONTINUE

    def on_processing_time(self, time, window, ctx) -> TriggerResult:
        return TriggerResult.CONTINUE

    def clear(self, window, ctx) -> None:
        ctx.clear_trigger_state(self.STATE)

    def __repr__(self):
        return f"DeltaTrigger({self.threshold!r})"
