"""Triggers: the one the grid assigners default to (EventTimeTrigger), and
the count triggers of the device global-window operator.

Counterpart of `EventTimeTrigger`, `CountTrigger` (:139), `PurgingTrigger`
(:174) and the trigger-state part of `TriggerContext` (:39) in
`flink_tpu/api/windowing/triggers.py`:
- EventTimeTrigger: FIRE once the watermark passes the window's max
  timestamp (EventTimeTrigger.java);
- CountTrigger: FIRE when the per-(key, window) count reaches max_count,
  clearing the count (CountTrigger.java);
- PurgingTrigger: wraps a trigger, turning FIRE into FIRE_AND_PURGE.

GlobalWindows with CountTrigger or PurgingTrigger(CountTrigger) run on the
device global-window operator. Any other trigger needs the per-record
oracle operator, which the port does not carry (ROADMAP item 18): a window
step with one raises.
"""

from __future__ import annotations

import enum
from typing import Any


class TriggerResult(enum.Flag):
    CONTINUE = 0
    FIRE = enum.auto()
    PURGE = enum.auto()
    FIRE_AND_PURGE = FIRE | PURGE

    @property
    def is_fire(self) -> bool:
        return bool(self & TriggerResult.FIRE)

    @property
    def is_purge(self) -> bool:
        return bool(self & TriggerResult.PURGE)


class EventTimeTrigger:
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

    def clear(self, window, ctx) -> None:
        ctx.delete_event_time_timer(window.max_timestamp())

    def __repr__(self):
        return "EventTimeTrigger()"


class TriggerContext:
    """The per-(key, window) trigger state a count trigger reads and writes
    (the state part of Trigger.TriggerContext)."""

    def get_trigger_state(self, name: str, default=None) -> Any:
        raise NotImplementedError

    def set_trigger_state(self, name: str, value) -> None:
        raise NotImplementedError

    def clear_trigger_state(self, name: str) -> None:
        raise NotImplementedError


class CountTrigger:
    """Fires once the per-(key, window) element count reaches max_count
    (CountTrigger.java: ReducingState sum; fire clears the count)."""

    def __init__(self, max_count: int):
        self.max_count = max_count

    @staticmethod
    def of(max_count: int) -> "CountTrigger":
        return CountTrigger(max_count)

    def on_element(self, element, timestamp, window, ctx: TriggerContext) -> TriggerResult:
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

    def clear(self, window, ctx: TriggerContext) -> None:
        ctx.clear_trigger_state("count")

    def __repr__(self):
        return f"CountTrigger({self.max_count})"


class PurgingTrigger:
    """Wraps a trigger, upgrading FIRE to FIRE_AND_PURGE (PurgingTrigger.java)."""

    def __init__(self, inner):
        self.inner = inner

    @staticmethod
    def of(inner) -> "PurgingTrigger":
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
