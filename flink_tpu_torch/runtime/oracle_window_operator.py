"""Oracle WindowOperator: per-record Python implementation at exact reference
parity.

Counterpart of `flink_tpu/runtime/oracle_window_operator.py`, copied. It is
host code: the device takes no part in a job it runs. The executor selects
it under the JAX runner's conditions (Python aggregates and window
functions, triggers other than a grid window's own, evictors,
processing-time windows, GlobalWindows without a count trigger, the
session steps the device session operator refuses), and SQL's
multi-aggregate SELECTs run on it through a composite accumulator.

This is the executable specification of
flink-runtime .../streaming/runtime/operators/windowing/WindowOperator.java
(processElement :293-447, onEventTime :450, onProcessingTime :497,
emitWindowContents :575, isWindowLate :609, cleanup timers :631/:670) plus
the MergingWindowSet session-merge path (:303-403). It serves three roles:

1. **Parity oracle** for the batched device operator (property tests assert
   result equality — the "result parity" requirement of BASELINE.json).
2. **CPU baseline operator** (the single-node per-record path the device
   operators are measured against).
3. **Fallback operator** for features outside the device path's columnar
   aggregator model (arbitrary Python AggregateFunctions, evictors).

Not a translation of the Java class structure: it is a direct implementation
of the documented per-record semantics against our heap state backend and
timer service.
"""

from __future__ import annotations

import operator
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from flink_tpu_torch.api.functions import (
    AggregateFunction,
    LATE_DATA_TAG,
    ProcessWindowFunction,
    ReduceAggregate,
)
from flink_tpu_torch.api.windowing.assigners import GlobalWindow, GlobalWindows, WindowAssigner
from flink_tpu_torch.api.windowing.evictors import Evictor
from flink_tpu_torch.api.windowing.triggers import Trigger, TriggerContext, TriggerResult
from flink_tpu_torch.core.keygroups import KeyGroupRange
from flink_tpu_torch.core.time import MAX_WATERMARK, MIN_WATERMARK, TimeWindow, cleanup_time, is_window_late
from flink_tpu_torch.runtime.timers import InternalTimerService
from flink_tpu_torch.state.heap import (
    HeapKeyedStateBackend,
    aggregating_state,
    list_state,
    map_state,
    value_state,
)

WINDOW_STATE = "window-contents"
MERGE_SET_STATE = "merging-window-set"
TRIGGER_STATE_PREFIX = "trigger."


class _OperatorTriggerContext(TriggerContext):
    """Binds (key, window) for trigger callbacks; trigger state is partitioned
    per (key, window-namespace) like Trigger.TriggerContext's partitioned
    state."""

    def __init__(self, op: "OracleWindowOperator"):
        self._op = op
        self.key = None
        self.window = None
        # the windows being merged into `window`, during a trigger's on_merge
        self.merged_windows: List = []

    def get_current_watermark(self) -> int:
        return self._op.timer_service.current_watermark

    def get_current_processing_time(self) -> int:
        # before the operator has been told a processing time, the wall
        # clock (as Flink's processing-time service reads it)
        t = self._op.processing_time
        return int(time.time() * 1000) if t == MIN_WATERMARK else t

    def register_event_time_timer(self, time: int) -> None:
        self._op.timer_service.register_event_time_timer(self.key, self.window, time)

    def delete_event_time_timer(self, time: int) -> None:
        self._op.timer_service.delete_event_time_timer(self.key, self.window, time)

    def register_processing_time_timer(self, time: int) -> None:
        self._op.timer_service.register_processing_time_timer(self.key, self.window, time)

    def delete_processing_time_timer(self, time: int) -> None:
        self._op.timer_service.delete_processing_time_timer(self.key, self.window, time)

    def get_trigger_state(self, name: str, default=None):
        v = self._op.state.get(TRIGGER_STATE_PREFIX + name, namespace=self.window)
        return default if v is None else v

    def set_trigger_state(self, name: str, value) -> None:
        self._op.state.put(TRIGGER_STATE_PREFIX + name, value, namespace=self.window)

    def clear_trigger_state(self, name: str) -> None:
        self._op.state.clear(TRIGGER_STATE_PREFIX + name, namespace=self.window)

    def merge_trigger_state(self, target, sources: List, names=("count",),
                            combine: Callable = operator.add) -> None:
        # numeric trigger state merges by `combine`: counts additively (the
        # JAX package's only merged state), a continuous trigger's next
        # fire time by min
        for name in names:
            total, found = None, False
            for ns in list(sources) + [target]:
                v = self._op.state.get(TRIGGER_STATE_PREFIX + name, namespace=ns)
                if v is not None:
                    total = v if total is None else combine(total, v)
                    found = True
                self._op.state.clear(TRIGGER_STATE_PREFIX + name, namespace=ns)
            if found:
                self._op.state.put(TRIGGER_STATE_PREFIX + name, total, namespace=target)


def _own_windows(obj):
    """`obj` (a snapshot's state tables or timers) with every window of
    the other package as this package's: windows are state namespaces and
    timer namespaces, so they must hash and compare as this package's."""
    kind = type(obj)
    if kind in (TimeWindow, GlobalWindow):
        return obj
    if kind.__name__ == "TimeWindow":
        return TimeWindow(int(obj.start), int(obj.end))
    if kind.__name__ == "GlobalWindow":
        return GlobalWindows._WINDOW
    if kind is dict:
        return {_own_windows(k): _own_windows(v) for k, v in obj.items()}
    if kind is tuple:
        return tuple(_own_windows(x) for x in obj)
    if kind is list:
        return [_own_windows(x) for x in obj]
    return obj


def _trigger_state_names(trigger) -> Tuple[str, ...]:
    """Trigger-state names a trigger (or the trigger it wraps) declares as
    `STATE`, beyond the count every operator registers."""
    names = []
    while trigger is not None:
        name = getattr(trigger, "STATE", None)
        if name is not None:
            names.append(name)
        trigger = getattr(trigger, "inner", None)
    return tuple(names)


class MergingWindowSet:
    """window -> state-window mapping with merge-on-add
    (MergingWindowSet.java semantics). Persisted in keyed state per key."""

    def __init__(self, op: "OracleWindowOperator", key):
        self._op = op
        self._key = key
        stored = op.state.get(MERGE_SET_STATE)
        self.mapping: Dict[TimeWindow, TimeWindow] = dict(stored) if stored else {}

    def persist(self) -> None:
        if self.mapping:
            self._op.state.put(MERGE_SET_STATE, dict(self.mapping))
        else:
            self._op.state.clear(MERGE_SET_STATE)

    def get_state_window(self, window: TimeWindow) -> Optional[TimeWindow]:
        return self.mapping.get(window)

    def retire_window(self, window: TimeWindow) -> None:
        self.mapping.pop(window, None)

    def add_window(self, new_window: TimeWindow, merge_fn: Callable) -> TimeWindow:
        """merge_fn(merge_result, merged_windows, state_window_result,
        merged_state_windows) — called only when an actual merge happens."""
        windows = list(self.mapping.keys()) + [new_window]
        merge_results = self._op.assigner.merge_windows(windows)

        result_window = new_window
        merged_new = False
        for cover, members in merge_results:
            if new_window in members:
                result_window = cover
                merged_new = len(members) > 1
            if len(members) <= 1:
                continue
            # pre-existing windows being merged (exclude the brand-new one,
            # which has no state window yet)
            merged_existing = [w for w in members if w != new_window or w in self.mapping]
            if not merged_existing:
                continue
            # keep the state window of one merged member; others get merged in
            kept_state_window = self.mapping.get(merged_existing[0], merged_existing[0])
            merged_state_windows = [
                self.mapping[w]
                for w in merged_existing[1:]
                if w in self.mapping and self.mapping[w] != kept_state_window
            ]
            for w in members:
                self.mapping.pop(w, None)
            self.mapping[cover] = kept_state_window
            # mergedWindows passed to callback excludes the result itself
            callback_merged = [w for w in members if w != cover]
            if callback_merged and (len(merged_existing) > 1 or merged_new):
                merge_fn(cover, callback_merged, kept_state_window, merged_state_windows)
        if not merged_new and new_window not in self.mapping:
            self.mapping[new_window] = new_window
        return result_window


class OracleWindowOperator:
    """One logical operator instance covering a key-group range."""

    def __init__(
        self,
        assigner: WindowAssigner,
        aggregate: AggregateFunction,
        *,
        trigger: Optional[Trigger] = None,
        allowed_lateness: int = 0,
        max_parallelism: int = 128,
        key_group_range: Optional[KeyGroupRange] = None,
        window_function: Optional[ProcessWindowFunction] = None,
        evictor: Optional[Evictor] = None,
        emit_late_to_side_output: bool = False,
    ):
        self.assigner = assigner
        self.aggregate = (
            ReduceAggregate(aggregate) if not isinstance(aggregate, AggregateFunction) and aggregate is not None
            else aggregate
        )
        self.trigger = trigger or assigner.get_default_trigger()
        self.allowed_lateness = allowed_lateness
        self.window_function = window_function
        self.evictor = evictor
        self.emit_late_to_side_output = emit_late_to_side_output
        self.max_parallelism = max_parallelism
        kg_range = key_group_range or KeyGroupRange(0, max_parallelism - 1)

        self.state = HeapKeyedStateBackend(kg_range, max_parallelism)
        if evictor is not None or self.aggregate is None:
            self.state.register(list_state(WINDOW_STATE))
            self._buffering = True
        else:
            self.state.register(aggregating_state(WINDOW_STATE, self.aggregate))
            self._buffering = False
        self.state.register(map_state(MERGE_SET_STATE))
        self.state.register(value_state(TRIGGER_STATE_PREFIX + "count"))
        # the trigger state of the triggers the JAX package does not have
        # (continuous, delta)
        for name in _trigger_state_names(self.trigger):
            self.state.register(value_state(TRIGGER_STATE_PREFIX + name))
        # processing time as far as it has advanced (advance_processing_time,
        # and the processing-time stamps of records of a processing-time
        # assigner): what a trigger reads as the current processing time
        self.processing_time = MIN_WATERMARK

        self.timer_service = InternalTimerService(self._on_event_time, self._on_processing_time)
        self._trigger_ctx = _OperatorTriggerContext(self)

        # outputs: (key, window, result, timestamp) / side outputs / metrics
        self.output: List[Tuple[Any, Any, Any, int]] = []
        self.side_output: Dict[str, List] = {}
        self.num_late_records_dropped = 0

    # ------------------------------------------------------------------
    # processElement (WindowOperator.java:293-447)
    # ------------------------------------------------------------------
    def process_record(self, key, value, timestamp: int) -> None:
        if not self.assigner.is_event_time and timestamp > self.processing_time:
            self.processing_time = timestamp
        self.state.set_current_key(key)
        windows = self.assigner.assign_windows(value, timestamp)
        skipped = True

        if self.assigner.is_merging:
            skipped = self._process_merging(key, value, timestamp, windows)
        else:
            for window in windows:
                if self._is_window_late(window):
                    continue
                skipped = False
                self._add_to_window(value, timestamp, window)
                self._trigger_ctx.key, self._trigger_ctx.window = key, window
                result = self.trigger.on_element(value, timestamp, window, self._trigger_ctx)
                if result.is_fire:
                    self._fire(key, window, window)
                if result.is_purge:
                    self.state.clear(WINDOW_STATE, namespace=window)
                self._register_cleanup_timer(key, window)

        if skipped and self._is_element_late(timestamp):
            if self.emit_late_to_side_output:
                self.side_output.setdefault(LATE_DATA_TAG.tag_id, []).append((key, value, timestamp))
            else:
                self.num_late_records_dropped += 1

    def _process_merging(self, key, value, timestamp, windows) -> bool:
        skipped = True
        merging = MergingWindowSet(self, key)

        def on_merge(merge_result, merged_windows, state_window_result, merged_state_windows):
            self._trigger_ctx.key, self._trigger_ctx.window = key, merge_result
            self._trigger_ctx.merged_windows = merged_windows
            if self.trigger.can_merge():
                self.trigger.on_merge(merge_result, self._trigger_ctx)
            self._trigger_ctx.merged_windows = []
            self._trigger_ctx.merge_trigger_state(merge_result, merged_windows)
            for m in merged_windows:
                self._trigger_ctx.window = m
                self.trigger.clear(m, self._trigger_ctx)
                self._delete_cleanup_timer(key, m)
            self._trigger_ctx.window = merge_result
            if merged_state_windows:
                self.state.merge_namespaces(WINDOW_STATE, state_window_result, merged_state_windows)

        for window in windows:
            actual = merging.add_window(window, on_merge)
            if self._is_window_late(actual):
                merging.retire_window(actual)
                continue
            skipped = False
            state_window = merging.get_state_window(actual)
            self._add_to_window(value, timestamp, state_window)
            self._trigger_ctx.key, self._trigger_ctx.window = key, actual
            result = self.trigger.on_element(value, timestamp, actual, self._trigger_ctx)
            if result.is_fire:
                self._fire(key, actual, state_window)
            if result.is_purge:
                self.state.clear(WINDOW_STATE, namespace=state_window)
            self._register_cleanup_timer(key, actual)
        merging.persist()
        return skipped

    def _add_to_window(self, value, timestamp, namespace) -> None:
        if self._buffering:
            self.state.add(WINDOW_STATE, (timestamp, value), namespace=namespace)
        else:
            self.state.add(WINDOW_STATE, value, namespace=namespace)

    # ------------------------------------------------------------------
    # timers (onEventTime :450 / onProcessingTime :497)
    # ------------------------------------------------------------------
    def _on_event_time(self, time: int, key, window) -> None:
        self.state.set_current_key(key)
        self._trigger_ctx.key, self._trigger_ctx.window = key, window

        merging = MergingWindowSet(self, key) if self.assigner.is_merging else None
        if merging is not None:
            state_window = merging.get_state_window(window)
            if state_window is None:
                return  # window was merged away; timer is stale
        else:
            state_window = window

        result = self.trigger.on_event_time(time, window, self._trigger_ctx)
        if result.is_fire:
            self._fire(key, window, state_window)
        if result.is_purge:
            self.state.clear(WINDOW_STATE, namespace=state_window)

        if self.assigner.is_event_time and self._is_cleanup_time(window, time):
            self._clear_all_state(key, window, state_window, merging)
        if merging is not None:
            merging.persist()

    def _on_processing_time(self, time: int, key, window) -> None:
        self.state.set_current_key(key)
        self._trigger_ctx.key, self._trigger_ctx.window = key, window
        merging = MergingWindowSet(self, key) if self.assigner.is_merging else None
        if merging is not None:
            state_window = merging.get_state_window(window)
            if state_window is None:
                return
        else:
            state_window = window
        result = self.trigger.on_processing_time(time, window, self._trigger_ctx)
        if result.is_fire:
            self._fire(key, window, state_window)
        if result.is_purge:
            self.state.clear(WINDOW_STATE, namespace=state_window)
        if not self.assigner.is_event_time and self._is_cleanup_time(window, time):
            self._clear_all_state(key, window, state_window, merging)
        if merging is not None:
            merging.persist()

    def process_watermark(self, watermark: int) -> None:
        self.timer_service.advance_watermark(watermark)

    def advance_processing_time(self, time: int) -> None:
        if time > self.processing_time:
            self.processing_time = time
        self.timer_service.advance_processing_time(time)

    # ------------------------------------------------------------------
    # firing & cleanup (emitWindowContents :575, clearAllState)
    # ------------------------------------------------------------------
    def _fire(self, key, window, state_window) -> None:
        contents = self.state.get(WINDOW_STATE, namespace=state_window)
        if contents is None:
            return
        ts = window.max_timestamp() if hasattr(window, "max_timestamp") else MAX_WATERMARK
        if self._buffering:
            elements = contents
            if self.evictor is not None:
                elements = self.evictor.evict_before(elements, len(elements), window)
            values = [v for _, v in elements]
            if self.window_function is not None:
                ctx = ProcessWindowFunction.Context(window, self.timer_service.current_watermark)
                for out in self.window_function.process(key, ctx, values):
                    self.output.append((key, window, out, ts))
            else:
                for out in values:
                    self.output.append((key, window, out, ts))
            if self.evictor is not None:
                remaining = self.evictor.evict_after(elements, len(elements), window)
                self.state.put(WINDOW_STATE, list(remaining), namespace=state_window)
        else:
            result = self.aggregate.get_result(contents)
            if self.window_function is not None:
                ctx = ProcessWindowFunction.Context(window, self.timer_service.current_watermark)
                for out in self.window_function.process(key, ctx, [result]):
                    self.output.append((key, window, out, ts))
            else:
                self.output.append((key, window, result, ts))

    def _clear_all_state(self, key, window, state_window, merging) -> None:
        self.state.clear(WINDOW_STATE, namespace=state_window)
        self._trigger_ctx.key, self._trigger_ctx.window = key, window
        self.trigger.clear(window, self._trigger_ctx)
        self._trigger_ctx.clear_trigger_state("count")
        if merging is not None:
            merging.retire_window(window)

    # ------------------------------------------------------------------
    # lateness helpers (:609-:670)
    # ------------------------------------------------------------------
    def _is_window_late(self, window) -> bool:
        if not self.assigner.is_event_time or not isinstance(window, TimeWindow):
            return False
        return is_window_late(window, self.allowed_lateness, self.timer_service.current_watermark)

    def _is_element_late(self, timestamp: int) -> bool:
        return (
            self.assigner.is_event_time
            and timestamp + self.allowed_lateness <= self.timer_service.current_watermark
        )

    def _cleanup_time(self, window) -> int:
        if not isinstance(window, TimeWindow):
            return MAX_WATERMARK
        if self.assigner.is_event_time:
            return cleanup_time(window, self.allowed_lateness)
        return window.max_timestamp()

    def _is_cleanup_time(self, window, time: int) -> bool:
        return time == self._cleanup_time(window)

    def _register_cleanup_timer(self, key, window) -> None:
        ct = self._cleanup_time(window)
        if ct == MAX_WATERMARK:
            return  # no cleanup for global windows / saturated lateness
        if self.assigner.is_event_time:
            self.timer_service.register_event_time_timer(key, window, ct)
        else:
            self.timer_service.register_processing_time_timer(key, window, ct)

    def _delete_cleanup_timer(self, key, window) -> None:
        ct = self._cleanup_time(window)
        if ct == MAX_WATERMARK:
            return
        if self.assigner.is_event_time:
            self.timer_service.delete_event_time_timer(key, window, ct)
        else:
            self.timer_service.delete_processing_time_timer(key, window, ct)

    # ------------------------------------------------------------------
    # snapshot / restore (operator-level; used by checkpointing)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "state": self.state.snapshot(),
            "timers": self.timer_service.snapshot(),
        }

    def restore(self, snap: dict) -> None:
        """Restore a snapshot of either package's oracle operator (its
        windows become this package's)."""
        self.state.restore(_own_windows(snap["state"]))
        self.timer_service.restore(_own_windows(snap["timers"]))

    def drain_output(self) -> List[Tuple[Any, Any, Any, int]]:
        out = self.output
        self.output = []
        return out
