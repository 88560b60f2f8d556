"""Watermark generation and combination.

Counterpart of `flink_tpu/core/watermarks.py`: a watermark is a per-source
scalar the job runtime advances on the host between steps, so the device
programs see one watermark per step. `WatermarkValve` combines channel
watermarks (min over the channels that are not idle), and `IdlenessTimer`
marks a channel idle after a timeout on an injected clock.
"""

from __future__ import annotations

import functools

import dataclasses
import time as _time
from typing import Callable, List, Optional

import numpy as np

from flink_tpu_torch.core.time import MIN_WATERMARK


class WatermarkGenerator:
    """on_event/on_periodic_emit contract (WatermarkGenerator.java)."""

    def on_event(self, event, event_timestamp: int) -> Optional[int]:
        """Returns a new watermark to emit now (punctuated), or None."""
        return None

    def on_periodic_emit(self) -> Optional[int]:
        """Returns the watermark to emit at a periodic checkpoint, or None."""
        return None

    def snapshot(self) -> dict:
        return {}

    def restore(self, snap: dict) -> None:
        pass


class BoundedOutOfOrdernessWatermarks(WatermarkGenerator):
    """watermark = maxTimestamp - outOfOrderness - 1."""

    def __init__(self, max_out_of_orderness_ms: int):
        self._delay = max_out_of_orderness_ms
        self._max_ts = MIN_WATERMARK + self._delay + 1

    def on_event(self, event, event_timestamp: int) -> Optional[int]:
        if event_timestamp > self._max_ts:
            self._max_ts = event_timestamp
        return None

    def on_periodic_emit(self) -> Optional[int]:
        return self._max_ts - self._delay - 1

    def on_batch_np(self, timestamps: np.ndarray) -> Optional[int]:
        """Vectorized batch form for the host ingest path."""
        if timestamps.size:
            m = int(timestamps.max())
            if m > self._max_ts:
                self._max_ts = m
        return self.on_periodic_emit()

    def snapshot(self) -> dict:
        return {"max_ts": self._max_ts}

    def restore(self, snap: dict) -> None:
        self._max_ts = snap["max_ts"]


class MonotonousTimestampsWatermarks(BoundedOutOfOrdernessWatermarks):
    """forMonotonousTimestamps == bounded with 0 delay."""

    def __init__(self):
        super().__init__(0)


class WatermarkStrategy:
    """Factory mirroring WatermarkStrategy.java's static builders."""

    def __init__(
        self,
        generator_factory: Callable[[], WatermarkGenerator],
        timestamp_assigner: Optional[Callable[[object, int], int]] = None,
        idle_timeout_ms: Optional[int] = None,
    ):
        self._generator_factory = generator_factory
        self.timestamp_assigner = timestamp_assigner
        self.idle_timeout_ms = idle_timeout_ms

    @staticmethod
    def for_monotonous_timestamps() -> "WatermarkStrategy":
        return WatermarkStrategy(MonotonousTimestampsWatermarks)

    @staticmethod
    def for_bounded_out_of_orderness(max_out_of_orderness_ms: int) -> "WatermarkStrategy":
        # a partial, not a lambda: a strategy pickles by reference into a
        # cluster job spec (a TaskManager process rebuilds it by name)
        return WatermarkStrategy(functools.partial(BoundedOutOfOrdernessWatermarks,
                                                   max_out_of_orderness_ms))

    @staticmethod
    def no_watermarks() -> "WatermarkStrategy":
        return WatermarkStrategy(WatermarkGenerator)

    def with_timestamp_assigner(self, fn: Callable[[object, int], int]) -> "WatermarkStrategy":
        return WatermarkStrategy(self._generator_factory, fn, self.idle_timeout_ms)

    def with_idleness(self, idle_timeout_ms: int) -> "WatermarkStrategy":
        """Store the idle timeout, as the JAX package does: a job's runtime
        takes it as a hint (one source channel has nothing to combine);
        `WatermarkValve` and `IdlenessTimer` apply it where channels
        combine."""
        return WatermarkStrategy(self._generator_factory, self.timestamp_assigner,
                                 idle_timeout_ms)

    def create_generator(self) -> WatermarkGenerator:
        return self._generator_factory()


@dataclasses.dataclass
class _Channel:
    watermark: int = MIN_WATERMARK
    idle: bool = False
    last_active_ns: int = 0


class WatermarkValve:
    """Combined watermark = min over non-idle channels; a channel that is idle
    is excluded; if all channels are idle the last combined watermark holds.
    (StatusWatermarkValve.inputWatermark:153, idleness handling :199.)

    Also the watermark-alignment point: `max_drift_ms` bounds how far any
    channel may run ahead of the combined watermark before `paused_channels`
    reports it (SourceCoordinator.announceCombinedWatermark:184 analogue).
    """

    def __init__(self, num_channels: int, max_drift_ms: Optional[int] = None):
        self._channels = [_Channel() for _ in range(num_channels)]
        self._combined = MIN_WATERMARK
        self._max_drift = max_drift_ms

    @property
    def combined_watermark(self) -> int:
        return self._combined

    def input_watermark(self, channel: int, watermark: int) -> Optional[int]:
        """Feed a channel watermark; returns new combined watermark if advanced."""
        ch = self._channels[channel]
        ch.idle = False
        if watermark > ch.watermark:
            ch.watermark = watermark
        return self._recompute()

    def mark_idle(self, channel: int) -> Optional[int]:
        self._channels[channel].idle = True
        return self._recompute()

    def mark_active(self, channel: int) -> None:
        self._channels[channel].idle = False

    def _recompute(self) -> Optional[int]:
        active = [c.watermark for c in self._channels if not c.idle]
        if not active:
            return None
        new = min(active)
        if new > self._combined:
            self._combined = new
            return new
        return None

    def paused_channels(self) -> List[int]:
        """Channels exceeding the alignment drift bound (to be paused)."""
        if self._max_drift is None:
            return []
        limit = self._combined + self._max_drift
        return [
            i for i, c in enumerate(self._channels)
            if not c.idle and c.watermark > limit
        ]


class IdlenessTimer:
    """Marks a source channel idle after no records for idle_timeout_ms
    (WatermarksWithIdleness semantics). `clock` returns seconds; the
    default is the host's monotonic clock, and tests inject their own."""

    def __init__(self, idle_timeout_ms: int, clock: Callable[[], float] = _time.monotonic):
        self._timeout_s = idle_timeout_ms / 1000.0
        self._clock = clock
        self._last_active = clock()
        self.idle = False

    def activity(self) -> None:
        self._last_active = self._clock()
        self.idle = False

    def check_idle(self) -> bool:
        if not self.idle and self._clock() - self._last_active >= self._timeout_s:
            self.idle = True
        return self.idle
