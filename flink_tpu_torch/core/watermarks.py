"""Watermark generation.

Counterpart of the generators and `WatermarkStrategy` of
`flink_tpu/core/watermarks.py`: a watermark is a per-source scalar the job
runtime advances on the host between steps, so the device programs see
one watermark per step.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from flink_tpu_torch.core.time import MIN_WATERMARK
from flink_tpu_torch.utils import deferred


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
    ):
        self._generator_factory = generator_factory
        self.timestamp_assigner = timestamp_assigner

    @staticmethod
    def for_monotonous_timestamps() -> "WatermarkStrategy":
        return WatermarkStrategy(MonotonousTimestampsWatermarks)

    @staticmethod
    def for_bounded_out_of_orderness(max_out_of_orderness_ms: int) -> "WatermarkStrategy":
        return WatermarkStrategy(lambda: BoundedOutOfOrdernessWatermarks(max_out_of_orderness_ms))

    @staticmethod
    def no_watermarks() -> "WatermarkStrategy":
        return WatermarkStrategy(WatermarkGenerator)

    def with_timestamp_assigner(self, fn: Callable[[object, int], int]) -> "WatermarkStrategy":
        return WatermarkStrategy(self._generator_factory, fn)

    def with_idleness(self, idle_timeout_ms: int) -> "WatermarkStrategy":
        # idleness only matters where several channels combine watermarks
        raise deferred.not_ported("WatermarkStrategy.with_idleness", deferred.PARALLELISM)

    def create_generator(self) -> WatermarkGenerator:
        return self._generator_factory()
