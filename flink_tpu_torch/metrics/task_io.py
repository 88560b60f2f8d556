"""Per-task busy/idle/backpressure accounting and device-time attribution.

Counterpart of `flink_tpu/metrics/task_io.py`, copied. On CUDA a launch
returns at once, so a `DeviceTimer` dispatch section reads the host's
launch time and the readback section (the wait of
`utils/device.py::HostCopy`) absorbs the device's; the timer itself adds
no synchronize, as the JAX timer adds no block_until_ready.

The reference tracks these in TaskIOMetricGroup (busyTimeMsPerSecond,
idleTimeMsPerSecond, backPressuredTimeMsPerSecond; TaskIOMetricGroup.java:48)
and samples them for the REST backpressure handlers
(JobVertexBackPressureHandler). The stepped executor's analogue:

- **busy** — time the run loop spends pushing a batch through the runner
  DAG (device dispatch included), minus time blocked on downstream credits;
- **backpressured** — time blocked inside an exchange sender waiting for
  credits (dataplane OutputChannel.send), i.e. the downstream stage's
  backlog surfacing in THIS task's loop — the "writer blocks on
  LocalBufferPool" condition;
- **idle** — everything else: source poll timeouts, starved stage-input
  channels, scheduling gaps.

Lifetime ratios are maintained continuously from these counters; the
windowed `*MsPerSecond` gauges are sampled on the run loop's
processing-time tick every `observability.sampling.interval-ms` (the
backpressure-sampling period), so REST/dashboard readers see the RECENT
state of the task, not its lifetime average.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List


def backpressure_level(ratio: float) -> str:
    """The reference's backpressure classification thresholds
    (JobVertexBackPressureHandler: ok <= 0.10 < low <= 0.5 < high)."""
    if ratio <= 0.10:
        return "ok"
    if ratio <= 0.5:
        return "low"
    return "high"


class TaskIOMetrics:
    """Busy/idle/backPressured time accounting for one task run loop."""

    def __init__(self):
        self.busy_s = 0.0
        self.loop_s = 1e-9
        # callables returning cumulative seconds blocked on credits (one per
        # exchange sender feeding a downstream stage)
        self._bp_sources: List[Callable[[], float]] = []
        # windowed sample state
        self._last_sample_t = time.monotonic()
        self._last = (0.0, 0.0, 0.0)          # (busy, bp, loop) at last sample
        self._rates = {"busy": 0.0, "idle": 0.0, "backPressured": 0.0}

    def add_backpressure_source(self, fn: Callable[[], float]) -> None:
        self._bp_sources.append(fn)

    def backpressured_s(self) -> float:
        return sum(fn() for fn in self._bp_sources)

    # -- run-loop feed -----------------------------------------------------
    def record_step(self, busy_dt: float, loop_dt: float) -> None:
        """One source turn: `busy_dt` spent pushing (includes any credit
        waits — they are separated out at read time), `loop_dt` total."""
        self.busy_s += busy_dt
        self.loop_s += loop_dt

    # -- lifetime ratios ---------------------------------------------------
    def ratios(self) -> Dict[str, float]:
        bp = min(self.backpressured_s(), self.busy_s)
        busy = self.busy_s - bp
        loop = max(self.loop_s, busy + bp, 1e-9)
        idle = max(loop - busy - bp, 0.0)
        return {
            "busyRatio": busy / loop,
            "idleRatio": idle / loop,
            "backPressuredRatio": bp / loop,
        }

    # -- windowed sampling -------------------------------------------------
    def maybe_sample(self, interval_ms: int, now: float = None) -> None:
        """Fold the deltas since the last sample into the msPerSecond rates;
        called from the processing-time tick (cheap: pure arithmetic)."""
        now = time.monotonic() if now is None else now
        dt = now - self._last_sample_t
        if dt * 1000.0 < max(interval_ms, 1):
            return
        bp_total = min(self.backpressured_s(), self.busy_s)
        d_busy = self.busy_s - self._last[0]
        d_bp = bp_total - self._last[1]
        d_loop = self.loop_s - self._last[2]
        self._last = (self.busy_s, bp_total, self.loop_s)
        self._last_sample_t = now
        del d_loop  # wall clock, not loop time, is the msPerSecond base
        wall = max(dt, 1e-9)
        bp = max(d_bp, 0.0)
        busy = max(d_busy - bp, 0.0)
        idle = max(wall - busy - bp, 0.0)
        self._rates = {
            "busy": min(busy / wall, 1.0) * 1000.0,
            "backPressured": min(bp / wall, 1.0) * 1000.0,
            "idle": min(idle / wall, 1.0) * 1000.0,
        }

    def ms_per_second(self, kind: str) -> float:
        return self._rates[kind]

    def register(self, group) -> None:
        """Register the TaskIOMetricGroup-analogue gauges on `group`."""
        r = self.ratios
        # per-task fractions (each bounded per task) fold MEAN
        group.gauge("busyTimeRatio", lambda: r()["busyRatio"], fold="mean")
        group.gauge("idleTimeRatio", lambda: r()["idleRatio"], fold="mean")
        group.gauge("backPressuredTimeRatio",
                    lambda: r()["backPressuredRatio"], fold="mean")
        group.gauge("busyTimeMsPerSecond",
                    lambda: self.ms_per_second("busy"), fold="mean")
        group.gauge("idleTimeMsPerSecond",
                    lambda: self.ms_per_second("idle"), fold="mean")
        group.gauge("backPressuredTimeMsPerSecond",
                    lambda: self.ms_per_second("backPressured"), fold="mean")


class DeviceTimer:
    """Host-clock attribution of one operator's device sections (dispatch +
    blocking readback). Wrap already-synchronous sections only — this is an
    observer, it must never add block_until_ready syncs of its own."""

    def __init__(self, histogram=None):
        self.total_s = 0.0
        self.dispatches = 0
        self._hist = histogram

    class _Section:
        __slots__ = ("timer", "t0")

        def __init__(self, timer: "DeviceTimer"):
            self.timer = timer

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            self.timer.total_s += dt
            self.timer.dispatches += 1
            if self.timer._hist is not None:
                self.timer._hist.update(dt * 1000.0)
            return False

    def section(self) -> "_Section":
        return DeviceTimer._Section(self)

    def register(self, group) -> None:
        group.gauge("deviceTimeMsTotal", lambda: self.total_s * 1000.0,
                    fold="sum", kind="counter")
        group.gauge("deviceDispatches", lambda: self.dispatches,
                    fold="sum", kind="counter")
