"""Adaptive superbatch sizing for latency-mode execution.

Counterpart of `flink_tpu/scheduler/latency_controller.py`, copied (the
port imports nothing of the JAX package). The fused window path amortizes
host/device round trips by buffering T steps per dispatch; T is also the
floor of emission latency: a fired window is host-visible only after the
dispatch that contains it launches and resolves. `SuperbatchController`
closes that trade-off under an explicit target
(`execution.latency.target-ms`): it estimates the step arrival rate over a
bounded window of samples, and picks the largest rung of a pow2 ladder
whose fill time still fits the target. Geometry is snapped to the ladder,
the same pow2 shapes the operator's tail-pad path already runs.

Stability discipline:

- warm-up: below ``min_samples`` observations the controller refuses to
  adapt and holds the FULL span, so an unwarmed estimate can never cost
  peak throughput;
- hysteresis: the windowed rate must overshoot a rung boundary by the
  configured margin before the rung changes, so a rate oscillating
  across a boundary never flaps geometries;
- min-dwell: a non-escalation move waits out a dwell interval after the
  previous change. The one exception is a rate spike that demands the
  full span: falling behind is strictly worse than a dwell violation, so
  escalation to the top rung applies immediately.

The clock is injectable (`clock=`, and `now=` on each call), so tests
drive the controller on a fake clock. This module imports neither torch
nor the runtime; the operator consumes it through plain numbers.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LatencySpec:
    """The execution.latency.* option bundle threaded to the fused
    operator (executor._latency_kwargs). target_ms > 0 is the mode
    switch; everything else tunes the controller and the dispatch ring."""

    target_ms: int
    max_inflight: int = 1
    floor_steps: int = 2
    readback_steps: int = 8
    min_dwell_ms: int = 500
    hysteresis_pct: int = 25


def build_rung_ladder(floor_steps: int, full_steps: int) -> Tuple[int, ...]:
    """Pow2 rungs from the latency floor up to the full span. The full
    span itself is always the top rung even when it is not a power of
    two (it is the one geometry the throughput path compiles anyway)."""
    full = max(int(full_steps), 1)
    floor = min(max(int(floor_steps), 1), full)
    rungs = []
    r = 1 << (floor - 1).bit_length()     # next pow2 >= floor
    while r < full:
        rungs.append(r)
        r <<= 1
    rungs.append(full)
    return tuple(rungs)


class SuperbatchController:
    """Windowed step-rate estimator + rung ladder policy.

    ``observe(n_steps)`` feeds arrivals; ``steps()`` returns the depth
    the next dispatch should cut at. Both are O(1) and host-only — the
    controller sits on the ingest hot path.
    """

    def __init__(
        self,
        *,
        full_steps: int,
        target_ms: int,
        floor_steps: int = 2,
        min_dwell_ms: int = 500,
        hysteresis_pct: int = 25,
        window: int = 8,
        min_samples: int = 3,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.ladder = build_rung_ladder(floor_steps, full_steps)
        self.target_s = max(int(target_ms), 1) / 1000.0
        self.min_dwell_s = max(int(min_dwell_ms), 0) / 1000.0
        self.hysteresis = max(int(hysteresis_pct), 0) / 100.0
        self.min_samples = max(int(min_samples), 1)
        self._clock = clock
        # (timestamp, n_steps) arrival samples; the bounded deque IS the
        # window — one stalled or bursty reading cannot dominate the rate
        self._samples: Deque[Tuple[float, int]] = deque(
            maxlen=max(int(window), 2))
        # cold start holds the TOP rung (full span): an unwarmed estimate
        # must never cost peak throughput or compile an extra shape
        self._rung = len(self.ladder) - 1
        self._last_change: Optional[float] = None

    # -- observation -----------------------------------------------------
    def observe(self, n_steps: int, now: Optional[float] = None) -> None:
        """Record that `n_steps` planner steps just arrived."""
        if n_steps <= 0:
            return
        self._samples.append(
            (self._clock() if now is None else now, int(n_steps)))

    def step_rate(self) -> Optional[float]:
        """Steps/second over the sample window; None while warming up
        (below min_samples, or a window too narrow to difference)."""
        if len(self._samples) < self.min_samples:
            return None
        t0 = self._samples[0][0]
        t1 = self._samples[-1][0]
        if t1 <= t0:
            return None
        # arrivals BETWEEN the first and last stamps: the first sample's
        # own steps predate the measured interval
        n = sum(s for _t, s in self._samples) - self._samples[0][1]
        return n / (t1 - t0)

    # -- policy ----------------------------------------------------------
    def _ideal_rung(self, budget_steps: float) -> int:
        """Largest rung whose depth fits the step budget (floor rung when
        even the floor does not fit — the ladder never goes below it)."""
        ideal = 0
        for i, steps in enumerate(self.ladder):
            if steps <= budget_steps:
                ideal = i
        return ideal

    def steps(self, now: Optional[float] = None) -> int:
        """The superbatch depth the next dispatch should cut at."""
        return self.ladder[self.decide(now)]

    def decide(self, now: Optional[float] = None) -> int:
        """Current rung index after applying warm-up, hysteresis,
        min-dwell, and spike escalation to the windowed estimate."""
        rate = self.step_rate()
        if rate is None:
            return self._rung          # warming up: hold (full span)
        now = self._clock() if now is None else now
        budget = rate * self.target_s  # steps arriving within the target
        top = len(self.ladder) - 1
        cur = self._rung
        ideal = self._ideal_rung(budget)
        if ideal == cur:
            return cur
        if ideal > cur:
            # moving up: the budget must overshoot the TARGET rung's
            # boundary by the hysteresis margin, not merely touch it
            if budget < self.ladder[ideal] * (1.0 + self.hysteresis):
                ideal = max(self._ideal_rung(
                    budget / (1.0 + self.hysteresis)), cur)
            if ideal == cur:
                return cur
            if ideal == top and self.ladder[cur] < self.ladder[top]:
                # rate spike demanding the full span: falling behind is
                # strictly worse than a dwell violation — escalate now
                self._rung = top
                self._last_change = now
                return self._rung
        else:
            # moving down: the budget must UNDERSHOOT the current rung's
            # own boundary by the margin (a rate oscillating across the
            # boundary reads as "still fits" and never flaps)
            if budget > self.ladder[cur] * (1.0 - self.hysteresis):
                return cur
        if (self._last_change is not None
                and now - self._last_change < self.min_dwell_s):
            return cur                 # min-dwell: hold the rung
        self._rung = ideal
        self._last_change = now
        return self._rung

    # -- exposure --------------------------------------------------------
    def current_steps(self) -> int:
        """The held rung's depth without re-evaluating the policy (gauge
        reads must not advance controller state)."""
        return self.ladder[self._rung]

    def reset(self) -> None:
        """Forget the window and re-hold the full span (restore/rescale:
        old-deployment samples describe a stream position that no longer
        exists — the autoscaler's shape-change reset discipline)."""
        self._samples.clear()
        self._rung = len(self.ladder) - 1
        self._last_change = None
