"""Skew rebalancer: closes the loop from key-skew telemetry to key-group
placement (parallel.mesh.skew-rebalance).

Counterpart of `flink_tpu/scheduler/rebalancer.py`, copied: the policy is
numpy over plain arrays. The static contiguous owner function piles the
hot key-groups onto whichever shards own the hot key ranges. This module
is the DECISION side of fixing that: it watches per-key-group loads, and
when the per-shard skew a placement produces crosses the configured
threshold AND a replanned balanced assignment
(parallel/routing.py::plan_balanced_assignment, capacity-bounded LPT)
would improve it by a meaningful margin, it hands the new assignment to
the runtime, which applies it at a step-aligned boundary through the
mesh-rescale capture/restore machinery (exactly-once; checkpoints stay
canonical [K, S]).

Like the autoscaler, this package never touches the runtime: the
MiniCluster's attempt loop polls `maybe_decide` with plain arrays and
executes the move itself. The clock is injected.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np

from flink_tpu_torch.parallel.routing import (
    plan_balanced_assignment,
    predicted_skew,
)

#: a replan must beat the current placement's predicted skew by this
#: factor to be worth a stop-the-world table swap — one unsplittable hot
#: group (skew high, replan identical) must never cause rebuild churn
MIN_IMPROVEMENT = 0.9


@dataclasses.dataclass
class RebalanceDecision:
    """One decision-log entry (mirrors the autoscaler's ScalingDecision
    shape: every poll that got past the throttle leaves a trace)."""

    timestamp: float
    action: str                  # "rebalance" | "hold"
    reason: str
    skew_before: float
    skew_after: Optional[float] = None
    moved_groups: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class SkewRebalancer:
    """Throttled skew-threshold policy over per-key-group loads.

    `maybe_decide(group_loads, current_assign, n_shards)` returns a new
    [G] assignment when a rebalance should happen NOW, else None. The
    caller owns execution; `rebalance_completed()` (mis)fires the
    cooldown clock so a just-applied table gets `interval_ms` of fresh
    traffic before it is judged again.

    Decisions run on a WINDOWED SUM of load snapshots, never one
    instantaneous reading — the autoscaler's lesson applied to
    placement: the resident ring right after a purge holds a handful of
    records, and the group of the freshest-admitted dense ids always
    reads as "hot" in a single snapshot (a moving target no placement
    can balance). Summing `window` samples time-integrates the load, so
    the stable hot groups accumulate while one-snapshot spikes dilute;
    `min_samples` due ticks must accumulate after a (re)start or a
    completed rebalance before the policy will judge the placement."""

    def __init__(self, *, skew_threshold: float = 1.25,
                 interval_ms: int = 1000, max_decisions: int = 64,
                 window: int = 8, min_samples: int = 4,
                 clock: Callable[[], float] = time.monotonic):
        self.skew_threshold = max(float(skew_threshold), 1.0)
        self.interval_s = max(int(interval_ms), 0) / 1000.0
        self._clock = clock
        self._last_t: Optional[float] = None
        self.num_rebalances = 0
        self.decisions: List[RebalanceDecision] = []
        self._max_decisions = max_decisions
        self.min_samples = max(int(min_samples), 1)
        self._window: Deque[np.ndarray] = deque(maxlen=max(int(window), 1))

    # ------------------------------------------------------------------
    def _log(self, d: RebalanceDecision) -> None:
        self.decisions.append(d)
        if len(self.decisions) > self._max_decisions:
            del self.decisions[:-self._max_decisions]

    def due(self, now: Optional[float] = None) -> bool:
        """True when the interval throttle would let a decision run —
        callers gate the (device-readback) load collection on this, so a
        per-step poll costs one clock read, not a device sync."""
        now = self._clock() if now is None else now
        return self._last_t is None or now - self._last_t >= self.interval_s

    def rebalance_completed(self) -> None:
        """The runtime applied an assignment: restart the interval clock
        AND the evidence window, so the new placement is judged only on
        traffic it actually served."""
        self.num_rebalances += 1
        self._last_t = self._clock()
        self._window.clear()

    def maybe_decide(self, group_loads, current_assign,
                     n_shards: int,
                     now: Optional[float] = None) -> Optional[np.ndarray]:
        """One throttled decision: None = hold (throttled, warming up,
        below threshold, or no worthwhile improvement); an [G] int32
        array = rebalance to this assignment now."""
        now = self._clock() if now is None else now
        if self._last_t is not None and now - self._last_t < self.interval_s:
            return None
        self._last_t = now
        sample = np.asarray(group_loads, np.float64)
        if sample.size == 0 or sample.sum() <= 0:
            return None
        if self._window and self._window[0].shape != sample.shape:
            # group count changed (capacity growth rebuilt the table):
            # stale-geometry evidence is meaningless, start fresh
            self._window.clear()
        self._window.append(sample)
        if len(self._window) < self.min_samples:
            return None
        loads = np.sum(self._window, axis=0)
        current = np.asarray(current_assign, np.int64)
        n = int(n_shards)
        before = predicted_skew(loads, current, n)
        if before < self.skew_threshold:
            self._log(RebalanceDecision(
                now, "hold",
                f"skew {before:.3f} below threshold "
                f"{self.skew_threshold:.2f}", before))
            return None
        assign = plan_balanced_assignment(loads, n, current)
        after = predicted_skew(loads, assign, n)
        moved = int(np.sum(assign != current))
        if moved == 0 or after > before * MIN_IMPROVEMENT:
            self._log(RebalanceDecision(
                now, "hold",
                f"replan does not improve enough ({before:.3f} -> "
                f"{after:.3f}, {moved} group(s) moved)", before, after,
                moved))
            return None
        self._log(RebalanceDecision(
            now, "rebalance",
            f"skew {before:.3f} >= {self.skew_threshold:.2f}; balanced "
            f"replan predicts {after:.3f} moving {moved} group(s)",
            before, after, moved))
        return assign

    def payload(self) -> dict:
        """JSON-safe decision log + counters."""
        return {
            "numRebalances": self.num_rebalances,
            "skewThreshold": self.skew_threshold,
            "intervalMs": int(self.interval_s * 1000),
            "decisions": [d.as_dict() for d in self.decisions[-16:]],
        }
