"""Pluggable scaling policies for the adaptive scheduler.

Counterpart of `flink_tpu/scheduler/policy.py`, copied. Two engines:

- `ThresholdPolicy`: the classic reactive rule (AdaptiveScheduler /
  Flink-autoscaler style): windowed utilization above the scale-up
  threshold doubles parallelism, below the scale-down threshold halves
  it, clamped to [min, max].

- `LearningPolicy`: the "Learning from the Past: Adaptive Parallelism
  Tuning for Stream Processing Systems" (PAPERS.md) blueprint: wrap a
  base policy, record every executed rescale's observed before/after
  throughput in a bounded history, and DAMP decisions that previously
  failed to help: a transition whose recorded gain stayed below
  `min_gain` is suppressed for `patience` further triggers before being
  retried, and a later good outcome clears the damping.

Policies are pure decision functions over `SignalEstimate`s (no clocks,
no runtime imports), so they unit-test deterministically.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from flink_tpu_torch.scheduler.signals import SignalEstimate

SCALE_UP = "scale-up"
SCALE_DOWN = "scale-down"
NONE = "none"


@dataclasses.dataclass(frozen=True)
class ScalingDecision:
    action: str                  # SCALE_UP / SCALE_DOWN / NONE
    target: int                  # proposed parallelism (== current for NONE)
    reason: str

    @property
    def is_action(self) -> bool:
        return self.action != NONE


def _none(parallelism: int, reason: str) -> ScalingDecision:
    return ScalingDecision(NONE, parallelism, reason)


class ScalingPolicy:
    """Base interface: decide() proposes, record_outcome() feeds back what
    an executed rescale actually bought (throughput before vs after)."""

    name = "base"

    def decide(self, estimate: SignalEstimate, parallelism: int,
               min_parallelism: int, max_parallelism: int) -> ScalingDecision:
        raise NotImplementedError

    def record_outcome(self, action: str, from_parallelism: int,
                       to_parallelism: int, throughput_before: float,
                       throughput_after: float) -> None:
        pass


class ThresholdPolicy(ScalingPolicy):
    name = "threshold"

    def __init__(self, scale_up_threshold: float = 0.85,
                 scale_down_threshold: float = 0.3, min_samples: int = 3):
        self.scale_up_threshold = float(scale_up_threshold)
        self.scale_down_threshold = float(scale_down_threshold)
        # decisions wait for a warm window: a single sample after a deploy
        # or a load step is exactly the noise the window exists to damp
        self.min_samples = max(int(min_samples), 1)

    def decide(self, estimate: SignalEstimate, parallelism: int,
               min_parallelism: int, max_parallelism: int) -> ScalingDecision:
        if estimate.samples < self.min_samples:
            return _none(parallelism,
                         f"warming up ({estimate.samples}/{self.min_samples} "
                         f"samples)")
        util = estimate.utilization
        if util >= self.scale_up_threshold:
            target = min(max(parallelism * 2, parallelism + 1), max_parallelism)
            if target <= parallelism:
                return _none(parallelism,
                             f"utilization {util:.2f} >= "
                             f"{self.scale_up_threshold} but already at max "
                             f"parallelism {max_parallelism}")
            return ScalingDecision(
                SCALE_UP, target,
                f"utilization {util:.2f} >= {self.scale_up_threshold}")
        if util <= self.scale_down_threshold:
            if estimate.peak_utilization > self.scale_down_threshold:
                # a mean dragged down by stalled ticks around a genuinely
                # busy one is a transient hiccup, not idle capacity —
                # halving here would churn rescales under load jitter
                return _none(parallelism,
                             f"utilization {util:.2f} <= "
                             f"{self.scale_down_threshold} but peak "
                             f"{estimate.peak_utilization:.2f} within the "
                             f"window — transient stall, not idle capacity")
            target = max(parallelism // 2, min_parallelism)
            if target >= parallelism:
                return _none(parallelism,
                             f"utilization {util:.2f} <= "
                             f"{self.scale_down_threshold} but already at min "
                             f"parallelism {min_parallelism}")
            return ScalingDecision(
                SCALE_DOWN, target,
                f"utilization {util:.2f} <= {self.scale_down_threshold}")
        return _none(parallelism,
                     f"utilization {util:.2f} within "
                     f"[{self.scale_down_threshold}, {self.scale_up_threshold}]")


@dataclasses.dataclass(frozen=True)
class RescaleOutcome:
    """One executed rescale and what it bought."""

    action: str
    from_parallelism: int
    to_parallelism: int
    throughput_before: float
    throughput_after: float

    @property
    def gain(self) -> float:
        return self.throughput_after / max(self.throughput_before, 1e-9)


class LearningPolicy(ScalingPolicy):
    name = "learning"

    def __init__(self, base: Optional[ScalingPolicy] = None,
                 history_size: int = 32, min_gain: float = 1.1,
                 patience: int = 4):
        self.base = base if base is not None else ThresholdPolicy()
        self.history: Deque[RescaleOutcome] = deque(
            maxlen=max(int(history_size), 1))
        self.min_gain = float(min_gain)
        self.patience = max(int(patience), 1)
        # (action, from_p) -> triggers suppressed since the bad outcome
        self._suppressed: Dict[Tuple[str, int], int] = {}

    def _recorded_gain(self, action: str, from_p: int) -> Optional[float]:
        """Mean observed gain for this transition shape (same direction
        from the same parallelism) over the bounded ring — old outcomes
        age out by eviction, all retained ones weigh equally."""
        gains = [o.gain for o in self.history
                 if o.action == action and o.from_parallelism == from_p]
        return sum(gains) / len(gains) if gains else None

    def decide(self, estimate: SignalEstimate, parallelism: int,
               min_parallelism: int, max_parallelism: int) -> ScalingDecision:
        decision = self.base.decide(
            estimate, parallelism, min_parallelism, max_parallelism)
        if not decision.is_action:
            return decision
        # scale-down is damped only by a past scale-down that LOST
        # throughput; scale-up by one that failed to add any
        gain = self._recorded_gain(decision.action, parallelism)
        bar = self.min_gain if decision.action == SCALE_UP else 1.0 / self.min_gain
        if gain is None or gain >= bar:
            return decision
        key = (decision.action, parallelism)
        n = self._suppressed.get(key, 0) + 1
        if n <= self.patience:
            self._suppressed[key] = n
            return _none(
                parallelism,
                f"damped: past {decision.action} from p={parallelism} gained "
                f"only {gain:.2f}x (< {bar:.2f}x); suppressing "
                f"{n}/{self.patience} before retrying — {decision.reason}")
        # patience exhausted: forget the grudge and try again
        self._suppressed.pop(key, None)
        return dataclasses.replace(
            decision, reason=f"{decision.reason} (retry after "
                             f"{self.patience} damped triggers)")

    def record_outcome(self, action: str, from_parallelism: int,
                       to_parallelism: int, throughput_before: float,
                       throughput_after: float) -> None:
        outcome = RescaleOutcome(action, from_parallelism, to_parallelism,
                                 throughput_before, throughput_after)
        self.history.append(outcome)
        bar = self.min_gain if action == SCALE_UP else 1.0 / self.min_gain
        if outcome.gain >= bar:
            self._suppressed.pop((action, from_parallelism), None)


def build_policy(name: str, *, scale_up_threshold: float = 0.85,
                 scale_down_threshold: float = 0.3, min_samples: int = 3,
                 history_size: int = 32, min_gain: float = 1.1,
                 patience: int = 4) -> ScalingPolicy:
    """Policy factory for the `autoscaler.policy` config value."""
    base = ThresholdPolicy(scale_up_threshold, scale_down_threshold,
                           min_samples)
    if name == "threshold":
        return base
    if name == "learning":
        return LearningPolicy(base, history_size=history_size,
                              min_gain=min_gain, patience=patience)
    raise ValueError(
        f"unknown autoscaler.policy {name!r} (expected 'threshold' or "
        f"'learning')")
