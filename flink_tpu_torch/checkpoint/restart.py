"""Restart and backoff strategies.

Counterpart of `flink_tpu/checkpoint/restart.py`, copied: no restart,
fixed delay, exponential delay and failure rate, chosen by
`restart-strategy.type` with the JAX package's keys and defaults."""

from __future__ import annotations

import time
from typing import Optional

from flink_tpu_torch.config import Configuration, RestartOptions


class RestartStrategy:
    def next_delay_ms(self, attempt: int) -> Optional[float]:
        """Delay before restart `attempt` (1-based); None = give up."""
        raise NotImplementedError

    def record_success(self) -> None:
        pass


class NoRestartStrategy(RestartStrategy):
    def next_delay_ms(self, attempt: int) -> Optional[float]:
        return None


class FixedDelayRestartStrategy(RestartStrategy):
    def __init__(self, max_attempts: int, delay_ms: float):
        self.max_attempts = max_attempts
        self.delay_ms = delay_ms

    def next_delay_ms(self, attempt: int) -> Optional[float]:
        return self.delay_ms if attempt <= self.max_attempts else None


class ExponentialDelayRestartStrategy(RestartStrategy):
    def __init__(self, max_attempts: int, initial_ms: float, max_ms: float, multiplier: float):
        self.max_attempts = max_attempts
        self.initial_ms = initial_ms
        self.max_ms = max_ms
        self.multiplier = multiplier

    def next_delay_ms(self, attempt: int) -> Optional[float]:
        if attempt > self.max_attempts:
            return None
        return min(self.initial_ms * (self.multiplier ** (attempt - 1)), self.max_ms)


class FailureRateRestartStrategy(RestartStrategy):
    """Gives up when more than max_failures occur within interval_ms."""

    def __init__(self, max_failures: int, interval_ms: float, delay_ms: float,
                 clock=time.monotonic):
        self.max_failures = max_failures
        self.interval_s = interval_ms / 1000.0
        self.delay_ms = delay_ms
        self._clock = clock
        self._failures = []

    def next_delay_ms(self, attempt: int) -> Optional[float]:
        now = self._clock()
        self._failures = [t for t in self._failures if now - t <= self.interval_s]
        self._failures.append(now)
        if len(self._failures) > self.max_failures:
            return None
        return self.delay_ms


def restart_strategy_from_config(config: Configuration) -> RestartStrategy:
    kind = config.get(RestartOptions.STRATEGY)
    attempts = config.get(RestartOptions.MAX_ATTEMPTS)
    initial = config.get(RestartOptions.INITIAL_BACKOFF_MS)
    if kind == "none":
        return NoRestartStrategy()
    if kind == "fixed-delay":
        return FixedDelayRestartStrategy(attempts, initial)
    if kind == "failure-rate":
        return FailureRateRestartStrategy(attempts, 60_000, initial)
    return ExponentialDelayRestartStrategy(
        attempts,
        initial,
        config.get(RestartOptions.MAX_BACKOFF_MS),
        config.get(RestartOptions.BACKOFF_MULTIPLIER),
    )
