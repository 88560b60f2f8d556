"""Signal aggregation for the adaptive scheduler.

Counterpart of `flink_tpu/scheduler/signals.py`, copied: plain Python over
metric-snapshot dicts. The observability plane already measures what a
scaler needs: the run loops feed busy/idle/backPressured accounting
(metrics/task_io.py), the device plane the roofline and key-skew gauges
(`job.device.hbmUtilizationPct`, `job.keySkew`), the checkpoint tracker
the checkpoint durations. This module turns a job's snapshot
(`metrics_snapshot` of its registry) into per-vertex *windowed*
utilization estimates the policy engine can act on: instantaneous ratios
are too noisy to rescale a job over, so each signal is averaged over a
bounded window of samples and decisions see the window, not the tick.

Layering: scheduler sits above metrics/config and below runtime; this
module never imports the runtime.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, Optional


@dataclasses.dataclass(frozen=True)
class SignalSample:
    """One reading of the scaling-relevant gauges for one vertex/job.

    busy/backpressured/idle prefer the windowed `*TimeMsPerSecond` gauges
    (recent state, sampled every observability.sampling.interval-ms) and
    fall back to the lifetime ratios for snapshots that lack them."""

    timestamp: float                     # seconds (coordinator clock)
    busy: float = 0.0                    # fraction of recent wall time busy
    backpressured: float = 0.0
    idle: float = 0.0
    in_pool_usage: float = 0.0           # mean exchange ring occupancy
    watermark_skew_ms: float = 0.0
    checkpoint_duration_ms: float = 0.0  # last completed checkpoint e2e
    records_in: float = 0.0              # cumulative counter (resets on redeploy)
    # device-plane signals — OPTIONAL, unlike the gauges above: a
    # build/job without device stats simply lacks them, and treating the
    # absence as 0.0 would feed "zero skew, zero utilization" into the
    # learning policy and bias it toward jobs that merely lack the gauge.
    # None means "not measured" and is EXCLUDED from window means.
    key_skew: Optional[float] = None           # max/mean key-group load
    device_utilization: Optional[float] = None  # worst roofline fraction 0..1

    @property
    def utilization(self) -> float:
        """Busy + backpressured fraction: the share of wall time this
        vertex either worked or was blocked by downstream backlog — both
        argue for more parallelism, idle argues for less."""
        return min(self.busy + self.backpressured, 1.0)


def _ratio(metrics: Dict[str, float], leaf: str) -> float:
    """Windowed ms-per-second gauge as a fraction, else the lifetime ratio.

    A PRESENT windowed gauge is authoritative even at 0.0 — a fully idle
    vertex legitimately reads busy 0, and falling back to a stale lifetime
    ratio there would invert the signal (a long-busy job going idle would
    keep reading ~0.9 and could never scale down). The warm-up guards
    (stabilization + min_samples) cover the instant after a deploy when
    the gauge exists but has not sampled yet."""
    rate = metrics.get(f"job.{leaf}TimeMsPerSecond")
    if isinstance(rate, (int, float)):
        return min(max(float(rate), 0.0) / 1000.0, 1.0)
    return float(metrics.get(f"job.{leaf}TimeRatio", 0.0) or 0.0)


def _optional(metrics: Dict[str, object], key: str,
              scale: float = 1.0) -> Optional[float]:
    """A gauge that is ABSENT stays None (excluded from window means) —
    only a present numeric value is a measurement."""
    v = metrics.get(key)
    return float(v) * scale if isinstance(v, (int, float)) else None


def extract_signals(metrics: Dict[str, object],
                    now: Optional[float] = None) -> SignalSample:
    """Pull the scaling signals out of a metric snapshot (JM-aggregated
    per-job dict, or a MiniCluster registry snapshot — same key space)."""
    pool = [float(v) for k, v in metrics.items()
            if "inPoolUsage" in k and isinstance(v, (int, float))]
    hbm = _optional(metrics, "job.device.hbmUtilizationPct", 0.01)
    flops = _optional(metrics, "job.device.flopsUtilizationPct", 0.01)
    present = [u for u in (hbm, flops) if u is not None]
    return SignalSample(
        timestamp=time.monotonic() if now is None else now,
        busy=_ratio(metrics, "busy"),
        backpressured=_ratio(metrics, "backPressured"),
        idle=_ratio(metrics, "idle"),
        in_pool_usage=sum(pool) / len(pool) if pool else 0.0,
        watermark_skew_ms=float(metrics.get("job.watermarkSkewMs", 0.0) or 0.0),
        checkpoint_duration_ms=float(
            metrics.get("job.lastCheckpointDuration", 0.0) or 0.0),
        records_in=float(metrics.get("job.numRecordsIn", 0.0) or 0.0),
        key_skew=_optional(metrics, "job.keySkew"),
        # roofline fraction: the binding resource (worst of HBM/FLOPs)
        device_utilization=max(present) if present else None,
    )


@dataclasses.dataclass(frozen=True)
class SignalEstimate:
    """Windowed view the policy decides on."""

    utilization: float
    busy: float
    backpressured: float
    idle: float
    in_pool_usage: float
    watermark_skew_ms: float
    checkpoint_duration_ms: float
    throughput_per_s: float      # records/s over the window
    samples: int                 # window fill — policies gate on warm-up
    # max single-sample utilization in the window: scale-down wants the
    # WHOLE window idle, not a mean dragged down by a few stalled ticks
    peak_utilization: float = 0.0
    # device-plane estimates: mean over the samples that MEASURED them;
    # None when no sample in the window carried the gauge (a build
    # without device stats must not read as "zero skew / zero
    # utilization" to the learning policy)
    key_skew: Optional[float] = None
    device_utilization: Optional[float] = None

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


class SignalWindow:
    """Bounded window of samples for one vertex with mean estimates.

    The records_in counter resets when an attempt redeploys (fresh task
    registries); a backwards step clears the window so a rescale never
    reports negative throughput or mixes attempts."""

    def __init__(self, size: int = 6):
        self.size = max(int(size), 1)
        self._samples: Deque[SignalSample] = deque(maxlen=self.size)

    def observe(self, sample: SignalSample) -> SignalEstimate:
        if self._samples and sample.records_in < self._samples[-1].records_in:
            self._samples.clear()    # counter reset: new attempt
        self._samples.append(sample)
        return self.estimate()

    def clear(self) -> None:
        self._samples.clear()

    def estimate(self) -> SignalEstimate:
        n = len(self._samples)
        if n == 0:
            return SignalEstimate(0, 0, 0, 0, 0, 0, 0, 0.0, 0)

        def mean(attr: str) -> float:
            return sum(getattr(s, attr) for s in self._samples) / n

        def optional_mean(attr: str) -> Optional[float]:
            # mean over the samples that MEASURED the signal; None when
            # none did — absence must never read as 0.0 downstream
            vals = [getattr(s, attr) for s in self._samples
                    if getattr(s, attr) is not None]
            return sum(vals) / len(vals) if vals else None

        first, last = self._samples[0], self._samples[-1]
        dt = max(last.timestamp - first.timestamp, 1e-9)
        tput = ((last.records_in - first.records_in) / dt) if n >= 2 else 0.0
        return SignalEstimate(
            utilization=mean("utilization"),
            peak_utilization=max(s.utilization for s in self._samples),
            busy=mean("busy"),
            backpressured=mean("backpressured"),
            idle=mean("idle"),
            in_pool_usage=mean("in_pool_usage"),
            watermark_skew_ms=mean("watermark_skew_ms"),
            checkpoint_duration_ms=last.checkpoint_duration_ms,
            throughput_per_s=max(tput, 0.0),
            samples=n,
            key_skew=optional_mean("key_skew"),
            device_utilization=optional_mean("device_utilization"),
        )


class SignalAggregator:
    """Per-vertex signal windows (today: one vertex per keyed job; the
    per-vertex shape is what a multi-vertex graph scaler will key on)."""

    def __init__(self, window: int = 6):
        self.window = window
        self._vertices: Dict[str, SignalWindow] = {}

    def observe(self, vertex: str, metrics: Dict[str, object],
                now: Optional[float] = None) -> SignalEstimate:
        win = self._vertices.get(vertex)
        if win is None:
            win = self._vertices[vertex] = SignalWindow(self.window)
        return win.observe(extract_signals(metrics, now))

    def reset(self, vertex: str) -> None:
        win = self._vertices.get(vertex)
        if win is not None:
            win.clear()

    def estimate(self, vertex: str) -> SignalEstimate:
        win = self._vertices.get(vertex)
        return win.estimate() if win is not None else SignalWindow().estimate()
