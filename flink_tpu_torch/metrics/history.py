"""Bounded ring time-series store for job/operator metrics.

Counterpart of `flink_tpu/metrics/history.py`, copied (it is jax-free).

Every observability plane before this one reported the *instant* or the
*lifetime*; the history plane retains the trajectory. A `MetricHistory`
samples a plain-data metric snapshot (the `metrics_snapshot` form) on the
caller's existing processing-time tick and keeps, per metric key, a
bounded deque of ``(t_ms, value)`` points:

- **counters** (kind ``"counter"`` — monotone totals, including gauges
  registered with ``kind="counter"``) are recorded as windowed *rates*
  (delta / dt, clamped at 0 so a restore rewind reads as a stall, which
  is exactly the signal the throughput-collapse watchdog keys on), with
  the recorded kind ``"counter-rate"``;
- **gauges/meters** are recorded as-is;
- **histogram-stats dicts** (emission-latency snapshots and reservoir
  stats alike) are recorded as derived per-sample sub-series
  ``<key>.p50`` / ``<key>.p99`` (plus ``<key>.count`` as a counter-rate,
  so fire *rates* are visible too).

The store is execution-path agnostic: the MiniCluster samples the
client's folded registry view; the distributed JobManager samples the
shard-folded snapshots it already assembles from heartbeats. Both serve
the same payload at ``GET /jobs/:id/history?metric=&since=``.

This module imports neither torch nor the runtime: it consumes snapshots
handed to it. On the port the MiniCluster path and the distributed
JobManager sample it; runtime/rest.py serves it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["MetricHistory", "DEFAULT_INTERVAL_MS", "DEFAULT_RETENTION"]

DEFAULT_INTERVAL_MS = 1000
DEFAULT_RETENTION = 256

# histogram-stats sub-series the ring derives (per-sample quantiles; the
# count rides along as a rate so "fires per second" is also a series)
_HIST_STATS = ("p50", "p99")


def _now_ms(clock) -> float:
    return clock() * 1000.0


class MetricHistory:
    """Per-key bounded rings of ``(t_ms, value)`` sampled on a tick.

    Thread-safe: the sampling tick (job thread / JM schedule loop) writes
    while REST handlers read. Sampling is self-timed — ``sample_time_ms``
    accumulates wall time spent inside ``sample()`` so the bench can
    stamp ``health.sampler_overhead_pct`` from measurements, not claims.
    """

    def __init__(self, interval_ms: int = DEFAULT_INTERVAL_MS,
                 retention_points: int = DEFAULT_RETENTION,
                 clock=time.time):
        self.interval_ms = max(1, int(interval_ms))
        self.retention_points = max(2, int(retention_points))
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[str, deque] = {}
        self._kinds: Dict[str, str] = {}
        # (t_ms, total) of the previous sample per counter key — the rate
        # window is sample-to-sample, so it tracks the configured interval
        self._last_totals: Dict[str, Tuple[float, float]] = {}
        self._last_sample_ms: Optional[float] = None
        self.sample_count = 0
        self.sample_time_ms = 0.0

    # -- sampling ----------------------------------------------------------

    def due(self, now_ms: Optional[float] = None) -> bool:
        """Cheap gate for the caller's tick — no lock, no allocation."""
        if now_ms is None:
            now_ms = _now_ms(self._clock)
        last = self._last_sample_ms
        return last is None or (now_ms - last) >= self.interval_ms

    def sample(self, snapshot: Dict[str, Any],
               kinds: Optional[Dict[str, str]] = None,
               now_ms: Optional[float] = None) -> None:
        """Record one point per metric in `snapshot`.

        `snapshot` is the plain-data `metrics_snapshot` form; its reserved
        ``__kinds__`` entry (when present) supplies sampling kinds, merged
        under any explicit `kinds` argument. Unknown keys default to
        gauge semantics. Never raises — observability must not fail the
        job."""
        t0 = time.perf_counter()
        try:
            self._sample_inner(snapshot, kinds, now_ms)
        except Exception:
            pass
        finally:
            self.sample_time_ms += (time.perf_counter() - t0) * 1000.0
            self.sample_count += 1

    def _sample_inner(self, snapshot, kinds, now_ms) -> None:
        if now_ms is None:
            now_ms = _now_ms(self._clock)
        merged_kinds: Dict[str, str] = {}
        embedded = snapshot.get("__kinds__")
        if isinstance(embedded, dict):
            merged_kinds.update(embedded)
        if kinds:
            merged_kinds.update(kinds)
        with self._lock:
            self._last_sample_ms = now_ms
            for key, val in snapshot.items():
                if key.startswith("__"):
                    continue
                kind = merged_kinds.get(key, "gauge")
                if isinstance(val, dict):
                    self._record_hist(key, val, now_ms)
                elif isinstance(val, (int, float)) \
                        and not isinstance(val, bool):
                    if kind == "counter":
                        self._record_rate(key, float(val), now_ms)
                    else:
                        self._record(key, float(val), now_ms, kind)

    def _record(self, key: str, value: float, t_ms: float,
                kind: str) -> None:
        ring = self._series.get(key)
        if ring is None:
            ring = self._series[key] = deque(maxlen=self.retention_points)
            self._kinds[key] = kind
        ring.append((t_ms, value))

    def _record_rate(self, key: str, total: float, t_ms: float) -> None:
        prev = self._last_totals.get(key)
        self._last_totals[key] = (t_ms, total)
        if prev is None:
            return                      # first sight: no window yet
        prev_t, prev_total = prev
        dt_s = (t_ms - prev_t) / 1000.0
        if dt_s <= 0:
            return
        # clamp: a counter rewind (restore from checkpoint) reads as rate
        # 0 — a visible stall, not a nonsense negative rate
        rate = max(0.0, total - prev_total) / dt_s
        self._record(key, rate, t_ms, "counter-rate")

    def _record_hist(self, key: str, stats: Dict[str, Any],
                     t_ms: float) -> None:
        if not any(s in stats for s in _HIST_STATS):
            return                      # not histogram-shaped (e.g. a map)
        for stat in _HIST_STATS:
            v = stats.get(stat)
            if isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and v == v:         # NaN-safe
                self._record(f"{key}.{stat}", float(v), t_ms, "gauge")
        cnt = stats.get("count")
        if isinstance(cnt, (int, float)) and not isinstance(cnt, bool):
            self._record_rate(f"{key}.count", float(cnt), t_ms)

    # -- reads -------------------------------------------------------------

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def snapshot_series(self, since_ms: Optional[float] = None
                        ) -> Dict[str, List[Tuple[float, float]]]:
        """Plain copy of every ring — the doctor's input (it never holds
        the lock or the live store)."""
        with self._lock:
            out = {}
            for key, ring in self._series.items():
                pts = list(ring)
                if since_ms is not None:
                    pts = [p for p in pts if p[0] >= since_ms]
                if pts:
                    out[key] = pts
            return out

    def window(self, suffix: str, window_ms: float,
               now_ms: Optional[float] = None) -> List[Tuple[float, float]]:
        """All points within the last `window_ms` across every key that
        ends with `suffix` (operator scopes prefix the family name), time
        ordered."""
        if now_ms is None:
            now_ms = _now_ms(self._clock)
        cutoff = now_ms - window_ms
        with self._lock:
            pts = [p for key, ring in self._series.items()
                   if key.endswith(suffix)
                   for p in ring if p[0] >= cutoff]
        pts.sort(key=lambda p: p[0])
        return pts

    def payload(self, metric: Optional[str] = None,
                since_ms: Optional[float] = None) -> Dict[str, Any]:
        """REST shape for ``GET /jobs/:id/history?metric=&since=``.

        `metric` filters to keys equal to, suffixed by, or containing the
        string; `since_ms` drops points older than the epoch-ms bound."""
        with self._lock:
            series = {}
            for key, ring in sorted(self._series.items()):
                if metric and not (key == metric or key.endswith(metric)
                                   or metric in key):
                    continue
                pts = list(ring)
                if since_ms is not None:
                    pts = [p for p in pts if p[0] >= since_ms]
                series[key] = {
                    "kind": self._kinds.get(key, "gauge"),
                    "points": [[round(t, 3), v] for t, v in pts],
                }
            return {
                "interval_ms": self.interval_ms,
                "retention_points": self.retention_points,
                "sample_count": self.sample_count,
                "sample_time_ms": round(self.sample_time_ms, 3),
                "series": series,
            }
