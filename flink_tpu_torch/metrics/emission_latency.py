"""Emission-latency plane: event-time close → host-visible result.

Counterpart of `flink_tpu/metrics/emission_latency.py`, copied (it is
jax-free). On the port a fire is host-visible after its readback's wait
(`utils/device.py::HostCopy`), and operators stamp there.

The marker plane (StepRunner.on_marker) measures *pipeline transit* of a
wall-clock stamp; what a serving user feels is different — the delay from
a window's event-time close (`window.end + allowed_lateness`, the instant
the result *could* exist) to the moment its rows are actually resolved on
the host. This module is that quantity as a first-class metric:

- `EmissionHistogram` — an HDR-style log-bucketed histogram (power-of-two
  octaves, 8 sub-buckets each, ≤12.5% relative error). Its snapshot is a
  FLAT numeric dict (`b<idx>` keys carry the buckets), so it survives
  `metrics_snapshot`'s numeric-only filter, ships on TM heartbeats
  unchanged, and merges bucket-wise across mesh shards with exact
  percentile recomputation — unlike the reservoir `Histogram`, whose
  quantiles cannot be folded.
- `EmissionLatencyTracker` — the per-operator recorder. Operators call
  `record_fire(window_end_ms, ...)` exactly where deferred emissions
  resolve (never earlier: stamping a dispatch would measure the wrong
  thing; never via a forced sync: the call sites are already host-side).
  Outliers above a configured percentile land in a bounded ring AND are
  reported as `latency`-scope spans through whatever span sink the
  runtime wired (TraceRegistry on the MiniCluster path, the TM's
  heartbeat span buffer on the distributed path) — which is what makes
  tail attribution work identically everywhere, OTLP export included.
- `stall_attribution` / `build_latency_report` — pure functions that
  join outlier spans against concurrent control-plane spans (checkpoint
  trigger/align, restart/rescale rebuild, rebalance, degrade-replay,
  XLA recompile) by interval overlap: the report behind
  `GET /jobs/:id/latency` and the dashboard panel.

Int64 safety: window ends at the MIN/MAX watermark sentinels (global
windows fire at MAX_WATERMARK; a terminal watermark closes everything)
carry no meaningful event-time close — `record_fire` counts them in
`sentinel` instead of poisoning the histogram with ±2^63 arithmetic.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

# -- log-bucketed histogram geometry ------------------------------------

SUBBUCKETS = 8           # per octave; relative error <= 1/8
_OCTAVES = 42            # covers (1ms, 2^42 ms] ~ 139 years
NUM_BUCKETS = 1 + _OCTAVES * SUBBUCKETS
_MAX_MS = float(1 << _OCTAVES)
# event-time sanity band: epoch-ms values far outside it are watermark
# sentinels (MIN_WATERMARK/MAX_WATERMARK are ±2^63-ish), not timestamps
_SANE_EVENT_MS = float(1 << 52)


def bucket_index(value_ms: float) -> int:
    """Bucket of a latency value; <=1ms collapses into bucket 0."""
    v = min(float(value_ms), _MAX_MS)
    if not v > 1.0 or v != v:        # <=1, negative, or NaN
        return 0
    m, e = math.frexp(v)             # v = m * 2^e, m in [0.5, 1)
    octave = e - 1                   # 2^octave <= v < 2^(octave+1)
    sub = min(SUBBUCKETS - 1,
              int((v / float(1 << octave) - 1.0) * SUBBUCKETS))
    return min(NUM_BUCKETS - 1, 1 + octave * SUBBUCKETS + sub)


def bucket_upper(idx: int) -> float:
    """Inclusive upper bound of a bucket — the reported percentile value."""
    if idx <= 0:
        return 1.0
    octave, sub = divmod(idx - 1, SUBBUCKETS)
    return float(1 << octave) * (1.0 + (sub + 1) / SUBBUCKETS)


class EmissionHistogram:
    """Mergeable log-bucketed latency histogram (sparse bucket counts)."""

    __slots__ = ("buckets", "count", "min", "max", "sum")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.min = math.inf
        self.max = 0.0
        self.sum = 0.0

    def record(self, value_ms: float, n: int = 1) -> None:
        if n <= 0:
            return
        v = max(0.0, min(float(value_ms), _MAX_MS))
        idx = bucket_index(v)
        self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.count += n
        self.sum += v * n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def value_at(self, pct: float) -> float:
        """Upper bound of the bucket where the cumulative count crosses
        `pct` percent of the total (0 on an empty histogram)."""
        if self.count == 0:
            return 0.0
        need = max(1, math.ceil(self.count * min(max(pct, 0.0), 100.0)
                                / 100.0))
        seen = 0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= need:
                # never report past the observed max (top bucket is coarse)
                return min(bucket_upper(idx), self.max) if self.max else 0.0
        return self.max

    def merge(self, other: "EmissionHistogram") -> "EmissionHistogram":
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def snapshot(self) -> Dict[str, float]:
        """Flat numeric dict: survives metrics_snapshot, folds bucket-wise
        (merge_snapshots), renders as a Prometheus summary (has `count`)."""
        out: Dict[str, float] = {
            "count": self.count,
            "min": 0.0 if self.count == 0 else round(self.min, 3),
            "max": round(self.max, 3),
            "mean": 0.0 if self.count == 0 else round(self.sum / self.count, 3),
            "p50": round(self.value_at(50.0), 3),
            "p95": round(self.value_at(95.0), 3),
            "p99": round(self.value_at(99.0), 3),
            "p999": round(self.value_at(99.9), 3),
        }
        for idx in sorted(self.buckets):
            out[f"b{idx}"] = self.buckets[idx]
        return out

    @staticmethod
    def from_snapshot(snap: Dict[str, Any]) -> "EmissionHistogram":
        h = EmissionHistogram()
        for k, n in snap.items():
            if k.startswith("b") and k[1:].isdigit():
                h.buckets[int(k[1:])] = int(n)
        h.count = int(snap.get("count", sum(h.buckets.values())))
        h.min = float(snap.get("min", 0.0)) if h.count else math.inf
        h.max = float(snap.get("max", 0.0))
        h.sum = float(snap.get("mean", 0.0)) * h.count
        return h


def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, float]:
    """Bucket-wise fold of shard snapshots — the `aggregate_shard_metrics`
    rule for emission histograms. Associative and commutative: percentiles
    are recomputed from the merged buckets, never averaged."""
    merged = EmissionHistogram()
    for s in snaps:
        if isinstance(s, dict):
            merged.merge(EmissionHistogram.from_snapshot(s))
    return merged.snapshot()


def is_emission_snapshot(d: Dict[str, Any]) -> bool:
    return "count" in d and any(
        k.startswith("b") and k[1:].isdigit() for k in d)


def watermark_lag_ms(current_watermark: Any,
                     now_ms: Optional[float] = None) -> float:
    """Wall clock minus the operator's watermark, int64-safe: before the
    first watermark (MIN sentinel) and past the terminal MAX sentinel the
    lag is reported as 0 — there is nothing to lag behind."""
    try:
        wm = float(current_watermark)
    except (TypeError, ValueError):
        return 0.0
    if not (-_SANE_EVENT_MS < wm < _SANE_EVENT_MS) or wm <= 0:
        return 0.0
    now = time.time() * 1000.0 if now_ms is None else now_ms
    return round(max(0.0, min(now - wm, _MAX_MS)), 3)


# -- per-operator recorder ----------------------------------------------

SpanSink = Callable[[str, str, float, float, Dict[str, Any]], None]

LATENCY_SPAN_SCOPE = "latency"
LATENCY_SPAN_NAME = "EmissionStall"


class EmissionLatencyTracker:
    """Per-operator emission-latency recorder with outlier capture.

    `record_fire` is called at the host-resolve instant of every fired
    window; the call sites are already host-side (after `.resolve()` or
    inside a synchronous fire loop), so recording never adds a device
    sync. Cost with defaults on: one clock read + one dict update per
    fire batch — fires are superbatch-granular, not per-record.
    """

    def __init__(self, operator_uid: str, *,
                 outlier_pct: float = 99.0,
                 outlier_floor_ms: float = 5.0,
                 ring_size: int = 64,
                 min_samples: int = 16,
                 span_sink: Optional[SpanSink] = None,
                 span_min_gap_ms: float = 100.0,
                 clock=time.time) -> None:
        self.operator_uid = operator_uid
        self.histogram = EmissionHistogram()
        self.outlier_pct = float(outlier_pct)
        self.outlier_floor_ms = float(outlier_floor_ms)
        self.min_samples = max(1, int(min_samples))
        self.outliers: List[Dict[str, float]] = []
        self._ring = max(1, int(ring_size))
        self.span_sink = span_sink
        self._span_gap = float(span_min_gap_ms)
        self._last_span_ms = -math.inf
        self._clock = clock
        self._thr = math.inf
        self.sentinel = 0            # fires with no event-time close
        # liveness bound for outlier stall intervals: a stall cannot
        # predate the operator's birth or its previous resolve — without
        # this, synthetic-epoch jobs (event time near 1970) would report
        # stall spans covering all of history and attribution would
        # degenerate to "whichever control span is longest"
        self._last_resolve_ms = clock() * 1000.0

    def record_fire(self, window_end_ms: Any, *, lateness_ms: float = 0,
                    count: int = 1) -> Optional[float]:
        """Record one resolved fire; returns the latency, or None when the
        window end is a watermark sentinel (global/terminal windows)."""
        try:
            end = float(window_end_ms)
        except (TypeError, ValueError):
            return None
        if not (0.0 < end < _SANE_EVENT_MS):
            self.sentinel += max(1, int(count))
            return None
        now = self._clock() * 1000.0
        due = end + float(lateness_ms)
        lat = max(0.0, now - due)
        self.histogram.record(lat, max(1, int(count)))
        # refresh the outlier threshold every 32 fires (value_at walks the
        # sparse buckets; keeping it off the per-fire path keeps the plane
        # under its <2% throughput budget)
        if self.histogram.count & 31 == 0 or self._thr is math.inf:
            self._thr = max(self.histogram.value_at(self.outlier_pct),
                            self.outlier_floor_ms)
        if self.histogram.count >= self.min_samples and lat >= self._thr:
            self._capture_outlier(max(due, self._last_resolve_ms), now, lat)
        self._last_resolve_ms = now
        return lat

    def _capture_outlier(self, due_ms: float, now_ms: float,
                         lat_ms: float) -> None:
        self.outliers.append({
            "resolveWallMs": round(now_ms, 3),
            "latencyMs": round(lat_ms, 3),
        })
        del self.outliers[:-self._ring]
        sink = self.span_sink
        if sink is not None and now_ms - self._last_span_ms >= self._span_gap:
            self._last_span_ms = now_ms
            try:
                sink(LATENCY_SPAN_SCOPE, LATENCY_SPAN_NAME, due_ms, now_ms,
                     {"operator": self.operator_uid,
                      "latencyMs": round(lat_ms, 3)})
            except Exception:
                pass                 # observability must never fail the job

    def snapshot(self) -> Dict[str, float]:
        out = self.histogram.snapshot()
        if self.sentinel:
            out["sentinel"] = self.sentinel
        return out


# -- tail attribution ----------------------------------------------------

def _span_fields(s: Any) -> Tuple[str, str, float, float, Dict[str, Any]]:
    if isinstance(s, dict):
        return (s.get("scope", ""), s.get("name", ""),
                float(s.get("start_ts_ms", 0.0)),
                float(s.get("end_ts_ms", 0.0)),
                dict(s.get("attributes") or {}))
    return (s.scope, s.name, float(s.start_ts_ms), float(s.end_ts_ms),
            dict(s.attributes or {}))


def stall_attribution(spans: List[Any], *,
                      slack_ms: float = 50.0) -> Dict[str, Any]:
    """Join `latency`-scope outlier spans against every concurrent
    control-plane span by interval overlap. The owner of an outlier is
    the control span with the largest overlap of its stall interval
    `[due, resolve]`; outliers no control span touches stay unattributed
    (the stall was the data plane itself: superbatch depth, readback)."""
    outliers, controls = [], []
    for s in spans:
        scope, name, start, end, attrs = _span_fields(s)
        if scope == LATENCY_SPAN_SCOPE:
            outliers.append((start, end, attrs))
        else:
            controls.append((f"{scope}.{name}", start, end))
    attributed: Dict[str, Dict[str, float]] = {}
    unattributed = 0
    for start, end, attrs in outliers:
        best, best_overlap = None, 0.0
        for key, cs, ce in controls:
            overlap = min(end + slack_ms, ce) - max(start - slack_ms, cs)
            if overlap > best_overlap:
                best, best_overlap = key, overlap
        if best is None:
            unattributed += 1
            continue
        blk = attributed.setdefault(best, {"count": 0, "maxLatencyMs": 0.0})
        blk["count"] += 1
        blk["maxLatencyMs"] = max(blk["maxLatencyMs"],
                                  float(attrs.get("latencyMs", 0.0)))
    return {"outliers": len(outliers), "attributed": attributed,
            "unattributed": unattributed}


_EMISSION_SUFFIX = ".emissionLatencyMs"
_LAG_SUFFIX = ".watermarkLagMs"


def build_latency_report(metrics: Dict[str, Any], spans: List[Any], *,
                         slack_ms: float = 50.0) -> Dict[str, Any]:
    """The `GET /jobs/:id/latency` payload, from a flat metric mapping
    (job-level `metrics_snapshot` on the MiniCluster path, the shard-folded
    aggregate on the JM path — both carry the same key shapes) plus the
    job's span log."""
    operators: Dict[str, Dict[str, Any]] = {}
    per_op_snaps: List[Dict[str, Any]] = []
    for name, val in metrics.items():
        if name.endswith(_EMISSION_SUFFIX) and isinstance(val, dict):
            uid = name[:-len(_EMISSION_SUFFIX)].rsplit(".", 1)[-1]
            operators.setdefault(uid, {})["emissionLatencyMs"] = val
            per_op_snaps.append(val)
        elif name.endswith(_LAG_SUFFIX):
            uid = name[:-len(_LAG_SUFFIX)].rsplit(".", 1)[-1]
            try:
                operators.setdefault(uid, {})["watermarkLagMs"] = float(val)
            except (TypeError, ValueError):
                pass
    merged = merge_snapshots(per_op_snaps)
    lags = [op["watermarkLagMs"] for op in operators.values()
            if "watermarkLagMs" in op]
    return {
        "operators": operators,
        "emission": {k: v for k, v in merged.items()
                     if not k.startswith("b")},
        "p50_ms": merged.get("p50", 0.0),
        "p99_ms": merged.get("p99", 0.0),
        "p999_ms": merged.get("p999", 0.0),
        "samples": merged.get("count", 0),
        "watermarkLagMs": max(lags) if lags else 0.0,
        "latency_mode": _latency_mode_block(metrics),
        "attribution": stall_attribution(spans, slack_ms=slack_ms),
    }


#: the latency-mode controller gauge family the report folds — the same
#: leaves cluster._LATENCY_CONTROLLER_GAUGES MAX-folds across shards
_CONTROLLER_LEAVES = ("latencyModeActive", "currentBatchRung",
                      "inflightDepth", "ladderRecompiles")


def _latency_mode_block(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Controller decisions in the /jobs/:id/latency report: worst-shard
    (MAX) fold of the execution.latency.* gauges. `active` False with all
    zeros when the mode is off — the report shape never changes with the
    flag, only the values."""
    folded = {leaf: 0 for leaf in _CONTROLLER_LEAVES}
    for name, val in metrics.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in folded:
            try:
                folded[leaf] = max(folded[leaf], int(val))
            except (TypeError, ValueError):
                pass
    return {
        "active": bool(folded["latencyModeActive"]),
        "currentBatchRung": folded["currentBatchRung"],
        "inflightDepth": folded["inflightDepth"],
        "ladderRecompiles": folded["ladderRecompiles"],
    }
