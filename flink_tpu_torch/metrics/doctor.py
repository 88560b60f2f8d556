"""Job doctor: ranked, evidence-attributed bottleneck diagnosis.

Counterpart of `flink_tpu/metrics/doctor.py`, copied (it is jax-free).

`diagnose()` joins the recent history windows across every observability
plane (backpressure ratios, phase counters, roofline gauges, tier
evictions/promotions, controller gauges, watermark lag) with the span
stream (`device.XlaCompile`, `checkpointing.*`, `recovery.JobRestart`,
rebalance, `latency.EmissionStall`) into a ranked list of diagnoses, each
carrying the evidence that produced its score. Served at
``GET /jobs/:id/doctor`` on both REST paths, rendered as a dashboard
panel, and stamped as the ``health`` block into every BENCH_*.json.

`HealthWatchdog` is the proactive half: it watches the same history rings
and turns threshold breaches — throughput collapse against the job's own
recent baseline, watermark stall, backpressure saturation, emission-p99
breach — into rate-limited ``health.*`` spans through the existing span
sink, so a breach is visible in the trace timeline (and the flamegraph)
even when nobody polled the doctor.

Scores are normalized to [0, 1]; a family crosses into the verdict at
``VERDICT_THRESHOLD``. When restarts landed inside the window, the
symptom families a restart *explains* (throughput collapse, watermark
stall, emission stall, the recompile burst) are attenuated and marked
``explained_by``, so the root cause outranks its own symptoms.

This module imports neither torch nor the runtime: it consumes a
`MetricHistory` and a list of span dicts handed to it. On the port the
doctor is served by `JobClient.doctor_report`; its REST route is ROADMAP
item 14. The `device.XlaCompile` spans it reads come from the device
plane's compile tracker (metrics/device_stats.py).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["diagnose", "HealthWatchdog", "VERDICT_THRESHOLD",
           "HEALTH_SPAN_SCOPE"]

VERDICT_THRESHOLD = 0.5
HEALTH_SPAN_SCOPE = "health"

# span sink signature shared with the emission-latency plane:
# (scope, name, start_ms, end_ms, attrs)
SpanSink = Callable[[str, str, float, float, Dict[str, Any]], None]

# symptom families a restart in the window explains — attenuated so the
# recovery-restart root cause outranks them. compile-stall is included
# (a restart rebuilds every executable, so the compile burst that
# follows is recovery fallout, not an independent compile regression);
# so are the churn families (the rebuilt attempt remaps its routing
# table and re-materializes its resident tier from the restored state)
_RESTART_SYMPTOMS = ("throughput-collapse", "watermark-stall",
                     "emission-stall", "compile-stall",
                     "rebalance-churn", "tier-churn")
_RESTART_ATTENUATION = 0.4


def _mean(vals: List[float]) -> float:
    return sum(vals) / len(vals) if vals else 0.0


def _clip01(x: float) -> float:
    return 0.0 if x < 0.0 else (1.0 if x > 1.0 else x)


def _vals(pts: List[Tuple[float, float]]) -> List[float]:
    return [v for _, v in pts]


def _span_overlap_ms(span: Dict[str, Any], lo: float, hi: float) -> float:
    """Milliseconds of `span` inside [lo, hi] (0 if disjoint/malformed).
    Span dicts carry `start_ts_ms`/`end_ts_ms` (traces.Span.to_dict). A
    zero-length span ON the window edge still counts via the half-open
    membership check below, but contributes 0 ms."""
    try:
        s = float(span.get("start_ts_ms", 0.0))
        e = float(span.get("end_ts_ms", s))
    except (TypeError, ValueError):
        return 0.0
    return max(0.0, min(e, hi) - max(s, lo))


def _span_in_window(span: Dict[str, Any], lo: float, hi: float) -> bool:
    """Interval overlap, inclusive — a point span (watchdog health.*
    spans have start == end) inside the window must count even though
    its overlap length is 0 ms."""
    try:
        s = float(span.get("start_ts_ms", 0.0))
        e = float(span.get("end_ts_ms", s))
    except (TypeError, ValueError):
        return False
    return e >= lo and s <= hi


def _spans_in(spans: List[Dict[str, Any]], lo: float, hi: float,
              scope: Optional[str] = None,
              name: Optional[str] = None) -> List[Dict[str, Any]]:
    out = []
    for sp in spans or ():
        if scope is not None and sp.get("scope") != scope:
            continue
        if name is not None and sp.get("name") != name:
            continue
        if _span_in_window(sp, lo, hi):
            out.append(sp)
    return out


def _rate_collapse(pts: List[Tuple[float, float]], lo: float, hi: float
                   ) -> Tuple[float, Dict[str, Any]]:
    """Recent quarter of the window vs the prior baseline: a recent mean
    at half the baseline scores 1.0. Needs a real baseline (>= 4 points
    and a non-trivial rate) so startup never reads as a collapse."""
    split = hi - (hi - lo) / 4.0
    base = _vals([p for p in pts if p[0] < split])
    recent = _vals([p for p in pts if p[0] >= split])
    if len(base) < 3 or not recent:
        return 0.0, {}
    base_mean = _mean(base)
    recent_mean = _mean(recent)
    if base_mean <= 1e-9:
        return 0.0, {}
    drop = 1.0 - recent_mean / base_mean
    score = _clip01(drop / 0.5)
    return score, {
        "baseline_rate": round(base_mean, 3),
        "recent_rate": round(recent_mean, 3),
        "drop_fraction": round(max(0.0, drop), 4),
    }


def _lag_slope(pts: List[Tuple[float, float]]) -> Tuple[float, float]:
    """(slope, latest) of a watermark-lag series — slope in lag-ms per
    wall-ms; a frozen watermark under advancing time slopes at ~1.0."""
    if len(pts) < 3:
        return 0.0, (pts[-1][1] if pts else 0.0)
    t0, v0 = pts[0]
    t1, v1 = pts[-1]
    dt = t1 - t0
    if dt <= 0:
        return 0.0, v1
    return (v1 - v0) / dt, v1


def diagnose(history, spans: Optional[List[Dict[str, Any]]] = None, *,
             now_ms: Optional[float] = None,
             window_ms: float = 60000.0) -> Dict[str, Any]:
    """Rank bottleneck families over the last `window_ms` of history +
    spans. Returns ``{"verdict", "score", "diagnoses": [...], "window_ms",
    "samples"}`` — diagnoses sorted most-severe first, each
    ``{"family", "score", "evidence"}``."""
    spans = spans or []
    if now_ms is None:
        now_ms = time.time() * 1000.0
    lo, hi = now_ms - window_ms, now_ms
    win = lambda suffix: history.window(suffix, window_ms, now_ms=now_ms)

    diagnoses: List[Dict[str, Any]] = []

    def add(family: str, score: float, evidence: Dict[str, Any]) -> None:
        if score > 0.0:
            diagnoses.append({"family": family,
                              "score": round(_clip01(score), 4),
                              "evidence": evidence})

    # -- recovery-restart: restarts in the window are categorically the
    #    dominant event; symptom families below get attenuated
    restarts = _spans_in(spans, lo, hi, scope="recovery", name="JobRestart")
    if restarts:
        n = len(restarts)
        add("recovery-restart", 0.7 + 0.3 * _clip01((n - 1) / 2.0), {
            "restarts_in_window": n,
            "restart_ms": round(sum(_span_overlap_ms(s, lo, hi)
                                    for s in restarts), 3),
        })

    def attenuated(family: str, score: float,
                   evidence: Dict[str, Any]) -> None:
        if restarts and family in _RESTART_SYMPTOMS:
            evidence = dict(evidence, explained_by="recovery-restart")
            # clip BEFORE attenuating: a hugely over-threshold symptom
            # must still land below the root cause, not clip back to 1.0
            score = _clip01(score) * _RESTART_ATTENUATION
        add(family, score, evidence)

    # -- compile-stall: device.XlaCompile span share of the window
    compiles = _spans_in(spans, lo, hi, scope="device", name="XlaCompile")
    compile_ms = sum(_span_overlap_ms(s, lo, hi) for s in compiles)
    if compiles:
        # the window may extend before the job started — normalize by the
        # observed span of activity, bounded below to dodge division blowup
        seen = [p[0] for p in win("numRecordsIn")] or [lo]
        active_ms = max(hi - min(seen), compile_ms, 1.0)
        share = compile_ms / active_ms
        attenuated("compile-stall", share / 0.3, {
            "compiles_in_window": len(compiles),
            "compile_ms": round(compile_ms, 3),
            "time_share": round(share, 4),
        })

    # -- backpressure: mean backPressuredTimeRatio over the window
    bp = _vals(win("backPressuredTimeRatio"))
    if bp:
        mean_bp = _mean(bp)
        add("backpressure", mean_bp / 0.8, {
            "mean_backpressured_ratio": round(mean_bp, 4),
            "points": len(bp),
        })

    # -- tier-churn: eviction+promotion rate vs resident keys (>=10% of
    #    the resident set churning per second saturates the score)
    churn = _mean(_vals(win("evictions"))) + _mean(_vals(win("promotions")))
    if churn > 0.0:
        resident = _mean(_vals(win("residentKeys")))
        ref = max(1.0, 0.1 * resident) if resident > 0 else 50.0
        attenuated("tier-churn", churn / ref, {
            "churn_per_sec": round(churn, 3),
            "mean_resident_keys": round(resident, 1),
        })

    # -- rebalance-churn: rebalance spans + routing-table movement
    rebalances = [sp for sp in _spans_in(spans, lo, hi)
                  if sp.get("scope") == "rebalance"
                  or "Rebalance" in str(sp.get("name", ""))]
    rb_rate = _mean(_vals(win("meshRebalances")))
    if rebalances or rb_rate > 0.0:
        attenuated("rebalance-churn",
                   _clip01(len(rebalances) / 3.0 + rb_rate / 1.0), {
                "rebalance_spans": len(rebalances),
                "mesh_rebalances_per_sec": round(rb_rate, 4),
            })

    # -- emission-stall: latency.EmissionStall outlier spans
    stalls = _spans_in(spans, lo, hi, scope="latency", name="EmissionStall")
    if stalls:
        stall_ms = sum(_span_overlap_ms(s, lo, hi) for s in stalls)
        attenuated("emission-stall", len(stalls) / 3.0 + stall_ms / 1000.0, {
            "stalls_in_window": len(stalls),
            "stall_ms": round(stall_ms, 3),
        })

    # -- watermark-stall: lag growing at wall speed means the watermark
    #    froze (slope ~1.0); half wall speed scores 1.0
    lag_pts = win("watermarkLagMs")
    slope, latest_lag = _lag_slope(lag_pts)
    if slope > 0.05:
        attenuated("watermark-stall", slope / 0.5, {
            "lag_slope": round(slope, 4),
            "latest_lag_ms": round(latest_lag, 3),
        })

    # -- throughput-collapse vs the job's own recent baseline
    c_score, c_ev = _rate_collapse(win("numRecordsIn"), lo, hi)
    if c_score > 0.0:
        attenuated("throughput-collapse", c_score, c_ev)

    diagnoses.sort(key=lambda d: d["score"], reverse=True)
    samples = getattr(history, "sample_count", 0)
    watchdog_events = len([sp for sp in spans
                           if sp.get("scope") == HEALTH_SPAN_SCOPE
                           and _span_in_window(sp, lo, hi)])
    if diagnoses and diagnoses[0]["score"] >= VERDICT_THRESHOLD:
        verdict = diagnoses[0]["family"]
        score = diagnoses[0]["score"]
    elif samples > 0:
        verdict, score = "healthy", 0.0
    else:
        verdict, score = "unknown", 0.0
    return {
        "verdict": verdict,
        "score": score,
        "diagnoses": diagnoses,
        "window_ms": window_ms,
        "samples": samples,
        "watchdog_events": watchdog_events,
    }


class HealthWatchdog:
    """Threshold watchdog emitting rate-limited ``health.*`` spans.

    Observes the same history rings the doctor reads, on the same tick
    that samples them. Each breach family emits at most one span per
    `min_gap_ms`; span attrs carry the numbers that crossed the line.
    Never raises — observability must not fail the job."""

    def __init__(self, span_sink: SpanSink, *,
                 min_gap_ms: float = 5000.0,
                 window_ms: float = 30000.0,
                 collapse_ratio: float = 0.5,
                 bp_ratio: float = 0.8,
                 stall_slope: float = 0.5,
                 p99_breach_ms: float = 0.0,
                 clock=time.time):
        self._sink = span_sink
        self.min_gap_ms = float(min_gap_ms)
        self.window_ms = float(window_ms)
        self.collapse_ratio = float(collapse_ratio)
        self.bp_ratio = float(bp_ratio)
        self.stall_slope = float(stall_slope)
        self.p99_breach_ms = float(p99_breach_ms)
        self._clock = clock
        self._lock = threading.Lock()
        self._last_emit: Dict[str, float] = {}
        self.events = 0

    def _emit(self, name: str, now_ms: float,
              attrs: Dict[str, Any]) -> None:
        with self._lock:
            last = self._last_emit.get(name)
            if last is not None and now_ms - last < self.min_gap_ms:
                return
            self._last_emit[name] = now_ms
            self.events += 1
        try:
            self._sink(HEALTH_SPAN_SCOPE, name, now_ms, now_ms, attrs)
        except Exception:
            pass

    def observe(self, history, now_ms: Optional[float] = None) -> None:
        try:
            self._observe_inner(history, now_ms)
        except Exception:
            pass

    def _observe_inner(self, history, now_ms) -> None:
        if now_ms is None:
            now_ms = self._clock() * 1000.0
        w = self.window_ms
        lo = now_ms - w

        # throughput collapse vs the job's own recent baseline
        pts = history.window("numRecordsIn", w, now_ms=now_ms)
        score, ev = _rate_collapse(pts, lo, now_ms)
        if ev and ev["recent_rate"] < self.collapse_ratio * ev["baseline_rate"]:
            self._emit("ThroughputCollapse", now_ms, ev)

        # watermark stall
        slope, latest = _lag_slope(history.window("watermarkLagMs", w,
                                                  now_ms=now_ms))
        if slope >= self.stall_slope:
            self._emit("WatermarkStall", now_ms, {
                "lag_slope": round(slope, 4),
                "latest_lag_ms": round(latest, 3)})

        # backpressure saturation
        bp = _vals(history.window("backPressuredTimeRatio", w,
                                  now_ms=now_ms))
        if bp and _mean(bp) >= self.bp_ratio:
            self._emit("BackpressureSaturation", now_ms, {
                "mean_backpressured_ratio": round(_mean(bp), 4)})

        # emission p99 breach (opt-in: 0 disables)
        if self.p99_breach_ms > 0.0:
            p99 = _vals(history.window("emissionLatencyMs.p99", w,
                                       now_ms=now_ms))
            if p99 and p99[-1] > self.p99_breach_ms:
                self._emit("P99Breach", now_ms, {
                    "p99_ms": round(p99[-1], 3),
                    "breach_ms": self.p99_breach_ms})
