"""The port's metric history, job doctor and health watchdog held against
the JAX package's (`flink_tpu_torch/metrics/{history,doctor}.py` against
`flink_tpu/metrics/...`).

Twins of the non-REST cases of tests/test_metrics_history.py: both
packages sample the same snapshots at the same injected times (numpy-made
where the case draws numbers), and their rings, payloads, diagnoses and
watchdog spans must be equal. `sample_time_ms` (the sampler's own host
time) is left out of the comparisons; every other field is compared.

Tolerance: exact.
"""

import types

import numpy as np
import pytest

pytest.importorskip("jax")

import flink_tpu.metrics.doctor as jdoc
import flink_tpu.metrics.history as jhist
import flink_tpu.metrics.registry as jreg
import flink_tpu_torch.metrics.doctor as tdoc
import flink_tpu_torch.metrics.history as thist
import flink_tpu_torch.metrics.registry as treg

PK = {"jax": types.SimpleNamespace(hist=jhist, doc=jdoc, reg=jreg),
      "port": types.SimpleNamespace(hist=thist, doc=tdoc, reg=treg)}
_NOW = 1_000_000.0        # ms


def _twin(fn):
    jax, port = fn(PK["jax"]), fn(PK["port"])
    assert port == jax
    return port


def _payload(h, **kw):
    p = h.payload(**kw)
    p.pop("sample_time_ms")
    return p


def test_history_rates_rewinds_and_histogram_subseries_match_jax():
    def run(pk):
        h = pk.hist.MetricHistory(interval_ms=10, retention_points=64)
        kinds = {"numRecordsIn": "counter", "n": "counter"}
        for t, (recs, lag, n) in enumerate(((0, 5.0, 1000), (500, 7.0, 200), (1500, 9.0, 700))):
            h.sample({"numRecordsIn": recs, "lag": lag, "n": n, "flag": True,
                      "emissionLatencyMs": {"count": 10 * (t + 1) ** 2, "p50": 2.0 + t,
                                            "p99": 9.0 + 3 * t, "mean": 3.0},
                      "recompile_causes": {"a": 1}},
                     kinds=kinds, now_ms=1000.0 * (t + 1))
        return h.snapshot_series(), _payload(h), h.keys()

    series, payload, _keys = _twin(run)
    assert [v for _, v in series["numRecordsIn"]] == [500.0, 1000.0]
    assert [v for _, v in series["n"]] == [0.0, 500.0]
    assert payload["series"]["numRecordsIn"]["kind"] == "counter-rate"


def test_history_retention_due_window_payload_filters_match_jax():
    def run(pk):
        h = pk.hist.MetricHistory(interval_ms=100, retention_points=4)
        due = [h.due(now_ms=0.0)]
        for i in range(10):
            h.sample({"g": float(i), "operator.w-1.watermarkLagMs": 5.0 + i,
                      "operator.w-2.watermarkLagMs": 9.0, "watermarkLagMsTotal": 1.0,
                      "a.rate": 1.0 + i, "b.rate": 2.0 * i},
                     now_ms=i * 100.0)
        due += [h.due(now_ms=950.0), h.due(now_ms=1000.0)]
        h.sample(None, now_ms=1100.0)                 # never raises
        h.sample({"bad": object()}, now_ms=1200.0)
        h.sample({"__folds__": {"x": "sum"}, "x": 1.0}, now_ms=1300.0)
        return (due, h.window("watermarkLagMs", 60000.0, now_ms=1300.0),
                _payload(h, metric="rate"), _payload(h, since_ms=750.0),
                h.snapshot_series(since_ms=800.0), h.sample_count)

    due, window, *_ = _twin(run)
    assert due == [True, False, True] and len(window) == 8


def test_snapshot_kinds_feed_the_history_like_jax():
    """A registry's metrics_snapshot carries its sampling kinds into the
    history (numRecordsIn gauges of kind counter become rates)."""
    rng = np.random.default_rng(2)
    totals = np.cumsum(rng.integers(0, 10_000, size=12))

    def run(pk):
        reg = pk.reg.MetricRegistry()
        g = reg.group("job")
        box = [0]
        g.gauge("numRecordsIn", lambda: int(box[0]), fold="sum", kind="counter")
        g.gauge("currentWatermark", lambda: 42.0, fold="min")
        h = pk.hist.MetricHistory(interval_ms=10)
        for i, t in enumerate(totals):
            box[0] = t
            h.sample(pk.reg.metrics_snapshot(reg.all_metrics()), now_ms=1000.0 * i)
        return _payload(h)

    _twin(run)


def _fill(pk, series, *, t0=_NOW - 55_000, dt=2_500, kinds=None):
    h = pk.hist.MetricHistory(interval_ms=10)
    n = max(len(v) for v in series.values())
    for i in range(n):
        h.sample({k: v[i] for k, v in series.items() if i < len(v)}, kinds=kinds,
                 now_ms=t0 + i * dt)
    return h


_REGIMES = {
    "compile_stall": ({"numRecordsIn": [i * 1000 for i in range(20)]},
                      [{"scope": "device", "name": "XlaCompile",
                        "start_ts_ms": _NOW - 50_000, "end_ts_ms": _NOW - 20_000}]),
    "backpressure": ({"backPressuredTimeRatio": [0.9] * 20,
                      "numRecordsIn": [i * 1000 for i in range(20)]}, []),
    "tier_churn": ({"evictions": [i * 2000 for i in range(20)],
                    "promotions": [i * 2000 for i in range(20)],
                    "residentKeys": [100.0] * 20}, []),
    "restart": ({"numRecordsIn": [i * 10_000 for i in range(15)] + [150_000] * 5},
                [{"scope": "recovery", "name": "JobRestart",
                  "start_ts_ms": _NOW - 12_000, "end_ts_ms": _NOW - 10_000},
                 {"scope": "device", "name": "XlaCompile",
                  "start_ts_ms": _NOW - 50_000, "end_ts_ms": _NOW - 10_000}]),
    "stalls_and_lag": ({"watermarkLagMs": [i * 2_500.0 for i in range(20)],
                        "meshRebalances": [i for i in range(20)],
                        "numRecordsIn": [i * 1000 for i in range(20)]},
                       [{"scope": "latency", "name": "EmissionStall",
                         "start_ts_ms": _NOW - 3_000, "end_ts_ms": _NOW - 2_000},
                        {"scope": "rebalance", "name": "MeshRebalance",
                         "start_ts_ms": _NOW - 9_000, "end_ts_ms": _NOW - 8_000},
                        {"scope": "health", "name": "WatermarkStall",
                         "start_ts_ms": _NOW - 1_000, "end_ts_ms": _NOW - 1_000}]),
    "healthy": ({"numRecordsIn": [i * 1000 for i in range(20)]}, []),
}


@pytest.mark.parametrize("regime", sorted(_REGIMES))
def test_doctor_diagnoses_match_jax(regime):
    series, spans = _REGIMES[regime]
    kinds = {"numRecordsIn": "counter", "evictions": "counter", "promotions": "counter",
             "meshRebalances": "counter"}

    def run(pk):
        return pk.doc.diagnose(_fill(pk, series, kinds=kinds), spans, now_ms=_NOW)

    doc = _twin(run)
    want = {"compile_stall": "compile-stall", "backpressure": "backpressure",
            "tier_churn": "tier-churn", "restart": "recovery-restart",
            "healthy": "healthy"}
    if regime in want:
        assert doc["verdict"] == want[regime]
    _twin(lambda pk: pk.doc.diagnose(pk.hist.MetricHistory(), [], now_ms=_NOW))


def test_watchdog_spans_and_rate_limits_match_jax():
    now = 100_000.0

    def run(pk):
        h = pk.hist.MetricHistory(interval_ms=10)
        totals = [i * 10_000 for i in range(12)] + [120_000] * 4
        for i, t in enumerate(totals):
            h.sample({"numRecordsIn": t}, kinds={"numRecordsIn": "counter"},
                     now_ms=now - 30_000 + i * 2_000)
        spans = []
        wd = pk.doc.HealthWatchdog(lambda *a: spans.append(a), min_gap_ms=5_000,
                                   window_ms=30_000)
        events = []
        for dt in (0, 1_000, 6_000):
            wd.observe(h, now_ms=now + dt)
            events.append(wd.events)
        h2 = pk.hist.MetricHistory(interval_ms=10)
        for i in range(8):
            h2.sample({"watermarkLagMs": i * 2_000.0, "backPressuredTimeRatio": 0.95,
                       "emissionLatencyMs": {"count": i + 1, "p50": 1.0, "p99": 40.0}},
                      now_ms=now - 16_000 + i * 2_000)
        spans2, spans3 = [], []
        pk.doc.HealthWatchdog(lambda *a: spans2.append(a), min_gap_ms=1, window_ms=30_000,
                              p99_breach_ms=25.0).observe(h2, now_ms=now)
        pk.doc.HealthWatchdog(lambda *a: spans3.append(a), min_gap_ms=1).observe(h2, now_ms=now)

        def boom(*a):
            raise RuntimeError("sink died")

        pk.doc.HealthWatchdog(boom, min_gap_ms=1, p99_breach_ms=25.0).observe(h2, now_ms=now)
        return spans, events, spans2, spans3

    spans, events, spans2, spans3 = _twin(run)
    assert events == [1, 1, 2]
    assert {"WatermarkStall", "BackpressureSaturation", "P99Breach"} <= {s[1] for s in spans2}
    assert "P99Breach" not in {s[1] for s in spans3}
