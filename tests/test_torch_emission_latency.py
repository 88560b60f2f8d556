"""The port's emission-latency plane held against the JAX package's.

Twins of tests/test_emission_latency.py: `flink_tpu_torch/metrics/
emission_latency.py` and `flink_tpu/metrics/emission_latency.py` are fed
the same numpy-made latencies and the same injected clocks, and their
bucket geometry, snapshots, percentiles, merges, outlier rings, EmissionStall
spans, stall attribution and latency reports must be equal. Then each
operator family's stamp site (fused, per-batch, session, global count,
oracle, device join) is held against the JAX operator's on the same job:
the same number of stamped fires, the same sentinel count.

Tolerance: exact (the same float arithmetic on the same inputs).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import flink_tpu.metrics.emission_latency as jel
import flink_tpu.metrics.registry as jreg
import flink_tpu_torch.metrics.emission_latency as tel
import flink_tpu_torch.metrics.registry as treg

MAX_WATERMARK = (1 << 63) - 1
MIN_WATERMARK = -(1 << 63)
BOTH = (jel, tel)


def _twin(fn):
    """fn(module) in both packages: equal results, returned once."""
    out_jax, out_port = (fn(m) for m in BOTH)
    assert out_port == out_jax
    return out_port


def test_constants_and_bucket_geometry_match_jax():
    assert (tel.SUBBUCKETS, tel.NUM_BUCKETS, tel.LATENCY_SPAN_SCOPE, tel.LATENCY_SPAN_NAME) == (
        jel.SUBBUCKETS, jel.NUM_BUCKETS, jel.LATENCY_SPAN_SCOPE, jel.LATENCY_SPAN_NAME)
    rng = np.random.default_rng(7)
    vals = [0.0, 0.5, 1.0, -3.0, float("nan"), 1.0001, 2.0, float(1 << 60)]
    vals += rng.uniform(1.001, 1e9, size=500).tolist()
    vals += np.sort(rng.uniform(0.0, 1e12, size=500)).tolist()
    got = _twin(lambda m: [m.bucket_index(v) for v in vals])
    assert got[-500:] == sorted(got[-500:])     # monotone in the value
    _twin(lambda m: [m.bucket_upper(i) for i in range(m.NUM_BUCKETS)])


@pytest.mark.parametrize("seed", [0, 11, 23])
def test_histogram_snapshots_and_percentiles_match_jax(seed):
    rng = np.random.default_rng(seed)
    lat = rng.lognormal(3.0, 2.0, size=600)
    weights = rng.integers(1, 5, size=600)

    def run(m):
        h = m.EmissionHistogram()
        for v, n in zip(lat, weights):
            h.record(float(v), n=int(n))
        h.record(10_000.0, n=10)       # an adversarial tail
        return (h.snapshot(), [h.value_at(p) for p in (0.0, 50.0, 95.0, 99.0, 99.9, 100.0)],
                m.EmissionHistogram.from_snapshot(h.snapshot()).snapshot())

    _twin(run)


def test_merges_and_snapshot_predicates_match_jax():
    rng = np.random.default_rng(11)
    chunks = [rng.lognormal(3.0, 2.0, size=200) for _ in range(3)]

    def run(m):
        snaps = []
        for c in chunks:
            h = m.EmissionHistogram()
            for v in c:
                h.record(float(v))
            snaps.append(h.snapshot())
        return (m.merge_snapshots([m.merge_snapshots(snaps[:2]), snaps[2]]),
                m.merge_snapshots(list(reversed(snaps))), m.merge_snapshots([]),
                m.is_emission_snapshot(snaps[0]), m.is_emission_snapshot({"count": 3}))

    merged = _twin(run)
    assert merged[0] == merged[1] and merged[0]["count"] == 600


def test_watermark_lag_and_sentinels_match_jax():
    now = 1_700_000_000_000.0
    wms = [MIN_WATERMARK, MAX_WATERMARK, 0, None, "x", now - 250.0, now + 10_000.0]
    _twin(lambda m: [m.watermark_lag_ms(w, now) for w in wms])

    def run(m):
        t = m.EmissionLatencyTracker("op", clock=lambda: 1000.0)
        out = [t.record_fire(w) for w in (MAX_WATERMARK - 1, MIN_WATERMARK + 1, 0,
                                          "not-a-number", 1.0)]
        out.append(t.record_fire(MAX_WATERMARK, count=7))
        return out, t.sentinel, t.snapshot()

    _twin(run)


def test_record_fire_and_outlier_ring_match_jax():
    """Fires at injected wall times, sub-floor then stalls: the same
    latencies, outlier ring and EmissionStall spans."""
    rng = np.random.default_rng(5)
    gaps = rng.uniform(0.001, 0.3, size=120)
    lats = rng.choice([1.0, 3.0, 50.0, 400.0], p=[0.6, 0.3, 0.07, 0.03], size=120)

    def run(m):
        clock, spans = [100.0], []
        t = m.EmissionLatencyTracker(
            "w", outlier_pct=99.0, outlier_floor_ms=5.0, ring_size=4, min_samples=16,
            span_sink=lambda *a: spans.append(a), span_min_gap_ms=100.0,
            clock=lambda: clock[0])
        got = []
        for g, lat in zip(gaps, lats):
            clock[0] += float(g)
            got.append(t.record_fire(clock[0] * 1000.0 - 500.0 - float(lat), lateness_ms=500))
        return got, t.outliers, spans, t.snapshot()

    got = _twin(run)
    assert got[2], "the stalls produced EmissionStall spans"


def test_outlier_gates_and_liveness_bound_match_jax():
    def run(m):
        clock, spans = [10.0], []
        t = m.EmissionLatencyTracker("w", min_samples=16, outlier_floor_ms=5.0,
                                     clock=lambda: clock[0])
        before = []
        for _ in range(16):
            t.record_fire(clock[0] * 1000.0 - 100.0)
            before.append(len(t.outliers))
        clock[0] = 500.0
        s = m.EmissionLatencyTracker("w", min_samples=1, span_min_gap_ms=0.0,
                                     clock=lambda: clock[0],
                                     span_sink=lambda *a: spans.append(a))
        clock[0] = 500.2
        s.record_fire(12_000)            # a 1970 window end: bounded by birth
        return before, spans

    before, spans = _twin(run)
    assert before[-1] == 1 and spans[0][2] >= 500_000.0


def _span(scope, name, start, end, **attrs):
    return {"scope": scope, "name": name, "start_ts_ms": start, "end_ts_ms": end,
            "attributes": attrs}


def test_stall_attribution_and_latency_report_match_jax():
    spans = [
        _span("checkpointing", "Checkpoint", 1000.0, 1010.0),
        _span("recovery", "JobRestart", 1005.0, 1095.0),
        _span("latency", "EmissionStall", 1000.0, 1100.0, latencyMs=100.0),
        _span("latency", "EmissionStall", 2000.0, 2100.0, latencyMs=7.0),
        _span("checkpointing", "Checkpoint", 2140.0, 2150.0),
    ]
    for slack in (0.0, 50.0):
        _twin(lambda m: m.stall_attribution(spans, slack_ms=slack))

    def report(m):
        h = m.EmissionHistogram()
        h.record(10.0, n=98)
        h.record(500.0, n=2)
        metrics = {
            "job.op.win-1.emissionLatencyMs": h.snapshot(),
            "job.op.win-1.watermarkLagMs": 25.0,
            "job.op.src-0.watermarkLagMs": 75.0,
            "job.op.win-1.numRecordsIn": 100,
            "job.op.win-1.currentBatchRung": 8,
            "job.op.win-2.latencyModeActive": 1,
        }
        return m.build_latency_report(metrics, spans)

    rep = _twin(report)
    assert rep["samples"] == 100 and rep["watermarkLagMs"] == 75.0
    assert rep["latency_mode"]["active"] and rep["latency_mode"]["currentBatchRung"] == 8


def test_prometheus_text_renders_emission_snapshot_as_summary_like_jax():
    def run(m, reg):
        h = m.EmissionHistogram()
        h.record(10.0, n=999)
        h.record(5000.0)
        r = reg.MetricRegistry()
        g = r.group("job", "op", "win-1")
        g.gauge("emissionLatencyMs", h.snapshot, fold="emission", kind="histogram")
        g.gauge("watermarkLagMs", lambda: 12.5, fold="max")
        return reg.prometheus_text(r.all_metrics()), reg.metrics_snapshot(r.all_metrics())

    port = run(tel, treg)
    assert port == run(jel, jreg)
    assert "# TYPE job_op_win_1_emissionLatencyMs summary" in port[0]


# -- the operators' stamp sites, one job shape each ----------------------

def _stamps(pkg, shape):
    """Per-operator (count, sentinel) of the emission snapshots after one
    job shape ran through each package's JobRuntime, and its rows."""
    from test_torch_checkpointing import PK, _job, _rows, _runtime

    env, sink = _job(pkg, shape, config=PK[pkg].cfg.Configuration())
    rt = _runtime(pkg, env)
    rt.run()
    snap = (treg if pkg == "port" else jreg).metrics_snapshot(rt.registry.all_metrics())
    return ({k: (v["count"], v.get("sentinel", 0)) for k, v in snap.items()
             if k.endswith(".emissionLatencyMs")}, _rows(sink))


@pytest.mark.parametrize("shape", ["fused_count", "fused_sum", "per_batch_lateness", "session",
                                   "global_count", "oracle_reduce", "join_q8",
                                   "join_q8_degraded"])
def test_each_operator_family_stamps_its_fires_like_jax(shape):
    port, jax = _stamps("port", shape), _stamps("jax", shape)
    assert port[1] == jax[1]
    assert port[0] == jax[0]
    assert port[0], "the job registered an emission histogram"
    if shape == "global_count":
        # count-triggered global windows have no event-time close
        assert all(c == 0 and s > 0 for c, s in port[0].values())
    elif shape != "join_q8_degraded":
        assert all(c > 0 for c, _s in port[0].values())
