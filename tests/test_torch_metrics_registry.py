"""The port's metric registry, task IO ratios, device timer, traces and OTLP
export held against the JAX package's (`flink_tpu_torch/metrics/
{registry,task_io,traces,otel}.py` against `flink_tpu/metrics/...`).

Both registries are fed the same numpy-made metric updates (seeded), with
the same injected clocks, and their `metrics_snapshot` dicts and
`prometheus_text` strings must be equal exactly; the Prometheus helpers,
reporters, TaskIOMetrics sampling and spans likewise. DeviceTimer sections
run on the host clock, so their durations are not compared: their counts,
histogram counts and registered names are.

Tolerance: exact.
"""

import logging
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import flink_tpu.metrics.otel as jotel
import flink_tpu.metrics.registry as jreg
import flink_tpu.metrics.task_io as jio
import flink_tpu.metrics.traces as jtr
import flink_tpu_torch.metrics.otel as totel
import flink_tpu_torch.metrics.registry as treg
import flink_tpu_torch.metrics.task_io as tio
import flink_tpu_torch.metrics.traces as ttr

PK = {"jax": types.SimpleNamespace(reg=jreg, io=jio, tr=jtr, otel=jotel),
      "port": types.SimpleNamespace(reg=treg, io=tio, tr=ttr, otel=totel)}


def _twin(fn):
    """fn(package namespace) in both packages: equal results, returned once."""
    jax, port = fn(PK["jax"]), fn(PK["port"])
    assert port == jax
    return port


def _populate(pk, seed: int):
    """A registry over two operators and the job group, updated from a
    seeded stream: counters, gauges of every fold and kind, meters on an
    injected clock, reservoir histograms (one overflowing its ring)."""
    rng = np.random.default_rng(seed)
    clock = [1000.0]
    reg = pk.reg.MetricRegistry()
    job = reg.group("job")
    meter = pk.reg.Meter(clock=lambda: clock[0])
    reg._register(("job",), "numRecordsInPerSecond", meter)
    counters, hists = [], []
    for uid in ("window_aggregate@3", "sink@4"):
        g = reg.group("job", "operator", uid)
        counters.append(g.counter("numRecordsIn"))
        hists.append(g.histogram("latencyMs", size=64))
        g.gauge("currentWatermark", lambda u=uid: len(u) * 1000, fold="min")
        g.gauge("stateBytes", lambda: np.int64(32768), fold="sum")
        g.gauge("busy", lambda: True)            # a bool is no metric value
        g.gauge("broken", lambda: 1 / 0)          # must not poison the snapshot
        g.gauge("tierHotFillRatio", lambda: np.float32(0.25), fold="mean")
    job.gauge("numRecordsIn", lambda: sum(c.count for c in counters), fold="sum",
              kind="counter")
    job.gauge("emission", lambda: {"count": 3, "p50": 1.5, "p99": 9.0, "b2": 3,
                                   "skip": "text"}, fold="emission", kind="histogram")
    step = job.histogram("stepLatencyMs")
    for _ in range(200):
        n = int(rng.integers(1, 5000))
        counters[int(rng.integers(0, 2))].inc(n)
        clock[0] += float(rng.uniform(0.001, 0.3))
        meter.mark(n)
        for h in hists:
            h.update(float(rng.lognormal(1.0, 1.0)))
        step.update(float(rng.uniform(0, 50)))
    reg.group("0weird", "a-b").counter("x:y").inc(1)
    return reg, clock, meter


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_snapshot_and_prometheus_text_equal_jax_exactly(seed):
    def run(pk):
        reg, _clock, meter = _populate(pk, seed)
        metrics = reg.all_metrics()
        # a raising gauge is skipped by the snapshot; the text encoders and
        # reporters read every metric, so they get the healthy ones
        healthy = {k: v for k, v in metrics.items() if not k.endswith(".broken")}
        rep, prom = pk.reg.InMemoryReporter(), pk.reg.PrometheusReporter()
        reg2 = pk.reg.MetricRegistry()
        reg2._metrics.update(healthy)
        reg2.add_reporter(rep)
        reg2.add_reporter(prom)
        reg2.report()
        return (pk.reg.metrics_snapshot(metrics),
                pk.reg.prometheus_text(healthy),
                pk.reg.prometheus_text(healthy, labels={"job": 'a"b\\c', "shard": 1}),
                prom.text, sorted((k, repr(v)) for k, v in rep.last.items()),
                meter.count, meter.rate())

    snap, text, *_ = _twin(run)
    assert "# TYPE job_numRecordsIn gauge" in text
    assert snap["__kinds__"]["job.numRecordsIn"] == "counter"
    assert "job.operator.sink@4.broken" not in snap
    assert "job.operator.sink@4.busy" not in snap


def test_snapshot_exposition_merge_and_metric_types_match_jax():
    def run(pk):
        a = pk.reg.prometheus_text_from_snapshot(
            {"job.n": 1, "job.h": {"count": 1, "p50": 2.0}, "__folds__": {"job.n": "sum"}},
            labels={"shard": 0})
        b = pk.reg.prometheus_text_from_snapshot(
            {"job.n": 2, "job.h": {"count": 3, "p50": 4.0, "p999": float("nan")}},
            labels={"shard": 1})
        c = pk.reg.Counter()
        c.inc()
        c.inc(4)
        h = pk.reg.Histogram(size=100)
        for i in range(100):
            h.update(i)
        empty = pk.reg.Histogram()
        return (a, b, pk.reg.merge_prometheus_text([a, b]), c.count, c.value(),
                h.stats(), h.quantile(0.5), empty.stats(), repr(empty.quantile(0.5)),
                pk.reg.FOLD_KINDS, pk.reg.METRIC_KINDS)

    _twin(run)
    for pk in PK.values():
        with pytest.raises(ValueError):
            pk.reg.Gauge(lambda: 1, fold="avg")
        with pytest.raises(ValueError):
            pk.reg.Gauge(lambda: 1, kind="rate")


def test_type_collision_keeps_first_and_warns_like_jax(caplog):
    def run(pk):
        reg = pk.reg.MetricRegistry()
        g = reg.group("job", "op")
        c = g.counter("m")
        c.inc(3)
        with caplog.at_level(logging.WARNING):
            h = g.histogram("m")
        h.update(1.5)
        return (type(h).__name__, reg.all_metrics()["job.op.m"] is c, g.counter("m") is c,
                pk.reg.metrics_snapshot(reg.all_metrics()), g.metric_identifier("x"))

    _twin(run)
    warned = [r for r in caplog.records if "already registered" in r.getMessage()]
    assert {r.name for r in warned} == {"flink_tpu.metrics", "flink_tpu_torch.metrics"}


def test_task_io_ratios_and_windowed_sampling_match_jax():
    rng = np.random.default_rng(3)
    steps = rng.uniform(0.0, 0.01, size=(300, 2))

    def run(pk):
        io = pk.io.TaskIOMetrics()
        bp = [0.0]
        io.add_backpressure_source(lambda: bp[0])
        t0 = io._last_sample_t = 100.0
        out = []
        for i, (busy, idle) in enumerate(steps):
            io.record_step(busy_dt=float(busy), loop_dt=float(busy + idle))
            bp[0] += float(busy) * 0.25
            io.maybe_sample(interval_ms=100, now=t0 + 0.01 * (i + 1))
            out.append((io.ratios(), {k: io.ms_per_second(k)
                                      for k in ("busy", "idle", "backPressured")}))
        reg = pk.reg.MetricRegistry()
        io.register(reg.group("job"))
        return (out, pk.reg.metrics_snapshot(reg.all_metrics()),
                [pk.io.backpressure_level(r) for r in (0.0, 0.1, 0.3, 0.5, 0.9)])

    _twin(run)


def test_device_timer_counts_sections_like_jax():
    def run(pk):
        reg = pk.reg.MetricRegistry()
        g = reg.group("job", "operator", "w")
        t = pk.io.DeviceTimer()
        t._hist = g.histogram("deviceDispatchMs")
        t.register(g)
        for _ in range(5):
            with t.section():
                pass
        snap = pk.reg.metrics_snapshot(reg.all_metrics())
        return (t.dispatches, snap["job.operator.w.deviceDispatchMs"]["count"],
                sorted(k for k in snap if not k.startswith("__")),
                snap["__folds__"], snap["__kinds__"], t.total_s >= 0.0)

    _twin(run)


def test_spans_trace_ids_and_otlp_match_jax(tmp_path):
    def run(pk):
        clock = [1.0]
        b = pk.tr.SpanBuilder("checkpointing", "Checkpoint", clock=lambda: clock[0])
        clock[0] = 1.2505
        span = (b.set_attribute("checkpointId", 7).set_attribute("status", "COMPLETED")
                .set_attribute("full", True).set_attribute("ratio", 0.5).end())
        reg = pk.tr.TraceRegistry(trace_id=pk.tr.job_trace_id("job-1"))
        mem = pk.tr.InMemoryTraceReporter(max_spans=2)
        path = tmp_path / f"{pk.tr.__name__}.otlp.jsonl"
        otlp = pk.otel.OtlpJsonTraceReporter(service_name="svc", path=str(path), max_spans=2)
        reg.add_reporter(mem)
        reg.add_reporter(otlp)
        for i in range(3):
            reg.report(pk.tr.Span("recovery", "JobRestart", float(i), i + 0.5, {"attempt": i}))
        enc = pk.otel.span_to_otlp(span, trace_id="0" * 32)
        enc.pop("spanId")
        def payload():
            # the instrumentation scope names the package; span ids are random
            doc = otlp.payload()
            scope = doc["resourceSpans"][0]["scopeSpans"][0]
            assert scope["scope"].pop("name") == pk.tr.__name__.split(".")[0]
            for s in scope["spans"]:
                s.pop("spanId")
            return doc

        full = payload()
        otlp.clear()
        return (span.to_dict(), span.duration_ms, pk.tr.Span.from_dict(span.to_dict()).to_dict(),
                reg.trace_id,
                [s.to_dict() for s in mem.spans], enc, full,
                len(path.read_text().splitlines()), payload())

    got = _twin(run)
    assert got[3] == PK["jax"].tr.job_trace_id("job-1") and len(got[3]) == 32
