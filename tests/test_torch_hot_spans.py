"""The port's hot-path sections and counts (`metrics/traces.py::section`,
`add`) on the fused window route, on the CPU.

A YSB-shaped job (20 int32 columns a record, a traceable filter on the
event type, a traceable key, 10 s tumbling windows, count) runs through
`env.execute()`. With no profiler running, no section opens a
`record_function` range and the totals still advance. A CPU
`torch.profiler` capture started and stopped from inside the source's
poll, as the benchmark's is, holds `flink.*` ranges on the job's thread
alone, none inside another, as many of each counted section as the
totals gained over the capture. The staging count is exact per staged
row, the queue and in-flight counts cover every record pushed, the log
of totals reaches back by time and fails loudly past its start, and the
job's TraceRegistry span log holds no section.
"""

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
from flink_tpu_torch.core.watermarks import WatermarkStrategy
from flink_tpu_torch.metrics import traces
from flink_tpu_torch.runtime.fused_window_pipeline import FusedWindowPipeline, TracedPrologue

N, BATCH, KEYS, COLS = 1 << 15, 256, 64, 20
EVENT_TYPE, VIEW = 1, 7
SECTIONS = {"flink.source.poll", "flink.source.watermark", "flink.fused.normalize",
            "flink.fused.stage", "flink.fused.readback_wait", "flink.fused.emit"}


def _records(idx):
    """Rows of 20 int32 columns; a third of them views; 1 ms apart."""
    col = np.zeros((len(idx), COLS), np.int32)
    col[:, 0] = (idx * 2654435761) % KEYS
    col[:, EVENT_TYPE] = np.where(idx % 3 == 0, VIEW, VIEW + 1)
    col[:, 2:] = (idx[:, None] + np.arange(2, COLS)) % 251
    return Batch(col, (10_000 + idx).astype(np.int64))


def _run(gen=_records, api="execute"):
    env = StreamExecutionEnvironment(
        Configuration({"execution.step.batch-size": BATCH,
                       "execution.state.key-capacity": KEYS}), device="cpu")
    sink = (env.from_source(DataGeneratorSource(gen, N),
                            WatermarkStrategy.for_bounded_out_of_orderness(0))
            .filter(lambda c: c[:, EVENT_TYPE] == VIEW, traceable=True)
            .key_by(lambda c: c[:, 0].to(torch.int32), traceable=True)
            .window(TumblingEventTimeWindows.of(10_000)).aggregate("count")
            .collect())
    if api == "execute":
        env.execute()
        return sink, None
    client = env.execute_async()
    client.wait(300)
    return sink, client


COUNTED = SECTIONS - {"flink.source.poll", "flink.source.watermark", "flink.fused.emit"}


@pytest.fixture
def exact_log(monkeypatch):
    """A log entry at every update, so an interval's totals are exact at
    both ends (the port resolves them to LOG_STEP_NS)."""
    monkeypatch.setattr(traces, "LOG_STEP_NS", 0)


def _now():
    return traces.time.perf_counter_ns()


@pytest.fixture
def counted_ranges(monkeypatch):
    """record_function, counting the ranges the sections open."""
    calls = []
    real = autograd_profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(autograd_profiler, "record_function", counting)
    return calls


def test_no_profiler_no_range_and_the_tables_still_count(counted_ranges, exact_log):
    t0 = _now()
    sink, _ = _run()
    got = traces.totals_between(t0, _now())
    assert sum(r for _k, r in sink.results) == -(-N // 3)
    assert counted_ranges == []
    assert COUNTED <= set(got) and not (SECTIONS - COUNTED) & set(got)
    assert all(got[name][0] > 0 for name in COUNTED)
    assert got["flink.fused.stage"][1] == got["flink.fused.readback_wait"][1]


def test_a_capture_from_inside_the_poll_holds_flat_ranges_on_the_job_thread(counted_ranges,
                                                                            exact_log):
    """The capture starts inside one poll and stops inside a later one: the
    first poll's section opened before the capture (no range) and closes
    inside it, the last one's opens inside and closes after the stop; both
    raise nothing. The counted sections' ranges in the capture are as many
    as their exits."""
    start_at, stop_at = 10, 90
    state = {}

    def gen(idx):
        k = int(idx[0]) // BATCH
        if k == start_at:
            state["prof"] = profile(activities=[ProfilerActivity.CPU])
            state["prof"].__enter__()
            state["open"] = _now()
        elif k == stop_at:
            state["close"] = _now()
            state["prof"].__exit__(None, None, None)
        return _records(idx)

    _run(gen)
    events = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name(), ev.start_thread_id())
              for ev in state["prof"].profiler.kineto_results.events()
              if ev.name().startswith("flink.")]
    assert {tid for *_r, tid in events} and len({tid for *_r, tid in events}) == 1
    events.sort()
    assert all(b[0] >= a[1] for a, b in zip(events, events[1:])), "a range inside another"
    in_capture = {name: n for name, (_v, n) in
                  traces.totals_between(state["open"], state["close"]).items()
                  if name in COUNTED}
    by_name = {}
    for _a, _b, name, _t in events:
        by_name[name] = by_name.get(name, 0) + 1
    assert {k: v for k, v in by_name.items() if k in COUNTED} == in_capture
    assert {"flink.fused.stage", "flink.fused.normalize", "flink.source.poll",
            "flink.source.watermark"} <= set(by_name)
    assert len(counted_ranges) == len(events)


def test_staged_bytes_are_the_raw_row_and_srel_exactly(exact_log):
    pipe = FusedWindowPipeline(
        TumblingEventTimeWindows.of(10_000), "count", key_capacity=KEYS, chunk=256,
        prologue=TracedPrologue((("filter", lambda c: c[:, EVENT_TYPE] == VIEW),),
                                key_fn=lambda c: c[:, 0].to(torch.int32)),
        device="cpu")
    idx = np.arange(3000)
    recs = _records(idx)
    steps = [(recs.values[i:i + n], recs.timestamps[i:i + n])
             for i, n in ((0, 1000), (1000, 700), (1700, 1300))]
    t0 = _now()
    pipe.stage_superbatch_raw(steps, [9_000, 9_000, 9_000])
    got = traces.totals_between(t0, _now())
    rows = 3 * 2048                  # steps padded to the chunk times a power of two
    assert got["flink.fused.staged_bytes"] == (rows * (COLS * 4 + 4), 1)
    assert got["flink.fused.plan_bytes"] == (4 * 3 * (1 + 3 * pipe.F + pipe.S), 1)
    assert got["flink.fused.stage"][1] == 1


def test_every_record_pushed_is_queued_and_in_flight_once(exact_log):
    t0 = _now()
    _run()
    got = traces.totals_between(t0, _now())
    assert got["flink.fused.queued_records"][0] == got["flink.fused.inflight_records"][0] == N
    assert got["flink.fused.queue_wait_ns"][0] > 0 and got["flink.fused.inflight_ns"][0] > 0


def test_the_interval_totals_are_what_was_added_in_it(monkeypatch, exact_log):
    traces.add("flink.test.count", 100)
    t0 = _now()
    for n in range(4):
        traces.add("flink.test.count", n)
    with traces.section("flink.test.section"):
        pass
    t1 = _now()
    traces.add("flink.test.count", 100)
    got = traces.totals_between(t0, t1)
    assert got["flink.test.count"] == (0 + 1 + 2 + 3, 4)
    assert got["flink.test.section"][1] == 1 and got["flink.test.section"][0] > 0
    # an interval whose start the bounded log no longer reaches: a loud miss
    monkeypatch.setattr(traces, "_log", traces.deque(maxlen=3))
    t2 = _now()
    for n in range(4):
        traces.add("flink.test.count", n)
    with pytest.raises(LookupError):
        traces.totals_between(t2, _now())
    # the oldest entry held is the add of 1: the interval after it holds 2 and 3
    assert traces.totals_between(traces._log[0][0], _now())["flink.test.count"] == (2 + 3, 2)


def test_the_log_keeps_an_entry_a_step_whatever_the_update_rate(monkeypatch):
    """Updates closer than LOG_STEP_NS share an entry: the log's span in
    time, not the batch size, sets how far back it reaches."""
    monkeypatch.setattr(traces, "_log", traces.deque(maxlen=1 << 16))
    monkeypatch.setattr(traces, "LOG_STEP_NS", 10**12)
    t0 = _now()
    for _ in range(1000):
        traces.add("flink.test.count", 1)
    assert len(traces._log) == 1
    got = traces.totals_between(t0 - 1, _now())
    assert got["flink.test.count"] == (1000, 1000)


def test_the_span_log_holds_no_section(exact_log):
    t0 = _now()
    _sink, client = _run(api="async")
    assert traces.totals_between(t0, _now())["flink.fused.stage"][1] > 0
    assert not any(s.name.startswith("flink.") for s in client.span_log.spans)


def test_a_section_without_count_is_a_range_alone(counted_ranges, exact_log):
    t0 = _now()
    with traces.section("flink.test.uncounted", count=False):
        pass
    assert "flink.test.uncounted" not in traces.totals_between(t0, _now())
    assert counted_ranges == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with traces.section("flink.test.uncounted", count=False):
            pass
    assert counted_ranges == ["flink.test.uncounted"]
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith("flink.")] == ["flink.test.uncounted"]
