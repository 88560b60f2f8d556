"""The readers of the port's hot-path sections and counts, and the split of
the traced part's idle device time by the port's spans.

The six counter readers read a finite value on the tiny `ysb.max` on the
CPU, and nothing (no error) from a port that keeps no section totals; a
log that no longer reaches back to the window's start gives nothing and
says so on standard error. The idle split is checked on hand-made
intervals: each idle gap goes to the span open there on the job's thread,
`(none)` takes the rest, and a span on another thread takes nothing."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

from streambench.core import runner, spans
from streambench.core.spec import load_module
from streambench.core.trace import TRACE_CLOSE, TRACE_OPEN
from streambench.tests.tiny import tiny_cell

READERS = ["stage_ns_per_rec", "normalize_ns_per_rec", "staged_bytes_per_rec",
           "step_queue_ms", "inflight_ms", "readback_wait_ns_per_rec"]


@pytest.fixture(scope="module")
def tiny_run():
    cell, traffic = tiny_cell("ysb.max")
    return runner.run_cell(cell, 2**31 + 91, 1.5, True, device="cpu", traffic=traffic)


@pytest.mark.parametrize("name", READERS)
def test_each_counter_reader_reads_the_tiny_cell(tiny_run, name):
    assert tiny_run.result["correct"]
    value = load_module("metrics", name).read(tiny_run.record)
    assert value is not None and math.isfinite(value) and value >= 0
    assert tiny_run.result["metrics"][name]["value"] == value


def test_the_staged_bytes_cover_the_raw_record_and_its_slice(tiny_run):
    # 80 bytes of columns and 4 of srel a row; pad rows and plan arrays add
    assert 84 <= tiny_run.result["metrics"]["staged_bytes_per_rec"]["value"] < 120


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_the_tables_gives_nothing(tiny_run, name, monkeypatch):
    from flink_tpu_torch.metrics import traces

    monkeypatch.delattr(traces, "totals_between")
    assert load_module("metrics", name).read(tiny_run.record) is None


def test_a_log_that_lost_the_window_start_gives_nothing_and_says_so(tiny_run, monkeypatch,
                                                                    capsys):
    from flink_tpu_torch.metrics import traces

    monkeypatch.setattr(traces, "_log", traces.deque(maxlen=2))
    monkeypatch.setattr(traces, "LOG_STEP_NS", 0)
    for n in range(3):
        traces.add("flink.test.count", n)
    rec = dict(tiny_run.record, t_open=traces.time.perf_counter() - 1.0)
    assert load_module("metrics", "stage_ns_per_rec").read(rec) is None
    assert "the window's totals are lost" in capsys.readouterr().err


def test_idle_gaps_go_to_the_span_open_there():
    busy = np.array([[2.0, 3.0], [5.0, 6.0], [2.5, 3.5]])     # merged: [2, 3.5], [5, 6]
    got = spans.split_idle(busy, 0.0, 10.0, [
        (1.0, 2.5, "flink.a"),       # idle 1.0 of it: [1, 2]
        (3.0, 5.5, "flink.b"),       # idle [3.5, 5]: 1.5
        (7.0, 8.0, "flink.a"),       # all idle: 1.0
        (9.5, 11.0, "flink.c"),      # clipped at the window's end: 0.5
    ])
    assert got == pytest.approx({"flink.a": 2.0, "flink.b": 1.5, "flink.c": 0.5,
                                 spans.NONE: 7.5 - 4.0})
    assert sum(got.values()) == pytest.approx(10.0 - 2.5)


def test_no_device_work_leaves_the_window_idle():
    got = spans.split_idle(np.zeros((0, 2)), 0.0, 4.0, [(1.0, 2.0, "flink.a")])
    assert got == pytest.approx({"flink.a": 1.0, spans.NONE: 3.0})


class _Event(SimpleNamespace):
    def name(self):
        return self.n

    def start_ns(self):
        return int(self.t0 * 1e9)

    def duration_ns(self):
        return int((self.t1 - self.t0) * 1e9)

    def device_type(self):
        return self.dev

    def start_thread_id(self):
        return self.tid


def _capture(events):
    evs = [_Event(n=n, t0=a, t1=b, dev=dev, tid=tid) for n, a, b, dev, tid in events]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))


def test_the_capture_is_split_by_the_job_threads_spans():
    cpu, cuda, job, other = "DeviceType.CPU", "DeviceType.CUDA", 7, 8
    got = spans.idle_by_span(_capture([
        (TRACE_OPEN, 1.0, 1.0, cpu, job),
        ("k1_superscan_kernel", 2.0, 3.0, cuda, 0),
        ("Memcpy HtoD", 6.0, 7.0, cuda, 0),
        ("flink.fused.stage", 1.5, 2.5, cpu, job),          # idle 0.5
        ("flink.fused.normalize", 4.0, 6.5, cpu, job),      # idle 2.0
        ("flink.fused.stage", 7.0, 9.0, cpu, other),        # another thread: nothing
        ("flink.source.poll", 0.0, 0.5, cpu, job),          # before the traced part
        ("aten::copy_", 8.0, 8.5, cpu, job),
        (TRACE_CLOSE, 10.0, 11.0, cpu, job),
    ]))
    # the traced part [1, 11] less the busy [2, 3] and [6, 7]: 8 s idle
    assert got["idle_s"] == pytest.approx(8.0)
    assert got["idle_by_span"] == pytest.approx({"flink.fused.stage": 0.5,
                                                 "flink.fused.normalize": 2.0,
                                                 spans.NONE: 5.5})
    assert got["idle_unspanned_pct"] == pytest.approx(100 * 5.5 / 8)
    assert got["span_events"] == {"flink.fused.stage": 1, "flink.fused.normalize": 1}
    assert got["flink_device_events"] == 0


def test_a_span_mirrored_on_the_device_is_counted():
    cpu, cuda = "DeviceType.CPU", "DeviceType.CUDA"
    got = spans.idle_by_span(_capture([
        (TRACE_OPEN, 0.0, 0.0, cpu, 1),
        ("flink.fused.stage", 1.0, 2.0, cpu, 1),
        ("flink.fused.stage", 1.2, 1.8, cuda, 0),       # its launch's annotation
        (TRACE_CLOSE, 3.0, 4.0, cpu, 1),
    ]))
    assert got["flink_device_events"] == 1
    assert got["idle_by_span"]["flink.fused.stage"] == pytest.approx(0.4)


def test_no_benchmark_spans_no_split():
    assert spans.idle_by_span(_capture([("flink.fused.stage", 1.0, 2.0, "DeviceType.CPU", 1)])) \
        == {}
