"""Job checkpoints on the card: captures, restores and restarts of jobs whose
fused window operator runs kernel K1, held against the port's CPU path on
the same inputs.

They need an NVIDIA GPU, so they carry the `cuda` marker and skip
elsewhere. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_checkpointing.py

Covered: a capture holds numpy arrays and plain data only (no tensor);
a restore into a runtime whose pipeline starts at a smaller key capacity
adopts the capture's grown K and launches K1 there, with the CPU run's
rows; a restarted attempt holds no more device memory than the first at
the same point (the failed attempt's rings are released); the job thread
builds and launches K1.

Tolerance: exact (counts and integer-valued sums).
"""

import threading

import numpy as np
import pytest
import torch

from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
from flink_tpu_torch.api.windowing.assigners import (
    EventTimeSessionWindows,
    SlidingEventTimeWindows,
)
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.connectors.sink import CollectSink, Sink, SinkWriter
from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
from flink_tpu_torch.core.watermarks import WatermarkStrategy
from flink_tpu_torch.graph.transformation import plan
from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.runtime.executor import JobRuntime
from flink_tpu_torch.runtime.minicluster import JobStatus

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


class _Stop(Exception):
    pass


class _CaptureAt:
    """A stand-in coordinator: captures at the `at`-th step boundary and
    stops the run there."""

    def __init__(self, at: int):
        self.at, self.n, self.snap = at, 0, None

    def register_on_complete(self, fn):
        pass

    def unregister_on_complete(self, fn):
        pass

    def maybe_trigger(self, capture):
        self.n += 1
        if self.n == self.at:
            self.snap = capture()
            raise _Stop()


def _columns(keys: int, n: int):
    def gen(idx):
        col = np.stack([(idx * 2654435761) % keys, idx % 3, (idx * 7) % 11],
                       axis=1).astype(np.float32)
        return Batch(col, (10_000 + idx * 64_000 // n).astype(np.int64))
    return gen


def _job(device, shape: str, *, n=1 << 16, keys=4096, batch=4096, extra=None, sink=None,
         gen=None):
    conf = {"execution.step.batch-size": batch, "execution.state.key-capacity": keys}
    conf.update(extra or {})
    env = StreamExecutionEnvironment(Configuration(conf), device=device)
    base = _columns(keys, n)
    ds = env.from_source(DataGeneratorSource(base if gen is None else gen(base), n),
                         WatermarkStrategy.for_bounded_out_of_orderness(0))
    sink = sink if sink is not None else CollectSink()
    if shape == "traced":
        (ds.filter(lambda c: c[:, 1] < 0.5, traceable=True)
         .key_by(lambda c: c[:, 0].to(torch.int32), traceable=True)
         .window(SlidingEventTimeWindows.of(10_000, 1_000))
         .aggregate("sum", value_fn=lambda c: c[:, 2], value_traceable=True).sink_to(sink))
    elif shape == "host_keyed":
        (ds.key_by(lambda c: c[:, 0].astype(np.int64), vectorized=True)
         .window(SlidingEventTimeWindows.of(10_000, 1_000)).count().sink_to(sink))
    else:  # sessions
        (ds.key_by(lambda c: c[:, 0].astype(np.int64), vectorized=True)
         .window(EventTimeSessionWindows.with_gap(500)).count().sink_to(sink))
    return env, sink


def _rows(sink):
    return sorted((int(k), float(v)) for k, v in sink.results)


def _tensors_in(obj, path="capture"):
    if isinstance(obj, torch.Tensor):
        yield path
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _tensors_in(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple, set)):
        for i, v in enumerate(obj):
            yield from _tensors_in(v, f"{path}[{i}]")
    elif isinstance(obj, np.ndarray) and obj.dtype == object:
        for i, v in enumerate(obj.ravel()):
            yield from _tensors_in(v, f"{path}[{i}]")
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        yield from _tensors_in(vars(obj), f"{path}.")


@pytest.mark.parametrize("shape", ["traced", "host_keyed", "sessions"])
def test_capture_holds_no_tensor(cuda, shape, tmp_path):
    from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage

    env, _sink = _job(cuda, shape)
    grab = _CaptureAt(9)
    with pytest.raises(_Stop):
        JobRuntime(plan(env._sinks), env.config, cuda).run(coordinator=grab)
    assert list(_tensors_in(grab.snap)) == []
    store = FsCheckpointStorage(str(tmp_path))
    store.save(1, grab.snap)
    assert store.load(store.latest()[1])["records_in"] == 9 * 4096


def test_restore_into_a_grown_capacity_launches_k1_at_the_restored_k(cuda, monkeypatch):
    keys = 5000          # the host dictionary grows the ring from 1024 to 8192 columns
    env, _sink = _job(cuda, "host_keyed", keys=keys)
    grab = _CaptureAt(10)
    rt = JobRuntime(plan(env._sinks), env.config, cuda)
    with pytest.raises(_Stop):
        rt.run(coordinator=grab)
    assert rt.runners[0].op.pipe.K == 8192
    widths = []
    real = cs.keyed_superscan

    def spy(agg, count, *a, **kw):
        widths.append(int(count.shape[1]))
        return real(agg, count, *a, **kw)

    monkeypatch.setattr(cs, "keyed_superscan", spy)
    env2, sink2 = _job(cuda, "host_keyed", keys=keys)
    rt2 = JobRuntime(plan(env2._sinks), env2.config, cuda)
    assert rt2.runners[0].op.pipe.K == 1024
    rt2.restore(grab.snap)
    assert rt2.runners[0].op.pipe.K == 8192
    cs.reset_launch_counts()
    rt2.run()
    torch.cuda.synchronize()
    assert widths and set(widths) == {8192}
    assert cs.LAUNCHES["k1_superscan"] == len(widths)
    env3, sink3 = _job("cpu", "host_keyed", keys=keys)
    env3.execute()
    assert _rows(sink2) == _rows(sink3) and len(sink2.results) > 0


class _FirstWriteMemory(Sink):
    """CollectSink's rows, the device memory allocated at each writer's
    first batch (one writer an attempt), and one failure on the first batch
    at or past `fail_ts`."""

    def __init__(self, fail_ts):
        self.results, self.first_write_bytes = [], []
        self.fail_ts, self.failed = fail_ts, False

    def create_writer(self):
        sink = self

        class Writer(SinkWriter):
            first = True
            store = sink.results

            def write_batch(self, values, timestamps=None):
                if self.first:
                    self.first = False
                    sink.first_write_bytes.append(torch.cuda.memory_allocated())
                if not sink.failed and int(np.max(timestamps)) >= sink.fail_ts:
                    sink.failed = True
                    raise RuntimeError("injected host failure in the sink")
                self.store.extend(values)

        return Writer()


def test_restart_releases_the_failed_attempts_device_memory(cuda, tmp_path):
    keys = 1 << 20       # rings [32, 2^20] int32 + float32: 256 MiB an attempt
    sink = _FirstWriteMemory(fail_ts=10_000 + int(64_000 * 0.6))
    env, _ = _job(cuda, "traced", n=1 << 18, keys=keys, batch=16384, sink=sink, extra={
        "execution.checkpointing.interval": 1,
        "execution.checkpointing.dir": str(tmp_path / "chk"),
        "execution.window.columnar-output": True,
        "restart-strategy.type": "fixed-delay", "restart-strategy.initial-backoff": 1})
    torch.cuda.synchronize()
    client = env.execute_async("memory")
    assert client.wait(300) == JobStatus.FINISHED
    assert client.num_restarts == 1
    first, restarted = sink.first_write_bytes
    assert first >= 256 << 20
    assert restarted <= first + (16 << 20), (first, restarted)


def test_the_job_thread_builds_and_launches_k1(cuda, tmp_path, monkeypatch):
    threads = []
    real_build = cs.build

    def build(names=tuple(cs.SOURCES)):
        threads.append(threading.current_thread().name)
        return real_build(names)

    monkeypatch.setattr(cs, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cs, "build", build)
    cs._library.cache_clear()
    try:
        env, sink = _job(cuda, "traced")
        cs.reset_launch_counts()
        client = env.execute_async("built-on-the-job-thread")
        assert client.wait(300) == JobStatus.FINISHED
        assert threads and all(t.startswith("jobmaster-") for t in threads), threads
        assert cs.LAUNCHES["k1_superscan"] > 0
        assert any((tmp_path / "build").glob("libsuperscan-*.so"))
    finally:
        cs._library.cache_clear()
    env2, sink2 = _job("cpu", "traced")
    env2.execute()
    assert _rows(sink) == _rows(sink2)
