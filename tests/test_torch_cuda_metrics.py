"""The metric planes add no synchronize on the card.

On CUDA a launch returns at once, so a `DeviceTimer` section times the
host's launch and the readback it waits on, and an emission stamp reads
the host clock after a fire's rows reached the host; neither may wait on
the device itself. This runs the api_ysb fused job (K1) on the card
through `env.execute_async` with every plane on (a latency marker every
batch, checkpoints, emission latency, the doctor, the history) and counts
the `torch.cuda.synchronize` calls made inside DeviceTimer sections and
emission stamps, and the event waits and `.item()` reads made inside the
stamps: all zero. It needs an NVIDIA GPU, so it carries the `cuda` marker
and skips elsewhere. Run it on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_metrics.py

Tolerance: exact (counts).
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
from flink_tpu_torch.core.watermarks import WatermarkStrategy
from flink_tpu_torch.metrics import emission_latency, task_io
from flink_tpu_torch.metrics.registry import metrics_snapshot
from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.testing import stream as st

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the metric planes on the card)")


class _Where:
    """Counts calls of synchronize, event waits and .item() by where they
    happen: inside a DeviceTimer section, inside an emission stamp."""

    def __init__(self, monkeypatch):
        self.section = self.stamp = 0
        self.counts = {"sync_in_section": 0, "sync_in_stamp": 0, "event_wait_in_stamp": 0,
                       "item_in_stamp": 0, "sections": 0, "stamps": 0}
        enter, exit_ = task_io.DeviceTimer._Section.__enter__, task_io.DeviceTimer._Section.__exit__
        record = emission_latency.EmissionLatencyTracker.record_fire
        sync, wait, item = torch.cuda.synchronize, torch.cuda.Event.synchronize, torch.Tensor.item

        def s_enter(sec):
            self.section += 1
            self.counts["sections"] += 1
            return enter(sec)

        def s_exit(sec, *exc):
            self.section -= 1
            return exit_(sec, *exc)

        def stamp(tracker, *a, **kw):
            self.stamp += 1
            self.counts["stamps"] += 1
            try:
                return record(tracker, *a, **kw)
            finally:
                self.stamp -= 1

        def counted_sync(*a, **kw):
            if self.section:
                self.counts["sync_in_section"] += 1
            if self.stamp:
                self.counts["sync_in_stamp"] += 1
            return sync(*a, **kw)

        def counted_wait(event):
            if self.stamp:
                self.counts["event_wait_in_stamp"] += 1
            return wait(event)

        def counted_item(t):
            if self.stamp:
                self.counts["item_in_stamp"] += 1
            return item(t)

        monkeypatch.setattr(task_io.DeviceTimer._Section, "__enter__", s_enter)
        monkeypatch.setattr(task_io.DeviceTimer._Section, "__exit__", s_exit)
        monkeypatch.setattr(emission_latency.EmissionLatencyTracker, "record_fire", stamp)
        monkeypatch.setattr(torch.cuda, "synchronize", counted_sync)
        monkeypatch.setattr(torch.cuda.Event, "synchronize", counted_wait)
        monkeypatch.setattr(torch.Tensor, "item", counted_item)


def _job(n, keys=8192, batch=65536, columnar=True):
    env = StreamExecutionEnvironment(Configuration({
        "execution.step.batch-size": batch, "execution.state.key-capacity": keys,
        "execution.window.columnar-output": columnar,
        "execution.checkpointing.interval": 20,
        "observability.latency-markers.interval-ms": 0,
        "observability.history.interval-ms": 10}), device="cuda")
    sink = (env.from_source(DataGeneratorSource(lambda idx: Batch(*st.api_columns(idx, n, keys)),
                                                n),
                            WatermarkStrategy.for_bounded_out_of_orderness(0))
            .filter(lambda c: c[:, 1] < 0.5, traceable=True)
            .key_by(lambda c: c[:, 0].to(torch.int32), traceable=True)
            .window(SlidingEventTimeWindows.of(10_000, 1_000)).aggregate("count").collect())
    return env, sink


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "rows"])
def test_no_synchronize_inside_device_sections_or_emission_stamps(card, monkeypatch,
                                                                   columnar):
    n = 1 << 21
    where = _Where(monkeypatch)
    cs.reset_launch_counts()
    env, sink = _job(n, columnar=columnar)
    client = env.execute_async()
    client.wait(300)
    snap = metrics_snapshot(client.metrics.all_metrics())
    assert cs.LAUNCHES["k1_superscan"] > 0 and len(sink.results) > 0
    assert where.counts["sections"] > 0 and where.counts["stamps"] > 0
    assert {k: v for k, v in where.counts.items() if k not in ("sections", "stamps")} == {
        "sync_in_section": 0, "sync_in_stamp": 0, "event_wait_in_stamp": 0,
        "item_in_stamp": 0}, where.counts
    assert snap["job.deviceTimeMsTotal"] > 0 and snap["job.numRecordsIn"] == n
    em = [v for k, v in snap.items() if k.endswith(".emissionLatencyMs")]
    assert em and em[0]["count"] == where.counts["stamps"]
    assert np.isfinite(snap["job.p99EmissionLatencyMs"])
