"""The join ring's device programs and the device join on the card, against
the port's CPU path on the same inputs.

They need an NVIDIA GPU, so they carry the `cuda` marker and skip
elsewhere. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_joins.py

Covered: `BucketRing` ingest and `FusedJoinPipeline`'s window and interval
matches (`ops/join_ring.py`, ROADMAP B5) at `chip_smoke.py`'s leg B
geometry (NB = 65, K = 65536, C = 16) and at a zipf geometry with C = 128,
bit for bit; a `DeviceJoinRunner` job whose rings live on the card; an
entry point that raises without a GPU.

Tolerance: exact (int32 lanes and row ids).
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
from flink_tpu_torch.api.windowing.assigners import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.config import Configuration
from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
from flink_tpu_torch.core.watermarks import WatermarkStrategy
from flink_tpu_torch.graph.transformation import plan
from flink_tpu_torch.joins.pipeline import FusedJoinPipeline
from flink_tpu_torch.joins.spec import plan_join_geometry
from flink_tpu_torch.ops import join_ring
from flink_tpu_torch.runtime.device_join_operator import DeviceJoinRunner
from flink_tpu_torch.runtime.executor import JobRuntime
from flink_tpu_torch.testing.stream import zipf_keys
from flink_tpu_torch.utils.arrays import obj_array

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


GEOMETRIES = {
    # chip_smoke.py leg B: q8's 1 s tumble at 2^16 keys, C at its start
    "leg_b": dict(size=1000, slide=1000, keys=1 << 16, C=16, records=1 << 15,
                  skewed=False),
    # q3's 2 s / 1 s slide over 2048 zipf keys, C grown to 128
    "zipf_c128": dict(size=2000, slide=1000, keys=2048, C=128, records=1 << 14,
                      skewed=True),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_ring_and_match_equal_the_cpu_bit_for_bit(cuda, name):
    g = GEOMETRIES[name]
    geom = plan_join_geometry(g["size"], g["slide"], 0, key_capacity=g["keys"],
                              bucket_capacity=g["C"])
    pipes = {d: FusedJoinPipeline(geom, d) for d in (cuda, "cpu")}
    n = g["records"]
    idx = np.arange(n, dtype=np.int64)
    for side in (0, 1):
        # the bench's streams: both sides draw the same keys at the same
        # times (zipf: the same draw), so windows and intervals match
        keys = (zipf_keys(idx, g["keys"]) if g["skewed"]
                else (idx * 2654435761) % g["keys"])
        if g["skewed"]:
            # keep each (key, bucket) side within C: the ring refuses more
            keep = np.zeros(n, bool)
            counts = {}
            for i, (k, t) in enumerate(zip(keys, idx * 8000 // n)):
                c = counts.get((k, t // 1000), 0)
                keep[i] = c < g["C"]
                counts[(k, t // 1000)] = c + 1
            keys_s, ts_s = keys[keep], (10_000 + idx * 8000 // n)[keep]
        else:
            keys_s, ts_s = keys, 10_000 + idx * 8000 // n
        rows = list(range(len(keys_s)))
        for lo in range(0, len(keys_s), 1024):
            for p in pipes.values():
                p.ingest(side, keys_s[lo:lo + 1024], ts_s[lo:lo + 1024], rows[lo:lo + 1024])
    for a, b in ((pipes[cuda].left, pipes["cpu"].left), (pipes[cuda].right, pipes["cpu"].right)):
        assert a.idx_arr.is_cuda and a.ts_arr.is_cuda
        assert torch.equal(a.idx_arr.cpu(), b.idx_arr) and torch.equal(a.ts_arr.cpu(), b.ts_arr)
    join_ring.reset_call_counts()
    fired = 0
    for start in range(10_000 - g["size"] + g["slide"], 18_000, g["slide"]):
        got = [pipes[d].fire_window(start, start + g["size"]) for d in (cuda, "cpu")]
        for x, y in zip(*got):
            assert np.array_equal(x, y)
        fired += len(got[0][0])
    b0 = 10
    got = [pipes[d].match_interval(np.arange(b0, b0 + 2), np.arange(b0, b0 + 3), -500, 700)
           for d in (cuda, "cpu")]
    for x, y in zip(*got):
        assert np.array_equal(x, y)
    assert len(got[0][0]) > 0 and fired > 0
    assert join_ring.CALLS["join_match"] > 0 and join_ring.CALLS["join_match_interval"] == 2


def _job(n, device, keys=256):
    conf = Configuration({"execution.step.batch-size": 512, "execution.state.key-capacity": keys})
    env = StreamExecutionEnvironment(conf, device=device)

    def source(side):
        def gen(idx):
            ks = (idx * 2654435761) % keys
            rows = obj_array([(int(k), f"{side}{int(i)}", int(i % 3)) for k, i in zip(ks, idx)])
            return Batch(rows, (10_000 + idx * 16_000 // n).astype(np.int64))
        return DataGeneratorSource(gen, n)

    wm = WatermarkStrategy.for_bounded_out_of_orderness(0)
    persons = env.from_source(source("p"), wm)
    auctions = env.from_source(source("a"), wm).filter(lambda r: r[2] == 0)
    sink = (persons.join(auctions).where(lambda r: r[0]).equal_to(lambda r: r[0])
            .window(SlidingEventTimeWindows.of(2000, 1000))
            .apply(lambda p, a: (p[0], p[1], a[1])).collect())
    rt = JobRuntime(plan(env._sinks), conf, device)
    return rt, sink


def test_device_join_job_on_the_card_equals_the_cpu(cuda):
    out = {}
    for d in (cuda, "cpu"):
        rt, sink = _job(1 << 13, d)
        join_ring.reset_call_counts()
        (runner,) = [r for r in rt.runners if isinstance(r, DeviceJoinRunner)]
        assert runner.pipeline.left.idx_arr.device.type == torch.device(d).type
        rt.run()
        assert runner.fallback_reason is None and runner._host is None
        assert join_ring.CALLS["join_ingest"] > 0 and join_ring.CALLS["join_match"] > 0
        out[d] = list(sink.results)
    assert out[cuda] == out["cpu"] and out["cpu"]


def test_an_entry_point_without_a_gpu_raises(cuda, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geom = plan_join_geometry(1000, 1000, 0, key_capacity=8, bucket_capacity=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedJoinPipeline(geom)
    env = StreamExecutionEnvironment()
    a = env.from_collection([("k", 1)], timestamp_fn=lambda r: 100)
    b = env.from_collection([("k", 2)], timestamp_fn=lambda r: 200)
    (a.join(b).where(lambda r: r[0]).equal_to(lambda r: r[0])
     .window(TumblingEventTimeWindows.of(1000)).apply(lambda x, y: (x, y)).collect())
    with pytest.raises(RuntimeError, match="CUDA"):
        env.execute()
