"""The DataStream path on the card against the same path on the CPU.

The fused device chain (torch prologue + kernel K1) and the host chain
(host key dictionary + K1, its key capacity doubling mid-job) run on CUDA
and are held against the port's plain CPU path on the same inputs. These
need an NVIDIA GPU and nvcc, so they carry the `cuda` marker and skip
elsewhere. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_datastream.py

(this file imports neither jax nor flink_tpu).

Tolerance: exact. Payloads are small integers, so every float32 partial
sum is an exact integer whatever order K1 adds in.
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
from flink_tpu_torch.api.windowing.assigners import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.config import Configuration, ExecutionOptions
from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
from flink_tpu_torch.core.time import MAX_WATERMARK
from flink_tpu_torch.core.watermarks import WatermarkStrategy
from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator
from flink_tpu_torch.testing.stream import api_columns

pytestmark = pytest.mark.cuda

KEYS = 4096


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K1 has no CPU form")
    return torch.device("cuda")


def _job(device, fused, n, assigner, aggregate, key_capacity=KEYS):
    cfg = Configuration()
    cfg.set(ExecutionOptions.CHAIN_FUSION, fused)
    cfg.set(ExecutionOptions.BATCH_SIZE, 8192)
    cfg.set(ExecutionOptions.SUPERBATCH_STEPS, 8)
    cfg.set(ExecutionOptions.KEY_CAPACITY, key_capacity)
    env = StreamExecutionEnvironment(cfg, device=device)
    keyed = (env.from_source(
        DataGeneratorSource(lambda idx: Batch(*api_columns(idx, n, KEYS, payload=True)), n),
        WatermarkStrategy.for_bounded_out_of_orderness(0))
        .filter(lambda c: c[:, 1] < 0.5, traceable=True)
        .key_by(lambda c: c[:, 0].to(torch.int32), traceable=True))
    value = {} if aggregate == "count" else dict(value_fn=lambda c: c[:, 2],
                                                 value_traceable=True)
    sink = keyed.window(assigner).aggregate(aggregate, **value).collect()
    cs.reset_launch_counts()
    env.execute()
    return sorted((int(k), float(v)) for k, v in sink.results), cs.LAUNCHES["k1_superscan"]


@pytest.mark.parametrize("aggregate", ["count", "sum", "max"])
def test_datastream_routes_on_the_card_match_the_cpu(cuda, aggregate):
    n = 1 << 18
    assigner = (SlidingEventTimeWindows.of(10_000, 1_000) if aggregate != "sum"
                else TumblingEventTimeWindows.of(2_000))
    ref, _ = _job("cpu", True, n, assigner, aggregate)
    for fused in (True, False):
        rows, launches = _job(cuda, fused, n, assigner, aggregate)
        assert launches > 0
        assert rows == ref and len(rows) > 1000


def test_out_of_range_key_raises_on_the_card(cuda):
    with pytest.raises(ValueError, match="outside \\[0, 1024\\)"):
        _job(cuda, True, 1 << 16, SlidingEventTimeWindows.of(10_000, 1_000), "count",
             key_capacity=1024)


def test_host_keyed_operator_grows_from_1024_to_8192_keys_on_the_card(cuda):
    """The host chain's operator starts at 1024 keys and doubles as the key
    dictionary grows, with a dispatch in flight: K1 runs at K = 1024, 2048,
    4096 and 8192 within one job."""
    rng = np.random.default_rng(3)
    kw = dict(key_capacity=1024, superbatch_steps=2, chunk=4096, columnar_output=False)
    window = SlidingEventTimeWindows.of(10_000, 1_000)
    ref = FusedWindowOperator(window, "sum", device="cpu", **kw)
    dev = FusedWindowOperator(window, "sum", device=cuda, **kw)
    seen_k = set()
    cs.reset_launch_counts()
    for t in range(16):
        hi = min(8192, 512 << (t // 2))
        keys = rng.integers(0, hi, 20000) * 13 + 1
        vals = rng.integers(0, 9, 20000).astype(np.float32)
        ts = 5000 + t * 700 + np.sort(rng.integers(0, 700, 20000))
        for op in (ref, dev):
            op.process_batch(keys, vals, ts)
            op.process_watermark(int(ts[-1]) - 1)
        seen_k.add(dev.pipe.K)
    for op in (ref, dev):
        op.process_watermark(MAX_WATERMARK - 1)
    assert {1024, 2048, 4096, 8192} <= seen_k and cs.LAUNCHES["k1_superscan"] >= 8
    got = dev.drain_output()
    assert got and [(k, w.start, v) for k, w, v, _t in ref.drain_output()] == \
        [(k, w.start, v) for k, w, v, _t in got]
