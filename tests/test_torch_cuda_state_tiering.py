"""The state plane's device side on the card against the port's CPU path on
the same inputs.

They need an NVIDIA GPU, so they carry the `cuda` marker and skip
elsewhere. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_state_tiering.py

Covered: the pipeline's row surface (`gather_key_rows`, `clear_key_rows`,
`write_cells`, `gather_cells`) on [S, K] rings for every built-in
aggregate; the tiered `FusedWindowOperator` under churn (K1 launched); the
hot/cold `TpuWindowOperator`; a `state.tier.*` DataStream job.

Tolerance: exact. Payloads are small integers, so float32 sums are exact
in any order of the atomics.
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch.api.windowing.assigners import (
    SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from flink_tpu_torch.core.time import MAX_WATERMARK
from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator
from flink_tpu_torch.runtime.fused_window_pipeline import FusedWindowPipeline
from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator
from flink_tpu_torch.state.tier_manager import TierConfig

pytestmark = pytest.mark.cuda

K, S, M = 1 << 16, 32, 1 << 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rings_equal(a, b):
    assert torch.equal(a._count.cpu(), b._count)
    for name in b._state:
        assert torch.equal(a._state[name].cpu(), b._state[name]), name


@pytest.mark.parametrize("agg", ["count", "sum", "min", "max", "mean"])
def test_row_surface_matches_the_cpu(cuda, agg):
    window = SlidingEventTimeWindows.of(10_000, 1_000)
    pipes = {d: FusedWindowPipeline(window, agg, key_capacity=K, num_slices=S, device=d)
             for d in (cuda, "cpu")}
    g = torch.Generator().manual_seed(3)
    count = torch.randint(0, 50, (S, K), generator=g, dtype=torch.int32)
    fields = {n: torch.randint(-1000, 1000, (S, K), generator=g).to(a.dtype)
              for n, a in pipes["cpu"]._state.items()}
    for p in pipes.values():
        p._count.copy_(count)
        for n, a in p._state.items():
            a.copy_(fields[n])
    rng = np.random.default_rng(4)
    kids = rng.choice(K, M, replace=False)
    got = {d: p.gather_key_rows(kids) for d, p in pipes.items()}
    assert got["cpu"][0].shape == (M, S) and got["cpu"][0].dtype == np.int32
    assert np.array_equal(got[cuda][0], got["cpu"][0])
    for n in fields:
        assert got[cuda][1][n].dtype == got["cpu"][1][n].dtype
        assert np.array_equal(got[cuda][1][n], got["cpu"][1][n])
    for p in pipes.values():
        p.clear_key_rows(kids)
    _rings_equal(pipes[cuda], pipes["cpu"])
    cell_k, cell_s = rng.choice(K, M, replace=False), rng.integers(0, S, M)
    counts = rng.integers(1, 9, M)
    vals = {n: rng.integers(-50, 50, M).astype(np.float64) for n in fields}
    for p in pipes.values():
        p.write_cells(cell_k, cell_s, counts, vals)
    _rings_equal(pipes[cuda], pipes["cpu"])
    cells = {d: p.gather_cells(cell_k, cell_s) for d, p in pipes.items()}
    assert np.array_equal(cells[cuda][0], counts)
    for n in fields:
        assert np.array_equal(cells[cuda][1][n], cells["cpu"][1][n])


def _stream(op, seed=7, steps=40, n_keys=2000, batch=4096):
    r = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        keys = r.integers(0, n_keys, batch)
        vals = (keys % 5 + 1).astype(np.float32)
        ts = (s * 250 + r.integers(0, 250, batch)).astype(np.int64)
        op.process_batch(keys, vals, ts)
        op.process_watermark(s * 250 + 125)
        out.extend(op.drain_output())
    op.process_watermark(MAX_WATERMARK - 1)
    out.extend(op.drain_output())
    return sorted((int(k), int(w.start), float(v)) for k, w, v, _ in out)


@pytest.mark.parametrize("agg", ["sum", "count", "max"])
def test_tiered_fused_operator_matches_the_cpu(cuda, agg):
    def make(d):
        return FusedWindowOperator(SlidingEventTimeWindows.of(2000, 500), agg,
                                   superbatch_steps=8, device=d,
                                   tier=TierConfig(hot_key_capacity=256))
    cs.reset_launch_counts()
    op = make(cuda)
    got = _stream(op)
    assert cs.LAUNCHES["k1_superscan"] > 0
    assert op.tier.vocab.num_evictions > 0 and op.tier.num_promoted_rows > 0
    assert got == _stream(make("cpu"))


def test_hot_cold_window_operator_matches_the_cpu(cuda):
    def run(d):
        op = TpuWindowOperator(TumblingEventTimeWindows.of(1000), "sum", key_capacity=1024,
                               hot_key_capacity=128, device=d)
        return _stream(op, steps=12), op.cold_tier.num_cold_rows_written
    (got, cold), (want, _) = run(cuda), run("cpu")
    assert got == want and cold > 0


def test_tiered_datastream_job_matches_the_cpu(cuda):
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.sink import CollectSink
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    n = 1 << 15

    def run(d):
        env = StreamExecutionEnvironment(Configuration({
            "execution.step.batch-size": 2048, "execution.state.key-capacity": 1 << 14,
            "state.tier.enabled": True, "state.tier.hot-key-capacity": 512,
            "state.tier.admission-min-count": 2}), device=d)
        sink = CollectSink()
        (env.from_source(DataGeneratorSource(
            lambda idx: Batch(*st.millikey_columns(idx, n, 1 << 14, True)), n),
            WatermarkStrategy.for_bounded_out_of_orderness(0))
         .key_by(lambda c: c, vectorized=True)
         .window(SlidingEventTimeWindows.of(10_000, 1_000)).count().sink_to(sink))
        env.execute()
        return sorted(sink.results)
    cs.reset_launch_counts()
    got = run(cuda)
    assert cs.LAUNCHES["k1_superscan"] > 0
    assert got == run("cpu") == st.millikey_oracle(n, 1 << 14, True)
