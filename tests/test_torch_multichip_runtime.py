"""Mesh jobs on the port through the user-facing runtime, held against the
single-device port, a numpy oracle and the JAX package's mesh jobs.

Twins of tests/test_multichip_runtime.py: fused DataStream jobs
(graph/fusion.py -> DeviceChainRunner -> FusedWindowOperator ->
ShardedFusedPipeline) with `parallel.mesh.enabled` run through
`env.execute()` / `execute_async()` over a mesh of `["cpu"] * 8` shards
(`parallel/mesh.py::visible_devices` patched: the counterpart of the JAX
tests' virtual 8-device CPU mesh); the host-keyed fused path with key
capacity growth; a FusedWindowOperator snapshot crossing between one
device and the mesh (and the JAX package); live mesh rescales mid-stream,
down and up, exactly-once; and one visible device, where the job stays on
one device as the JAX package's `_mesh_for_config` has it.

Jobs are held on threading.Events inside the source's generator, never on
sleeps. Tolerance: exact (integer counts, sorted rows).
"""

import threading

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.datastream import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.windowing import assigners as jasg
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.config import ExecutionOptions as JaxExecutionOptions
from flink_tpu.config import ParallelOptions as JaxParallelOptions
from flink_tpu.connectors.sink import CollectSink as JaxCollectSink
from flink_tpu.connectors.source import Batch as JaxBatch
from flink_tpu.connectors.source import DataGeneratorSource as JaxGeneratorSource
from flink_tpu.core.watermarks import WatermarkStrategy as JaxWatermarkStrategy
from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
from flink_tpu_torch.api.windowing import assigners as tasg
from flink_tpu_torch.config import (
    Configuration,
    ExecutionOptions,
    ParallelOptions,
    RestartOptions,
)
from flink_tpu_torch.connectors.sink import CollectSink
from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
from flink_tpu_torch.core.watermarks import WatermarkStrategy
from flink_tpu_torch.graph.transformation import plan
from flink_tpu_torch.parallel import mesh as mesh_lib
from flink_tpu_torch.runtime.executor import build_runners

N_KEYS = 192          # divides an 8-shard mesh
SPAN_MS = 40_000
N = 20_000

JAX = dict(env=JaxEnv, cfg=JaxConfiguration, opts=JaxExecutionOptions,
           par=JaxParallelOptions, batch=JaxBatch, source=JaxGeneratorSource,
           wm=JaxWatermarkStrategy, sink=JaxCollectSink,
           key=lambda col: col[:, 0].astype(jnp.int32), env_kw={})
PORT = dict(env=StreamExecutionEnvironment, cfg=Configuration, opts=ExecutionOptions,
            par=ParallelOptions, batch=Batch, source=DataGeneratorSource,
            wm=WatermarkStrategy, sink=CollectSink,
            key=lambda col: col[:, 0].to(torch.int32), env_kw={"device": "cpu"})
WINDOWS = {"tumbling": lambda m: m.TumblingEventTimeWindows.of(5000),
           "sliding": lambda m: m.SlidingEventTimeWindows.of(8000, 2000)}


@pytest.fixture
def shards(monkeypatch):
    """`n` virtual shards: visible_devices gives the CPU n times."""
    def use(n):
        monkeypatch.setattr(mesh_lib, "visible_devices", lambda device: [torch.device("cpu")] * n)
    use(8)
    return use


def _columns(idx, n):
    camp = (idx * 2654435761) % N_KEYS
    etype = idx % 3
    col = np.stack([camp, etype], axis=1).astype(np.float32)
    ts = 10_000 + idx * SPAN_MS // n
    return col, ts.astype(np.int64)


def _make_env(pkg, window, *, mesh_on, n=N, batch=1536, devices=0, extra=None, hook=None):
    cfg = pkg["cfg"]()
    cfg.set(pkg["opts"].BATCH_SIZE, batch)
    cfg.set(pkg["opts"].KEY_CAPACITY, N_KEYS)
    cfg.set(pkg["opts"].SUPERBATCH_STEPS, 8)
    cfg.set(pkg["par"].MESH_ENABLED, mesh_on)
    if devices:
        cfg.set(pkg["par"].MESH_DEVICES, devices)
    for opt, val in (extra or {}).items():
        cfg.set(opt, val)

    def gen(idx):
        if hook is not None:
            hook(idx)
        col, ts = _columns(idx, n)
        return pkg["batch"](col, ts)

    env = pkg["env"](cfg, **pkg["env_kw"])
    # 7 splits over a count that is no multiple: ragged tails everywhere
    ds = env.from_source(pkg["source"](gen, n, num_splits=7),
                         watermark_strategy=pkg["wm"].for_bounded_out_of_orderness(0))
    sink = pkg["sink"]()
    (ds.filter(lambda col: col[:, 1] < 0.5, traceable=True)
       .key_by(pkg["key"], traceable=True)
       .window(window).count().sink_to(sink))
    return env, sink


def _rows(sink):
    return sorted((int(k), int(v)) for k, v in sink.results)


def _numpy_oracle(window, n):
    idx = np.arange(n)
    col, ts = _columns(idx, n)
    keep = col[:, 1] < 0.5
    size = window.slices_per_window * window.slice_ms
    slide = window.slide_slices * window.slice_ms
    counts = {}
    for k, t in zip(col[keep, 0].astype(np.int64), ts[keep]):
        start = t - (t % slide)
        while start > t - size:
            counts[(int(k), int(start))] = counts.get((int(k), int(start)), 0) + 1
            start -= slide
    return sorted((k, v) for (k, _s), v in counts.items())


@pytest.fixture(scope="module")
def reference_rows():
    """Per window shape: the single-device port's rows and the JAX mesh
    job's (8 devices of the conftest's CPU mesh)."""
    out = {}
    for name, win in WINDOWS.items():
        env, sink = _make_env(PORT, win(tasg), mesh_on=False)
        env.execute()
        jenv, jsink = _make_env(JAX, win(jasg), mesh_on=True)
        jenv.execute()
        out[name] = (_rows(sink), _rows(jsink))
    return out


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_fused_mesh_job_matches_single_chip_and_host_oracle(shards, reference_rows, window):
    env, sink = _make_env(PORT, WINDOWS[window](tasg), mesh_on=True)
    # the runner is the device chain AND it targets the sharded pipeline
    runners, _ = build_runners(plan(env._sinks), env.config, "cpu")
    fused = [r for r in runners if type(r).__name__ == "DeviceChainRunner"]
    assert fused and fused[0].op.mesh_devices() == 8
    assert type(fused[0].op.pipe).__name__ == "ShardedFusedPipeline"
    env.execute()
    single, jax_mesh = reference_rows[window]
    rows = _rows(sink)
    assert len(rows) > 0
    assert rows == single == jax_mesh
    assert rows == _numpy_oracle(WINDOWS[window](tasg), N)


@pytest.mark.parametrize("combine", [False, True], ids=["raw", "combine"])
@pytest.mark.parametrize("devices", [2, 4])
def test_mesh_job_options_reach_the_pipeline(shards, reference_rows, devices, combine):
    env, sink = _make_env(PORT, WINDOWS["tumbling"](tasg), mesh_on=True, devices=devices,
                          extra={ParallelOptions.MESH_LOCAL_COMBINE: combine})
    runners, _ = build_runners(plan(env._sinks), env.config, "cpu")
    pipe = runners[0].op.pipe
    assert pipe.n == devices and pipe.local_combine == combine
    env.execute()
    assert _rows(sink) == reference_rows["tumbling"][0]


def test_one_visible_device_stays_on_one_device(shards, reference_rows):
    shards(1)
    env, sink = _make_env(PORT, WINDOWS["tumbling"](tasg), mesh_on=True, devices=4)
    runners, _ = build_runners(plan(env._sinks), env.config, "cpu")
    assert runners[0].op.mesh_devices() == 1
    assert type(runners[0].op.pipe).__name__ == "FusedWindowPipeline"
    env.execute()
    assert _rows(sink) == reference_rows["tumbling"][0]


def test_key_capacity_that_no_mesh_divides_stays_on_one_device(shards):
    """The clamp rounds the shard count down to a divisor of the key
    capacity: 7 keys over 8 visible devices leave a mesh of 7, and 7 over
    a requested 4 leave 1 (one device)."""
    from flink_tpu_torch.runtime.executor import _mesh_for_config

    cfg = Configuration()
    cfg.set(ParallelOptions.MESH_ENABLED, True)
    assert _mesh_for_config(cfg, 7, "cpu").size == 7
    cfg.set(ParallelOptions.MESH_DEVICES, 4)
    assert _mesh_for_config(cfg, 7, "cpu") is None
    assert _mesh_for_config(Configuration(), 8, "cpu") is None


def test_classic_keydict_fused_path_on_mesh_with_capacity_growth(shards):
    """The host-keyed fused path goes onto the mesh too, and mid-stream
    dictionary growth past the operator's 1024-row start re-shards the
    global [K, S] state without losing a row."""
    n, n_keys = 20_000, 1600
    from flink_tpu_torch.utils.arrays import obj_array

    def build(mesh_on):
        cfg = Configuration()
        cfg.set(ExecutionOptions.BATCH_SIZE, 1024)
        cfg.set(ExecutionOptions.KEY_CAPACITY, 4096)
        cfg.set(ExecutionOptions.SUPERBATCH_STEPS, 8)
        cfg.set(ParallelOptions.MESH_ENABLED, mesh_on)

        def gen(idx):
            hi = np.where(idx < n // 2, 512, n_keys)
            keys = (idx * 48271) % hi
            vals = [(int(k), 1.0, int(t)) for k, t in zip(keys, 10_000 + idx * 3)]
            return Batch(obj_array(vals), (10_000 + idx * 3).astype(np.int64))

        env = StreamExecutionEnvironment(cfg, device="cpu")
        sink = CollectSink()
        (env.from_source(DataGeneratorSource(gen, n, num_splits=5),
                         watermark_strategy=WatermarkStrategy.for_monotonous_timestamps())
            .key_by(lambda x: x[0]).window(tasg.TumblingEventTimeWindows.of(4000)).count()
            .sink_to(sink))
        return env, sink

    env_m, sink_m = build(True)
    op = build_runners(plan(env_m._sinks), env_m.config, "cpu")[0][-2].op
    assert op.mesh_devices() == 8
    env_m.execute()
    env_s, sink_s = build(False)
    env_s.execute()
    assert len(_rows(sink_m)) > 0 and _rows(sink_m) == _rows(sink_s)


@pytest.mark.parametrize("src", ["port", "jax"])
def test_snapshot_interchange_single_chip_to_mesh_operator(src):
    """A FusedWindowOperator snapshot taken on one device (either package)
    restores into a mesh operator and into a one-device operator, which
    then emit the same rows."""
    from flink_tpu.runtime.fused_window_operator import FusedWindowOperator as JaxOp
    from flink_tpu_torch.core.time import MAX_WATERMARK
    from flink_tpu_torch.parallel.mesh import Mesh
    from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator

    def mk(mesh):
        return FusedWindowOperator(tasg.TumblingEventTimeWindows.of(2000), "count",
                                   key_capacity=128, superbatch_steps=4, chunk=256, mesh=mesh,
                                   device="cpu")

    rng = np.random.default_rng(5)
    a = (mk(None) if src == "port" else
         JaxOp(jasg.TumblingEventTimeWindows.of(2000), "count", key_capacity=128,
               superbatch_steps=4, chunk=256))
    for s in range(6):
        keys = rng.integers(0, 96, 300)
        a.process_batch(keys, np.ones(300, np.float32), np.full(300, s * 400, np.int64))
        a.process_watermark(s * 400)
    snap = a.snapshot()
    b = mk(Mesh(["cpu"] * 8))
    b.restore(snap)
    assert b.mesh_devices() == 8 and b.mesh_capacity() == 128
    a2 = mk(None)
    a2.restore(snap)
    for s in range(6, 12):
        keys = rng.integers(0, 96, 300)
        for op in (b, a2):
            op.process_batch(keys.copy(), np.ones(300, np.float32),
                             np.full(300, s * 400, np.int64))
            op.process_watermark(s * 400)
    for op in (b, a2):
        op.process_watermark(MAX_WATERMARK)
    got = sorted((k, int(r)) for k, _w, r, _t in b.drain_output())
    ref = sorted((k, int(r)) for k, _w, r, _t in a2.drain_output())
    assert got == ref and len(got) > 0
    # and the mesh operator's own snapshot restores on one device
    c = mk(None)
    c.restore(b.snapshot())
    assert c.pipe.K == 128


def _rescaled_run(shards, window, *, start, target, visible=8):
    """A mesh job that asks for a live rescale from inside its source: the
    generator holds at the quarter mark until the test has asked."""
    shards(visible)
    reached, go = threading.Event(), threading.Event()
    fired = []

    def hook(idx):
        if not fired and idx[0] >= N // 4:
            fired.append(True)
            reached.set()
            assert go.wait(60)

    env, sink = _make_env(PORT, window, mesh_on=True, batch=1024, devices=start,
                          extra={RestartOptions.INITIAL_BACKOFF_MS: 1}, hook=hook)
    client = env.execute_async("multichip-rescale")
    assert reached.wait(60)
    client.rescale_mesh(target)
    go.set()
    client.wait(120)
    return client, sink


def test_live_mesh_rescale_mid_stream_is_exactly_once(shards, reference_rows):
    """8 -> 4 at a step boundary (capture, rebuild, re-shard, restore):
    the rows equal an undisturbed one-device run's."""
    client, sink = _rescaled_run(shards, WINDOWS["sliding"](tasg), start=0, target=4)
    assert client.status().value == "FINISHED"
    assert client.mesh_rescales == 1 and client.num_restarts == 0
    assert client._runtime.mesh_devices() == 4
    kinds = [r["kind"] for r in client.exceptions.payload()["recoveries"]]
    assert kinds == ["rescale"]
    assert client.last_mesh_rescale_duration_ms > 0
    assert _rows(sink) == reference_rows["sliding"][0]


def test_mesh_rescale_up_mid_stream(shards, reference_rows):
    """2 -> 8 mid-stream, exact."""
    client, sink = _rescaled_run(shards, WINDOWS["tumbling"](tasg), start=2, target=8)
    assert client.status().value == "FINISHED"
    assert client.mesh_rescales == 1
    assert client._runtime.mesh_devices() == 8
    assert _rows(sink) == reference_rows["tumbling"][0]


def test_manual_rescale_to_same_effective_size_is_a_no_op(shards, reference_rows):
    """9 on an 8-shard mesh with 8 visible devices clamps back to 8: no
    rebuild, no recovery record."""
    client, sink = _rescaled_run(shards, WINDOWS["tumbling"](tasg), start=0, target=9)
    assert client.status().value == "FINISHED"
    assert client.mesh_rescales == 0 and client._runtime.mesh_devices() == 8
    assert client.exceptions.payload()["recoveries"] == []
    assert _rows(sink) == reference_rows["tumbling"][0]
