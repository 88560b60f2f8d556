"""The mesh's control loops on the card: K1 once per shard under a
rebalanced routing table, and the rebalance, autoscale and device-loss
degrade of mesh jobs on four shards of the card.

They need an NVIDIA GPU, so they carry the `cuda` marker and skip
elsewhere. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_mesh_control.py

Covered: a ShardedFusedPipeline of four shards on the card under a
permuted key-group table (raw exchange and the map-side combiner) against
the same pipeline on four CPU shards (the plain version), fire rows and
snapshots bit for bit, K1's launches once per shard a dispatch; shard 0's
K1 inputs under the table, the lane entry and the partials entry against
their plain versions with the phase counters; the table swap mid-stream;
tests/test_skew_routing.py's skewed job under the rebalancer on four
shards of the card against the same job on four CPU shards (rows,
rebalances, table version, decisions); the autoscaler's 4 -> 2 and the
device-loss degrade (a device-scoped marker at the sixth sharded
dispatch) on four shards of the card, against the job on the CPU.

Tolerance: exact (integer counts and sums of small integers).
"""

import threading

import numpy as np
import pytest
import torch

from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.ops.superscan import keyed_superscan_partials_plain, keyed_superscan_plain
from flink_tpu_torch.parallel import mesh as mesh_lib
from flink_tpu_torch.parallel.mesh import Mesh
from flink_tpu_torch.parallel.sharded_superscan import ShardedFusedPipeline

pytestmark = pytest.mark.cuda

K, T, B = 1024, 8, 2048
GEOM = dict(key_capacity=K, num_slices=32, nsb=4, fires_per_step=4, out_rows=64, chunk=1024)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _stream(n_steps, seed=3, vals=False):
    """Zipf-like keys clustered in the first quarter of the key space (the
    static table's first shard), 1 s of event time a step."""
    rng = np.random.default_rng(seed)
    batches, wms = [], []
    for t in range(n_steps):
        hot = rng.integers(0, K // 4, B)
        cold = rng.integers(0, K, B)
        keys = np.where(rng.random(B) < 0.7, hot, cold).astype(np.int64)
        ts = (t * 1000 + rng.integers(0, 1000, B)).astype(np.int64)
        v = rng.integers(0, 9, B).astype(np.float32) if vals else None
        batches.append((keys, v, ts))
        wms.append(t * 1000 - 1)
    return batches, wms


def _permuted(pipe):
    G, n = pipe.routing.G, pipe.n
    return np.repeat(np.arange(n)[::-1], G // n)


def _pipe(device, agg, combine):
    return ShardedFusedPipeline(Mesh([device] * 4), SlidingEventTimeWindows.of(4000, 1000), agg,
                                local_combine=combine, skew_routing=True, **GEOM)


def _fires(out):
    return [(w.start, w.end, np.asarray(c).tolist(), {k: np.asarray(v).tolist()
                                                       for k, v in f.items()})
            for w, c, f in out]


@pytest.mark.parametrize("combine", [False, True], ids=["raw", "combine"])
@pytest.mark.parametrize("agg", ["count", "sum"])
def test_k1_per_shard_under_a_rebalanced_table_equals_the_cpu_mesh(cuda, agg, combine):
    batches, wms = _stream(4 * T, vals=agg == "sum")
    runs = {}
    for name, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        pipe = _pipe(dev, agg, combine)
        pipe.set_routing_assignment(_permuted(pipe))
        cs.reset_launch_counts()
        fires = []
        for d in range(4):
            sl = slice(d * T, (d + 1) * T)
            fires += _fires(pipe.process_superbatch(batches[sl], wms[sl]))
            if d == 1:
                # a second swap mid-stream, back to identity and forth
                pipe.set_routing_assignment((np.arange(pipe.routing.G) * 4) // pipe.routing.G)
                pipe.set_routing_assignment(_permuted(pipe))
        torch.cuda.synchronize()
        runs[name] = (fires, pipe.snapshot(), dict(cs.LAUNCHES), pipe.routing_version())
    card, cpu = runs["card"], runs["cpu"]
    assert card[0] == cpu[0] and len(card[0]) > 0
    for key in ("count",):
        assert np.array_equal(card[1][key], cpu[1][key])
    for name, arr in card[1]["state"].items():
        assert np.array_equal(arr, cpu[1]["state"][name])
    entry = "k1_partials" if combine else "k1_superscan"
    assert card[2][entry] >= 4 * 4 and card[2][entry] % 4 == 0
    assert cpu[2][entry] == 0            # CPU shards run the plain version
    assert card[3] == cpu[3] == 3


@pytest.mark.parametrize("combine", [False, True], ids=["lanes", "partials"])
def test_shard_zero_k1_inputs_under_the_table_match_the_plain_version(cuda, combine):
    from flink_tpu_torch.runtime.fused_window_pipeline import phase_buffer

    pipe = _pipe(cuda, "count", combine)
    pipe.set_routing_assignment(_permuted(pipe))
    batches, wms = _stream(T)
    staged = pipe.stage_superbatch([(k, v, t) for k, v, t in batches], wms)
    plan = pipe._plan_on(staged[2][:5], {}, cuda) + (staged[2][5],)
    src_idx, src_vals, _kb = pipe.source_lanes(staged, T)
    kw = dict(NSB=pipe.NSB, R=pipe.R, spws=pipe.slot_spws())
    rings = [(torch.zeros((pipe.S, pipe.K_local), dtype=torch.int32, device=cuda), [])
             for _ in range(2)]
    phases = [phase_buffer(True, cuda) for _ in range(2)]
    if combine:
        cpart, parts = pipe.route_partials(src_idx, src_vals, 0, T)[0]
        got = cs.keyed_superscan_partials(pipe.agg, *rings[0], cpart, parts, plan[:5],
                                          phase=phases[0], **kw)
        want = keyed_superscan_partials_plain(pipe.agg, *rings[1], cpart, parts, plan[:5],
                                              phase=phases[1], **kw)
    else:
        idx, vals = pipe.route_lanes(src_idx, src_vals)[0]
        got = cs.keyed_superscan(pipe.agg, *rings[0], idx.reshape(-1), vals, plan[:5],
                                 phase=phases[0], exact=True, **kw)
        want = keyed_superscan_plain(pipe.agg, *rings[1], idx.reshape(-1), vals, plan[:5],
                                     phase=phases[1], exact=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(rings[0][0], rings[1][0]) and rings[0][0].sum() > 0
    assert torch.equal(got[0], want[0])
    assert torch.equal(phases[0], phases[1]) and int(phases[0][0]) > 0


def _shards(monkeypatch, device, n=4):
    monkeypatch.setattr(mesh_lib, "visible_devices", lambda d: [device] * n)


def _skewed_job(dev):
    """tests/test_skew_routing.py's skewed host-keyed job on four shards of
    `dev` under the rebalancer: (rows, rebalances, table version, recovery
    kinds, decisions but their times)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.sink import CollectSink
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy

    def keys_of(idx):
        u = ((idx * 2654435761) % 1000) / 1000.0
        return np.where(u < 0.7, (idx % 32) * 8, (idx * 40503) % 256).astype(np.int64)

    cfg = Configuration({"execution.step.batch-size": 512, "execution.state.key-capacity": 256,
                         "execution.window.superbatch-steps": 4, "parallel.mesh.enabled": True,
                         "parallel.mesh.devices": 4, "parallel.mesh.local-combine": True,
                         "parallel.mesh.skew-rebalance": True,
                         "parallel.mesh.rebalance.skew-threshold": 1.2,
                         "parallel.mesh.rebalance.interval-ms": 0})
    env = StreamExecutionEnvironment(cfg, device=dev)
    sink = CollectSink()
    (env.from_source(DataGeneratorSource(
        lambda idx: Batch(keys_of(idx), (idx * 2).astype(np.int64)), 16 * 512),
        WatermarkStrategy.for_monotonous_timestamps())
        .key_by(lambda col: col, vectorized=True)
        .window(TumblingEventTimeWindows.of(1000)).count().sink_to(sink))
    client = env.execute_async("skew-routing")
    client.wait(300)
    return (sorted((int(k), int(c)) for k, c in sink.results), client.mesh_rebalances,
            client._runtime.mesh_routing_version(),
            [r["kind"] for r in client.exceptions.payload()["recoveries"]],
            [{k: v for k, v in d.as_dict().items() if k != "timestamp"}
             for d in client.rebalancer.decisions])


def test_rebalanced_mesh_job_on_the_card_equals_the_cpu_mesh(cuda, monkeypatch):
    facts = {}
    for name, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        _shards(monkeypatch, dev)
        facts[name] = _skewed_job(dev)
    assert facts["card"] == facts["cpu"]
    rows, rebalances, version, kinds, _decisions = facts["card"]
    assert len(rows) > 0 and rebalances >= 1 and version >= 1 and set(kinds) == {"rebalance"}


def _tumbling_job(dev, *, mesh_on, extra=None, hook=None, n=40_000):
    """tests/test_torch_multichip_runtime.py's program: a traceable filter
    and key over 192 campaigns, 5 s tumbling counts, batch 1024."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.sink import CollectSink
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy

    cfg = Configuration({"execution.step.batch-size": 1024, "execution.state.key-capacity": 192,
                         "execution.window.superbatch-steps": 8,
                         "parallel.mesh.enabled": mesh_on,
                         "restart-strategy.initial-backoff": 1, **(extra or {})})

    def gen(idx):
        if hook is not None:
            hook(idx)
        col = np.stack([(idx * 2654435761) % 192, idx % 3], axis=1).astype(np.float32)
        return Batch(col, (10_000 + idx * 40_000 // n).astype(np.int64))

    env = StreamExecutionEnvironment(cfg, device=dev)
    sink = CollectSink()
    (env.from_source(DataGeneratorSource(gen, n, num_splits=7),
                     WatermarkStrategy.for_bounded_out_of_orderness(0))
        .filter(lambda col: col[:, 1] < 0.5, traceable=True)
        .key_by(lambda col: col[:, 0].to(torch.int32), traceable=True)
        .window(TumblingEventTimeWindows.of(5000)).count().sink_to(sink))
    return env, sink


def _rows(sink):
    return sorted((int(k), int(v)) for k, v in sink.results)


def test_autoscale_and_device_loss_on_four_shards_of_the_card(cuda, monkeypatch):
    from flink_tpu_torch.checkpoint.coordinator import CheckpointCoordinator

    _shards(monkeypatch, cuda)
    env, sink = _tumbling_job(cuda, mesh_on=False)
    env.execute()
    reference = _rows(sink)
    cpu_env, cpu_sink = _tumbling_job("cpu", mesh_on=False)
    cpu_env.execute()
    assert reference == _rows(cpu_sink) and len(reference) > 0
    # the autoscaler's executor: 4 -> 2 while the source is held
    reached, go, fired = threading.Event(), threading.Event(), []

    def hook(idx):
        if not fired and idx[0] >= 10_000:
            fired.append(True)
            reached.set()
            go.wait(120)

    env, sink = _tumbling_job(cuda, mesh_on=True, hook=hook,
                              extra={"autoscaler.enabled": True})
    client = env.execute_async("card-autoscale")
    try:
        assert reached.wait(120)
        accepted, detail = client.autoscaler.rescale_executor(client.job_id, 4, "drill")
        assert not accepted and "already at 4" in detail
        assert client.autoscaler.rescale_executor(client.job_id, 2, "drill")[0]
    finally:
        go.set()
    client.wait(300)
    assert client.mesh_rescales == 1 and client._runtime.mesh_devices() == 2
    assert _rows(sink) == reference
    # the degrade: a device-scoped failure at the sixth sharded dispatch
    monkeypatch.setattr(CheckpointCoordinator, "due", lambda self: True)
    real, calls = ShardedFusedPipeline._scan_shards, [0]

    def scan(pipe, *a, **kw):
        calls[0] += 1
        if calls[0] == 6:
            raise RuntimeError("[chaos-injected:device] shard 1 lost")
        return real(pipe, *a, **kw)

    monkeypatch.setattr(ShardedFusedPipeline, "_scan_shards", scan)
    env, sink = _tumbling_job(cuda, mesh_on=True,
                              extra={"execution.checkpointing.interval": 5,
                                     "parallel.mesh.degrade-on-device-loss": True})
    client = env.execute_async("card-device-loss")
    client.wait(300)
    assert client.status().value == "FINISHED" and client.num_restarts == 1
    assert calls[0] > 6 and client._runtime.mesh_devices() == 2
    (recovery,) = client.exceptions.payload()["recoveries"]
    assert recovery["restored_checkpoint_id"] is not None
    assert _rows(sink) == reference
