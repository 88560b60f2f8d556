"""The mesh on the card: K1's partials entry against its plain version, and
a 4-shard CUDA mesh against the one-card pipeline.

They need an NVIDIA GPU, so they carry the `cuda` marker and skip
elsewhere. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_mesh.py

Covered: `cuda_superscan.keyed_superscan_partials` (K1's partials entry)
bit for bit against `keyed_superscan_partials_plain` on count, sum, max8,
min/max and int fields, at chip_smoke.py's per-shard shape (K_local 2048,
T 32) and at a wide ring (S 256, rings in device memory); an int sum of
quarter values, cast once per cell by both K1 entries; a
ShardedFusedPipeline of four shards on the one card (raw exchange and the
map-side combiner, its step groups, a routing table, the traced chain)
against FusedWindowPipeline on the card and on the CPU; a mesh job
through env.execute with four virtual shards; the sharded join's rings
on the card.

Tolerance: exact (integer- or quarter-valued payloads; counts and order
statistics).
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.ops.aggregators import AccField, DeviceAggregator, ONE, max_agg, resolve
from flink_tpu_torch.ops.superscan import (
    keyed_superscan_partials_plain,
    segment_partials,
    value_fields,
)
from flink_tpu_torch.parallel.mesh import Mesh
from flink_tpu_torch.parallel.sharded_superscan import ShardedFusedPipeline
from flink_tpu_torch.runtime.fused_window_pipeline import FusedWindowPipeline, TracedPrologue

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _multi():
    return DeviceAggregator("multi", (
        AccField("count", np.int32, 0, "add", ONE),
        AccField("sum", np.float32, 0, "add"),
        AccField("imax", np.int32, -(2 ** 31), "max"),
        AccField("fmin", np.float32, float(np.finfo(np.float32).max), "min")),
        lambda f: f["sum"])


AGGS = {"count": lambda: resolve("count"), "sum": lambda: resolve("sum"),
        "max8": lambda: max_agg(domain_bits=8), "max": lambda: resolve("max"),
        "isum": lambda: DeviceAggregator("isum", (AccField("s", np.int32, 0, "add"),),
                                         lambda f: f["s"]),
        "multi": _multi}
SHAPES = {"shard": dict(S=32, K=2048, NSB=4, T=32, B=8192, R=64, F=4),
          "wide_ring": dict(S=256, K=1000, NSB=4, T=8, B=4096, R=16, F=4)}


def _inputs(agg, shape, dev, seed=0, quarters=False):
    """Random lanes and a random plan at `shape`; the partials B4 makes of
    the lanes (values with quarter fractions where `quarters`: their
    float32 sums are exact in any order); fresh rings."""
    rng = np.random.default_rng(seed)
    S, K, NSB, T, B, R, F = (shape[k] for k in ("S", "K", "NSB", "T", "B", "R", "F"))
    idx = torch.tensor(rng.integers(-1, K * NSB, (T, B)), dtype=torch.int32, device=dev)
    vals = torch.tensor(rng.integers(-40, 300, (T, B)) / (4 if quarters else 1),
                        dtype=torch.float32, device=dev)
    plan = tuple(torch.tensor(a, dtype=torch.int32, device=dev) for a in (
        rng.integers(0, S, T), rng.integers(0, S, (T, F)), rng.integers(0, 2, (T, F)),
        rng.integers(0, R, (T, F)), (rng.random((T, S)) > 0.1).astype(np.int32)))
    cpart, parts = segment_partials(agg, idx, vals, K * NSB)
    parts = [p.view(T, K, NSB) for p in parts]
    return cpart.view(T, K, NSB), parts, plan


def _rings(agg, shape, dev):
    from flink_tpu_torch.ops.aggregators import torch_dtype

    count = torch.zeros((shape["S"], shape["K"]), dtype=torch.int32, device=dev)
    states = [torch.full((shape["S"], shape["K"]), f.device_identity,
                         dtype=torch_dtype(f.dtype), device=dev) for f in value_fields(agg)]
    return count, states


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(AGGS))
def test_k1_partials_entry_matches_its_plain_version(cuda, name, shape):
    agg, geo = AGGS[name](), SHAPES[shape]
    cpart, parts, plan = _inputs(agg, geo, cuda)
    spws = tuple(range(3, 3 + geo["F"]))
    kc, ks = _rings(agg, geo, cuda)
    pc, ps = _rings(agg, geo, cuda)
    cs.reset_launch_counts()
    for _ in range(2):                       # twice: the rings carry over
        ko = cs.keyed_superscan_partials(agg, kc, ks, cpart, parts, plan, NSB=geo["NSB"],
                                         R=geo["R"], spws=spws)
        po = keyed_superscan_partials_plain(agg, pc, ps, cpart, parts, plan, NSB=geo["NSB"],
                                            R=geo["R"], spws=spws)
        torch.cuda.synchronize()
        assert torch.equal(kc, pc) and all(torch.equal(a, b) for a, b in zip(ks, ps))
        assert torch.equal(ko[0], po[0]) and all(torch.equal(a, b) for a, b in zip(ko[1], po[1]))
    assert cs.LAUNCHES["k1_partials"] == 2 and cs.CUDA_LAUNCHES["k1_partials"] == 4


def test_k1_partials_entry_casts_an_int_sum_once_per_cell(cuda):
    """An int add field's partial is its float32 sum: the partials entry
    casts each cell once, as the lane entry does (ROADMAP C3), so on quarter
    values both entries leave the same rings and rows, and the plain
    version's."""
    agg, geo = AGGS["isum"](), SHAPES["shard"]
    T, B = geo["T"], geo["B"]
    cpart, parts, plan = _inputs(agg, geo, cuda, seed=2, quarters=True)
    assert parts[0].dtype == torch.float32 and bool((parts[0].frac() != 0).any())
    rng = np.random.default_rng(2)
    idx = torch.tensor(rng.integers(-1, geo["K"] * geo["NSB"], (T, B)), dtype=torch.int32,
                       device=cuda)
    vals = torch.tensor(rng.integers(-40, 300, (T, B)) / 4, dtype=torch.float32, device=cuda)
    spws = tuple(range(3, 3 + geo["F"]))
    kw = dict(NSB=geo["NSB"], R=geo["R"], spws=spws)
    rings = [_rings(agg, geo, cuda) for _ in range(3)]
    outs = [cs.keyed_superscan_partials(agg, *rings[0], cpart, parts, plan, **kw),
            keyed_superscan_partials_plain(agg, *rings[1], cpart, parts, plan, **kw),
            cs.keyed_superscan(agg, *rings[2], idx.reshape(-1), vals.reshape(-1), plan,
                               exact=True, **kw)]
    torch.cuda.synchronize()
    for (c, st), (co, oo) in zip(rings[1:], outs[1:]):
        assert torch.equal(rings[0][0], c) and torch.equal(rings[0][1][0], st[0])
        assert torch.equal(outs[0][0], co) and torch.equal(outs[0][1][0], oo[0])


def test_k1_partials_entry_refuses_what_k1_refuses(cuda):
    agg = resolve("count")
    geo = dict(SHAPES["shard"], F=65)
    with pytest.raises(NotImplementedError, match="kernel K1"):
        cpart, parts, _plan = _inputs(agg, dict(geo, F=4), cuda)
        plan = tuple(torch.zeros(s, dtype=torch.int32, device=cuda)
                     for s in ((geo["T"],), (geo["T"], 65), (geo["T"], 65), (geo["T"], 65),
                               (geo["T"], geo["S"])))
        count, _ = _rings(agg, geo, cuda)
        cs.keyed_superscan_partials(agg, count, [], cpart, parts, plan, NSB=4, R=64,
                                    spws=(2,) * 65)


def _stream(seed, steps=8, batch=8192, keys=8192):
    rng = np.random.default_rng(seed)
    batches, wms = [], []
    for t in range(steps):
        ts = (t * 400 + np.sort(rng.integers(0, 400, batch))).astype(np.int64)
        batches.append((rng.integers(0, keys, batch).astype(np.int32),
                        rng.integers(0, 9, batch).astype(np.float32), ts))
        wms.append(t * 400 + 250)
    return batches, wms


def _rows(out):
    rows = []
    for w, c, f in out:
        live = np.flatnonzero(c > 0)
        rows.append((w.start, live.tolist(), c[live].tolist(),
                     {k: v[live].tolist() for k, v in sorted(f.items())}))
    return rows


@pytest.mark.parametrize("mode", ["raw", "combine", "routed"])
@pytest.mark.parametrize("agg", ["count", "sum", "max"])
def test_four_shards_on_one_card_match_the_one_card_pipeline(cuda, agg, mode):
    batches, wms = _stream(3)
    geo = dict(key_capacity=8192, num_slices=32, nsb=4, fires_per_step=4, out_rows=64,
               chunk=4096)
    window = SlidingEventTimeWindows.of(2000, 500)
    mesh = ShardedFusedPipeline(Mesh(["cuda:0"] * 4), window, agg,
                                local_combine=mode == "combine",
                                skew_routing=mode == "routed", num_key_groups=64, **geo)
    if mode == "routed":
        mesh.set_routing_assignment(np.roll(mesh.routing.assign, 5))
    rows = {}
    for name, pipe in (("mesh", mesh), ("card", FusedWindowPipeline(window, agg, device=cuda,
                                                                    **geo)),
                       ("cpu", FusedWindowPipeline(window, agg, device="cpu", **geo))):
        cs.reset_launch_counts()
        out = []
        for lo in range(0, len(batches), 4):
            out.extend(pipe.process_superbatch(batches[lo:lo + 4], wms[lo:lo + 4]))
        rows[name] = (_rows(out), dict(cs.LAUNCHES))
    assert len(rows["mesh"][0]) > 0
    assert rows["mesh"][0] == rows["card"][0] == rows["cpu"][0]
    entry = "k1_partials" if mode == "combine" else "k1_superscan"
    assert rows["mesh"][1][entry] == 4 * rows["card"][1]["k1_superscan"] == 8
    snap = mesh.snapshot()
    one = FusedWindowPipeline(window, agg, device=cuda, **geo)
    one.restore(snap)
    np.testing.assert_array_equal(one.snapshot()["count"], snap["count"])


@pytest.mark.parametrize("agg", ["count", "sum"])
def test_partials_in_step_groups_on_one_card(cuda, agg, monkeypatch):
    """With a partials budget of one step, four shards' map-side combiner
    runs each dispatch as four step groups and gives the one-card rows."""
    batches, wms = _stream(5)
    geo = dict(key_capacity=8192, num_slices=32, nsb=4, fires_per_step=4, out_rows=64,
               chunk=4096)
    window = SlidingEventTimeWindows.of(2000, 500)
    mesh = ShardedFusedPipeline(Mesh(["cuda:0"] * 4), window, agg, local_combine=True, **geo)
    monkeypatch.setattr(cs, "PARTIAL_BUDGET", 4 * 8192 * 4 * 4 * (1 + (agg == "sum")))
    assert len(mesh.partial_groups(4)) == 4
    rows = {}
    for name, pipe in (("mesh", mesh), ("card", FusedWindowPipeline(window, agg, device=cuda,
                                                                    **geo))):
        cs.reset_launch_counts()
        out = []
        for lo in range(0, len(batches), 4):
            out.extend(pipe.process_superbatch(batches[lo:lo + 4], wms[lo:lo + 4]))
        rows[name] = (_rows(out), dict(cs.LAUNCHES))
    assert len(rows["mesh"][0]) > 0 and rows["mesh"][0] == rows["card"][0]
    assert rows["mesh"][1]["k1_partials"] == 4 * 4 * 2


def test_traced_chain_on_four_shards_of_one_card(cuda):
    rng = np.random.default_rng(1)
    steps, wms = [], []
    for t in range(8):
        col = np.stack([rng.integers(0, 8192, 8192), rng.integers(0, 3, 8192)],
                       axis=1).astype(np.float32)
        steps.append((col, (t * 400 + np.sort(rng.integers(0, 400, 8192))).astype(np.int64)))
        wms.append(t * 400 + 250)
    pro = TracedPrologue((("filter", lambda c: c[:, 1] < 0.5),),
                         lambda c: c[:, 0].to(torch.int32))
    geo = dict(key_capacity=8192, num_slices=32, nsb=4, fires_per_step=4, out_rows=64,
               chunk=4096, prologue=pro)
    window = SlidingEventTimeWindows.of(2000, 500)
    got = []
    for pipe in (ShardedFusedPipeline(Mesh(["cuda:0"] * 4), window, "count", **geo),
                 FusedWindowPipeline(window, "count", device=cuda, **geo)):
        out = []
        for lo in range(0, 8, 4):
            out.extend(pipe.process_superbatch_raw(steps[lo:lo + 4], wms[lo:lo + 4]))
        got.append(_rows(out))
    assert len(got[0]) > 0 and got[0] == got[1]


def test_mesh_job_through_execute_on_four_virtual_shards(cuda, monkeypatch):
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration, ExecutionOptions, ParallelOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.parallel import mesh as mesh_lib
    from flink_tpu_torch.runtime.executor import build_runners

    monkeypatch.setattr(mesh_lib, "visible_devices", lambda device: [torch.device("cuda", 0)] * 4)
    n = 1 << 17

    def run(mesh_on):
        cfg = Configuration()
        cfg.set(ExecutionOptions.BATCH_SIZE, 8192)
        cfg.set(ExecutionOptions.KEY_CAPACITY, 8192)
        cfg.set(ParallelOptions.MESH_ENABLED, mesh_on)

        def gen(idx):
            col = np.stack([(idx * 2654435761) % 8192, idx % 3], axis=1).astype(np.float32)
            return Batch(col, (10_000 + idx * 64_000 // n).astype(np.int64))

        env = StreamExecutionEnvironment(cfg)
        sink = (env.from_source(DataGeneratorSource(gen, n),
                                WatermarkStrategy.for_bounded_out_of_orderness(0))
                .filter(lambda c: c[:, 1] < 0.5, traceable=True)
                .key_by(lambda c: c[:, 0].to(torch.int32), traceable=True)
                .window(SlidingEventTimeWindows.of(10_000, 1_000)).count().collect())
        op = build_runners(plan(env._sinks), env.config)[0][0].op
        cs.reset_launch_counts()
        env.execute()
        return op.mesh_devices(), sorted(sink.results), cs.LAUNCHES["k1_superscan"]

    n_mesh, rows_mesh, k1_mesh = run(True)
    n_one, rows_one, k1_one = run(False)
    assert (n_mesh, n_one) == (4, 1)
    assert len(rows_mesh) > 0 and rows_mesh == rows_one
    assert k1_mesh == 4 * k1_one > 0


def test_sharded_join_rings_on_the_card(cuda):
    from flink_tpu_torch.joins.pipeline import FusedJoinPipeline
    from flink_tpu_torch.joins.sharded import ShardedJoinPipeline
    from flink_tpu_torch.joins.spec import plan_join_geometry

    geom = plan_join_geometry(2000, 1000, 0, key_capacity=1024, bucket_capacity=16,
                              ring_slack_buckets=2)
    rng = np.random.default_rng(4)
    pipes = [ShardedJoinPipeline(geom, Mesh(["cuda:0"] * 4)), FusedJoinPipeline(geom, cuda)]
    assert all(a.device.type == "cuda" for a in pipes[0].left.idx_arrs)
    feeds = [(side, rng.integers(0, 1024, 500), rng.integers(0, 2000, 500).astype(np.int64))
             for side in (0, 1)]
    got = []
    for pipe in pipes:
        for side, kids, ts in feeds:
            pipe.ingest(side, kids, ts, list(range(500)))
        got.append([a.tolist() for a in pipe.fire_window(0, 2000)])
    assert len(got[0][0]) > 0 and got[0] == got[1]
