"""The main path's features on the port's mesh, held against the JAX
package's mesh and the one-device port.

The port runs on meshes of `["cpu"] * n` shards (the plain version of K1
and of its partials entry), the JAX package on the tier-1 conftest's
virtual 8-device CPU mesh, over the same numpy-made streams:

- shared correlated windows: `ShardedFusedPipeline(assigners=)` on meshes
  of 2 and 4 with the map-side combiner on and off, its snapshots'
  `fire_cursors`, the shared-partials FusedWindowOperator on the mesh with
  snapshots crossing to the other package and to one device both ways, and
  bench.py::correlated_windows_microbench's program through both
  packages' `env.execute()` with `parallel.mesh.enabled`;
- the tiered state plane: the sharded row surface (`gather_key_rows`,
  `clear_key_rows`, `write_cells`, `gather_cells`) against the JAX mesh's
  and across mesh sizes and a permuted routing table, the tiered operator
  on the mesh under churn, its snapshots, and millikey_microbench's
  program through both packages' `env.execute()` on the mesh;
- queryable state: `query_state_for` on the mesh operator against the JAX
  mesh operator's, the errors of the chain and tiered paths, and
  `JobClient.query_state` on a running mesh job.

Tolerance: exact. Counts are integers and payloads small integers, so
every float32 partial sum is exact whatever the order of the adds; the
row surface is compared bit for bit.
"""

import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from jax.sharding import Mesh as JaxMesh  # noqa: E402

import test_torch_shared_pipeline as shp  # noqa: E402
import test_torch_state_tiering as tier_twins  # noqa: E402
from flink_tpu.api.windowing import assigners as jasg  # noqa: E402
from flink_tpu.core.time import MAX_WATERMARK  # noqa: E402
from flink_tpu.parallel import sharded_superscan as jss  # noqa: E402
from flink_tpu.runtime import fused_window_operator as jfo  # noqa: E402
from flink_tpu.runtime import fused_window_pipeline as jfp  # noqa: E402
from flink_tpu.state import tier_manager as jtm  # noqa: E402
from flink_tpu_torch.api.windowing import assigners as tasg  # noqa: E402
from flink_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from flink_tpu_torch.parallel import sharded_superscan as tsp  # noqa: E402
from flink_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from flink_tpu_torch.runtime import fused_window_operator as tfo  # noqa: E402
from flink_tpu_torch.runtime import fused_window_pipeline as tfp  # noqa: E402
from flink_tpu_torch.state import tier_manager as ttm  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401

NUM_KEYS = shp.NUM_KEYS
SHARED_GEOM = dict(key_capacity=NUM_KEYS, nsb=4, fires_per_step=4, out_rows=64, chunk=256)


def _jmesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("shards",))


@pytest.fixture
def shards(monkeypatch):
    """`n` virtual shards for jobs: visible_devices gives the CPU n times."""
    def use(n):
        monkeypatch.setattr(mesh_lib, "visible_devices",
                            lambda device: [torch.device("cpu")] * n)
    use(4)
    return use


# ---------------------------------------------------------------------------
# shared correlated windows on the mesh: the pipeline
# ---------------------------------------------------------------------------

def _port_shared(group, agg, n, combine=False):
    return tsp.ShardedFusedPipeline(Mesh(["cpu"] * n), None, agg,
                                    assigners=shp._assigners(tasg, group),
                                    local_combine=combine, **SHARED_GEOM)


def _jax_shared(group, agg, n, combine=False):
    return jss.ShardedFusedPipeline(_jmesh(n), None, agg, assigners=shp._assigners(jasg, group),
                                    local_combine=combine, **SHARED_GEOM)


@pytest.fixture(scope="module")
def shared_stream():
    return shp._stream(32, 300, seed=4)


def _shared_rows(pipe, batches, wms, lo=0, hi=32):
    rows = []
    for t in range(lo, hi, 4):
        rows += shp._emissions(pipe.process_superbatch(batches[t:t + 4], wms[t:t + 4]))
    return rows


@pytest.fixture(scope="module")
def one_device_shared(shared_stream):
    return {(g, a): _shared_rows(shp._port_pipe(g, a), *shared_stream)
            for g in shp.GROUPS for a in ("count", "sum")}


JAX_SHARED = [("three", "count", 2, False), ("three", "sum", 4, True),
              ("five", "sum", 2, True), ("five", "count", 4, False)]


@pytest.mark.parametrize("group,agg,n,combine", JAX_SHARED,
                         ids=[f"{g}-{a}-n{n}-{'combine' if c else 'raw'}"
                              for g, a, n, c in JAX_SHARED])
def test_sharded_shared_pipeline_matches_jax(shared_stream, one_device_shared, group, agg, n,
                                             combine):
    port = _port_shared(group, agg, n, combine)
    assert port.F == 4 * len(shp.GROUPS[group]) and port.local_combine == combine
    assert port.slot_spws() == shp._port_pipe(group, agg, plan_only=True).slot_spws()
    got = _shared_rows(port, *shared_stream)
    ref = _jax_shared(group, agg, n, combine)
    assert got == _shared_rows(ref, *shared_stream)
    assert got == one_device_shared[(group, agg)]
    assert {s for s, *_ in got} == set(range(len(shp.GROUPS[group])))
    assert port.fire_cursors == ref._planner.fire_cursors
    assert port.snapshot()["fire_cursors"] == ref.snapshot()["fire_cursors"]


@pytest.mark.parametrize("combine", [False, True], ids=["raw", "combine"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("group", sorted(shp.GROUPS))
def test_sharded_shared_pipeline_matches_one_device(shared_stream, one_device_shared, group, n,
                                                    combine):
    for agg in ("count", "sum"):
        got = _shared_rows(_port_shared(group, agg, n, combine), *shared_stream)
        assert got == one_device_shared[(group, agg)]


@pytest.mark.parametrize("dst", ["port_one", "port_mesh2", "jax_mesh", "jax_one"])
def test_sharded_shared_snapshot_restores_with_its_fire_cursors(shared_stream,
                                                                one_device_shared, dst):
    """A shared mesh pipeline's snapshot, taken mid-stream, carries the
    members' fire cursors and resumes on one device, on another mesh size
    and in the JAX package, to the uninterrupted rows; and a snapshot of
    each of those resumes on the mesh."""
    batches, wms = shared_stream
    whole = one_device_shared[("five", "sum")]
    make = {"port_one": lambda: shp._port_pipe("five", "sum"),
            "port_mesh2": lambda: _port_shared("five", "sum", 2),
            "jax_mesh": lambda: _jax_shared("five", "sum", 2),
            "jax_one": lambda: shp._jax_pipe("five", "sum", backend="xla")}[dst]
    first = _port_shared("five", "sum", 4, combine=True)
    rows = _shared_rows(first, batches, wms, 0, 16)
    snap = first.snapshot()
    assert snap["fire_cursors"] == first.fire_cursors and None not in snap["fire_cursors"]
    second = make()
    second.restore(snap)
    assert rows + _shared_rows(second, batches, wms, 16, 32) == whole
    # the other way: that pipeline's snapshot resumes on the mesh
    other = make()
    rows = _shared_rows(other, batches, wms, 0, 16)
    mesh = _port_shared("five", "sum", 4)
    mesh.restore(other.snapshot())
    assert mesh.fire_cursors == list(other.snapshot()["fire_cursors"])
    assert rows + _shared_rows(mesh, batches, wms, 16, 32) == whole


# ---------------------------------------------------------------------------
# shared correlated windows on the mesh: the operator
# ---------------------------------------------------------------------------

def _port_shared_op(n, group="five", agg="sum"):
    return tfo.FusedWindowOperator(None, agg, assigners=shp._assigners(tasg, group),
                                   prologue=shp._prologues()[0], device="cpu",
                                   mesh=None if n is None else Mesh(["cpu"] * n), **shp.OP_KW)


def _jax_shared_op(n, group="five", agg="sum"):
    return jfo.FusedWindowOperator(None, agg, assigners=shp._assigners(jasg, group),
                                   prologue=shp._prologues()[1],
                                   mesh=None if n is None else _jmesh(n), **shp.OP_KW)


@pytest.fixture(scope="module")
def shared_op_stream():
    batches, wms = shp._stream(40, 200, seed=5)
    raw = shp._raw(batches)
    op = _port_shared_op(None)
    return raw, wms, shp._finish(op, shp._feed(op, raw, wms, 5), 5)


def test_shared_operator_on_the_mesh_matches_jax_mesh(shared_op_stream):
    raw, wms, whole = shared_op_stream
    port, ref = _port_shared_op(4), _jax_shared_op(4)
    assert type(port.pipe).__name__ == "ShardedFusedPipeline" and port.mesh_devices() == 4
    assert type(port.norm).__name__ == "SharedStepNormalizer"
    got = shp._finish(port, shp._feed(port, raw, wms, 5), 5)
    assert got == whole and all(len(lane) > 0 for lane in got)
    assert got == shp._finish(ref, shp._feed(ref, raw, wms, 5), 5)


SHARED_CROSSINGS = [("port_mesh", "port_one"), ("port_one", "port_mesh"),
                    ("port_mesh", "jax_mesh"), ("jax_mesh", "port_mesh"),
                    ("port_mesh", "jax_one"), ("jax_one", "port_mesh")]


@pytest.mark.parametrize("src,dst", SHARED_CROSSINGS,
                         ids=[f"{s}-to-{d}" for s, d in SHARED_CROSSINGS])
def test_shared_mesh_operator_snapshot_crosses(shared_op_stream, src, dst):
    """A shared mesh operator's mid-stream snapshot resumes in the other
    package and on one device, both ways, to the uninterrupted lanes."""
    raw, wms, whole = shared_op_stream
    make = {"port_mesh": lambda: _port_shared_op(4), "port_one": lambda: _port_shared_op(None),
            "jax_mesh": lambda: _jax_shared_op(2), "jax_one": lambda: _jax_shared_op(None)}
    first, second = make[src](), make[dst]()
    lanes = shp._feed(first, raw[:17], wms[:17], 5)
    first.process_raw_batch(*raw[17])
    first.process_watermark(wms[17])
    snap = first.snapshot()
    assert snap["pipe"]["fire_cursors"] and len(snap["spec_outputs"]) == 5
    second.restore(snap)
    rest = shp._finish(second, shp._feed(second, raw[18:], wms[18:], 5), 5)
    assert [a + b for a, b in zip(lanes, rest)] == whole


# ---------------------------------------------------------------------------
# shared correlated windows on the mesh: the DataStream program
# ---------------------------------------------------------------------------

def _correlated_mesh(name, shared, devices):
    import test_torch_window_sharing as ws

    pkg = ws.PORT if name == "port" else ws.JAX
    env, cfg, sinks = ws._correlated(pkg, shared, False)
    if devices:
        cfg.set_string("parallel.mesh.enabled", True)
        cfg.set_string("parallel.mesh.devices", devices)
    runners = pkg["runners"](pkg["plan"](env._sinks), cfg)[0]
    env.execute()
    return runners, [ws._rows(s.results, False) for s in sinks]


@pytest.fixture(scope="module")
def correlated_one_device():
    return _correlated_mesh("port", True, 0)[1]


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "independent"])
def test_correlated_program_on_the_mesh_matches_jax_mesh(shards, correlated_one_device, shared):
    runners, rows = _correlated_mesh("port", shared, 4)
    fused = [r for r in runners if type(r).__name__ in ("SharedWindowRunner",
                                                        "DeviceChainRunner")]
    assert fused and all(r.op.mesh_devices() == 4 for r in fused)
    assert [type(r).__name__ for r in fused].count("SharedWindowRunner") == int(shared)
    assert rows == correlated_one_device and all(len(r) > 0 for r in rows)
    if shared:
        _jr, jax_rows = _correlated_mesh("jax", True, 4)
        assert rows == jax_rows


def test_shared_mesh_runner_planes_hold(shards):
    """The shared runner on the mesh: member lanes, the device plane's
    per-device key loads and the mesh gauges."""
    import test_torch_window_sharing as ws
    from flink_tpu_torch.metrics.registry import metrics_snapshot
    from flink_tpu_torch.runtime.executor import JobRuntime

    env, cfg, sinks = ws._correlated(ws.PORT, True, False)
    cfg.set_string("parallel.mesh.enabled", True)
    cfg.set_string("observability.device.key-stats.interval-ms", 0)
    rt = JobRuntime(ws.PORT["plan"](env._sinks), cfg, "cpu")
    rt.run()
    leader = next(r for r in rt.runners if type(r).__name__ == "SharedWindowRunner")
    assert leader.op.mesh_devices() == 4 and rt.mesh_devices() == 4
    assert leader.op.per_device_key_loads().shape == (4, ws.CORRELATED_KEYS // 4)
    assert leader.op.phase_totals()["ingestRecords"] > 0
    snap = metrics_snapshot(rt.registry.all_metrics())
    assert any(k.endswith("meshDevices") and v == 4 for k, v in snap.items())
    assert [ws._rows(s.results, False) for s in sinks] == \
        _correlated_mesh("port", True, 0)[1]


# ---------------------------------------------------------------------------
# the tiered state plane on the mesh: the sharded row surface
# ---------------------------------------------------------------------------

ROW_GEOM = dict(key_capacity=64, num_slices=16, nsb=4, fires_per_step=4, out_rows=16, chunk=256)
ROW_ASG = lambda m: m.SlidingEventTimeWindows.of(2000, 500)   # noqa: E731


def _row_stream(steps=8, batch=300, seed=12):
    rng = np.random.default_rng(seed)
    batches, wms = [], []
    for t in range(steps):
        keys = rng.integers(0, 64, batch).astype(np.int32)
        vals = rng.integers(-4, 9, batch).astype(np.float32) * 0.25
        ts = (t * 400 + rng.integers(0, 400, batch)).astype(np.int64)
        batches.append((keys, vals, ts))
        wms.append(t * 400 - 500)
    return batches, wms


def _row_pipe(pkg, n, agg="sum", routed=False):
    kw = dict(skew_routing=True, num_key_groups=16) if routed else {}
    if pkg == "jax":
        pipe = jss.ShardedFusedPipeline(_jmesh(n), ROW_ASG(jasg), agg, **ROW_GEOM, **kw)
    elif n is None:
        pipe = tfp.FusedWindowPipeline(ROW_ASG(tasg), agg, device="cpu", **ROW_GEOM)
    else:
        pipe = tsp.ShardedFusedPipeline(Mesh(["cpu"] * n), ROW_ASG(tasg), agg, **ROW_GEOM, **kw)
    batches, wms = _row_stream()
    pipe.process_superbatch(batches[:4], wms[:4])
    pipe.process_superbatch(batches[4:], wms[4:])
    if routed:
        # a permuted table: group g on shard (g * 3) % n
        pipe.set_routing_assignment(np.asarray([(g * 3) % n for g in range(16)], np.int32))
    return pipe


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32 if a.dtype.itemsize == 4 else np.int64).tolist(), str(a.dtype)


def _surface_story(pipe, agg):
    """Every call of the row surface, in the tier manager's order (gather
    rows, clear them, write cells back elsewhere, point-read them), and the
    canonical snapshot after each mutation, as bits."""
    kids = np.asarray([5, 63, 0, 17, 32, 5 + 16, 40], np.int64)
    out = []
    counts, fields = pipe.gather_key_rows(kids)
    out.append((_bits(counts), {k: _bits(v) for k, v in sorted(fields.items())}))
    pipe.clear_key_rows(kids[:4])
    snap = pipe.snapshot()
    out.append((_bits(snap["count"]), {k: _bits(v) for k, v in sorted(snap["state"].items())}))
    dst = np.asarray([5, 63, 0, 17, 5, 63], np.int64)
    spos = np.asarray([1, 2, 3, 4, 9, 15], np.int64)
    cvals = np.asarray([3, 1, 7, 2, 5, 4], np.int64)
    fvals = {f: np.asarray([0.25, -1.0, 2.5, 0.75, 3.0, -0.5]) for f in fields}
    pipe.write_cells(dst, spos, cvals, fvals)
    snap = pipe.snapshot()
    out.append((_bits(snap["count"]), {k: _bits(v) for k, v in sorted(snap["state"].items())}))
    c, f = pipe.gather_cells(np.asarray([5, 63, 0, 40, 17]), np.asarray([1, 2, 3, 6, 4]))
    out.append((_bits(c), {k: _bits(v) for k, v in sorted(f.items())}))
    return out


@pytest.mark.parametrize("agg", ["sum", "max"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_row_surface_matches_jax_bit_for_bit(agg, n):
    got = _surface_story(_row_pipe("port", n, agg), agg)
    assert got == _surface_story(_row_pipe("jax", n, agg), agg)
    assert got == _surface_story(_row_pipe("port", None, agg), agg)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_row_surface_under_a_routing_table(n):
    """Rows identify global key ids under any placement: a permuted
    key-group table gives the canonical rows of the static layout, and
    the JAX mesh's under the same table."""
    got = _surface_story(_row_pipe("port", n, "sum", routed=True), "sum")
    assert got == _surface_story(_row_pipe("port", n, "sum"), "sum")
    assert got == _surface_story(_row_pipe("jax", n, "sum", routed=True), "sum")


def test_sharded_row_surface_takes_empty_and_repeated_reads():
    pipe = _row_pipe("port", 4, "mean")
    counts, fields = pipe.gather_key_rows(np.empty(0, np.int64))
    assert counts.shape == (0, pipe.S) and counts.dtype == np.int32
    assert all(v.shape == (0, pipe.S) for v in fields.values())
    counts, _f = pipe.gather_key_rows(np.asarray([3, 3, 60]))
    assert np.array_equal(counts[0], counts[1])
    c, _f = pipe.gather_cells(np.empty(0, np.int64), np.empty(0, np.int64))
    assert c.shape == (0,)


# ---------------------------------------------------------------------------
# the tiered state plane on the mesh: the operator and the job
# ---------------------------------------------------------------------------

def _tiered_op(pkg, n, window="sliding", agg="sum", **tier):
    tier = {"hot_key_capacity": 32, **tier}
    if pkg == "jax":
        return jfo.FusedWindowOperator(tier_twins.WINDOWS[window](jasg), agg, superbatch_steps=8,
                                       tier=jtm.TierConfig(**tier),
                                       mesh=None if n is None else _jmesh(n))
    return tfo.FusedWindowOperator(tier_twins.WINDOWS[window](tasg), agg, superbatch_steps=8,
                                   tier=ttm.TierConfig(**tier), device="cpu",
                                   mesh=None if n is None else Mesh(["cpu"] * n))


@pytest.mark.parametrize("agg,window,n", [("sum", "sliding", 2), ("count", "tumbling", 4),
                                          ("max", "sliding", 4)])
def test_tiered_operator_on_the_mesh_matches_jax_mesh(agg, window, n):
    batches = tier_twins._batches()
    ops = {"port": _tiered_op("port", n, window, agg), "jax": _tiered_op("jax", n, window, agg)}
    out = {p: tier_twins._finish(op, batches) for p, op in ops.items()}
    assert tier_twins._emitted(out["port"]) == tier_twins._emitted(out["jax"])
    one = tier_twins._finish(_tiered_op("port", None, window, agg), batches)
    assert tier_twins._emitted(out["port"]) == tier_twins._emitted(one)
    port = ops["port"]
    assert type(port.pipe).__name__ == "ShardedFusedPipeline" and port.mesh_devices() == n
    t = port.tier
    assert t.vocab.num_evictions > 0 and t.num_promoted_rows > 0 and t.num_demoted_rows > 0
    assert t.vocab.resident_count <= 32 and port.pipe.K == 32
    assert port.tier_gauges() == ops["jax"].tier_gauges()
    assert port.tier_payload() == ops["jax"].tier_payload()


@pytest.mark.parametrize("kind", ["full", "changelog"])
@pytest.mark.parametrize("src,dst", [("port_mesh", "port_one"), ("port_one", "port_mesh"),
                                     ("port_mesh", "jax_mesh"), ("jax_mesh", "port_mesh")])
def test_tiered_mesh_snapshot_restores_across(src, dst, kind, tmp_path):
    batches = tier_twins._batches(seed=5)

    def make(name, d):
        tier = {}
        if kind == "changelog":
            tier = dict(changelog_enabled=True, changelog_dir=str(tmp_path / d),
                        cold_dir=str(tmp_path / (d + "-cold")))
        pkg, where = name.split("_")
        return _tiered_op(pkg, 2 if where == "mesh" else None, **tier)

    whole = tier_twins._finish(make("port_one", "whole"), batches)
    first = make(src, "a")
    out, snaps = tier_twins._feed(first, batches[:20], snap_at=(19,))
    second = make(dst, "b" if kind == "full" else "a")
    second.restore(snaps[0])
    out += tier_twins._finish(second, batches[20:])
    assert tier_twins._emitted(out) == tier_twins._emitted(whole)


def test_tiered_mesh_job_through_both_packages(shards):
    """millikey_microbench's program with state.tier.* and the mesh on:
    the port's rows are the JAX mesh job's, the untiered job's and the
    numpy oracle's."""
    from flink_tpu_torch.testing import stream as st

    got, ops = _mesh_job("port", True)
    (op,) = ops
    assert op.mesh_devices() == 4 and op.tier is not None and op.pipe.K == 128
    assert got == _mesh_job("jax", True)[0] == _mesh_job("port", False)[0]
    assert got == st.millikey_oracle(1 << 13, 1 << 11, True)


def _mesh_job(p, tiered, n=1 << 13, n_keys=1 << 11, batch=1024):
    """tests/test_torch_state_tiering.py's millikey job with the mesh on
    (4 shards): (its sorted rows, the port's fused window operators)."""
    from importlib import import_module

    from flink_tpu_torch.testing import stream as st

    m = {name: import_module(f"{'flink_tpu' if p == 'jax' else 'flink_tpu_torch'}.{name}")
         for name in ("api.datastream", "config", "connectors.sink", "connectors.source",
                      "core.watermarks")}
    conf = {"execution.step.batch-size": batch, "execution.state.key-capacity": n_keys,
            "parallel.mesh.enabled": True, "parallel.mesh.devices": 4}
    if tiered:
        conf.update({"state.tier.enabled": True, "state.tier.hot-key-capacity": 128,
                     "state.tier.admission-min-count": 2})
    cfg = m["config"].Configuration(conf)
    env = m["api.datastream"].StreamExecutionEnvironment(cfg, **tier_twins.PK[p].kw)
    src = m["connectors.source"]
    sink = m["connectors.sink"].CollectSink()
    (env.from_source(src.DataGeneratorSource(
        lambda idx: src.Batch(*st.millikey_columns(idx, n, n_keys, True)), n),
        m["core.watermarks"].WatermarkStrategy.for_bounded_out_of_orderness(0))
     .key_by(lambda c: c, vectorized=True)
     .window(tier_twins.PK[p].asg.SlidingEventTimeWindows.of(10_000, 1_000)).count()
     .sink_to(sink))
    ops = []
    if p == "port":
        from flink_tpu_torch.graph.transformation import plan
        from flink_tpu_torch.runtime.executor import build_runners

        ops = [r.op for r in build_runners(plan(env._sinks), cfg, "cpu")[0]
               if type(getattr(r, "op", None)).__name__ == "FusedWindowOperator"]
    env.execute()
    return sorted(sink.results), ops


def test_tiered_mesh_clamps_to_the_hot_capacity(shards):
    """The mesh size is clamped against the hot capacity, as the JAX
    package's usable_mesh_size clamps it against the key capacity: 24 hot
    rows over 8 visible devices leave a mesh of 8, over a requested 5 a
    mesh of 4."""
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.runtime.executor import _mesh_for_config, _tier_for_config

    shards(8)
    cfg = Configuration({"parallel.mesh.enabled": True, "state.tier.enabled": True,
                         "state.tier.hot-key-capacity": 24})
    hot = _tier_for_config(cfg).hot_key_capacity
    assert _mesh_for_config(cfg, hot, "cpu").size == 8
    cfg.set_string("parallel.mesh.devices", 5)
    assert _mesh_for_config(cfg, hot, "cpu").size == 4


# ---------------------------------------------------------------------------
# queryable state on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_query_state_for_on_the_mesh_matches_jax_mesh(n):
    batches = tier_twins._batches(seed=9, steps=20, n_keys=40)

    def make(pkg, mesh):
        kw = dict(key_capacity=64, superbatch_steps=8)
        if pkg == "jax":
            return jfo.FusedWindowOperator(tier_twins.WINDOWS["sliding"](jasg), "mean",
                                           mesh=None if mesh is None else _jmesh(mesh), **kw)
        return tfo.FusedWindowOperator(tier_twins.WINDOWS["sliding"](tasg), "mean",
                                       device="cpu",
                                       mesh=None if mesh is None else Mesh(["cpu"] * mesh), **kw)

    ops = {"port": make("port", n), "jax": make("jax", n), "one": make("port", None)}
    assert ops["port"].mesh_devices() == n
    seen = 0
    for i, (keys, vals, ts, wm) in enumerate(batches):
        for op in ops.values():
            op.process_batch(keys, vals, ts)
            op.process_watermark(wm)
        if i % 3 == 2:     # some steps buffered, some dispatched
            for key in (0, 5, 17, 39, 1000):
                got = ops["port"].query_state_for(key)
                assert got == ops["jax"].query_state_for(key) == ops["one"].query_state_for(key)
                seen += len(got)
    assert seen > 0


def test_query_state_on_the_mesh_keeps_the_jax_errors():
    mesh = Mesh(["cpu"] * 2)
    tiered = _tiered_op("port", 2, hot_key_capacity=8)
    with pytest.raises(RuntimeError, match="tiered path"):
        tiered.query_state_for(1)
    traced = tfo.FusedWindowOperator(tier_twins.WINDOWS["sliding"](tasg), "count", device="cpu",
                                     key_capacity=64, mesh=mesh,
                                     prologue=tfp.TracedPrologue(transforms=(),
                                                                 key_fn=lambda c: c))
    with pytest.raises(RuntimeError, match="fused chain path"):
        traced.query_state_for(1)


def test_job_client_query_state_reaches_a_mesh_job(shards):
    """JobClient.query_state on a running host-keyed fused job on 4 shards:
    the operator's canonical view, as the one-device job's at the same
    point of the input."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.sink import CollectSink
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.utils.arrays import obj_array

    n = 8192

    def run(mesh_on):
        reached, go = threading.Event(), threading.Event()

        def gen(idx):
            if idx[0] >= n // 2 and not reached.is_set():
                reached.set()
                assert go.wait(60)
            keys = (idx * 48271) % 96
            ts = (10_000 + idx * 2).astype(np.int64)
            return Batch(obj_array([(int(k), float(k % 5), int(t)) for k, t in zip(keys, ts)]),
                         ts)

        cfg = Configuration({"execution.step.batch-size": 512,
                             "execution.state.key-capacity": 256,
                             "execution.window.superbatch-steps": 4,
                             "parallel.mesh.enabled": mesh_on})
        env = StreamExecutionEnvironment(cfg, device="cpu")
        sink = CollectSink()
        (env.from_source(DataGeneratorSource(gen, n),
                         watermark_strategy=WatermarkStrategy.for_monotonous_timestamps())
            .key_by(lambda x: x[0]).window(tasg.TumblingEventTimeWindows.of(4000))
            .aggregate("sum", value_fn=lambda x: x[1]).sink_to(sink))
        client = env.execute_async("mesh-query")
        assert reached.wait(60)
        runner = next(r for r in client._runtime.runners
                      if hasattr(getattr(r, "op", None), "query_state_for"))
        assert runner.op.mesh_devices() == (4 if mesh_on else 1)
        views = [client.query_state(runner.uid, k) for k in (0, 7, 95, 1000)]
        go.set()
        client.wait(120)
        return views, sorted(sink.results)

    mesh_views, mesh_rows = run(True)
    one_views, one_rows = run(False)
    assert mesh_views == one_views and any(v["slices"] for v in mesh_views)
    assert mesh_rows == one_rows and len(mesh_rows) > 0
