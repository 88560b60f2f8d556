"""DataStream jobs on the port held against the same jobs on the JAX package.

The programs are `bench.py::api_path_microbench`'s — YSB's sliding count
written as `from_source().filter().key_by().window().aggregate()` — at a
small size (2^14 records, batch 1024, 256 keys), run through each
package's `env.execute()` in all three modes: fused (the traceable chain
runs as a device prologue; DeviceChainRunner), chain (ChainRunner +
WindowStepRunner through the host key dictionary) and scalar (per-record
UDFs on the host route). A tumbling sum fed by a traceable value_fn and a
sliding max add the VALUE-field paths. JAX UDFs use jnp, the port's use
torch; one port UDF object serves both of its routes.

Tolerance: exact. Sorted result rows are compared; payloads are small
integer-valued floats, so float32 sums are exact in any order.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.datastream import StreamExecutionEnvironment as JaxEnv
from flink_tpu.api.windowing import assigners as jasg
from flink_tpu.config import Configuration as JaxConfiguration
from flink_tpu.config import ExecutionOptions as JaxExecutionOptions
from flink_tpu.connectors.source import Batch as JaxBatch
from flink_tpu.connectors.source import DataGeneratorSource as JaxGeneratorSource
from flink_tpu.core.watermarks import WatermarkStrategy as JaxWatermarkStrategy
from flink_tpu_torch.api import datastream as tds
from flink_tpu_torch.api.windowing import assigners as tasg
from flink_tpu_torch.config import Configuration, ExecutionOptions, PipelineOptions
from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
from flink_tpu_torch.core.watermarks import WatermarkStrategy
from flink_tpu_torch.graph.transformation import plan
from flink_tpu_torch.runtime.executor import JobRuntime, build_runners
from jax_native_twins import jax_native_library  # noqa: E402,F401

NUM_KEYS = 256
EVENTS = 1 << 14
BATCH = 1024

JAX = dict(env=JaxEnv, cfg=JaxConfiguration, opts=JaxExecutionOptions, batch=JaxBatch,
           source=JaxGeneratorSource, wm=JaxWatermarkStrategy, asg=jasg,
           filter=lambda col: col[:, 1] < 0.5,
           key=lambda col: col[:, 0].astype(jnp.int32),
           value=lambda col: col[:, 2] * 2.0)
PORT = dict(env=tds.StreamExecutionEnvironment, cfg=Configuration, opts=ExecutionOptions,
            batch=Batch, source=DataGeneratorSource, wm=WatermarkStrategy, asg=tasg,
            filter=lambda col: col[:, 1] < 0.5,
            key=lambda col: col[:, 0].to(torch.int32),
            value=lambda col: col[:, 2] * 2.0)
S_FILTER = lambda r: r[1] < 0.5         # noqa: E731
S_KEY = lambda r: int(r[0])             # noqa: E731
S_VALUE = lambda r: float(r[2]) * 2.0   # noqa: E731


def _source(pkg, n, span_event_ms=64_000):
    """api_path_microbench's YSB columns (campaign, event_type) plus a small
    integer payload column; the filter keeps event_type 0 (one in three)."""
    def gen(idx):
        camp = (idx * 2654435761) % NUM_KEYS
        etype = idx % 3
        payload = (idx * 7) % 11
        col = np.stack([camp, etype, payload], axis=1).astype(np.float32)
        ts = 10_000 + idx * span_event_ms // n
        return pkg["batch"](col, ts.astype(np.int64))

    return pkg["source"](gen, n)


def _build(pkg, mode, assigner, aggregate, with_value, columnar=False, n=EVENTS, **env_kw):
    cfg = pkg["cfg"]()
    cfg.set(pkg["opts"].CHAIN_FUSION, mode == "fused")
    cfg.set(pkg["opts"].BATCH_SIZE, BATCH)
    cfg.set(pkg["opts"].KEY_CAPACITY, NUM_KEYS)
    cfg.set(pkg["opts"].COLUMNAR_OUTPUT, columnar)
    env = pkg["env"].get_execution_environment(cfg, **env_kw)
    ds = env.from_source(_source(pkg, n),
                         watermark_strategy=pkg["wm"].for_bounded_out_of_orderness(0))
    if mode == "scalar":
        keyed = ds.filter(S_FILTER).key_by(S_KEY)
        value = dict(value_fn=S_VALUE) if with_value else {}
    else:
        keyed = ds.filter(pkg["filter"], traceable=True).key_by(pkg["key"], traceable=True)
        value = dict(value_fn=pkg["value"], value_traceable=True) if with_value else {}
    sink = keyed.window(assigner(pkg["asg"])).aggregate(aggregate, **value).collect()
    return env, sink


def _run(pkg, mode, assigner, aggregate, with_value=False, **kw):
    env_kw = {"device": "cpu"} if pkg is PORT else {}
    env, sink = _build(pkg, mode, assigner, aggregate, with_value, **env_kw, **kw)
    env.execute()
    return env, sorted((int(k), float(v)) for k, v in sink.results)


SLIDING = lambda m: m.SlidingEventTimeWindows.of(10_000, 1_000)    # noqa: E731
TUMBLING = lambda m: m.TumblingEventTimeWindows.of(2_000)           # noqa: E731
RUNNER = {"fused": "DeviceChainRunner", "chain": "WindowStepRunner",
          "scalar": "WindowStepRunner"}


@pytest.mark.parametrize("mode", ["fused", "chain", "scalar"])
def test_ysb_sliding_count_matches_jax(mode):
    env, port_rows = _run(PORT, mode, SLIDING, "count")
    _jenv, jax_rows = _run(JAX, mode, SLIDING, "count")
    assert len(port_rows) > 1000 and port_rows == jax_rows
    kinds = [type(r).__name__ for r in build_runners(plan(env._sinks), env.config, "cpu")[0]]
    assert RUNNER[mode] in kinds
    assert ("DeviceChainRunner" in kinds) == (mode == "fused")


@pytest.mark.parametrize("mode", ["fused", "chain"])
@pytest.mark.parametrize("job", ["tumbling_sum", "sliding_max"])
def test_value_jobs_match_jax(job, mode):
    assigner, aggregate = (TUMBLING, "sum") if job == "tumbling_sum" else (SLIDING, "max")
    _env, port_rows = _run(PORT, mode, assigner, aggregate, with_value=True)
    _jenv, jax_rows = _run(JAX, mode, assigner, aggregate, with_value=True)
    assert len(port_rows) > 100 and port_rows == jax_rows
    # the scalar program agrees with both
    _env, scalar_rows = _run(PORT, "scalar", assigner, aggregate, with_value=True)
    assert scalar_rows == port_rows


def test_columnar_output_matches_jax():
    """Packed (window, key ids, values) fires: the fused route's ids are the
    traced keys, equal across the packages."""
    rows = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        env_kw = {"device": "cpu"} if pkg is PORT else {}
        env, sink = _build(pkg, "fused", SLIDING, "count", False, columnar=True, **env_kw)
        env.execute()
        rows[name] = [((w.start, w.end), np.asarray(ids).tolist(), np.asarray(v).tolist())
                      for w, ids, v in sink.results]
    assert rows["port"] and rows["port"] == rows["jax"]


def test_map_and_map_with_timestamp_chain_matches_jax():
    """A longer traceable chain: filter, map, map_with_timestamp, key,
    value_fn; the fused and host routes against the JAX package's fused
    route."""
    maps = {
        "port": (lambda c: c * torch.tensor([1.0, 1.0, 3.0]),
                 lambda c, ts: torch.stack([c[:, 0], c[:, 1], c[:, 2] + (ts % 3).to(torch.float32)], 1)),
        "jax": (lambda c: c * jnp.asarray([1.0, 1.0, 3.0]),
                lambda c, ts: jnp.stack([c[:, 0], c[:, 1], c[:, 2] + (ts % 3).astype(jnp.float32)], 1)),
    }
    out = {}
    for name, pkg, mode in (("port", PORT, "fused"), ("port", PORT, "chain"),
                            ("jax", JAX, "fused")):
        cfg = pkg["cfg"]()
        cfg.set(pkg["opts"].CHAIN_FUSION, mode == "fused")
        cfg.set(pkg["opts"].BATCH_SIZE, 512)
        cfg.set(pkg["opts"].KEY_CAPACITY, NUM_KEYS)
        env = pkg["env"](cfg, device="cpu") if pkg is PORT else pkg["env"](cfg)
        ds = env.from_source(_source(pkg, 6000, 20_000),
                             watermark_strategy=pkg["wm"].for_bounded_out_of_orderness(0))
        m, mts = maps[name]
        ds = ds.filter(pkg["filter"], traceable=True).map(m, traceable=True)
        ds = ds.map_with_timestamp(mts, traceable=True)
        sink = (ds.key_by(pkg["key"], traceable=True).window(TUMBLING(pkg["asg"]))
                .aggregate("sum", value_fn=lambda c: c[:, 2], value_traceable=True).collect())
        env.execute()
        out[(name, mode)] = sorted((int(k), float(v)) for k, v in sink.results)
    assert out[("port", "fused")] and out[("port", "fused")] == out[("jax", "fused")]
    assert out[("port", "chain")] == out[("jax", "fused")]


@pytest.mark.parametrize("vectorized", [False, True])
def test_flat_map_and_global_match_jax(vectorized):
    """flat_map (per record, or vectorized with its source index carrying
    the timestamps) behind a global() hint, feeding a keyed tumbling sum."""
    def per_record(r):
        return [(r[0], r[1] + i) for i in range(int(r[1]) % 3)]

    def columns(vals):
        out, idx = [], []
        for i, r in enumerate(vals):
            for o in per_record(r):
                out.append(o)
                idx.append(i)
        arr = np.empty(len(out), dtype=object)
        arr[:] = out
        return arr, np.asarray(idx, np.int64)

    recs = [(i % 5, float(i % 7), i * 10) for i in range(300)]
    out = []
    for pkg, kw in ((JAX, {}), (PORT, {"device": "cpu"})):
        cfg = pkg["cfg"]()
        cfg.set(pkg["opts"].BATCH_SIZE, 64)
        env = pkg["env"](cfg, **kw)
        ds = env.from_collection(recs, timestamp_fn=lambda r: r[2],
                                 watermark_strategy=pkg["wm"].for_bounded_out_of_orderness(0))
        ds = ds.global_().flat_map(columns if vectorized else per_record, vectorized=vectorized)
        sink = (ds.key_by(lambda r: r[0]).window(pkg["asg"].TumblingEventTimeWindows.of(500))
                .aggregate("sum", value_fn=lambda r: r[1]).collect())
        env.execute()
        out.append(repr(sink.results))
    assert out[0] == out[1] and len(out[1]) > 10


def test_fused_route_raises_on_keys_beyond_capacity():
    cfg = Configuration()
    cfg.set(ExecutionOptions.KEY_CAPACITY, NUM_KEYS // 2)
    cfg.set(ExecutionOptions.BATCH_SIZE, BATCH)
    env = tds.StreamExecutionEnvironment(cfg, device="cpu")
    (env.from_source(_source(PORT, 4096), WatermarkStrategy.for_bounded_out_of_orderness(0))
     .filter(PORT["filter"], traceable=True).key_by(PORT["key"], traceable=True)
     .window(SLIDING(tasg)).aggregate("count").collect())
    with pytest.raises(ValueError, match="outside \\[0, 128\\)"):
        env.execute()


def test_execute_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env, _sink = _build(PORT, "fused", SLIDING, "count", False)
    with pytest.raises(RuntimeError, match="CUDA"):
        env.execute()


def _execute(stream):
    stream.collect()
    stream.env.execute()


def _deferred_calls():
    env = tds.StreamExecutionEnvironment(device="cpu")
    ds = env.from_collection([1, 2, 3], timestamp_fn=lambda x: x)
    keyed = ds.key_by(lambda x: x)
    win = keyed.window(SLIDING(tasg))
    return {
        # the rest of the DataStream API (test_torch_multi_input.py,
        # test_torch_iterations.py, test_torch_async_io.py,
        # test_torch_process_functions.py run them against the JAX package)
        "map_batch": (lambda: ds.map_batch(lambda xs: xs), None),
        "union": (lambda: ds.union(ds), None),
        "connect": (lambda: ds.connect(ds), None),
        "async_map": (lambda: ds.async_map(lambda x: x), None),
        "get_side_output": (lambda: ds.get_side_output("late"), None),
        "broadcast": (lambda: ds.broadcast(), None),
        "iterate": (lambda: ds.iterate(), None),
        # two-input joins (test_torch_joins.py)
        "join": (lambda: ds.join(ds), None),
        "keyed_process": (lambda: keyed.process(None), None),
        # brought in by the per-record oracle operator (item None: the
        # call runs; test_torch_oracle_datastream.py holds the jobs
        # against the JAX package)
        "trigger": (lambda: win.trigger(None), None),
        "window_reduce": (lambda: win.reduce(lambda a, b: a), None),
        # allowed lateness runs on the per-batch operator; on session
        # windows on the per-record oracle
        "allowed_lateness": (lambda: _execute(keyed.window(
            tasg.EventTimeSessionWindows.with_gap(5)).allowed_lateness(5).sum()), None),
        # job checkpoints and savepoints (test_torch_checkpointing.py):
        # the job runs on the port's MiniCluster
        "execute_async": (lambda: (ds.collect(), env.execute_async().wait(60)), None),
        # parallelism and key groups (test_torch_key_groups.py runs them)
        "idleness": (lambda: WatermarkStrategy.for_monotonous_timestamps().with_idleness(5),
                     None),
        # the mesh (test_torch_multichip_runtime.py) and its control loops
        # (test_torch_mesh_control.py runs them): the options are accepted
        "mesh_option": (lambda: Configuration().set_string("parallel.mesh.enabled", True),
                        None),
        "mesh_rebalance_option": (
            lambda: Configuration().set_string("parallel.mesh.skew-rebalance", True), None),
        "mesh_key_groups_option": (
            lambda: Configuration().set_string("parallel.mesh.key-groups", 64), None),
        "mesh_autoscale_option": (
            lambda: Configuration().set_string("parallel.mesh.autoscale", True), None),
        # latency mode (test_torch_latency_mode.py)
        "latency_option": (lambda: Configuration({"execution.latency.target-ms": 5}), None),
        # shared partials (test_torch_window_sharing.py)
        "shared_partials_option": (
            lambda: Configuration().set_string("execution.window.shared-partials", False),
            None),
        # job metrics and emission latency (test_torch_observability.py)
        "metrics_option": (
            lambda: Configuration().set_string("observability.emission-latency.enabled", True),
            None),
        "checkpoint_option": (
            lambda: Configuration().set_string("execution.checkpointing.interval", 10),
            None),
    }


@pytest.mark.parametrize("name", sorted(_deferred_calls()))
def test_unported_surfaces_raise_naming_the_roadmap(name):
    call, item = _deferred_calls()[name]
    if item is None:          # ported since: the surface runs
        call()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A, {item}"):
        call()


@pytest.mark.parametrize("what", ["parallelism", "oracle_aggregate", "fused_windows_off",
                                  "checkpoint_capture"])
def test_unported_job_shapes_raise_at_execute(what):
    from flink_tpu_torch.api.functions import AggregateFunction

    class Count(AggregateFunction):
        def create_accumulator(self):
            return 0

        def add(self, value, acc):
            return acc + 1

        def get_result(self, acc):
            return acc

        def merge(self, a, b):
            return a + b

    cfg = Configuration()
    agg, item = "count", None
    if what == "parallelism":
        # ported since (test_torch_key_groups.py): no runner reads the
        # option, as in the JAX package, so the job's rows are those of
        # parallelism 1
        cfg.set(PipelineOptions.PARALLELISM, 2)
        rows = {}
        for p in (2, 1):
            cfg.set(PipelineOptions.PARALLELISM, p)
            env = tds.StreamExecutionEnvironment(cfg, device="cpu")
            sink = (env.from_source(_source(PORT, 64), WatermarkStrategy.for_monotonous_timestamps())
                    .key_by(S_KEY).window(SLIDING(tasg)).aggregate(agg).collect())
            env.execute()
            rows[p] = sorted((int(k), int(v)) for k, v in sink.results)
        assert len(rows[2]) > 0 and rows[2] == rows[1]
        return
    elif what == "oracle_aggregate":
        agg = Count()
    elif what == "fused_windows_off":
        # the per-batch operator takes grid windows with the fused path
        # off; a global window without a count trigger takes the oracle
        cfg.set(ExecutionOptions.FUSED_WINDOWS, False)
    env = tds.StreamExecutionEnvironment(cfg, device="cpu")
    assigner = (tasg.GlobalWindows.create() if what == "fused_windows_off"
                else SLIDING(tasg))
    sink = (env.from_source(_source(PORT, 64), WatermarkStrategy.for_monotonous_timestamps())
            .key_by(S_KEY).window(assigner).aggregate(agg).collect())
    if what == "checkpoint_capture":
        # ported since (test_torch_checkpointing.py): a capture before the
        # run holds the source's splits and records_in 0, and restores
        runtime = JobRuntime(plan(env._sinks), cfg, "cpu")
        snap = runtime.capture()
        assert snap["records_in"] == 0 and snap["coordinators"] == {}
        assert len(snap["sources"]) == 1
        JobRuntime(plan(env._sinks), cfg, "cpu").restore(snap)
        return
    if item is None:
        # brought in by the per-record oracle operator: the Python count
        # gives the device count's rows; GlobalWindows' NeverTrigger never
        # fires
        op = build_runners(plan(env._sinks), cfg, "cpu")[0][0].op
        assert type(op).__name__ == "OracleWindowOperator"
        env.execute()
        rows = sorted((int(k), int(v)) for k, v in sink.results)
        if what == "fused_windows_off":
            assert rows == []
            return
        # the JAX package's oracle on its own Python count (the fused route
        # would trip the reference's ring-aliasing fault on this one
        # 64-slice batch, ROADMAP Queue C)
        from flink_tpu.api.functions import AggregateFunction as JaxAggregateFunction

        jcount = type("JaxCount", (JaxAggregateFunction,), {
            k: v for k, v in Count.__dict__.items() if not k.startswith("__")})()
        jenv = JaxEnv.get_execution_environment(JaxConfiguration())
        want = (jenv.from_source(_source(JAX, 64),
                                 JaxWatermarkStrategy.for_monotonous_timestamps())
                .key_by(S_KEY).window(SLIDING(jasg)).aggregate(jcount).collect())
        jenv.execute()
        assert rows == sorted((int(k), int(v)) for k, v in want.results) and len(rows) == 640
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A, {item}"):
        env.execute()
