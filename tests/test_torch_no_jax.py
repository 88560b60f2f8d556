"""The port stands alone: no jax, nothing of flink_tpu, no silent CPU.

tests/conftest.py imports jax before every test, so the import check runs
in a fresh subprocess.
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "flink_tpu_torch"


def test_one_cpu_dispatch_imports_no_jax_and_no_flink_tpu():
    code = textwrap.dedent("""
        import sys
        before = set(sys.modules)   # whatever site start-up preloaded
        import numpy as np
        from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
        from flink_tpu_torch.runtime.fused_window_pipeline import FusedWindowPipeline
        pipe = FusedWindowPipeline(SlidingEventTimeWindows.of(2000, 500), "count",
                                   key_capacity=64, num_slices=16, nsb=4,
                                   fires_per_step=4, out_rows=16, chunk=256,
                                   device="cpu")
        rng = np.random.default_rng(0)
        batches = [(rng.integers(0, 64, 200).astype(np.int32), None,
                    np.sort(rng.integers(t * 400, t * 400 + 400, 200)).astype(np.int64))
                   for t in range(6)]
        out = pipe.process_superbatch(batches, [t * 400 + 250 for t in range(6)])
        assert len(out) > 0 and sum(int(c.sum()) for _w, c, _f in out) > 0

        # a DataStream job through the port's API, planner, runners and
        # operator: the traced chain runs as the device prologue
        import torch
        from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
        from flink_tpu_torch.config import Configuration, ExecutionOptions
        from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
        from flink_tpu_torch.core.watermarks import WatermarkStrategy

        def gen(idx):
            col = np.stack([idx % 32, idx % 3], axis=1).astype(np.float32)
            return Batch(col, (1000 + idx * 7).astype(np.int64))

        cfg = Configuration()
        cfg.set(ExecutionOptions.BATCH_SIZE, 256)
        cfg.set(ExecutionOptions.KEY_CAPACITY, 32)
        env = StreamExecutionEnvironment(cfg, device="cpu")
        sink = (env.from_source(DataGeneratorSource(gen, 3000),
                                WatermarkStrategy.for_bounded_out_of_orderness(0))
                .filter(lambda c: c[:, 1] < 0.5, traceable=True)
                .key_by(lambda c: c[:, 0].to(torch.int32), traceable=True)
                .window(SlidingEventTimeWindows.of(2000, 500)).aggregate("count")
                .collect())
        env.execute()
        assert sum(v for _k, v in sink.results) == 4 * 1000

        # a session job: the session operator's ingest and gap-merge
        from flink_tpu_torch.api.windowing.assigners import EventTimeSessionWindows
        env = StreamExecutionEnvironment(device="cpu")
        clicks = [("u1", 0), ("u1", 300), ("u2", 100), ("u1", 2000), ("u2", 2500)]
        sink = (env.from_collection(clicks, timestamp_fn=lambda x: x[1],
                                    watermark_strategy=WatermarkStrategy.for_monotonous_timestamps())
                .key_by(lambda x: x[0]).window(EventTimeSessionWindows.with_gap(1000))
                .count().collect())
        env.execute()
        assert sorted(sink.results) == [("u1", 1), ("u1", 2), ("u2", 1), ("u2", 1)]

        # the per-batch window operator with lateness and a late side output
        from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator
        op = TpuWindowOperator(SlidingEventTimeWindows.of(2000, 1000), "sum",
                               allowed_lateness=1000, emit_late_to_side_output=True,
                               device="cpu")
        op.process_batch(np.array(["a", "b", "a"], dtype=object),
                         np.array([1, 2, 3], np.float32), np.array([100, 900, 1500]))
        op.process_watermark(1999)
        op.process_batch(np.array(["a", "c"], dtype=object), np.array([4, 5], np.float32),
                         np.array([1200, -5000]))
        out = [(k, w.start, r) for k, w, r, _t in op.drain_output()]
        assert out == [("a", -1000, 1.0), ("b", -1000, 2.0), ("a", 0, 4.0), ("b", 0, 2.0),
                       ("a", 0, 8.0)], out
        assert op.side_output["late-data"] == [("c", 5.0, -5000)]

        # a continuous aggregate on the device path (the port's own columns)
        from flink_tpu_torch.table.changelog import DELETE, with_kind
        env = StreamExecutionEnvironment(device="cpu")
        rows = [{"k": "a", "v": 1.0}, {"k": "a", "v": 3.0}, with_kind({"k": "a", "v": 1.0}, DELETE)]
        sink = (env.from_collection(rows).key_by(lambda r: r["k"])
                .continuous_aggregate([("COUNT", None), ("SUM", "v")], ["k"], ["c", "s"],
                                      mini_batch=False, device=True).collect())
        env.execute()
        assert [(r["c"], r["s"]) for r in sink.results][-1] == (1, 3.0), sink.results

        # a SQL statement through the port's parser, planner and
        # TableEnvironment, fused onto the traced chain; the gateway and
        # its bearer check import too
        from flink_tpu_torch.config import TableOptions
        from flink_tpu_torch.table import TableEnvironment, TableSchema
        from flink_tpu_torch.table.gateway import SqlGateway  # noqa: F401
        from flink_tpu_torch.security import bearer_header_equal
        assert bearer_header_equal("Bearer t", "t")
        env = StreamExecutionEnvironment(device="cpu")
        tenv = TableEnvironment(env)
        tenv.from_rows("pay", [{"user": i % 3, "amount": float(i % 4), "rowtime": i * 100}
                               for i in range(60)],
                       TableSchema(["user", "amount", "rowtime"], rowtime="rowtime",
                                   field_types=["int", "float", "int"]))
        rows = tenv.execute_sql_to_list(
            "SELECT user, SUM(amount) AS s FROM pay WHERE amount > 0 "
            "GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)")
        assert tenv.last_plan_report.fused and env.config.get(TableOptions.DEVICE_FUSION)
        assert sum(r["s"] for r in rows) == sum(float(i % 4) for i in range(60)), rows
        # latency mode: a fused job cut at the controller's rung and read
        # back in groups of 2 steps
        cfg = Configuration({"execution.step.batch-size": 256, "execution.state.key-capacity": 32,
                             "execution.window.superbatch-steps": 8,
                             "execution.latency.target-ms": 50,
                             "execution.latency.readback-steps": 2,
                             "execution.latency.max-inflight-dispatches": 2})
        env = StreamExecutionEnvironment(cfg, device="cpu")
        sink = (env.from_source(DataGeneratorSource(gen, 3000),
                                WatermarkStrategy.for_bounded_out_of_orderness(0))
                .filter(lambda c: c[:, 1] < 0.5, traceable=True)
                .key_by(lambda c: c[:, 0].to(torch.int32), traceable=True)
                .window(SlidingEventTimeWindows.of(2000, 500)).aggregate("count")
                .collect())
        env.execute()
        assert sum(v for _k, v in sink.results) == 4 * 1000
        from flink_tpu_torch.scheduler.latency_controller import SuperbatchController
        assert SuperbatchController(full_steps=32, target_ms=50).steps() == 32
        # the mesh's control loops: the rebalancer and the autoscaler
        from flink_tpu_torch.scheduler import AutoscalerCoordinator, SkewRebalancer
        assert SkewRebalancer(interval_ms=0).due()
        assert AutoscalerCoordinator.from_config(Configuration()).payload("j")["enabled"]

        # the per-record oracle operator: a continuous trigger, an evictor,
        # reduce and process, and a multi-aggregate SELECT on it
        from flink_tpu_torch.api.functions import PassThroughWindowFunction
        from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
        from flink_tpu_torch.api.windowing.evictors import CountEvictor
        from flink_tpu_torch.api.windowing.triggers import ContinuousEventTimeTrigger
        from flink_tpu_torch.core.keygroups import assign_to_key_group
        assert assign_to_key_group("campaign-7", 128) == 73
        recs = [("k%d" % (i % 3), i, i * 100) for i in range(40)]
        env = StreamExecutionEnvironment(device="cpu")
        keyed = env.from_collection(recs, timestamp_fn=lambda r: r[2],
                                    watermark_strategy=WatermarkStrategy.for_monotonous_timestamps()
                                    ).key_by(lambda r: r[0])
        sums = (keyed.window(TumblingEventTimeWindows.of(1000))
                .trigger(ContinuousEventTimeTrigger.of(300)).sum(lambda r: r[1]).collect())
        reduced = (keyed.window(TumblingEventTimeWindows.of(1000))
                   .reduce(lambda a, b: (a[0], a[1] + b[1], b[2])).collect())
        evicted = (keyed.window(TumblingEventTimeWindows.of(1000)).evictor(CountEvictor.of(1))
                   .process(PassThroughWindowFunction()).collect())
        env.execute()
        assert sum(r[1][1] for r in reduced.results) == sum(range(40))
        assert len(evicted.results) == 12 and len(sums.results) > 12
        rows = tenv.execute_sql_to_list(
            "SELECT user, COUNT(*) AS n, SUM(amount) AS s FROM pay "
            "GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND)")
        assert tenv.last_plan_report.reason == "multi-aggregate"
        assert sum(r["n"] for r in rows) == 60, rows
        # the million-key state plane: a tiered job (hot/cold key tiering
        # over the native spill store, the changelog on), the row surface,
        # queryable state, and the state plane's other modules
        from flink_tpu_torch.connectors.sink import CollectSink
        from flink_tpu_torch.runtime.external_resources import get_external_resource_infos
        from flink_tpu_torch.runtime.memory import MemoryManager
        from flink_tpu_torch.state.spillable import SpillableKeyedStateBackend  # noqa: F401
        import tempfile
        tmp = tempfile.mkdtemp()
        cfg = Configuration({"execution.step.batch-size": 256,
                             "state.tier.enabled": True, "state.tier.hot-key-capacity": 8,
                             "state.tier.cold-dir": tmp + "/cold",
                             "state.changelog.enabled": True,
                             "state.changelog.dir": tmp + "/log"})
        env = StreamExecutionEnvironment(cfg, device="cpu")
        sink = CollectSink()
        (env.from_source(DataGeneratorSource(
            lambda idx: Batch(idx % 64, (1000 + idx * 7).astype(np.int64)), 3000),
            WatermarkStrategy.for_bounded_out_of_orderness(0))
         .key_by(lambda c: c, vectorized=True)
         .window(SlidingEventTimeWindows.of(2000, 500)).count().sink_to(sink))
        env.execute()
        assert sum(v for _k, v in sink.results) == 4 * 3000
        from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator
        from flink_tpu_torch.state.tier_manager import TierConfig
        op = FusedWindowOperator(SlidingEventTimeWindows.of(2000, 500), "sum", device="cpu",
                                 tier=TierConfig(hot_key_capacity=4, changelog_enabled=True,
                                                 changelog_dir=tmp + "/log2"))
        op.process_batch(np.arange(12), np.ones(12, np.float32), np.arange(12) * 100)
        assert "tier_changelog" in op.snapshot() and op.tier.cold.native
        plain = FusedWindowOperator(SlidingEventTimeWindows.of(2000, 500), "sum", device="cpu")
        plain.process_batch(np.arange(3), np.ones(3, np.float32), np.arange(3) * 100)
        assert plain.query_state_for(1) == {0: {"sum": 1.0, "count": 1}}
        assert MemoryManager.for_device("cpu").budget > 0
        assert get_external_resource_infos("cuda") == []
        # job checkpoints: execute_async on the port's MiniCluster, a host
        # failure recovered from a file checkpoint, and a savepoint written
        from flink_tpu_torch.checkpoint import FsCheckpointStorage
        from flink_tpu_torch.runtime.minicluster import JobStatus
        failed = []

        def failing(idx):
            if not failed and idx[0] >= 1536:
                failed.append(1)
                raise RuntimeError("injected")
            return Batch(idx % 64, (1000 + idx * 7).astype(np.int64))

        cfg = Configuration({"execution.step.batch-size": 256,
                             "execution.checkpointing.interval": 1,
                             "execution.checkpointing.dir": tmp + "/chk",
                             "restart-strategy.type": "fixed-delay",
                             "restart-strategy.initial-backoff": 1})
        env = StreamExecutionEnvironment(cfg, device="cpu")
        sink = CollectSink()
        (env.from_source(DataGeneratorSource(failing, 3000),
                         WatermarkStrategy.for_bounded_out_of_orderness(0))
         .key_by(lambda c: c, vectorized=True)
         .window(SlidingEventTimeWindows.of(2000, 500)).count().sink_to(sink))
        client = env.execute_async("no-jax")
        assert client.wait(60) == JobStatus.FINISHED and client.num_restarts == 1
        assert sum(v for _k, v in sink.results) == 4 * 3000
        assert FsCheckpointStorage(tmp + "/chk").latest() is not None
        assert client.checkpoint_stats.gauge_values()["numberOfCompletedCheckpoints"] > 0
        # two-input joins: a window join on the device join ring and a
        # regular SQL join on the streaming join runner
        from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
        env = StreamExecutionEnvironment(device="cpu")
        wm = WatermarkStrategy.for_monotonous_timestamps()
        a = env.from_collection([("k%d" % (i % 3), i) for i in range(30)],
                                timestamp_fn=lambda r: r[1] * 100, watermark_strategy=wm)
        b = env.from_collection([("k%d" % (i % 2), -i) for i in range(30)],
                                timestamp_fn=lambda r: -r[1] * 100, watermark_strategy=wm)
        joined = (a.join(b).where(lambda r: r[0]).equal_to(lambda r: r[0])
                  .window(TumblingEventTimeWindows.of(1000)).apply(lambda x, y: (x, y))
                  .collect())
        env.execute()
        assert len(joined.results) == 100, len(joined.results)
        rows = tenv.execute_sql_to_list(
            "SELECT a.user, b.amount FROM pay AS a LEFT JOIN pay AS b ON a.user = b.user")
        assert len(rows) == 1200, len(rows)
        # the mesh: a fused job over four CPU shards through env.execute,
        # the sharded pipelines, the exchange, the ring collectives, the
        # spmd step, key groups, the valve and the idleness timer
        import flink_tpu_torch.parallel.mesh as mesh_lib
        from flink_tpu_torch.config import ParallelOptions
        mesh_lib.visible_devices = lambda device: [torch.device("cpu")] * 4
        cfg = Configuration()
        cfg.set(ExecutionOptions.BATCH_SIZE, 256)
        cfg.set(ExecutionOptions.KEY_CAPACITY, 32)
        cfg.set(ParallelOptions.MESH_ENABLED, True)
        cfg.set(ParallelOptions.MESH_LOCAL_COMBINE, True)
        env = StreamExecutionEnvironment(cfg, device="cpu")
        env.set_parallelism(4)
        sink = (env.from_source(DataGeneratorSource(gen, 3000),
                                WatermarkStrategy.for_bounded_out_of_orderness(0).with_idleness(9))
                .filter(lambda c: c[:, 1] < 0.5, traceable=True)
                .key_by(lambda c: c[:, 0].to(torch.int32), traceable=True)
                .window(SlidingEventTimeWindows.of(2000, 500)).aggregate("count")
                .collect())
        env.execute()
        assert sum(v for _k, v in sink.results) == 4 * 1000
        from flink_tpu_torch.core.records import hash_keys
        from flink_tpu_torch.core.watermarks import IdlenessTimer, WatermarkValve
        from flink_tpu_torch.joins.sharded import ShardedJoinPipeline  # noqa: F401
        from flink_tpu_torch.ops.exchange import make_keyby_exchange
        from flink_tpu_torch.ops.matmul_hist import count_hist
        from flink_tpu_torch.parallel.mesh import Mesh
        from flink_tpu_torch.parallel.ring import ring_all_reduce
        from flink_tpu_torch.parallel.routing import KeyGroupRouting
        from flink_tpu_torch.parallel.sharded_window import ShardedTpuWindowOperator
        from flink_tpu_torch.parallel.spmd_step import make_spmd_step  # noqa: F401
        from flink_tpu_torch.state.key_groups import verify_partition
        verify_partition(128, 4)
        mesh = Mesh(["cpu"] * 2)
        kg, _ = make_keyby_exchange(mesh, 128)([torch.tensor([1, 100])] * 2, {})
        assert [int((k < 128).sum()) for k in kg] == [2, 2]
        assert ring_all_reduce([torch.ones(3)] * 2, mesh.devices)[0].tolist() == [2, 2, 2]
        assert count_hist(torch.tensor([0, 0, 2]), 3).tolist() == [2, 0, 1]
        assert KeyGroupRouting(64, 2, 8).G == 8 and len(hash_keys(np.arange(3))) == 3
        valve = WatermarkValve(2)
        valve.input_watermark(0, 5)
        assert valve.mark_idle(1) == 5 and not IdlenessTimer(5, clock=lambda: 0.0).check_idle()
        op = ShardedTpuWindowOperator(SlidingEventTimeWindows.of(2000, 1000), "sum", mesh)
        op.process_batch(np.array(["a", "b"], dtype=object), np.array([1, 2], np.float32),
                         np.array([100, 900]))
        op.process_watermark(5000)
        assert sorted((k, r) for k, _w, r, _t in op.drain_output())[-1] == ("b", 2.0)

        # the metric planes: a fused job through execute_async with markers,
        # checkpoints, emission latency, the history and the doctor
        from flink_tpu_torch.metrics import (doctor, emission_latency, history, otel,  # noqa
                                             registry, task_io, traces)
        cfg = Configuration({"execution.step.batch-size": 256,
                             "execution.state.key-capacity": 32,
                             "execution.checkpointing.interval": 1,
                             "observability.latency-markers.interval-ms": 0,
                             "observability.history.interval-ms": 1})
        env = StreamExecutionEnvironment(cfg, device="cpu")
        sink = (env.from_source(DataGeneratorSource(gen, 3000),
                                WatermarkStrategy.for_bounded_out_of_orderness(0))
                .key_by(lambda c: c[:, 0].to(torch.int32), traceable=True)
                .window(SlidingEventTimeWindows.of(2000, 500)).aggregate("count")
                .collect())
        client = env.execute_async()
        client.wait(60)
        snap = registry.metrics_snapshot(client.metrics.all_metrics())
        assert snap["job.numRecordsIn"] == 3000 and snap["job.p99EmissionLatencyMs"] > 0
        assert "prometheus" not in registry.prometheus_text(client.metrics.all_metrics())
        assert sorted(client.latency_report())[0] == "attribution"
        assert client.history_report()["enabled"] and client.doctor_report()["samples"] >= 1
        assert otel.spans_to_otlp([], "x")["resourceSpans"]
        # the chaos plane, the State Processor API, the formats and types
        from flink_tpu_torch.chaos import scenarios
        from flink_tpu_torch.core.types import Types
        from flink_tpu_torch.formats import get_format
        from flink_tpu_torch.formats.file_io import FormattedFileSource  # noqa: F401
        from flink_tpu_torch.state_processor import SavepointReader
        from flink_tpu_torch.testing.harness import fault_injection  # noqa: F401
        drill = scenarios.run_scenario("device-dispatch-error", device="cpu")
        assert drill["passed"] and drill["attributed"], drill
        assert SavepointReader.load(tmp + "/chk").records_in() > 0
        assert Types.ROW(["a"], [Types.LONG]).serializer().serialize((1,)) == bytes(
            [0, 1, 0, 0, 0, 0, 0, 0, 0])
        import io
        buf = io.BytesIO()
        get_format("avro").write([{"n": -3}], buf)
        assert get_format("avro").read(io.BytesIO(buf.getvalue())) == [{"n": -3}]
        # ML_PREDICT over a torch model, and the cluster: a graph job (the
        # fused window, so K1's plain version) on an in-process JobManager
        # and TaskExecutor over the authenticated RPC and data planes
        from flink_tpu_torch.table.ml import TorchModelProvider, params_from_numpy
        tenv.register_model("m", TorchModelProvider(
            lambda p, x: x @ p["w"], params_from_numpy({"w": np.ones((1, 1), np.float32)},
                                                      "cpu"), ["amount"], ["y"], device="cpu"))
        rows = tenv.execute_sql_to_list("SELECT user, ML_PREDICT(m, amount) AS y FROM pay")
        assert sum(r["y"] for r in rows) == sum(float(i % 4) for i in range(60))
        from flink_tpu_torch.runtime.cluster import JobManagerEndpoint, TaskExecutorEndpoint
        from flink_tpu_torch.runtime.rpc import RpcService
        from flink_tpu_torch.security import wire  # noqa: F401
        from flink_tpu_torch.testing import cluster_jobs
        from flink_tpu_torch.testing.harness import ephemeral_transport_security
        sec = ephemeral_transport_security()
        jm_svc, tm_svc = RpcService(security=sec), RpcService(security=sec)
        jm = JobManagerEndpoint(jm_svc, heartbeat_interval=0.2, heartbeat_timeout=10.0)
        te = TaskExecutorEndpoint(tm_svc, slots=2, device="cpu")
        te.connect(jm_svc.address)
        spec = cluster_jobs.api_graph_spec("c", 4096, keys=16, batch=512, window_ms=2000,
                                           slide_ms=1000, device="cpu", stages=True)
        gw = jm_svc.gateway(jm_svc.address, "jobmanager")
        job = gw.submit_job(spec.to_bytes(), 1)
        import time as _time
        deadline = _time.time() + 60
        while gw.job_status(job)["status"] not in ("FINISHED", "FAILED") and _time.time() < deadline:
            _time.sleep(0.05)
        assert gw.job_status(job)["status"] == "FINISHED", gw.job_status(job)
        rows = cluster_jobs.fired_rows(gw.job_result(job))
        assert sum(v for _t, _k, v in rows) == 2 * 4096 // 3 + 2
        # the HTTP planes over that cluster job (the jm_gateway bridge), the
        # dashboard and a flame graph; then a chaos cluster drill and the tools
        import json as _json
        import urllib.request as _rq
        from flink_tpu_torch.runtime.minicluster import MiniCluster
        from flink_tpu_torch.runtime.rest import RestServer
        server = RestServer(MiniCluster(), jm_gateway=gw).start()
        with _rq.urlopen(f"{server.url}/jobs/{job}", timeout=30) as r:
            assert _json.loads(r.read())["status"] == "FINISHED"
        with _rq.urlopen(f"{server.url}/flamegraph?duration=0.05", timeout=30) as r:
            assert "tree" in _json.loads(r.read())
        with _rq.urlopen(server.url + "/", timeout=30) as r:
            assert b"device plane" in r.read()
        server.stop()
        te.stop(); jm.heartbeats.stop(); jm_svc.stop(); tm_svc.stop()
        from flink_tpu_torch.chaos.scenarios import run_scenario
        drill = run_scenario("dataplane-blip", device="cpu")
        assert drill["passed"] and drill["parity"], drill
        from flink_tpu_torch.cli import frontend  # noqa: F401
        from flink_tpu_torch.core.fs import MemoryFileSystem
        from flink_tpu_torch.deploy.kubernetes import KubernetesClusterDescriptor
        from flink_tpu_torch.docs.generate import render_markdown
        from flink_tpu_torch.fs.object_store import S3FileSystem  # noqa: F401
        from flink_tpu_torch.runtime.ha import JobResultStore  # noqa: F401
        from flink_tpu_torch.runtime.ha_kubernetes import KubernetesLeaderElection  # noqa: F401
        mem = MemoryFileSystem()
        mem.write("mem://b/k", b"v")
        assert mem.read("mem://b/k") == b"v"
        assert "nvidia.com/gpu" in KubernetesClusterDescriptor("c", gpus_per_tm=1).render()
        assert "| Key |" in render_markdown()
        bad = sorted(m for m in set(sys.modules) - before
                     if m == "jax" or m.startswith(("jax.", "flink_tpu.")) or m == "flink_tpu")
        print("BAD", bad)
        assert not bad, bad
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_neither_jax_nor_flink_tpu():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    # the SQL front door, the latency controller and the oracle's state are
    # scanned too
    for sub in ("table", "planner", "security", "scheduler", "state", "core", "checkpoint",
                "metrics", "joins", "parallel", "chaos", "formats", "testing", "cli", "fs",
                "deploy", "docs"):
        assert any(f.parent == PKG / sub for f in files), sub
    for name in ("runtime/oracle_window_operator.py", "runtime/timers.py", "state/heap.py",
                 "core/keygroups.py", "core/functions.py", "api/windowing/evictors.py",
                 "scheduler/latency_controller.py", "state/vocab.py", "state/changelog.py",
                 "state/cold_tier.py", "state/tier_manager.py", "state/spillable.py",
                 "utils/native_bridge.py", "runtime/memory.py",
                 "runtime/external_resources.py", "checkpoint/storage.py",
                 "checkpoint/coordinator.py", "checkpoint/restart.py",
                 "metrics/checkpoint_stats.py", "runtime/minicluster.py",
                 "ops/join_ring.py", "joins/spec.py", "joins/ring.py", "joins/pipeline.py",
                 "runtime/device_join_operator.py", "runtime/stream_join_operator.py",
                 "state/key_groups.py", "core/records.py", "parallel/mesh.py",
                 "parallel/routing.py", "parallel/ring.py", "parallel/spmd_step.py",
                 "parallel/sharded_window.py", "parallel/sharded_superscan.py",
                 "runtime/sharded_window_operator.py", "ops/matmul_hist.py",
                 "ops/exchange.py", "joins/sharded.py", "metrics/registry.py",
                 "metrics/task_io.py", "metrics/traces.py", "metrics/otel.py",
                 "metrics/emission_latency.py", "metrics/history.py", "metrics/doctor.py",
                 "scheduler/rebalancer.py", "scheduler/signals.py", "scheduler/policy.py",
                 "scheduler/autoscaler.py", "core/serializers.py", "core/types.py",
                 "formats/registry.py", "formats/file_io.py", "state_processor.py",
                 "chaos/plan.py", "chaos/scenarios.py", "testing/harness.py",
                 "table/ml.py", "security/framing.py", "security/wire.py",
                 "security/transport.py", "runtime/rpc.py", "runtime/heartbeat.py",
                 "runtime/blob.py", "runtime/dataplane.py", "metrics/exchange.py",
                 "runtime/stages.py", "runtime/cluster.py", "testing/cluster_jobs.py",
                 "runtime/rest.py", "runtime/web_dashboard.py", "metrics/flamegraph.py",
                 "runtime/ha.py", "runtime/ha_kubernetes.py", "cli/__init__.py",
                 "cli/__main__.py", "cli/frontend.py", "core/fs.py", "fs/__init__.py",
                 "fs/object_store.py", "deploy/__init__.py", "deploy/kubernetes.py",
                 "docs/__init__.py", "docs/generate.py"):
        assert PKG / name in files, name
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flink_tpu"), f"{path}: imports {mod}"


def test_pipelines_raise_instead_of_falling_back_to_cpu(monkeypatch):
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.runtime.tpu_global_window_operator import TpuGlobalWindowOperator
    from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator
    from flink_tpu_torch.runtime.fused_window_pipeline import (
        FusedGlobalWindowPipeline,
        FusedWindowPipeline,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedWindowPipeline(SlidingEventTimeWindows.of(2000, 500), "count",
                            key_capacity=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedGlobalWindowPipeline(SlidingEventTimeWindows.of(2000, 500), "max")
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuWindowOperator(SlidingEventTimeWindows.of(2000, 500), "count")
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuGlobalWindowOperator("sum", count_n=4, purging=True)
