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
    for sub in ("table", "planner", "security", "scheduler", "state", "core"):
        assert any(f.parent == PKG / sub for f in files), sub
    for name in ("runtime/oracle_window_operator.py", "runtime/timers.py", "state/heap.py",
                 "core/keygroups.py", "core/functions.py", "api/windowing/evictors.py",
                 "scheduler/latency_controller.py"):
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
