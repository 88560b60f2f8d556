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
