"""Session-window DataStream jobs on the port held against the JAX package's.

`from_collection(...).key_by(...).window(EventTimeSessionWindows.with_gap(g))
.aggregate(...)` through both packages' `env.execute()` (the port on the
CPU): the record-mode job of `tests/test_session_operator.py::
test_session_through_datastream_api_uses_device_operator`, and a columnar
job with a traceable int32 key over the session stream of
`testing/stream.py::session_records` (four rotating key blocks, 500 ms
jitter), also held against `numpy_sessionize`. Then the routing gates: the
session operator is selected while the sources' out-of-orderness is below
the gap; where the JAX package would pick its per-record oracle (disorder
>= gap, `execution.window.device-sessions` false, processing-time
sessions) the port raises naming ROADMAP item 18.

Tolerance: exact. Sorted (key, value) rows; payloads are small integers.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api.datastream import StreamExecutionEnvironment as JaxEnv  # noqa: E402
from flink_tpu.api.windowing import assigners as jasg  # noqa: E402
from flink_tpu.config import Configuration as JaxConfiguration  # noqa: E402
from flink_tpu.config import ExecutionOptions as JaxExecutionOptions  # noqa: E402
from flink_tpu.connectors.source import Batch as JaxBatch  # noqa: E402
from flink_tpu.connectors.source import DataGeneratorSource as JaxGeneratorSource  # noqa: E402
from flink_tpu.core.watermarks import WatermarkStrategy as JaxWatermarkStrategy  # noqa: E402
from flink_tpu_torch.api import datastream as tds  # noqa: E402
from flink_tpu_torch.api.windowing import assigners as tasg  # noqa: E402
from flink_tpu_torch.config import Configuration, ExecutionOptions  # noqa: E402
from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource  # noqa: E402
from flink_tpu_torch.core.watermarks import WatermarkStrategy  # noqa: E402
from flink_tpu_torch.graph.transformation import plan  # noqa: E402
from flink_tpu_torch.runtime.executor import WindowStepRunner, build_runners  # noqa: E402
from flink_tpu_torch.runtime.tpu_session_operator import TpuSessionWindowOperator  # noqa: E402
from flink_tpu_torch.testing import stream as st  # noqa: E402

JAX = dict(env=JaxEnv, cfg=JaxConfiguration, opts=JaxExecutionOptions, batch=JaxBatch,
           source=JaxGeneratorSource, wm=JaxWatermarkStrategy, asg=jasg,
           key=lambda col: col[:, 0].astype(jnp.int32), value=lambda col: col[:, 1])
PORT = dict(env=tds.StreamExecutionEnvironment, cfg=Configuration, opts=ExecutionOptions,
            batch=Batch, source=DataGeneratorSource, wm=WatermarkStrategy, asg=tasg,
            key=lambda col: col[:, 0].to(torch.int32), value=lambda col: col[:, 1])

CLICKS = [("u1", 0), ("u1", 300), ("u2", 100), ("u1", 2000), ("u2", 2500)]


def _env(pkg, cfg=None):
    kw = {"device": "cpu"} if pkg is PORT else {}
    return pkg["env"].get_execution_environment(cfg or pkg["cfg"](), **kw)


def _clicks_job(pkg, cfg=None, *, bound=None, gap=1000, assigner=None):
    env = _env(pkg, cfg)
    wm = (pkg["wm"].for_monotonous_timestamps() if bound is None
          else pkg["wm"].for_bounded_out_of_orderness(bound))
    asg = assigner or pkg["asg"].EventTimeSessionWindows.with_gap(gap)
    sink = (env.from_collection(CLICKS, timestamp_fn=lambda x: x[1], watermark_strategy=wm)
            .key_by(lambda x: x[0]).window(asg).count().collect())
    return env, sink


def test_record_job_matches_jax_on_the_session_operator():
    rows = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        cfg = pkg["cfg"]()
        cfg.set(pkg["opts"].BATCH_SIZE, 8)
        env, sink = _clicks_job(pkg, cfg)
        env.execute()
        rows[name] = sorted(sink.results)
    # u1: sessions {0, 300} and {2000}; u2: {100} and {2500}
    assert rows["port"] == rows["jax"] == [("u1", 1), ("u1", 2), ("u2", 1), ("u2", 1)]
    env, _sink = _clicks_job(PORT)
    wr = [r for r in build_runners(plan(env._sinks), env.config, "cpu")[0]
          if isinstance(r, WindowStepRunner)]
    assert len(wr) == 1 and isinstance(wr[0].op, TpuSessionWindowOperator)


N, STEP = 1 << 14, 1024          # 16 steps of the session stream, one batch each


def _columnar_job(pkg, aggregate):
    def gen(idx):
        keys, ts, vals = st.session_records(idx, STEP)
        return pkg["batch"](np.stack([keys, vals], axis=1).astype(np.float32), ts)

    cfg = pkg["cfg"]()
    cfg.set(pkg["opts"].BATCH_SIZE, STEP)
    env = _env(pkg, cfg)
    sink = (env.from_source(pkg["source"](gen, N),
                            watermark_strategy=pkg["wm"].for_bounded_out_of_orderness(500))
            .key_by(pkg["key"], traceable=True)
            .window(pkg["asg"].EventTimeSessionWindows.with_gap(st.SESSION_GAP_MS))
            .aggregate(aggregate, value_fn=pkg["value"], value_traceable=True)
            .collect())
    env.execute()
    return sorted((int(k), float(v)) for k, v in sink.results)


@pytest.mark.parametrize("aggregate", ["sum", "max"])
def test_columnar_traceable_key_job_matches_jax(aggregate):
    port_rows = _columnar_job(PORT, aggregate)
    assert port_rows == _columnar_job(JAX, aggregate)
    keys, ts, vals = st.session_records(np.arange(N, dtype=np.int64), STEP)
    if aggregate == "sum":
        expect = st.numpy_sessionize(keys, ts, vals, st.SESSION_GAP_MS)
        assert port_rows == sorted((k, v) for (k, _s, _e), v in expect.items())
    assert len(port_rows) > 4096


@pytest.mark.parametrize("what", ["device_sessions_off", "disorder_at_gap",
                                  "processing_time"])
def test_jobs_the_jax_package_gives_its_oracle_raise_naming_item_18(what):
    cfg = Configuration()
    kw = {}
    if what == "device_sessions_off":
        cfg.set(ExecutionOptions.DEVICE_SESSIONS, False)
        match = "device-sessions is false"
    elif what == "disorder_at_gap":
        kw = dict(bound=2000, gap=2000)
        match = "out-of-orderness bound"
    else:
        kw = dict(assigner=tasg.ProcessingTimeSessionWindows(1000))
        match = "processing-time"
    env, _sink = _clicks_job(PORT, cfg, **kw)
    with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP.md Queue A, item 18"):
        env.execute()


def test_disorder_below_gap_selects_the_session_operator():
    env, _sink = _clicks_job(PORT, bound=1999, gap=2000)
    wr = [r for r in build_runners(plan(env._sinks), env.config, "cpu")[0]
          if isinstance(r, WindowStepRunner)]
    assert isinstance(wr[0].op, TpuSessionWindowOperator)


def test_session_job_raises_without_a_gpu_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = tds.StreamExecutionEnvironment()
    (env.from_collection(CLICKS, timestamp_fn=lambda x: x[1],
                         watermark_strategy=WatermarkStrategy.for_monotonous_timestamps())
     .key_by(lambda x: x[0]).window(tasg.EventTimeSessionWindows.with_gap(1000)).count()
     .collect())
    with pytest.raises(RuntimeError, match="CUDA"):
        env.execute()


def test_session_assigner_merges_touching_windows_as_the_jax_one():
    from flink_tpu.core.time import TimeWindow as JaxTimeWindow
    from flink_tpu_torch.core.time import TimeWindow

    spans = [(0, 100), (100, 200), (201, 301), (50, 60)]
    ws = [TimeWindow(*s) for s in spans]
    jws = [JaxTimeWindow(*s) for s in spans]
    port = tasg.EventTimeSessionWindows.with_gap(100).merge_windows(ws)
    ref = jasg.EventTimeSessionWindows.with_gap(100).merge_windows(jws)
    assert [(m.start, m.end, len(src)) for m, src in port] == \
        [(m.start, m.end, len(src)) for m, src in ref] == [(0, 200, 3), (201, 301, 1)]
    assert tasg.EventTimeSessionWindows.with_gap(100).assign_windows(None, 7) == [TimeWindow(7, 107)]
    assert tasg.EventTimeSessionWindows.with_gap(100).is_merging
    assert tasg.EventTimeSessionWindows.with_gap(100).slice_ms is None
