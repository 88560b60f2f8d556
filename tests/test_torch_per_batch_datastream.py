"""Per-batch DataStream jobs on the port held against the same jobs on the
JAX package.

Four job shapes through both packages' `env.execute()` (the port's with
`device="cpu"`), at a small size:

- the api_ysb program (traceable filter and key, 10 s windows sliding by
  1 s, `count`) with `allowed_lateness(2000)`, `side_output_late_data()`
  and a `get_side_output(LATE_DATA_TAG)` sink, over the lateness stream
  (`testing/stream.py::late_columns`: 1% of records 1-2 s behind the
  watermark, 0.1% 15 s behind), also held against `LatenessOracle`;
- the same program without lateness and `execution.window.fused` off;
- `GlobalWindows` with `PurgingTrigger.of(CountTrigger.of(n))` and with a
  plain `CountTrigger`;
- `continuous_aggregate` with `execution.group-agg.device` on and off.

Each asserts the operator the runner selected. The methods and options
these operators brought in no longer raise; the surfaces the per-record
oracle operator brought in run in both packages to the same rows; the
ones still deferred raise naming their ROADMAP item.

Tolerance: exact (integer-valued payloads; AVG to rtol 1e-6).
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.api import functions as jfn  # noqa: E402
from flink_tpu.api.datastream import StreamExecutionEnvironment as JaxEnv  # noqa: E402
from flink_tpu.api.windowing import assigners as jasg  # noqa: E402
from flink_tpu.api.windowing import evictors as jev  # noqa: E402
from flink_tpu.api.windowing import triggers as jtrg  # noqa: E402
from flink_tpu.config import Configuration as JaxConfiguration  # noqa: E402
from flink_tpu.config import ExecutionOptions as JaxExecutionOptions  # noqa: E402
from flink_tpu.connectors.source import Batch as JaxBatch  # noqa: E402
from flink_tpu.connectors.source import DataGeneratorSource as JaxGeneratorSource  # noqa: E402
from flink_tpu.core.watermarks import WatermarkStrategy as JaxWatermarkStrategy  # noqa: E402
from flink_tpu_torch.api import datastream as tds  # noqa: E402
from flink_tpu_torch.api import functions as tfn  # noqa: E402
from flink_tpu_torch.api.windowing import assigners as tasg  # noqa: E402
from flink_tpu_torch.api.windowing import evictors as tev  # noqa: E402
from flink_tpu_torch.api.windowing import triggers as ttrg  # noqa: E402
from flink_tpu_torch.config import Configuration, ExecutionOptions  # noqa: E402
from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource  # noqa: E402
from flink_tpu_torch.core.watermarks import WatermarkStrategy  # noqa: E402
from flink_tpu_torch.graph.transformation import plan  # noqa: E402
from flink_tpu_torch.runtime.executor import build_runners  # noqa: E402
from flink_tpu_torch.table.changelog import ROW_KIND_FIELD  # noqa: E402
from flink_tpu_torch.testing import stream as st  # noqa: E402
from tests.test_retract_sql import _mixed_stream  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401

KEYS = 256
BATCH = 1024
EVENTS = 1 << 15

JAX = dict(env=JaxEnv, cfg=JaxConfiguration, opts=JaxExecutionOptions, batch=JaxBatch,
           source=JaxGeneratorSource, wm=JaxWatermarkStrategy, asg=jasg, trg=jtrg, fn=jfn, ev=jev,
           filter=lambda col: col[:, 1] < 0.5, key=lambda col: col[:, 0].astype(jnp.int32))
PORT = dict(env=tds.StreamExecutionEnvironment, cfg=Configuration, opts=ExecutionOptions,
            batch=Batch, source=DataGeneratorSource, wm=WatermarkStrategy, asg=tasg, trg=ttrg,
            fn=tfn, ev=tev, filter=lambda col: col[:, 1] < 0.5,
            key=lambda col: col[:, 0].to(torch.int32))


def _env(pkg, **opts):
    cfg = pkg["cfg"]()
    cfg.set(pkg["opts"].BATCH_SIZE, BATCH)
    cfg.set(pkg["opts"].KEY_CAPACITY, KEYS)
    for name, value in opts.items():
        cfg.set(getattr(pkg["opts"], name), value)
    return pkg["env"](cfg, device="cpu") if pkg is PORT else pkg["env"](cfg)


def _late_source(pkg, n):
    return pkg["source"](lambda idx: pkg["batch"](*st.late_columns(idx, BATCH, KEYS)), n)


def _lateness_job(pkg, n=EVENTS, lateness=2000, side=True, **opts):
    """(env, main sink, side sink or None) of the api_ysb program over the
    lateness stream, with allowed lateness and the late side output."""
    env = _env(pkg, **opts)
    ws = (env.from_source(_late_source(pkg, n), pkg["wm"].for_bounded_out_of_orderness(500))
          .filter(pkg["filter"], traceable=True).key_by(pkg["key"], traceable=True)
          .window(pkg["asg"].SlidingEventTimeWindows.of(10_000, 1_000)))
    if lateness:
        ws = ws.allowed_lateness(lateness)
    if side:
        ws = ws.side_output_late_data()
    counted = ws.count()
    sink = counted.collect()
    late = counted.get_side_output(pkg["fn"].LATE_DATA_TAG).collect() if side else None
    return env, sink, late


def _ops(env, dev="cpu"):
    return [type(getattr(r, "op", r)).__name__
            for r in build_runners(plan(env._sinks), env.config, dev)[0]]


def _oracle(n, lateness=2000):
    """The oracle's emissions as (window end - 1, key, count) in the order
    the operator emits them, and its side output as (key, ts)."""
    orc = st.LatenessOracle(10_000, 1_000, lateness, KEYS, agg="count")
    rows, side = [], []
    wm = None
    for lo in range(0, n, BATCH):
        col, ts = st.late_columns(np.arange(lo, lo + BATCH, dtype=np.int64), BATCH, KEYS)
        wm = int(ts.max()) - 501 if wm is None else max(wm, int(ts.max()) - 501)
        keep = col[:, 1] == 0
        events, late = orc.step(col[keep, 0].astype(np.int64), ts[keep], col[keep, 2], wm)
        rows += [(j * 1000 + 9999, int(k), int(v)) for _kind, j, ks, vs in events
                 for k, v in zip(ks, vs)]
        side += list(zip(late[0].tolist(), late[2].tolist()))
    rows += [(j * 1000 + 9999, int(k), int(v)) for _kind, j, ks, vs in orc.advance(2**62)
             for k, v in zip(ks, vs)]
    return rows, side


def _by_window(rows):
    """(ts, key, value) rows grouped as the operator's fire events (runs of
    one window), each sorted by key: emission order within a fire follows
    the key dictionary's ids."""
    out, run = [], []
    for r in rows:
        if run and r[0] != run[-1][0]:
            out.append(sorted(run))
            run = []
        run.append(r)
    return out + ([sorted(run)] if run else [])


def test_lateness_job_matches_jax_and_the_oracle():
    env, sink, late = _lateness_job(PORT)
    env.execute()
    jenv, jsink, jlate = _lateness_job(JAX)
    jenv.execute()
    assert "TpuWindowOperator" in _ops(env)
    assert sink.results == jsink.results and len(sink.results) > 1000
    assert late.results == jlate.results and len(late.results) > 0
    # the collect sink keeps no timestamps: the oracle's rows as a multiset
    # here, fire by fire in the next test
    rows, side = _oracle(EVENTS)
    assert sorted(sink.results) == sorted((k, v) for _t, k, v in rows)
    assert sorted(k for k, _v in late.results) == sorted(k for k, _ts in side)


def test_lateness_job_emission_sequence_matches_the_oracle():
    """The operator's rows with their timestamps, fire by fire, equal the
    oracle's, re-fires included."""
    from flink_tpu_torch.connectors.sink import Sink, SinkWriter

    class Writer(SinkWriter):
        def __init__(self, rows):
            self.rows = rows

        def write_batch(self, values, timestamps=None):
            self.rows += [(int(t), int(k), v) for (k, v), t in zip(values, timestamps)]

    class RowsSink(Sink):
        def __init__(self):
            self.rows = []

        def create_writer(self):
            return Writer(self.rows)

    env = _env(PORT)
    sink = RowsSink()
    (env.from_source(_late_source(PORT, EVENTS), WatermarkStrategy.for_bounded_out_of_orderness(500))
     .filter(PORT["filter"], traceable=True).key_by(PORT["key"], traceable=True)
     .window(tasg.SlidingEventTimeWindows.of(10_000, 1_000)).allowed_lateness(2000)
     .count().sink_to(sink))
    env.execute()
    rows, _side = _oracle(EVENTS)
    assert _by_window(sink.rows) == _by_window(rows)
    refired = len(rows) - len({(t, k) for t, k, _v in rows})
    assert refired > 0


def test_lateness_without_side_output_drops_too_late_records():
    env, sink, _ = _lateness_job(PORT, side=False)
    env.execute()
    jenv, jsink, _ = _lateness_job(JAX, side=False)
    jenv.execute()
    assert sink.results == jsink.results


def test_side_output_without_lateness():
    env, sink, late = _lateness_job(PORT, lateness=0)
    env.execute()
    jenv, jsink, jlate = _lateness_job(JAX, lateness=0)
    jenv.execute()
    assert "TpuWindowOperator" in _ops(env)
    assert sink.results == jsink.results and late.results == jlate.results
    # a record 1-2 s behind the watermark is in no cleaned window of 10 s:
    # only the 15 s delays are late without lateness, as with it
    assert len(late.results) == len(_oracle(EVENTS, lateness=0)[1]) > 0


@pytest.mark.parametrize("columnar", [False, True])
def test_fused_off_runs_the_per_batch_operator(columnar):
    rows = {}
    for name, pkg, fused in (("port", PORT, False), ("jax", JAX, False), ("fused", PORT, True)):
        env, sink, _ = _lateness_job(pkg, n=1 << 14, lateness=0, side=False,
                                     FUSED_WINDOWS=fused, COLUMNAR_OUTPUT=columnar)
        env.execute()
        if name == "port":
            assert "TpuWindowOperator" in _ops(env)
        if columnar and name != "fused":
            # the per-batch operator's packed row: (key ids, values) a fire
            rows[name] = [(np.asarray(ids).tolist(), np.asarray(v).tolist())
                          for ids, v in sink.results]
        elif not columnar:
            rows[name] = sorted(sink.results)
    assert rows["port"] and rows["port"] == rows["jax"]
    if not columnar:
        # the fused operator drops the same too-late records
        assert rows["port"] == rows["fused"]


def _count_job(pkg, n, purging, agg="sum", batch=BATCH):
    env = _env(pkg, BATCH_SIZE=batch)
    trigger = pkg["trg"].CountTrigger.of(64)
    if purging:
        trigger = pkg["trg"].PurgingTrigger.of(trigger)

    def gen(idx):
        keys, ts, vals = st.late_records(idx, batch, KEYS)
        return pkg["batch"](np.stack([keys, vals], 1).astype(np.float32), np.sort(ts))

    ws = (env.from_source(pkg["source"](gen, n), pkg["wm"].for_monotonous_timestamps())
          .key_by(lambda r: int(r[0])).window(pkg["asg"].GlobalWindows.create()).trigger(trigger))
    sink = ws.aggregate(agg, value_fn=lambda r: float(r[1])).collect()
    return env, sink


@pytest.mark.parametrize("agg", ["sum", "count", "max"])
@pytest.mark.parametrize("purging", [True, False])
def test_count_window_job_matches_jax(purging, agg):
    env, sink = _count_job(PORT, 1 << 15, purging, agg)
    env.execute()
    jenv, jsink = _count_job(JAX, 1 << 15, purging, agg)
    jenv.execute()
    assert "TpuGlobalWindowOperator" in _ops(env)
    assert sink.results == jsink.results and len(sink.results) > 100


def _group_agg_job(pkg, device):
    cfg = pkg["cfg"]()
    cfg.set(pkg["opts"].BATCH_SIZE, 100)
    cfg.set(pkg["opts"].DEVICE_GROUP_AGG, device)
    env = pkg["env"](cfg, device="cpu") if pkg is PORT else pkg["env"](cfg)
    sink = (env.from_collection(_mixed_stream(n=1000, n_keys=40, seed=8))
            .key_by(lambda r: r["k"])
            .continuous_aggregate([("COUNT", None), ("SUM", "v"), ("AVG", "v")], ["k"],
                                  ["c", "s", "a"]).collect())
    return env, sink


@pytest.mark.parametrize("device", [False, True])
def test_continuous_aggregate_job_matches_jax(device):
    env, sink = _group_agg_job(PORT, device)
    env.execute()
    jenv, jsink = _group_agg_job(JAX, device)
    jenv.execute()
    assert "GroupAggRunner" in _ops(env)
    assert len(sink.results) == len(jsink.results) > 0
    for p, j in zip(sink.results, jsink.results):
        assert (p[ROW_KIND_FIELD], p["k"], p["c"], p["s"]) == (
            j[ROW_KIND_FIELD], j["k"], j["c"], j["s"])
        assert p["a"] == pytest.approx(j["a"], rel=1e-6)


def test_undeferred_surfaces_no_longer_raise():
    env = tds.StreamExecutionEnvironment(device="cpu")
    keyed = env.from_collection([1, 2, 3], timestamp_fn=lambda x: x).key_by(lambda x: x)
    win = keyed.window(tasg.TumblingEventTimeWindows.of(10))
    agg = win.allowed_lateness(5).side_output_late_data().sum()
    agg.get_side_output(tfn.LATE_DATA_TAG)
    agg.get_side_output("late-data")
    keyed.window(tasg.GlobalWindows.create()).trigger(ttrg.CountTrigger.of(2))
    keyed.window(tasg.GlobalWindows.create()).trigger(
        ttrg.PurgingTrigger.of(ttrg.CountTrigger.of(2)))
    keyed.continuous_aggregate([("COUNT", None)], ["k"], ["c"])
    Configuration({"execution.window.fused": False, "execution.group-agg.device": True,
                   "execution.group-agg.mini-batch": False})


def _count_function(fn):
    """A Python AggregateFunction counting records, on package `fn`'s base
    class (each package's oracle tells a Python aggregate by its own)."""
    class Count(fn.AggregateFunction):
        def create_accumulator(self):
            return 0

        def add(self, value, acc):
            return acc + 1

        def get_result(self, acc):
            return acc

        def merge(self, a, b):
            return a + b

    return Count()


def _still_deferred(pkg=None):
    """Surfaces by name: (job or call, the ROADMAP item it raises naming;
    None for the ones the per-record oracle operator and the state plane
    brought in, which run in both packages instead)."""
    pkg = pkg or PORT

    def job(make, float_sums=False, **opts):
        def run():
            env = (pkg["env"](pkg["cfg"](opts), device="cpu") if pkg is PORT
                   else pkg["env"].get_execution_environment(pkg["cfg"](opts)))
            keyed = env.from_collection([1, 2, 3, 12, 25], timestamp_fn=lambda x: x).key_by(
                lambda x: x % 2)
            sink = make(keyed).collect()
            env.execute()
            rows = sink.results
            if float_sums and pkg is not PORT:
                # the JAX oracle's float sum of integer values is an int,
                # the port's the float its device routes emit (ROADMAP.md
                # Queue C, not reproduced); the values are compared exactly
                rows = [(k, float(v)) for k, v in rows]
            return sorted(repr(r) for r in rows)
        return run

    def window(keyed):
        return keyed.window(pkg["asg"].TumblingEventTimeWindows.of(10))

    def source_side_output():
        env = (pkg["env"](device="cpu") if pkg is PORT
               else pkg["env"].get_execution_environment())
        env.from_collection([1]).get_side_output(pkg["fn"].LATE_DATA_TAG).collect()
        try:
            env.execute()
        except ValueError as e:
            return f"ValueError: {e}"

    return {
        # the constructor: with_gap() is EventTimeSessionWindows' factory
        # and makes event-time sessions in both packages (ROADMAP Queue C)
        "processing_time_sessions": (job(lambda k: k.window(
            pkg["asg"].ProcessingTimeSessionWindows(5)).sum(), float_sums=True), None),
        "event_time_trigger": (job(lambda k: window(k).trigger(
            pkg["trg"].EventTimeTrigger()).sum(), float_sums=True), None),
        "evictor": (job(lambda k: window(k).evictor(pkg["ev"].CountEvictor.of(1)).process(
            pkg["fn"].PassThroughWindowFunction())), None),
        "window_function": (job(lambda k: window(k).process(
            pkg["fn"].PassThroughWindowFunction())), None),
        "python_aggregate": (job(lambda k: window(k).aggregate(_count_function(pkg["fn"]))),
                             None),
        "global_window_without_count_trigger": (job(lambda k: k.window(
            pkg["asg"].GlobalWindows.create()).sum()), None),
        "global_window_with_fused_off": (job(lambda k: k.window(
            pkg["asg"].GlobalWindows.create()).sum(), **{"execution.window.fused": False}),
            None),
        # side outputs of any operator are ported: a source has none, and
        # both packages refuse the job at execute with the same error
        "side_output_of_a_source": (source_side_output, None),
        # the state plane is ported: a tiered job (the fused path
        # off: TpuWindowOperator's hot/cold id split) runs in both packages
        "state_tier": (job(lambda k: window(k).sum(), **{
            "state.tier.enabled": True, "state.tier.hot-key-capacity": 1,
            "execution.window.fused": False}), None),
    }


@pytest.mark.parametrize("name", sorted(_still_deferred()))
def test_still_deferred_surfaces_raise(name):
    call, item = _still_deferred()[name]
    if item is None:
        # brought in by the per-record oracle operator: the job runs, and
        # its rows are the JAX package's
        assert call() == _still_deferred(JAX)[name][0]()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A, {item}"):
        call()
