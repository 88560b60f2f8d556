"""DataStream surfaces of the per-record oracle operator on the port, held
against the same jobs on the JAX package.

Each job runs through both packages' `env.execute()` (the port's with
`device="cpu"`) on the same records, made with numpy from a seed: custom
triggers (`EventTimeTrigger`, `CountTrigger`, `PurgingTrigger`) on grid
windows, evictors with `process`, `reduce`, `process`, `aggregate` with a
window function, a Python `AggregateFunction`, GlobalWindows without a
count trigger, allowed lateness with a late side output on session
windows, a traceable key on a columnar source, and the port's continuous
and delta triggers (the JAX package has no such classes: the port's
trigger object runs in both jobs). The runner must select the oracle
operator, as the JAX runner does, and processing-time windows select it
too; their rows follow the executor's clock, which the tests replace with
one that advances the same way on every run.
Last, the selection itself, condition by condition of the JAX runner
(`flink_tpu/runtime/executor.py:560-690`): the port's runner picks the
operator the JAX runner picks.

Tolerance: exact. The sink's rows are compared by `repr`, in emission
order; payloads are small integers.
"""

import contextlib
import types

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
from flink_tpu.connectors.source import Batch as JaxBatch  # noqa: E402
from flink_tpu.connectors.source import DataGeneratorSource as JaxGeneratorSource  # noqa: E402
from flink_tpu.core.watermarks import WatermarkStrategy as JaxWatermarkStrategy  # noqa: E402
from flink_tpu.state.heap import value_state as jax_value_state  # noqa: E402
from flink_tpu_torch.api import datastream as tds  # noqa: E402
from flink_tpu_torch.api import functions as tfn  # noqa: E402
from flink_tpu_torch.api.windowing import assigners as tasg  # noqa: E402
from flink_tpu_torch.api.windowing import evictors as tev  # noqa: E402
from flink_tpu_torch.api.windowing import triggers as ttrg  # noqa: E402
from flink_tpu_torch.config import Configuration  # noqa: E402
from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource  # noqa: E402
from flink_tpu_torch.core.watermarks import WatermarkStrategy  # noqa: E402
from flink_tpu_torch.graph.transformation import plan  # noqa: E402
from flink_tpu_torch.runtime import executor as tex  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401

JAX = types.SimpleNamespace(env=JaxEnv, cfg=JaxConfiguration, fn=jfn, asg=jasg, ev=jev,
                            trg=jtrg, wm=JaxWatermarkStrategy, batch=JaxBatch,
                            source=JaxGeneratorSource, port=False,
                            key=lambda col: col[:, 0].astype(jnp.int32))
PORT = types.SimpleNamespace(env=tds.StreamExecutionEnvironment, cfg=Configuration, fn=tfn,
                             asg=tasg, ev=tev, trg=ttrg, wm=WatermarkStrategy, batch=Batch,
                             source=DataGeneratorSource, port=True,
                             key=lambda col: col[:, 0].to(torch.int32))


def _records(n=400, seed=1, keys=6):
    """(key, value, ts) tuples, mildly out of order."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 20_000, n)) + rng.integers(-300, 300, n)
    return [(f"k{int(k)}", int(v), int(t)) for k, v, t in
            zip(rng.integers(0, keys, n), rng.integers(-5, 20, n), np.maximum(ts, 0))]


def _env(P, **conf):
    conf = {"execution.step.batch-size": 64, **conf}
    if P.port:
        return P.env(P.cfg(conf), device="cpu")
    return P.env.get_execution_environment(P.cfg(conf))


def _keyed(P, env, records=None, bound=400):
    ds = env.from_collection(records or _records(), timestamp_fn=lambda r: r[2],
                             watermark_strategy=P.wm.for_bounded_out_of_orderness(bound))
    return ds.key_by(lambda r: r[0])


def _sum_function(P):
    class Sum(P.fn.AggregateFunction):
        def create_accumulator(self):
            return (0, 0)

        def add(self, value, acc):
            return (acc[0] + value[1], acc[1] + 1)

        def get_result(self, acc):
            return f"{acc[0]}/{acc[1]}"

        def merge(self, a, b):
            return (a[0] + b[0], a[1] + b[1])

    return Sum()


def _describe(P):
    class Describe(P.fn.ProcessWindowFunction):
        def process(self, key, context, elements):
            elements = list(elements)
            yield (key, context.window.start, context.window.end, len(elements),
                   repr(elements[-1]) if elements else None)

    return Describe()


TUMBLING = lambda P: P.asg.TumblingEventTimeWindows.of(2000)            # noqa: E731
SLIDING = lambda P: P.asg.SlidingEventTimeWindows.of(4000, 1000)        # noqa: E731

JOBS = {
    "event_time_trigger": lambda P, k: k.window(TUMBLING(P)).trigger(
        P.trg.EventTimeTrigger()).sum(lambda r: r[1]),
    "count_trigger": lambda P, k: k.window(SLIDING(P)).trigger(
        P.trg.CountTrigger.of(5)).aggregate("sum", lambda r: r[1]),
    "purging_count_trigger": lambda P, k: k.window(TUMBLING(P)).trigger(
        P.trg.PurgingTrigger.of(P.trg.CountTrigger.of(4))).count(),
    "count_evictor_process": lambda P, k: k.window(SLIDING(P)).evictor(
        P.ev.CountEvictor.of(3)).process(_describe(P)),
    "time_evictor_process": lambda P, k: k.window(TUMBLING(P)).evictor(
        P.ev.TimeEvictor.of(500)).process(_describe(P)),
    "reduce": lambda P, k: k.window(SLIDING(P)).reduce(
        lambda a, b: (a[0], a[1] + b[1], max(a[2], b[2]))),
    "process": lambda P, k: k.window(TUMBLING(P)).process(_describe(P)),
    "aggregate_with_window_function": lambda P, k: k.window(TUMBLING(P)).aggregate(
        "max", lambda r: r[1], window_fn=_describe(P)),
    "python_aggregate": lambda P, k: k.window(SLIDING(P)).aggregate(_sum_function(P)),
    "python_aggregate_sessions": lambda P, k: k.window(
        P.asg.EventTimeSessionWindows.with_gap(300)).aggregate(_sum_function(P)),
    "global_windows_never_fire": lambda P, k: k.window(P.asg.GlobalWindows.create()).sum(
        lambda r: r[1]),
    "global_windows_reduce_count_trigger": lambda P, k: k.window(
        P.asg.GlobalWindows.create()).trigger(P.trg.CountTrigger.of(7)).reduce(
        lambda a, b: (a[0], a[1] + b[1], b[2])),
}


# the jobs whose window sums integer values through the oracle's python form
# of a float `sum`: the JAX package emits those sums as ints, the port as the
# floats its device routes emit (ROADMAP.md Queue C, not reproduced)
FLOAT_SUM_JOBS = {"event_time_trigger", "count_trigger"}


def _jax_float_sums(rows):
    """The JAX package's (key, sum) rows with each sum as the float the
    port emits; the values are compared exactly."""
    assert all(isinstance(v, int) for _k, v in rows)
    return [(k, float(v)) for k, v in rows]


def _run(P, name, **conf):
    env = _env(P, **conf)
    sink = JOBS[name](P, _keyed(P, env)).collect()
    env.execute()
    return env, sink.results


def _oracle_selected(env):
    ops = [type(r.op).__name__ for r in tex.build_runners(plan(env._sinks), env.config, "cpu")[0]
           if isinstance(r, tex.WindowStepRunner)]
    return ops == ["OracleWindowOperator"]


@pytest.mark.parametrize("name", sorted(JOBS))
def test_job_matches_jax(name):
    env, rows = _run(PORT, name)
    _jenv, jrows = _run(JAX, name)
    if name in FLOAT_SUM_JOBS:
        jrows = _jax_float_sums(jrows)
    assert repr(rows) == repr(jrows)
    assert _oracle_selected(env)
    if name != "global_windows_never_fire":
        assert len(rows) > 10
    else:
        assert rows == []


def test_sessions_with_allowed_lateness_and_a_late_side_output_match_jax():
    records = _records(600, seed=4)
    # every 40th record 2-3 s behind its neighbours: late for its session
    records = [(k, v, max(t - 2000 - 25 * (i % 40), 0)) if i % 40 == 39 else (k, v, t)
               for i, (k, v, t) in enumerate(records)]
    out = []
    for P in (JAX, PORT):
        env = _env(P)
        win = (_keyed(P, env, records, bound=50)
               .window(P.asg.EventTimeSessionWindows.with_gap(400))
               .allowed_lateness(300).side_output_late_data())
        agg = win.sum(lambda r: r[1])
        main = agg.collect()
        late = agg.get_side_output(P.fn.LATE_DATA_TAG).collect()
        env.execute()
        rows = main.results if P.port else _jax_float_sums(main.results)
        out.append((repr(rows), repr(late.results), len(late.results)))
        if P.port:
            assert _oracle_selected(env)
    assert out[0] == out[1] and out[1][2] > 0


def _columnar(P, n=4096, batch=512):
    def gen(idx):
        col = np.stack([(idx * 2654435761) % 16, idx % 5], axis=1).astype(np.float32)
        return P.batch(col, (idx * 7).astype(np.int64))

    env = _env(P, **{"execution.step.batch-size": batch})
    ds = env.from_source(P.source(gen, n), watermark_strategy=P.wm.for_bounded_out_of_orderness(0))
    return env, ds.key_by(P.key, traceable=True)


def test_traceable_key_on_the_oracle_matches_jax():
    out = []
    for P in (JAX, PORT):
        env, keyed = _columnar(P)
        sink = (keyed.window(P.asg.TumblingEventTimeWindows.of(1000))
                .trigger(P.trg.CountTrigger.of(9)).aggregate("sum", lambda r: float(r[1]))
                .collect())
        env.execute()
        out.append(repr(sorted(sink.results, key=repr)))
    assert out[0] == out[1] and len(out[1]) > 100


@pytest.mark.parametrize("trigger", ["continuous_event_time", "delta"])
def test_port_only_triggers_run_in_both_jobs(trigger):
    """The continuous and delta triggers (the port's; the JAX package has
    none): the same trigger object drives both jobs. The JAX operator
    registers the trigger's state as the port's operator does."""
    if trigger == "continuous_event_time":
        trg = ttrg.ContinuousEventTimeTrigger.of(500)
    else:
        # the trigger sees the value the job aggregates (r[1])
        trg = ttrg.DeltaTrigger.of(6, lambda a, b: abs(b - a))
    from flink_tpu.runtime import executor as jex

    real = jex.OracleWindowOperator

    def jax_operator(*args, **kw):
        op = real(*args, **kw)
        op.state.register(jax_value_state("trigger." + trg.STATE))
        return op

    out = []
    for P in (JAX, PORT):
        env = _env(P)
        sink = (_keyed(P, env, bound=100).window(SLIDING(P)).trigger(trg)
                .sum(lambda r: r[1]).collect())
        jex.OracleWindowOperator = jax_operator
        try:
            env.execute()
        finally:
            jex.OracleWindowOperator = real
        out.append(repr(sink.results if P.port else _jax_float_sums(sink.results)))
    assert out[0] == out[1] and out[1].count("(") > 50


def _stepped_clock(step_ms=100, start_s=1_700_000_000.0):
    """The executor's `time` module with a wall clock that advances
    `step_ms` at every read: processing time that passes the same way on
    every run, however loaded the machine."""
    reads = iter(range(1 << 40))
    return types.SimpleNamespace(
        time=lambda: start_s + next(reads) * step_ms / 1000.0,
        perf_counter=__import__("time").perf_counter,
        time_ns=__import__("time").time_ns)


@pytest.mark.parametrize("assigner", ["tumbling", "sliding", "sessions"])
def test_processing_time_windows_select_the_oracle(assigner, monkeypatch):
    make = {"tumbling": lambda: tasg.TumblingProcessingTimeWindows(1000),
            "sliding": lambda: tasg.SlidingProcessingTimeWindows(2000, 1000),
            "sessions": lambda: tasg.ProcessingTimeSessionWindows(500)}[assigner]
    env = _env(PORT)
    sink = _keyed(PORT, env).window(make()).sum(lambda r: r[1]).collect()
    assert _oracle_selected(env)
    # the stepped clock passes window ends inside the run, so windows fire
    # on every run (on the wall clock a fast run fired none)
    monkeypatch.setattr(tex, "time", _stepped_clock())
    env.execute()
    assert sink.results
    assert all(isinstance(v, float) for _k, v in sink.results)


@pytest.mark.parametrize("assigner", ["tumbling", "sliding", "sessions"])
def test_processing_time_windows_match_jax_on_an_injected_clock(assigner, monkeypatch):
    """Both packages' executors read a clock that moves 600 ms a source
    batch of 64 records (set as the source assigns each batch's
    timestamps), so every read inside one batch sees the same processing
    time in both runs: the rows are the JAX package's, with its int sums
    as floats."""
    from flink_tpu.runtime import executor as jex

    make = {"tumbling": lambda P: P.asg.TumblingProcessingTimeWindows(1000),
            "sliding": lambda P: P.asg.SlidingProcessingTimeWindows(2000, 1000),
            "sessions": lambda P: P.asg.ProcessingTimeSessionWindows(500)}[assigner]
    out = []
    for P, module in ((JAX, jex), (PORT, tex)):
        seen = [0]

        def ts_of(r, seen=seen):
            seen[0] += 1
            return r[2]

        now = lambda seen=seen: 1_700_000_000.0 + (seen[0] // 64) * 0.6  # noqa: E731
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            time=now, perf_counter=__import__("time").perf_counter,
            time_ns=__import__("time").time_ns))
        env = _env(P)
        ds = env.from_collection(_records(), timestamp_fn=ts_of,
                                 watermark_strategy=P.wm.for_bounded_out_of_orderness(400))
        sink = ds.key_by(lambda r: r[0]).window(make(P)).sum(lambda r: r[1]).collect()
        env.execute()
        out.append(repr(sink.results if P.port else _jax_float_sums(sink.results)))
    assert out[0] == out[1] and out[1].count("(") >= 18


# ---------------------------------------------------------------------------
# the selection: the port's runner picks the operator the JAX runner picks,
# condition by condition (JAX executor.py:560-690)
# ---------------------------------------------------------------------------

SELECTION = {
    # name: (window, configure the windowed stream, aggregate, options)
    "sliding_count": ("sliding", None, "count", {}),
    "sliding_python_aggregate": ("sliding", None, "python", {}),
    "sliding_window_function": ("sliding", None, "window_fn", {}),
    "sliding_reduce": ("sliding", "reduce", None, {}),
    "sliding_process": ("sliding", "process", None, {}),
    "sliding_event_time_trigger": ("sliding", "event_trigger", "sum", {}),
    "sliding_count_trigger": ("sliding", "count_trigger", "sum", {}),
    "sliding_evictor": ("sliding", "evictor", "sum", {}),
    "sliding_lateness": ("sliding", "lateness", "sum", {}),
    "sliding_side_output": ("sliding", "side_output", "sum", {}),
    "sliding_fused_off": ("sliding", None, "sum", {"execution.window.fused": False}),
    "sliding_processing_time": ("sliding_pt", None, "sum", {}),
    "tumbling_processing_time": ("tumbling_pt", None, "count", {}),
    "global_count_trigger": ("global", "count_trigger", "sum", {}),
    "global_purging_count_trigger": ("global", "purging_count_trigger", "sum", {}),
    "global_default_trigger": ("global", None, "sum", {}),
    "global_count_trigger_evictor": ("global", "count_trigger_evictor", "sum", {}),
    "global_count_trigger_python": ("global", "count_trigger", "python", {}),
    "global_fused_off": ("global", None, "sum", {"execution.window.fused": False}),
    "sessions": ("sessions", None, "sum", {}),
    "sessions_disorder_at_gap": ("sessions_wide", None, "sum", {}),
    "sessions_device_off": ("sessions", None, "sum",
                            {"execution.window.device-sessions": False}),
    "sessions_python": ("sessions", None, "python", {}),
    "sessions_trigger": ("sessions", "count_trigger", "sum", {}),
    "sessions_lateness": ("sessions", "lateness", "sum", {}),
    "sessions_processing_time": ("sessions_pt", None, "sum", {}),
}


def _selected(P, name):
    window, configure, aggregate, opts = SELECTION[name]
    env = _env(P, **opts)
    bound = 3000 if window == "sessions_wide" else 100
    keyed = _keyed(P, env, _records(50), bound=bound)
    asg = {"sliding": lambda: P.asg.SlidingEventTimeWindows.of(4000, 1000),
           "sliding_pt": lambda: P.asg.SlidingProcessingTimeWindows(4000, 1000),
           "tumbling_pt": lambda: P.asg.TumblingProcessingTimeWindows(2000),
           "global": lambda: P.asg.GlobalWindows.create(),
           "sessions": lambda: P.asg.EventTimeSessionWindows.with_gap(1000),
           "sessions_wide": lambda: P.asg.EventTimeSessionWindows.with_gap(1000),
           "sessions_pt": lambda: P.asg.ProcessingTimeSessionWindows(1000)}[window]()
    win = keyed.window(asg)
    if configure == "event_trigger":
        win = win.trigger(P.trg.EventTimeTrigger())
    elif configure == "count_trigger":
        win = win.trigger(P.trg.CountTrigger.of(3))
    elif configure == "purging_count_trigger":
        win = win.trigger(P.trg.PurgingTrigger.of(P.trg.CountTrigger.of(3)))
    elif configure == "count_trigger_evictor":
        win = win.trigger(P.trg.CountTrigger.of(3)).evictor(P.ev.CountEvictor.of(2))
    elif configure == "evictor":
        win = win.evictor(P.ev.CountEvictor.of(2))
    elif configure == "lateness":
        win = win.allowed_lateness(500)
    elif configure == "side_output":
        win = win.side_output_late_data()
    if configure == "reduce":
        out = win.reduce(lambda a, b: a)
    elif configure == "process":
        out = win.process(_describe(P))
    elif aggregate == "python":
        out = win.aggregate(_sum_function(P))
    elif aggregate == "window_fn":
        out = win.aggregate("sum", lambda r: r[1], window_fn=_describe(P))
    else:
        out = win.aggregate(aggregate, None if aggregate == "count" else (lambda r: r[1]))
    out.collect()
    if P.port:
        runners = tex.build_runners(plan(env._sinks), env.config, "cpu")[0]
    else:
        from flink_tpu.graph.transformation import plan as jax_plan
        from flink_tpu.runtime.executor import build_runners as jax_build_runners

        runners = jax_build_runners(jax_plan(env._sinks), env.config)[0]
    return [type(r.op).__name__ for r in runners if hasattr(r, "op")]


@pytest.mark.parametrize("name", sorted(SELECTION))
def test_runner_selects_the_operator_the_jax_runner_selects(name):
    warns = name == "sessions_disorder_at_gap"
    with pytest.warns(RuntimeWarning) if warns else contextlib.nullcontext():
        port = _selected(PORT, name)
    with pytest.warns(RuntimeWarning) if warns else contextlib.nullcontext():
        jax = _selected(JAX, name)
    assert port == jax and len(port) == 1


def test_the_selection_cases_reach_every_operator():
    kinds = {_selected(PORT, name)[0] for name in SELECTION
             if name != "sessions_disorder_at_gap"}
    assert kinds == {"OracleWindowOperator", "FusedWindowOperator", "TpuWindowOperator",
                     "TpuGlobalWindowOperator", "TpuSessionWindowOperator"}
