"""Keyed process functions, the rolling reduce, operator coordinators,
queryable state and API V2 on the port, held against the JAX package.
Modelled on tests/test_side_outputs_ttl.py (side outputs through
`ctx.output(tag, v)` and `get_side_output(tag)`, into windows) and
tests/test_datastream_e2e.py::test_operator_coordinator_event_bus.

Each job runs through both packages' `env.execute()` (or `JobRuntime`, or
the MiniCluster's `execute_async`) on the same records, made with numpy
from a seed; rows compare by `repr` in emission order. Processing-time
timers are driven through the runners' `on_processing_time(now_ms)`, so
no wall clock enters a result. Runner snapshots (process, reduce) and
coordinator state are restored across the packages.

Tolerance: exact.
"""

import threading

import numpy as np
import pytest

from api_twins import (
    JAX,
    PKGS,
    PORT,
    RunnerProbe,
    assert_restores_like_jax,
    batches,
    env,
    records,
    register_restored_states,
    restored_across,
    runner_kinds,
    stream,
    twin,
)
from jax_native_twins import jax_native_library  # noqa: F401


def _router(P, processing_time=False):
    """Routes low-valued records (value < 3) to "low", purchases to "buy";
    keeps a per-key running count in state; registers an event-time timer
    at the end of the record's second and, with `processing_time`, a
    processing-time timer 100 ms after its timestamp (fired only by the
    ticks a test drives: a job's run loop ticks on the wall clock)."""
    low, buy = P.fn.OutputTag("low"), P.fn.OutputTag("buy")

    class Router(P.fn.ProcessFunction):
        def process_element(self, v, ctx):
            st = ctx.timer_service.state()
            st.put("n", (st.get("n") or 0) + 1)
            ctx.timer_service.register_event_time_timer(v[3] - v[3] % 1000 + 999)
            if processing_time:
                ctx.timer_service.register_processing_time_timer(v[3] + 100)
            if v[2] < 3:
                ctx.output(low, (v[0], v[2]))
            if v[1] == 2:
                ctx.output(buy, v)
            return [(v[0], st.get("n"))]

        def on_timer(self, t, ctx):
            return [("timer", t, ctx.timer_service.state().get("n"))]

    return Router()


def _routed(P, e, recs, processing_time=False):
    return stream(P, e, recs).key_by(lambda r: r[0]).process(
        _router(P, processing_time), name="router")


class _Three:
    def __init__(self, *sinks):
        self.sinks = sinks

    @property
    def results(self):
        return tuple(s.results for s in self.sinks)


def test_side_outputs_route_by_tag_like_jax():
    def build(P, e):
        main = _routed(P, e, records(500))
        return _Three(main.collect(), main.get_side_output(P.fn.OutputTag("low")).collect(),
                      main.get_side_output("buy").collect())

    jax_rows, port_rows = twin(build)
    assert repr(port_rows) == repr(jax_rows)
    assert all(len(r) > 50 for r in port_rows)


def test_a_side_output_feeds_a_window_like_jax():
    def build(P, e):
        main = _routed(P, e, records(600, seed=4))
        return (main.get_side_output(P.fn.OutputTag("low")).key_by(lambda r: r[0])
                .window(P.asg.SlidingEventTimeWindows.of(4000, 1000)).count().collect())

    jax_rows, port_rows = twin(build)
    assert repr(port_rows) == repr(jax_rows) and len(port_rows) > 50
    kinds = []
    for P in PKGS:
        e = env(P)
        build(P, e)
        kinds.append(runner_kinds(P, e))
    # the window fed by a side output stays on the host chain
    assert kinds[0] == kinds[1] and "WindowStepRunner" in kinds[1]


def test_event_and_processing_time_timers_like_jax():
    """Batches and watermarks in turn, with processing-time ticks between
    them: the timers' output (processing-time output stamped
    MIN_TIMESTAMP) and both side channels equal the JAX runner's."""
    events = []
    for i, ev in enumerate(batches(records(300), size=30)):
        events.append(ev)
        if ev[0] == "wm":
            events.append(("pt", ev[2] + 150 * (i % 3)))
    out = [RunnerProbe(P, e, "KeyedProcessRunner", ("low", "buy")).feed(events).rows()
           for P, e in ((P, _build_routed(P)) for P in PKGS)]
    assert repr(out[0]) == repr(out[1])
    rows, _sides = out[1]
    pt = [t for (v, t) in rows if v[0] == "timer" and t < -(1 << 62)]
    assert len(pt) > 20 and sum(v[0] == "timer" for v, _t in rows) > len(pt)


def _build_routed(P, processing_time=True):
    e = env(P)
    _routed(P, e, records(10), processing_time).collect()
    return e


def test_keyed_reduce_like_jax():
    def build(P, e):
        return (stream(P, e, records(500)).key_by(lambda r: r[0])
                .reduce(lambda a, b: (a[0], a[1] + b[1], a[2] + b[2], max(a[3], b[3])))
                .collect())

    jax_rows, port_rows = twin(build)
    assert repr(port_rows) == repr(jax_rows) and len(port_rows) == 500


@pytest.mark.parametrize("kind", ["KeyedProcessRunner", "KeyedReduceRunner"])
def test_stateful_runners_restore_across_the_packages(kind):
    recs = records(400, seed=9)

    def make(P, e):
        if kind == "KeyedReduceRunner":
            stream(P, e, recs).key_by(lambda r: r[0]).reduce(
                lambda a, b: (a[0], a[1], a[2] + b[2], b[3])).collect()
        else:
            _routed(P, e, recs).collect()

    events = batches(recs, size=40)
    tags = ("low", "buy") if kind == "KeyedProcessRunner" else ()
    out = restored_across(make, events, len(events) // 2, kind, tags,
                          jax_restore=(register_restored_states
                                       if kind == "KeyedProcessRunner" else None))
    assert_restores_like_jax(out, min_rows=100)


def test_a_restored_process_function_reads_its_state():
    """The JAX backend restores a state declared at first use without its
    descriptor, and the next access raises KeyError (ROADMAP.md Queue C);
    the port's registers it there, with its entries."""
    recs = records(100)
    events = batches(recs, size=20)
    for P in PKGS:
        first = RunnerProbe(P, _build_routed(P), "KeyedProcessRunner").feed(events[:4])
        second = RunnerProbe(P, _build_routed(P), "KeyedProcessRunner")
        second.runner.restore(first.runner.snapshot())
        if P.port:
            second.feed(events[4:])
            key = recs[0][0]
            second.runner.state.set_current_key(key)
            assert second.runner.state.get("n") == sum(r[0] == key for r in recs)
        else:
            with pytest.raises(KeyError):
                second.feed(events[4:])


def _gated_source(P, recs, at):
    """A generator source of `recs` that blocks before record `at` until
    released: (source, reached, go)."""
    reached, go = threading.Event(), threading.Event()

    def gen(idx):
        if idx[0] >= at and not reached.is_set():
            reached.set()
            go.wait(60)
        vals = np.empty(len(idx), dtype=object)
        vals[:] = [recs[i] for i in idx]
        return P.src.Batch(vals, np.asarray([recs[i][3] for i in idx], dtype=np.int64))

    return P.src.DataGeneratorSource(gen, len(recs)), reached, go


QUERIED = {
    "reduce": lambda P, s: s.key_by(lambda r: r[0]).reduce(
        lambda a, b: (a[0], a[1], a[2] + b[2], b[3]), name="q"),
    "oracle_window": lambda P, s: s.key_by(lambda r: r[0]).window(
        P.asg.SlidingEventTimeWindows.of(4000, 1000)).reduce(
        lambda a, b: (a[0], 0, a[2] + b[2], b[3]), name="q"),
    "per_batch_window": lambda P, s: s.key_by(lambda r: r[0]).window(
        P.asg.TumblingEventTimeWindows.of(2000)).allowed_lateness(500).aggregate(
        "sum", lambda r: r[2], name="q"),
}


@pytest.mark.parametrize("shape", sorted(QUERIED))
def test_query_state_of_a_running_job_like_jax(shape):
    recs = records(400, keys=6)
    out = []
    for P in PKGS:
        e = env(P, **{"execution.step.batch-size": 32})
        src, reached, go = _gated_source(P, recs, 256)
        s = e.from_source(src, P.wm.for_bounded_out_of_orderness(300))
        QUERIED[shape](P, s).collect()
        client = e.execute_async(f"query-{shape}")
        try:
            assert reached.wait(60)
            uid = next(r.uid for r in client._runtime.runners if type(r).__name__ in (
                "KeyedReduceRunner", "WindowStepRunner"))
            views = [client.query_state(uid, k) for k in range(6)]
        finally:
            go.set()
        client.wait(60)
        out.append(repr(views))
    assert out[0] == out[1] and ("states" in out[1] or "slices" in out[1] or "value" in out[1])


class _ThresholdCoordinator:
    """JAX test_operator_coordinator_event_bus's coordinator, on package P's
    OperatorCoordinator."""

    @staticmethod
    def make(P):
        class ThresholdCoordinator(P.coord.OperatorCoordinator):
            def __init__(self):
                self.seen = 0

            def start(self, context):
                self.ctx = context

            def handle_event(self, event):
                self.seen += event
                if self.seen >= 10:
                    self.ctx.send_to_operator(("raise_threshold", 100))

            def checkpoint(self):
                return {"seen": self.seen}

            def restore(self, snap):
                self.seen = snap["seen"]

        class Gated:
            def __init__(self):
                self.threshold = 0

            def create_coordinator(self):
                return ThresholdCoordinator()

            def handle_coordinator_event(self, event):
                kind, value = event
                if kind == "raise_threshold":
                    self.threshold = value

            def process_element(self, v, ctx):
                self.coordinator_gateway.send_event(1)
                return [v] if v >= self.threshold else []

        return Gated()


def _gated_job(P):
    e = env(P, **{"execution.step.batch-size": 5})
    sink = e.from_collection(list(range(30))).key_by(lambda v: v % 2).process(
        _ThresholdCoordinator.make(P)).collect()
    extra = ("cpu",) if P.port else ()
    return P.ex.JobRuntime(P.tr.plan(e._sinks), e.config, *extra), sink


def test_operator_coordinator_event_bus_like_jax():
    out = []
    for P in PKGS:
        rt, sink = _gated_job(P)
        assert len(rt.coordinators) == 1
        rt.run()
        out.append((sink.results, rt.capture()["coordinators"]))
    assert out[0] == out[1]
    assert out[1][0] == list(range(9)) and list(out[1][1].values()) == [{"seen": 30}]


def test_coordinator_state_restores_across_the_packages():
    for src in PKGS:
        rt, _sink = _gated_job(src)
        rt.run()
        snap = rt.capture()
        for dst in PKGS:
            rt2, _sink2 = _gated_job(dst)
            rt2.restore(snap)
            (coord,) = rt2.coordinators.values()
            assert coord.seen == 30


def _counting(P):
    class Counter(P.coord.OperatorCoordinator):
        def __init__(self):
            self.seen = 0

        def start(self, context):
            self.ctx = context

        def handle_event(self, event):
            self.seen += 1
            self.ctx.send_to_operator(self.seen)

        def checkpoint(self):
            return {"seen": self.seen}

        def restore(self, snap):
            self.seen = snap["seen"]

    class Stamped:
        last = None

        def create_coordinator(self):
            return Counter()

        def handle_coordinator_event(self, event):
            self.last = event

        def process_element(self, v, ctx):
            self.coordinator_gateway.send_event(v[0])
            return [(v[0], v[3], self.last)]

    return Stamped()


def test_a_failed_job_restores_its_coordinator_like_jax(monkeypatch, tmp_path):
    """A checkpoint every step (CheckpointCoordinator.due held true in both
    packages) and one host failure in the source at 60% of the records:
    one restart, the uninterrupted run's rows, and the coordinator's count
    restored with the checkpoint (not recounted over the replay)."""
    from flink_tpu.checkpoint.coordinator import CheckpointCoordinator as JaxCoordinator
    from flink_tpu_torch.checkpoint.coordinator import CheckpointCoordinator

    monkeypatch.setattr(JaxCoordinator, "due", lambda self: True)
    monkeypatch.setattr(CheckpointCoordinator, "due", lambda self: True)
    recs = records(400)
    out = {}
    for P in PKGS:
        for fail in (False, True):
            failed = []

            def gen(idx, failed=failed, fail=fail, P=P):
                if fail and not failed and idx[0] >= 240:
                    failed.append(True)
                    raise RuntimeError("injected host failure in the source")
                vals = np.empty(len(idx), dtype=object)
                vals[:] = [recs[i] for i in idx]
                return P.src.Batch(vals, np.asarray([recs[i][3] for i in idx], dtype=np.int64))

            e = env(P, **{"execution.step.batch-size": 40,
                          "execution.checkpointing.interval": 1,
                          "execution.checkpointing.dir": str(tmp_path / f"{P.port}{fail}"),
                          "restart-strategy.type": "fixed-delay",
                          "restart-strategy.initial-backoff": 1})
            fn = _counting(P)
            sink = (e.from_source(P.src.DataGeneratorSource(gen, len(recs)),
                                  P.wm.for_bounded_out_of_orderness(300))
                    .key_by(lambda r: r[0]).process(fn).collect())
            client = e.execute_async(f"coordinated-{fail}")
            client.wait(60)
            out[(P.port, fail)] = (client.status().value, client.num_restarts,
                                   repr(sink.results), fn._operator_coordinator.seen)
    for port in (False, True):
        ok, failed = out[(port, False)], out[(port, True)]
        assert ok[:2] == ("FINISHED", 0) and failed[:2] == ("FINISHED", 1)
        assert failed[2] == ok[2] and failed[3] == ok[3] == len(recs)
    assert out[(True, True)] == out[(False, True)]


def test_api_v2_jobs_like_jax():
    def build(P, e):
        class Purchases(P.v2.OneInputStreamProcessFunction):
            def process_record(self, record, output, ctx):
                if record[1] == 2:
                    output.collect((ctx.key, 3 * record[2], ctx.timestamp))

        v2 = P.v2.ExecutionEnvironment(e)
        s = P.v2.NonKeyedPartitionStream(stream(P, e, records(300)))
        doubled = s.process(lambda r: [r, r] if r[2] > 7 else [r])
        build.v2 = v2
        return doubled.key_by(lambda r: r[0]).process(Purchases()).collect_to_list()

    jax_rows, port_rows = twin(build)
    assert repr(port_rows) == repr(jax_rows) and len(port_rows) > 50


def test_api_v2_environment_runs_on_the_given_device():
    v2 = PORT.v2.ExecutionEnvironment.get_instance(device="cpu")
    sink = v2.from_collection([1, 2, 3]).process(lambda x: [x * 2]).collect_to_list()
    v2.execute()
    assert sink.results == [2, 4, 6]
    jv2 = JAX.v2.ExecutionEnvironment.get_instance()
    jsink = jv2.from_collection([1, 2, 3]).process(lambda x: [x * 2]).collect_to_list()
    jv2.execute()
    assert jsink.results == sink.results
