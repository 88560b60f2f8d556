"""The port's per-record oracle window operator held against the JAX
package's.

`flink_tpu_torch/runtime/oracle_window_operator.py` and what it imports
(`state/heap.py`, `runtime/timers.py`, `core/keygroups.py`, the evictors and
triggers) are copies of the JAX package's modules. Every case of
`tests/test_oracle_window_operator.py` runs here on both operators at once
(`Twin`), with the same records, watermarks and processing times; each
drain must be equal by `repr`, in emission order (the order comes from
timer order and key-group order). Further cases: merging sessions with a
count trigger (the trigger-state merge), processing-time windows and
sessions, evictors, snapshots restored across the packages in both
directions, a randomized stream over several assigners and aggregates,
the key-group hash, and the continuous and delta triggers, which the JAX
package does not have: the port's trigger object runs on both operators
(the JAX operator's context gives it what it calls), and a case pins
ContinuousEventTimeTrigger to the fires Flink's class makes.

Tolerance: exact.
"""

import types

import numpy as np
import pytest

from flink_tpu.api import functions as jfn
from flink_tpu.api.windowing import assigners as jasg
from flink_tpu.api.windowing import evictors as jev
from flink_tpu.api.windowing import triggers as jtrg
from flink_tpu.core import keygroups as jkg
from flink_tpu.core.time import TimeWindow as JaxTimeWindow
from flink_tpu.ops import aggregators as jagg
from flink_tpu.runtime import oracle_window_operator as jor
from flink_tpu.state.heap import value_state as jax_value_state
from flink_tpu_torch.api import functions as tfn
from flink_tpu_torch.api.windowing import assigners as tasg
from flink_tpu_torch.api.windowing import evictors as tev
from flink_tpu_torch.api.windowing import triggers as ttrg
from flink_tpu_torch.core import keygroups as tkg
from flink_tpu_torch.core.time import TimeWindow
from flink_tpu_torch.ops import aggregators as tagg
from flink_tpu_torch.runtime import oracle_window_operator as tor
from jax_native_twins import jax_native_library  # noqa: E402,F401

JAX = types.SimpleNamespace(fn=jfn, asg=jasg, ev=jev, trg=jtrg, agg=jagg, op=jor)
PORT = types.SimpleNamespace(fn=tfn, asg=tasg, ev=tev, trg=ttrg, agg=tagg, op=tor)


def _agg(P, agg):
    return P.agg.BUILTINS[agg]().python_equivalent() if isinstance(agg, str) else agg


class Twin:
    """One operator per package, built by make(P), fed the same inputs."""

    def __init__(self, make):
        self.ops = [make(JAX), make(PORT)]

    def elements(self, *records):
        for (key, value), ts in records:
            for op in self.ops:
                op.process_record(key, value, ts)
        return self

    def watermark(self, wm):
        for op in self.ops:
            op.process_watermark(wm)
        return self

    def processing_time(self, t):
        for op in self.ops:
            op.advance_processing_time(t)
        return self

    def output(self):
        a, b = (op.drain_output() for op in self.ops)
        assert repr(b) == repr(a)
        return b

    def results(self):
        return [(k, r) for k, _w, r, _t in self.output()]

    def side(self, tag):
        a, b = (list(op.side_output.get(tag, [])) for op in self.ops)
        assert repr(b) == repr(a)
        return b


def twin(assigner, agg="sum", **kw):
    """assigner, trigger, evictor and window_function are callables of the
    package namespace P."""
    def make(P):
        extra = {k: (v(P) if callable(v) and k in ("trigger", "evictor", "window_function")
                     else v) for k, v in kw.items()}
        return P.op.OracleWindowOperator(assigner(P), _agg(P, agg if not callable(agg)
                                                           else agg(P)), **extra)
    return Twin(make)


TUMBLING = lambda P: P.asg.TumblingEventTimeWindows.of(1000)  # noqa: E731


def test_tumbling_sum_basic():
    t = twin(TUMBLING).elements((("a", 1.0), 100), (("a", 2.0), 900), (("b", 5.0), 500))
    assert t.output() == []
    out = t.watermark(999).output()
    assert sorted((k, (w.start, w.end), r, ts) for k, w, r, ts in out) == [
        ("a", (0, 1000), 3.0, 999), ("b", (0, 1000), 5.0, 999)]


def test_tumbling_multiple_windows_fire_in_order():
    t = twin(TUMBLING).elements((("a", 1.0), 100), (("a", 2.0), 1100), (("a", 4.0), 2100))
    out = t.watermark(5000).output()
    assert [r for (_, _, r, _) in out] == [1.0, 2.0, 4.0]
    assert [ts for (_, _, _, ts) in out] == [999, 1999, 2999]


def test_sliding_count_overlap():
    t = twin(lambda P: P.asg.SlidingEventTimeWindows.of(10_000, 2_000), agg="count")
    out = t.elements((("k", 1.0), 10_500)).watermark(30_000).output()
    assert len(out) == 5 and all(r == 1 for (_, _, r, _) in out)
    assert sorted(w.end for (_, w, _, _) in out) == [12_000, 14_000, 16_000, 18_000, 20_000]


def test_late_element_within_allowed_lateness_refires():
    t = twin(TUMBLING, allowed_lateness=500)
    assert t.elements((("a", 1.0), 100)).watermark(999).results() == [("a", 1.0)]
    assert t.elements((("a", 2.0), 200)).results() == [("a", 3.0)]
    assert t.watermark(1499).elements((("a", 7.0), 300)).results() == []
    assert [op.num_late_records_dropped for op in t.ops] == [1, 1]


def test_late_element_side_output():
    t = twin(TUMBLING, emit_late_to_side_output=True)
    t.elements((("a", 1.0), 100)).watermark(999).elements((("a", 2.0), 150))
    assert t.side("late-data") == [("a", 2.0, 150)]


def test_cleanup_frees_state():
    t = twin(TUMBLING).elements((("a", 1.0), 100)).watermark(999)
    assert [op.state.is_empty() for op in t.ops] == [True, True]


def test_count_trigger_on_global_window():
    t = twin(lambda P: P.asg.GlobalWindows.create(),
             trigger=lambda P: P.trg.PurgingTrigger.of(P.trg.CountTrigger.of(3)))
    t.elements(*[(("k", 1.0), i) for i in range(7)])
    assert t.results() == [("k", 3.0), ("k", 3.0)]


def test_global_window_never_fires_by_default():
    t = twin(lambda P: P.asg.GlobalWindows.create())
    t.elements(*[(("k", 1.0), i) for i in range(100)])
    assert t.watermark(10**9).output() == []


SESSIONS = lambda gap: (lambda P: P.asg.EventTimeSessionWindows.with_gap(gap))  # noqa: E731


def test_session_merge_basic():
    t = twin(SESSIONS(1000)).elements((("u", 1.0), 0), (("u", 2.0), 500), (("u", 4.0), 900))
    (out,) = t.watermark(10_000).output()
    assert (out[0], out[2], (out[1].start, out[1].end), out[3]) == ("u", 7.0, (0, 1900), 1899)


def test_session_two_sessions_per_key():
    t = twin(SESSIONS(100)).elements((("u", 1.0), 0), (("u", 2.0), 50), (("u", 10.0), 500))
    out = t.watermark(10_000).output()
    assert [(o[0], o[2], o[1].start, o[1].end) for o in out] == [
        ("u", 3.0, 0, 150), ("u", 10.0, 500, 600)]


def test_session_bridging_element_merges_sessions():
    t = twin(SESSIONS(100)).elements((("u", 1.0), 0), (("u", 2.0), 300), (("u", 4.0), 90),
                                     (("u", 8.0), 180), (("u", 16.0), 250))
    (out,) = t.watermark(10_000).output()
    assert out[2] == 31.0 and (out[1].start, out[1].end) == (0, 400)


def test_session_out_of_order_no_double_fire():
    t = twin(SESSIONS(100)).elements((("u", 1.0), 200), (("u", 2.0), 100))
    assert t.watermark(298).output() == []
    (out,) = t.watermark(299).output()
    assert (out[1].start, out[1].end, out[2]) == (100, 300, 3.0)


def test_merging_sessions_merge_the_count_trigger_state():
    # the trigger-state merge: counts of merged sessions add up, so the
    # bridging record makes the merged session's count reach 4
    t = twin(SESSIONS(100), agg="count", trigger=lambda P: P.trg.CountTrigger.of(4))
    t.elements((("u", 1.0), 0), (("u", 1.0), 10), (("u", 1.0), 150))
    assert t.output() == []
    out = t.elements((("u", 1.0), 90)).output()
    assert [(k, r, w.start, w.end) for k, w, r, _ in out] == [("u", 4, 0, 250)]


def test_reduce_function_path():
    t = twin(TUMBLING, agg=lambda P: P.fn.ReduceAggregate(lambda a, b: max(a, b)))
    t.elements((("a", 3.0), 0), (("a", 9.0), 10), (("a", 5.0), 20))
    assert t.watermark(999).results() == [("a", 9.0)]


@pytest.mark.parametrize("name,expected", [("sum", 6.0), ("count", 3), ("max", 3.0),
                                           ("min", 1.0), ("mean", 2.0)])
def test_builtin_aggregator_python_equivalents(name, expected):
    t = twin(TUMBLING, agg=name).elements((("a", 1.0), 0), (("a", 2.0), 1), (("a", 3.0), 2))
    assert t.watermark(999).results() == [("a", expected)]


def _counting_pwf(P):
    class CountingPWF(P.fn.ProcessWindowFunction):
        def process(self, key, context, elements):
            for e in elements:
                yield (key, context.window.start, e)
    return CountingPWF()


def test_process_window_function():
    t = twin(TUMBLING, window_function=_counting_pwf).elements((("a", 5.0), 100))
    (out,) = t.watermark(1000).output()
    assert out[2] == ("a", 0, 5.0)


@pytest.mark.parametrize("evictor,expected", [
    (lambda P: P.ev.CountEvictor.of(2), [2.0, 3.0]),
    (lambda P: P.ev.TimeEvictor.of(1), [2.0, 3.0]),
])
def test_evictor_buffered_path(evictor, expected):
    t = twin(TUMBLING, agg=None, evictor=evictor)
    t.elements((("a", 1.0), 0), (("a", 2.0), 1), (("a", 3.0), 2))
    assert [r for (_, _, r, _) in t.watermark(999).output()] == expected


def test_watermark_does_not_regress_fire():
    t = twin(TUMBLING).elements((("a", 1.0), 100)).watermark(999).watermark(500)
    assert len(t.output()) == 1


# ---------------------------------------------------------------------------
# processing time
# ---------------------------------------------------------------------------

def test_processing_time_tumbling_windows_fire_on_processing_time():
    t = twin(lambda P: P.asg.TumblingProcessingTimeWindows(1000))
    t.elements((("a", 1.0), 100), (("b", 2.0), 400), (("a", 4.0), 1200))
    assert t.watermark(10**6).output() == []        # event time never fires them
    assert t.processing_time(999).results() == [("a", 1.0), ("b", 2.0)]
    assert t.processing_time(5000).results() == [("a", 4.0)]
    assert [op.state.is_empty() for op in t.ops] == [True, True]


def test_processing_time_sessions_merge_and_fire():
    t = twin(lambda P: P.asg.ProcessingTimeSessionWindows(100))
    t.elements((("u", 1.0), 0), (("u", 2.0), 50), (("v", 5.0), 60), (("u", 4.0), 400))
    out = t.processing_time(10_000).output()
    assert [(k, r, w.start, w.end) for k, w, r, _ in out] == [
        ("u", 3.0, 0, 150), ("v", 5.0, 60, 160), ("u", 4.0, 400, 500)]


# ---------------------------------------------------------------------------
# snapshots across the packages
# ---------------------------------------------------------------------------

def _jax_windows(obj):
    """The JAX package's restore takes its own windows: map the port's."""
    if type(obj) is TimeWindow:
        return JaxTimeWindow(obj.start, obj.end)
    if type(obj) is tasg.GlobalWindow:
        return jasg.GlobalWindows._WINDOW
    if type(obj) is dict:
        return {_jax_windows(k): _jax_windows(v) for k, v in obj.items()}
    if type(obj) in (tuple, list):
        return type(obj)(_jax_windows(x) for x in obj)
    return obj


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("shape", ["tumbling", "sessions", "global_count"])
def test_snapshot_restores_across_the_packages(direction, shape):
    """A snapshot of one package restored into the other gives the rows a
    restore into the same package gives, in the same order (a restore
    re-queues the timers in the snapshot's order, so equal-time fires may
    come in another order than in an uninterrupted run: in both packages),
    and the uninterrupted run's rows."""
    assigner, kw = {
        "tumbling": (TUMBLING, {}),
        "sessions": (SESSIONS(100), {"trigger": lambda P: P.trg.CountTrigger.of(3)}),
        "global_count": (lambda P: P.asg.GlobalWindows.create(),
                         {"trigger": lambda P: P.trg.CountTrigger.of(3)}),
    }[shape]
    first = [(("a", 1.0), 100), (("b", 2.0), 200), (("a", 4.0), 120)]
    second = [(("a", 10.0), 130), (("b", 3.0), 230), (("a", 1.0), 900)]
    whole = twin(assigner, **kw).elements(*first, *second).watermark(5000).output()
    src, dst = (0, 1) if direction == "jax_to_port" else (1, 0)
    runs = []
    for from_ in (src, dst):
        a, b = twin(assigner, **kw), twin(assigner, **kw)
        a.elements(*first)
        head = a.ops[from_].drain_output()
        snap = a.ops[from_].snapshot()
        if from_ == 1 and dst == 0:
            snap = _jax_windows(snap)
        op = b.ops[dst]
        op.restore(snap)
        for (key, value), ts in second:
            op.process_record(key, value, ts)
        op.process_watermark(5000)
        runs.append(head + op.drain_output())
    assert repr(runs[0]) == repr(runs[1])
    assert sorted(map(repr, runs[0])) == sorted(map(repr, whole)) and whole


# ---------------------------------------------------------------------------
# a randomized stream
# ---------------------------------------------------------------------------

ASSIGNERS = {
    "tumbling": TUMBLING,
    "sliding": lambda P: P.asg.SlidingEventTimeWindows.of(2000, 500),
    "sessions": SESSIONS(300),
}


@pytest.mark.parametrize("agg", ["sum", "count", "max", "mean"])
@pytest.mark.parametrize("assigner", sorted(ASSIGNERS))
def test_random_stream_matches_jax(assigner, agg):
    rng = np.random.default_rng(len(assigner) * 7 + len(agg))
    t = twin(ASSIGNERS[assigner], agg=agg, allowed_lateness=300,
             emit_late_to_side_output=True)
    wm, ts = 0, 0
    for step in range(40):
        recs = []
        for _ in range(25):
            key = int(rng.integers(0, 9))
            recs.append(((key if step % 3 else f"k{key}", float(rng.integers(-5, 9))),
                         int(ts + rng.integers(-900, 200))))
        t.elements(*recs)
        ts += 150
        wm = max(wm, ts - 400)
        t.watermark(wm)
        t.output()
    t.side("late-data")
    t.watermark(10**9)
    assert t.output() is not None


# ---------------------------------------------------------------------------
# the key-group hash
# ---------------------------------------------------------------------------

KEYS = [0, 1, -1, 7, 2**31 - 1, -2**31, 2**40 + 3, -(2**40), "", "a", "campaign-42", "ünï",
        b"bytes", 3.5, -0.0, True, ("a", 1), (1, 2, 3), np.int32(-5), np.int64(2**33)]


@pytest.mark.parametrize("max_par", [1, 2, 128, 4096, 32768])
def test_key_group_hash_is_bit_equal_to_jax(max_par):
    for key in KEYS:
        assert tkg.key_hash(key) == jkg.key_hash(key), key
        assert tkg.assign_to_key_group(key, max_par) == jkg.assign_to_key_group(key, max_par)
    hashes = np.random.default_rng(max_par).integers(-2**31, 2**31, 4096).astype(np.int32)
    assert np.array_equal(tkg.key_groups_for_hashes(hashes, max_par),
                          jkg.key_groups_for_hashes(hashes, max_par))
    for p in sorted({1, min(3, max_par), min(max_par, 8)}):
        for i in range(p):
            r, jr = (m.key_group_range_for_operator(max_par, p, i) for m in (tkg, jkg))
            assert (r.start, r.end) == (jr.start, jr.end)


# ---------------------------------------------------------------------------
# the triggers the JAX package does not have: the port's trigger object on
# both operators
# ---------------------------------------------------------------------------

def _shared_trigger(trigger):
    """Twin construction with one port trigger object on both operators;
    the JAX operator registers the trigger's state as the port's does."""
    def register(t):
        t.ops[0].state.register(jax_value_state(jor.TRIGGER_STATE_PREFIX + trigger.STATE))
        return t
    return register


@pytest.mark.parametrize("assigner", ["tumbling", "sliding"])
def test_continuous_event_time_trigger_matches_jax(assigner):
    trigger = ttrg.ContinuousEventTimeTrigger.of(500)
    t = _shared_trigger(trigger)(twin(ASSIGNERS[assigner], trigger=lambda P: trigger))
    rng = np.random.default_rng(5)
    ts = 0
    fired = 0
    for _ in range(30):
        t.elements(*[((int(rng.integers(0, 4)), 1.0), ts + int(rng.integers(0, 150)))
                     for _ in range(10)])
        ts += 150
        t.watermark(ts - 100)
        fired += len(t.output())
    t.watermark(10**9)
    fired += len(t.output())
    assert fired > 30


def test_continuous_event_time_trigger_fires_as_flinks_class():
    # one 10 s window, interval 2 s: fires at 2000, 4000, 6000, 8000 and at
    # the window's end, each with the window's contents so far
    trigger = ttrg.ContinuousEventTimeTrigger.of(2000)
    op = tor.OracleWindowOperator(tasg.TumblingEventTimeWindows.of(10_000),
                                  tagg.sum_agg().python_equivalent(), trigger=trigger)
    for v, ts in ((1.0, 500), (2.0, 2500)):
        op.process_record("k", v, ts)
    op.process_watermark(3000)
    assert [r for _k, _w, r, _t in op.drain_output()] == [3.0]        # the 2000 timer
    op.process_record("k", 4.0, 4500)
    for wm in (5000, 7000, 9000, 20_000):
        op.process_watermark(wm)
    assert [r for _k, _w, r, _t in op.drain_output()] == [7.0] * 4    # 4000 ... 9999
    assert op.state.is_empty()
    # one advance past several fire times: the timer service (the JAX
    # package's) fires the timers due at the advance as one batch, so the
    # 6000 timer the 4000 fire registers comes after the window's end and
    # is cleared with it (Flink re-peeks its queue and fires 4000, 6000,
    # 8000, 9999: a reference fault, ROADMAP Queue C)
    op2 = tor.OracleWindowOperator(tasg.TumblingEventTimeWindows.of(10_000),
                                   tagg.sum_agg().python_equivalent(), trigger=trigger)
    op2.process_record("k", 1.0, 500)
    op2.process_watermark(20_000)
    assert [r for _k, _w, r, _t in op2.drain_output()] == [1.0, 1.0]


def test_continuous_trigger_merges_its_fire_time_on_sessions():
    # two sessions merge: the merged session keeps the earlier fire time
    op = tor.OracleWindowOperator(tasg.EventTimeSessionWindows.with_gap(1000),
                                  tagg.count_agg().python_equivalent(),
                                  trigger=ttrg.ContinuousEventTimeTrigger.of(400))
    op.process_record("u", 1.0, 100)        # fire time 400
    op.process_record("u", 1.0, 1900)       # its own session: fire time 2000
    op.process_record("u", 1.0, 1000)       # bridges both: [100, 2900)
    op.process_watermark(500)
    assert [(r, w.start, w.end) for _k, w, r, _t in op.drain_output()] == [(3, 100, 2900)]


def test_continuous_processing_time_trigger_matches_jax():
    trigger = ttrg.ContinuousProcessingTimeTrigger.of(300)
    t = _shared_trigger(trigger)(twin(lambda P: P.asg.TumblingProcessingTimeWindows(1000),
                                      trigger=lambda P: trigger))
    # the JAX context has no processing-time clock: the port's trigger
    # reads it through this method, given the records' processing time
    # (the port's operator reads it from them)
    clock = [0]
    t.ops[0]._trigger_ctx.get_current_processing_time = lambda: clock[0]
    for step in range(12):
        now = clock[0] = 5 + step * 170
        t.elements(*[((k, 1.0), now) for k in range(3)])
        t.processing_time(now + 10)
        t.output()
    assert len(t.processing_time(10_000).output()) > 0


def test_delta_trigger_matches_jax():
    trigger = ttrg.DeltaTrigger.of(4.0, lambda a, b: abs(b - a))
    t = _shared_trigger(trigger)(twin(lambda P: P.asg.GlobalWindows.create(), agg="sum",
                                      trigger=lambda P: trigger))
    values = [1.0, 2.0, 6.0, 6.5, 11.0, 3.0, 3.5, 9.0]
    out = []
    for i, v in enumerate(values):
        t.elements((("k", v), i))
        out += t.results()
    # fires when |v - last fired| > 4: at 6.0 (vs 1.0), 11.0 (vs 6.0),
    # 3.0 (vs 11.0) and 9.0 (vs 3.0), each with the sum so far
    assert out == [("k", 9.0), ("k", 26.5), ("k", 29.5), ("k", 42.0)]
