"""Multi-input topologies on the port held against the JAX package: union,
connect (co-map, co-flat-map, the keyed co-process, the broadcast state
pattern), the partitioner hints and slot-sharing groups, and SQL UNION
ALL. Modelled on tests/test_multi_input.py.

Each job runs through both packages' `env.execute()` on the same records
(made with numpy from a seed) and the rows are compared exactly, by
`repr`, in emission order. The runners each package selects are compared
for the smoke's union graph (a traceable chain fused onto the device
after a UnionRunner) and its UNION ALL statement; the stateful two-input
runners' snapshots are restored across the packages.

Tolerance: exact.
"""

import pytest

from api_twins import (
    PKGS,
    assert_restores_like_jax,
    PORT,
    batches,
    columns,
    env,
    records,
    register_restored_states,
    restored_across,
    runner_kinds,
    stream,
    twin,
)
from jax_native_twins import jax_native_library  # noqa: F401


def _feeds(P, e, recs, n=3, bound=300):
    """`recs` dealt round-robin over n sources."""
    return [stream(P, e, recs[i::n], bound=bound, name=f"feed{i}") for i in range(n)]


@pytest.mark.parametrize("bound", [0, 300])
def test_union_min_combines_watermarks_like_jax(bound):
    def build(P, e):
        a, b, c = _feeds(P, e, records(900, seed=bound), bound=bound)
        return (a.union(b, c).key_by(lambda r: r[0])
                .window(P.asg.TumblingEventTimeWindows.of(1000)).count().collect())

    jax_rows, port_rows = twin(build)
    assert repr(port_rows) == repr(jax_rows) and len(port_rows) > 50


def test_union_with_an_empty_source_does_not_stall_like_jax():
    def build(P, e):
        a = stream(P, e, records(300))
        empty = stream(P, e, [], name="empty")
        return (a.union(empty).key_by(lambda r: r[0])
                .window(P.asg.TumblingEventTimeWindows.of(2000)).sum(lambda r: r[2]).collect())

    jax_rows, port_rows = twin(build)
    assert repr(port_rows) == repr(jax_rows) and port_rows


@pytest.mark.parametrize("kind", ["map", "flat_map"])
def test_co_map_and_co_flat_map_like_jax(kind):
    def build(P, e):
        a, b = _feeds(P, e, records(400), n=2)
        cs = a.connect(b)
        if kind == "map":
            return cs.map(lambda r: ("a", r[0], r[2]), lambda r: ("b", r[0] * 10)).collect()
        return cs.flat_map(lambda r: [("a", r[0])] * (r[2] % 3),
                           lambda r: [("b", r[2])] * (r[1] + 1)).collect()

    jax_rows, port_rows = twin(build)
    assert repr(port_rows) == repr(jax_rows) and len(port_rows) > 100


def _threshold(P):
    """Input 1 stores a per-key threshold, input 2 emits readings above it
    (state shared across the inputs) and each reading registers an
    event-time timer that reports the key's reading count."""
    class Threshold(P.fn.ProcessFunction):
        def process_element1(self, v, ctx):
            ctx.timer_service.state().put("threshold", v[2])
            return []

        def process_element2(self, v, ctx):
            st = ctx.timer_service.state()
            st.put("n", (st.get("n") or 0) + 1)
            ctx.timer_service.register_event_time_timer(v[3] - v[3] % 1000 + 999)
            thr = st.get("threshold")
            return [(v[0], v[2], thr)] if thr is not None and v[2] > thr else []

        def on_timer(self, t, ctx):
            return [("timer", t, ctx.timer_service.state().get("n"))]

    return Threshold()


def _co_process(P, e):
    thresholds, readings = _feeds(P, e, records(600, seed=3), n=2)
    return (thresholds.connect(readings).key_by(lambda r: r[0], lambda r: r[0])
            .process(_threshold(P)))


def test_keyed_co_process_shares_state_and_fires_timers_like_jax():
    jax_rows, port_rows = twin(lambda P, e: _co_process(P, e).collect())
    assert repr(port_rows) == repr(jax_rows)
    assert sum(r[0] == "timer" for r in port_rows) > 20 and len(port_rows) > 100


class _Rules:
    """Broadcast side: rules (id, modulus, least value); event side: the
    rules an event meets, read through the read-only view."""

    def process_element(self, v, state):
        hit = [rid for rid, (m, lo) in sorted(state.items()) if v[0] % m == 0 and v[2] >= lo]
        return [(v[0], v[3], tuple(hit))] if hit else []

    def process_broadcast_element(self, rule, state):
        state[rule[0]] = (rule[1], rule[2])


def _broadcast(P, e, recs):
    rules = [(i, m, lo, 100 * i) for i, (m, lo) in enumerate([(2, 7), (3, 3), (1, 9), (5, 0)])]
    events = stream(P, e, recs)
    return events.connect(stream(P, e, rules, name="rules").broadcast()).process(_Rules())


def test_broadcast_state_pattern_like_jax():
    jax_rows, port_rows = twin(lambda P, e: _broadcast(P, e, records(500)).collect())
    assert repr(port_rows) == repr(jax_rows) and len(port_rows) > 50


def test_connect_without_keys_or_broadcast_is_refused_in_both():
    for P in PKGS:
        e = env(P)
        a, b = _feeds(P, e, records(10), n=2)
        with pytest.raises(ValueError, match="requires key_by"):
            a.connect(b).process(_Rules())


@pytest.mark.parametrize("hint", ["rebalance", "rescale", "shuffle", "broadcast", "forward",
                                  "global_"])
def test_partition_hints_pass_through_like_jax(hint):
    """A hint after a side output keeps the side channel, and forward keeps
    chaining; locally each is a pass-through view."""
    def build(P, e):
        win = (stream(P, e, records(400), bound=0).key_by(lambda r: r[0])
               .window(P.asg.TumblingEventTimeWindows.of(1000)).allowed_lateness(0)
               .side_output_late_data())
        agg = win.sum(lambda r: r[2])
        return getattr(agg.map(lambda r: (r[0], r[1] * 2)), hint)().map(
            lambda r: ("out", r)).collect()

    jax_rows, port_rows = twin(build)
    assert repr(port_rows) == repr(jax_rows) and port_rows
    kinds = []
    for P in PKGS:
        e = env(P)
        build(P, e)
        kinds.append(runner_kinds(P, e))
    assert kinds[0] == kinds[1]


class _Both:
    """Two sinks' rows as one result."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    @property
    def results(self):
        return (self.a.results, self.b.results)


def test_forward_does_not_fuse_across_a_fan_out_like_jax():
    """A map read twice, once through forward(): the planners cut the same
    chains, and the rows are the JAX package's."""
    def build(P, e):
        m = stream(P, e, records(200)).map(lambda r: (r[0], r[2]))
        return _Both(m.forward().map(lambda r: ("f", r)).collect(),
                     m.map(lambda r: ("direct", r)).collect())

    jax_rows, port_rows = twin(build)
    assert repr(port_rows) == repr(jax_rows) and port_rows[0] and port_rows[1]
    shapes = []
    for P in PKGS:
        e = env(P)
        build(P, e)
        graph = P.tr.plan(e._sinks)
        shapes.append([(len(s.chain), s.terminal.kind if s.terminal else None, s.slot_group)
                       for s in graph.steps])
    assert shapes[0] == shapes[1]


def test_slot_sharing_groups_break_chains_like_jax():
    def build(P, e):
        s = stream(P, e, records(200)).map(lambda r: (r[0], r[2] + 1)).slot_sharing_group("a")
        s = s.map(lambda r: (r[0], r[1] * 3)).slot_sharing_group("b").filter(lambda r: r[1] > 6)
        return s.collect()

    jax_rows, port_rows = twin(build)
    assert repr(port_rows) == repr(jax_rows) and port_rows
    shapes = []
    for P in PKGS:
        e = env(P)
        build(P, e)
        shapes.append([(len(s.chain), s.slot_group) for s in P.tr.plan(e._sinks).steps])
    assert shapes[0] == shapes[1] and len(shapes[1]) == 3


def _union_program(P, e):
    """The smoke's leg A at a small size: api_path_microbench's traceable
    filter and key over the union of the stream's even and odd records."""
    a = e.from_source(columns(P, parity=0), P.wm.for_bounded_out_of_orderness(0))
    b = e.from_source(columns(P, parity=1), P.wm.for_bounded_out_of_orderness(0))
    filt = (lambda col: col[:, 1] < 0.5)
    return (a.union(b).filter(filt, traceable=True).key_by(P.key, traceable=True)
            .window(P.asg.SlidingEventTimeWindows.of(10_000, 1_000)).aggregate("count"))


def test_the_union_program_fuses_after_the_union_runner_like_jax():
    conf = {"execution.step.batch-size": 256, "execution.state.key-capacity": 64}
    kinds = []
    for P in PKGS:
        e = env(P, **conf)
        _union_program(P, e).collect()
        kinds.append(runner_kinds(P, e))
    assert kinds[0] == kinds[1] == ["UnionRunner", "DeviceChainRunner", "SinkRunner"]
    jax_rows, port_rows = twin(lambda P, e: _union_program(P, e).collect(),
                               rows=lambda rs: sorted((int(k), int(v)) for k, v in rs), **conf)
    assert port_rows == jax_rows and len(port_rows) > 500
    # the single-source program over the same records gives the same rows
    single = env(PORT, **conf)
    sink = (single.from_source(columns(PORT, n=8192), PORT.wm.for_bounded_out_of_orderness(0))
            .filter(lambda col: col[:, 1] < 0.5, traceable=True).key_by(PORT.key, traceable=True)
            .window(PORT.asg.SlidingEventTimeWindows.of(10_000, 1_000)).aggregate("count")
            .collect())
    single.execute()
    assert sorted((int(k), int(v)) for k, v in sink.results) == port_rows


def test_stateful_two_input_runners_restore_across_the_packages():
    recs = records(400, seed=5)
    events = batches(recs, gates=(0, 1))
    assert_restores_like_jax(restored_across(
        lambda P, e: _co_process(P, e).collect(), events, len(events) // 2,
        "KeyedCoProcessRunner", jax_restore=register_restored_states), min_rows=50)
    rules = [(i, m, lo, 0) for i, (m, lo) in enumerate([(2, 7), (3, 3), (1, 9)])]
    events = [("batch", 1, rules, [0] * 3)] + batches(recs, gates=(0,))
    assert_restores_like_jax(restored_across(
        lambda P, e: _broadcast(P, e, recs).collect(), events, len(events) // 2,
        "BroadcastProcessRunner"), min_rows=50)


SQL_TABLE = ["user", "amount", "rowtime"]
UNION_ALL = ("SELECT user, COUNT(*) AS n, SUM(amount) AS s FROM pay "
             "GROUP BY user, TUMBLE(rowtime, INTERVAL '1' SECOND) "
             "UNION ALL SELECT user, COUNT(*) AS n, SUM(amount) AS s FROM pay "
             "WHERE amount > 4 GROUP BY user, HOP(rowtime, INTERVAL '1' SECOND, "
             "INTERVAL '3' SECOND)")


def _sql(P, e):
    tenv = P.tenv(e)
    rows = [{"user": f"u{r[0]}", "amount": r[2], "rowtime": r[3]} for r in records(500)]
    src = e.from_collection(rows, timestamp_fn=lambda r: r["rowtime"],
                            watermark_strategy=P.wm.for_bounded_out_of_orderness(300))
    tenv.register_table("pay", src, P.schema(SQL_TABLE, rowtime="rowtime"))
    return tenv


@pytest.mark.parametrize("fusion", [True, False])
def test_sql_union_all_like_jax(fusion):
    conf = {"table.device-fusion": fusion}
    reports, kinds, rows = [], [], []
    for P in PKGS:
        e = env(P, **conf)
        tenv = _sql(P, e)
        sink = tenv.sql_query(UNION_ALL).collect()
        rep = tenv.last_plan_report
        reports.append((rep.path, rep.reason, rep.detail))
        kinds.append(runner_kinds(P, e))
        e.execute()
        rows.append(repr(sink.results))
    assert reports[0] == reports[1] and kinds[0] == kinds[1] and "UnionRunner" in kinds[1]
    assert rows[0] == rows[1] and rows[1].count("{") > 20


def test_the_union_all_program_selects_the_jax_runners():
    """The smoke's leg D at a small size: SQL_YSB's HOP count and its
    purchases twin over sql_path_microbench's columnar table, joined by
    UNION ALL: each branch a host-keyed window runner, the rows and the
    plan report the JAX package's."""
    views = ("SELECT campaign, COUNT(*) AS views, WINDOW_END AS wend FROM ysb "
             "WHERE event_type < 0.5 GROUP BY campaign, "
             "HOP(rowtime, INTERVAL '1000' MILLISECOND, INTERVAL '10000' MILLISECOND)")
    sql = views + " UNION ALL " + views.replace("event_type < 0.5", "event_type > 1.5")
    reports, kinds, rows = [], [], []
    for P in PKGS:
        e = env(P, **{"execution.step.batch-size": 512, "execution.state.key-capacity": 64})
        tenv = P.tenv(e)
        src = e.from_source(columns(P, n=8192), P.wm.for_bounded_out_of_orderness(0))
        tenv.register_table("ysb", src, P.schema(["campaign", "event_type", "rowtime"],
                                                 rowtime="rowtime",
                                                 field_types=["int", "float", "int"]),
                            columnar=True)
        sink = tenv.sql_query(sql).collect()
        rep = tenv.last_plan_report
        reports.append((rep.path, rep.reason, rep.detail))
        kinds.append(runner_kinds(P, e))
        e.execute()
        rows.append(sorted(map(repr, sink.results)))
    assert reports[0] == reports[1] and reports[1][1] == "union"
    assert kinds[0] == kinds[1] and kinds[1].count("WindowStepRunner") == 2
    assert rows[0] == rows[1] and len(rows[1]) > 1000
