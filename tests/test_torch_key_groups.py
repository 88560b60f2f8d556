"""Parallelism and key groups on the port, held against the JAX package.

Twins of tests/test_state_key_groups.py (the key-group remap: ranges,
owners, merge, split and timer filters, over the same parameter sweeps),
of the watermark valve and idleness cases of tests/test_watermarks.py (on
an injected clock, never the wall clock), and jobs that set
`pipeline.parallelism` or a watermark strategy `with_idleness`: both run
on the port as on the JAX package, whose runtime reads neither, and give
the JAX package's rows.

Tolerance: exact.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from flink_tpu.core import watermarks as jwm
from flink_tpu.state import key_groups as jkg
from flink_tpu_torch.core import watermarks as twm
from flink_tpu_torch.core.keygroups import assign_to_key_group
from flink_tpu_torch.state import key_groups as tkg

MAXES = (1, 2, 3, 7, 16, 127, 128)


def _parallelisms(max_p):
    return sorted(p for p in ({1, 2, 3, max(max_p // 2, 1), max_p}
                              | set(range(1, min(max_p, 17) + 1))) if 1 <= p <= max_p)


def _ranges(rs):
    return [(r.start, r.end) for r in rs]


@pytest.mark.parametrize("max_p", MAXES)
def test_every_key_group_owned_by_exactly_one_subtask(max_p):
    for p in _parallelisms(max_p):
        tkg.verify_partition(max_p, p)
        assert _ranges(tkg.ranges_for_parallelism(max_p, p)) == \
            _ranges(jkg.ranges_for_parallelism(max_p, p))


@pytest.mark.parametrize("max_p", (7, 16, 128))
def test_owner_agrees_with_range_membership_and_jax(max_p):
    for p in _parallelisms(max_p):
        ranges = tkg.ranges_for_parallelism(max_p, p)
        for kg in range(max_p):
            idx = tkg.owner_of_key_group(max_p, p, kg)
            assert idx == jkg.owner_of_key_group(max_p, p, kg)
            assert ranges[idx].contains(kg) and sum(r.contains(kg) for r in ranges) == 1


def _shard_state(max_p, old_p, shard, n_keys=200):
    tables = {"window-contents": {}, "timers-aux": {}}
    rng = tkg.ranges_for_parallelism(max_p, old_p)[shard]
    for k in range(n_keys):
        kg = assign_to_key_group(k, max_p)
        if not rng.contains(kg):
            continue
        tables["window-contents"].setdefault(kg, {})[k] = k * 10
        if k % 3 == 0:
            tables["timers-aux"].setdefault(kg, {})[k] = -k
    return tables


@pytest.mark.parametrize("old_p,new_p", [(1, 2), (2, 1), (2, 3), (3, 2), (2, 4), (4, 2),
                                         (5, 7), (7, 5), (1, 16), (16, 1), (3, 16), (16, 3)])
def test_merge_then_split_match_jax(old_p, new_p):
    max_p = 16
    per_shard = [_shard_state(max_p, old_p, s) for s in range(old_p)]
    merged = tkg.merge_keyed_state(per_shard)
    assert merged == jkg.merge_keyed_state(per_shard)
    timers = [{"event": [(k * 7, k) for kg in t["window-contents"]
                         for k in t["window-contents"][kg]],
               "proc": [], "watermark": 500 + s} for s, t in enumerate(per_shard)]
    mt = tkg.merge_timers(timers + [None])
    assert mt == jkg.merge_timers(timers + [None]) and mt["watermark"] == 500
    snap = {"operator": {"state": merged, "timers": mt}, "results": [("a", 1)], "step": 9}
    got = tkg.split_merged_snapshot(snap, max_p, new_p)
    assert got == jkg.split_merged_snapshot(snap, max_p, new_p)
    assert set(got) == set(range(new_p))
    seen = set()
    for shard in got.values():
        for name, table in shard["operator"]["state"].items():
            for kg, entries in table.items():
                for k in entries:
                    assert (name, k) not in seen
                    seen.add((name, k))
    assert len(seen) == sum(len(e) for t in merged.values() for e in t.values())


@pytest.mark.parametrize("old_p,new_p", [(2, 3), (3, 1), (1, 4), (4, 4)])
def test_timer_filter_round_trip_matches_jax(old_p, new_p):
    max_p = 16
    rng = np.random.default_rng(7)
    timers = {"event": [(int(k) * 7, int(k)) for k in sorted(set(rng.integers(0, 500, 60)))],
              "proc": [(int(k) * 11, int(k)) for k in sorted(set(rng.integers(0, 500, 60)))],
              "watermark": 1000}
    claimed = {}
    for idx, r in enumerate(tkg.ranges_for_parallelism(max_p, new_p)):
        mine = tkg.filter_timers_for_range(timers, r, max_p)
        assert mine == jkg.filter_timers_for_range(timers, r, max_p)
        for _t, k in mine["event"]:
            assert k not in claimed
            claimed[k] = idx
    assert set(claimed) == {k for _t, k in timers["event"]}
    assert tkg.merge_timers([{"watermark": None}, {}]) == jkg.merge_timers([{"watermark": None}, {}])


def test_reshardable_rejects_device_operator_snapshots_as_jax():
    for handles in ({0: {"operator": {"state": {}}}}, {0: {"operator": {"pipe": {}}}},
                    {1: {"operator": {"columnar": {}}}}, {0: {"operator": {"tier": {}}}}):
        assert tkg.reshardable(handles) == jkg.reshardable(handles)


# ---------------------------------------------------------------------------
# the watermark valve and idleness (tests/test_watermarks.py's cases)
# ---------------------------------------------------------------------------

def _both(fn):
    """Run fn on both packages' watermark modules; return both results."""
    return fn(twm), fn(jwm)


def test_valve_min_over_channels():
    def run(m):
        v = m.WatermarkValve(3)
        return [v.input_watermark(0, 100), v.input_watermark(1, 200),
                v.input_watermark(2, 150), v.input_watermark(0, 300), v.combined_watermark]
    got, want = _both(run)
    assert got == want == [None, None, 100, 150, 150]


def test_valve_idle_channels_excluded_and_all_idle_holds():
    def run(m):
        v = m.WatermarkValve(2)
        out = [v.input_watermark(0, 100), v.combined_watermark, v.mark_idle(1)]
        v.mark_active(1)
        out += [v.input_watermark(1, 50), v.combined_watermark]
        w = m.WatermarkValve(1)
        w.input_watermark(0, 10)
        out += [w.mark_idle(0), w.combined_watermark]
        return out
    got, want = _both(run)
    assert got == want
    assert got[2] == 100 and got[3] is None and got[4] == 100 and got[5:] == [None, 10]


def test_valve_alignment_pause():
    def run(m):
        v = m.WatermarkValve(2, max_drift_ms=100)
        v.input_watermark(0, 0)
        v.input_watermark(1, 500)
        a = v.paused_channels()
        v.input_watermark(0, 450)
        return a, v.paused_channels(), m.WatermarkValve(2).paused_channels()
    got, want = _both(run)
    assert got == want == ([1], [], [])


def test_idleness_timer_on_an_injected_clock():
    def run(m):
        now = [100.0]
        t = m.IdlenessTimer(500, clock=lambda: now[0])
        out = [t.check_idle()]
        now[0] += 0.499
        out.append(t.check_idle())
        now[0] += 0.002
        out.append(t.check_idle())
        t.activity()
        out.append(t.idle)
        now[0] += 0.6
        out.append(t.check_idle())
        return out
    got, want = _both(run)
    assert got == want == [False, False, True, False, True]


def test_with_idleness_stores_the_timeout_through_the_builders():
    def run(m):
        s = m.WatermarkStrategy.for_bounded_out_of_orderness(5).with_idleness(250)
        s2 = s.with_timestamp_assigner(lambda e, t: t)
        gen = s2.create_generator()
        return (s.idle_timeout_ms, s2.idle_timeout_ms, s2.timestamp_assigner is not None,
                type(gen).__name__,
                m.WatermarkStrategy.for_monotonous_timestamps().idle_timeout_ms)
    got, want = _both(run)
    assert got == want == (250, 250, True, "BoundedOutOfOrdernessWatermarks", None)


# ---------------------------------------------------------------------------
# jobs at parallelism 4 and with idleness, against the JAX package's
# ---------------------------------------------------------------------------

def _job(pkg, parallelism, idleness):
    if pkg == "jax":
        from flink_tpu.api.datastream import StreamExecutionEnvironment as Env
        from flink_tpu.api.windowing.assigners import TumblingEventTimeWindows
        from flink_tpu.config import Configuration, ExecutionOptions
        from flink_tpu.connectors.source import Batch, DataGeneratorSource
        from flink_tpu.core.watermarks import WatermarkStrategy
        kw = {}
    else:
        from flink_tpu_torch.api.datastream import StreamExecutionEnvironment as Env
        from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
        from flink_tpu_torch.config import Configuration, ExecutionOptions
        from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
        from flink_tpu_torch.core.watermarks import WatermarkStrategy
        kw = {"device": "cpu"}
    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, 512)
    env = Env(cfg, **kw)
    if parallelism:
        env.set_parallelism(parallelism)
    assert env.parallelism == (parallelism or 1)
    strategy = WatermarkStrategy.for_bounded_out_of_orderness(0)
    if idleness:
        strategy = strategy.with_idleness(idleness)

    def gen(idx):
        vals = [(f"user-{int(i * 2654435761) % 37}", float(i % 5)) for i in idx]
        from flink_tpu_torch.utils.arrays import obj_array
        return Batch(obj_array(vals), (1000 + idx * 3).astype(np.int64))

    sink = (env.from_source(DataGeneratorSource(gen, 8000), watermark_strategy=strategy)
            .key_by(lambda r: r[0]).window(TumblingEventTimeWindows.of(2000))
            .aggregate("sum", value_fn=lambda r: r[1]).collect())
    env.execute()
    return sorted((k, float(v)) for k, v in sink.results)


@pytest.mark.parametrize("parallelism,idleness", [(4, None), (None, 300), (4, 300)],
                         ids=["parallelism4", "idleness", "both"])
def test_parallelism_and_idleness_jobs_run_and_match_jax(parallelism, idleness):
    got = _job("port", parallelism, idleness)
    assert len(got) > 0
    assert got == _job("jax", parallelism, idleness) == _job("port", None, None)
