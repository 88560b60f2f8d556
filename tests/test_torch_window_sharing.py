"""The port's sharing optimizer and shared-window jobs held against the JAX
package's.

- `plan_shared_windows` on the graphs of tests/test_window_sharing.py, built
  the same way in both packages: groups, granule, member spws, the
  estimated sharing factor, the absorbed chain and every refusal (mixed
  offsets, different aggregates, a granule ratio over MAX_SHARED_SPW, a
  single member, a second consumer of the chain).
- `WindowAssigner.slices_on` over the degenerate shapes (a slide that does
  not divide the size, size == slide) and its refusals.
- The correlated-windows program of `bench.py::correlated_windows_microbench`
  (a traceable filter and key, 1 min / 5 min / 1 h tumbling counts; here
  over 2^15 records and 256 keys) through both packages' `env.execute()`
  with shared partials on and off, in row and columnar output: the same
  rows everywhere, and one SharedWindowRunner built in both packages.

Tolerance: exact (counts and sums of small integers).
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
from flink_tpu.graph import fusion as jfusion  # noqa: E402
from flink_tpu.graph import transformation as jtrans  # noqa: E402
from flink_tpu.graph import window_sharing as jws  # noqa: E402
from flink_tpu.runtime import executor as jexec  # noqa: E402
from flink_tpu_torch.api import datastream as tds  # noqa: E402
from flink_tpu_torch.api.windowing import assigners as tasg  # noqa: E402
from flink_tpu_torch.config import Configuration, ExecutionOptions  # noqa: E402
from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource  # noqa: E402
from flink_tpu_torch.core.watermarks import WatermarkStrategy  # noqa: E402
from flink_tpu_torch.graph import fusion as tfusion  # noqa: E402
from flink_tpu_torch.graph import transformation as ttrans  # noqa: E402
from flink_tpu_torch.graph import window_sharing as tws  # noqa: E402
from flink_tpu_torch.runtime import executor as texec  # noqa: E402
from jax_native_twins import jax_native_library  # noqa: E402,F401

JAX = dict(env=lambda cfg: JaxEnv.get_execution_environment(cfg), cfg=JaxConfiguration,
           opts=JaxExecutionOptions, batch=JaxBatch, source=JaxGeneratorSource,
           wm=JaxWatermarkStrategy, asg=jasg, plan=jtrans.plan,
           chains=jfusion.plan_device_chains, share=jws.plan_shared_windows,
           runners=lambda g, cfg: jexec.build_runners(g, cfg),
           filter=lambda col: col[:, 1] < 4.5,
           key=lambda col: col[:, 0].astype(jnp.int32),
           proj=lambda col: col[:, 1])
PORT = dict(env=lambda cfg: tds.StreamExecutionEnvironment(cfg, device="cpu"),
            cfg=Configuration, opts=ExecutionOptions, batch=Batch, source=DataGeneratorSource,
            wm=WatermarkStrategy, asg=tasg, plan=ttrans.plan,
            chains=tfusion.plan_device_chains, share=tws.plan_shared_windows,
            runners=lambda g, cfg: texec.build_runners(g, cfg, "cpu"),
            filter=lambda col: col[:, 1] < 4.5,
            key=lambda col: col[:, 0].to(torch.int32),
            proj=lambda col: col[:, 1])


def _source(pkg, n=3000, keys=7, span_ms=40_000):
    """tests/test_window_sharing.py's stream: (key, kind) columns."""
    def gen(idx):
        k = (idx * 2654435761) % keys
        col = np.stack([k, idx % 5], axis=1).astype(np.float32)
        ts = 1_000 + idx * span_ms // n
        return pkg["batch"](col, ts.astype(np.int64))

    return pkg["source"](gen, n)


def _env(pkg, assigners, *, shared=True, aggregates=None, second_consumer=False):
    cfg = pkg["cfg"]()
    cfg.set(pkg["opts"].BATCH_SIZE, 512)
    cfg.set(pkg["opts"].KEY_CAPACITY, 16)
    cfg.set(pkg["opts"].SHARED_PARTIALS, shared)
    cfg.set(pkg["opts"].COLUMNAR_OUTPUT, False)
    env = pkg["env"](cfg)
    ds = env.from_source(_source(pkg),
                         watermark_strategy=pkg["wm"].for_bounded_out_of_orderness(0))
    ds = ds.filter(pkg["filter"], traceable=True)
    if second_consumer:
        ds.map(pkg["proj"], traceable=True).collect()
    keyed = ds.key_by(pkg["key"], traceable=True)
    aggregates = aggregates or ["count"] * len(assigners)
    for a, agg in zip(assigners, aggregates):
        keyed.window(a(pkg["asg"])).aggregate(agg).collect()
    return env, cfg


def _summary(pkg, assigners, **kw):
    """What plan_shared_windows decided, in package-neutral terms."""
    env, _cfg = _env(pkg, assigners, **kw)
    graph = pkg["plan"](env._sinks)
    chain_plans, _absorbed = pkg["chains"](graph)
    out = []
    for p in pkg["share"](graph, chain_plans):
        out.append(dict(
            members=[graph.steps.index(m) for m in p.members],
            aggregates=[t.config["aggregate"] for t in p.terminals],
            assigners=[repr(a) for a in p.assigners],
            transforms=[t.kind for t in p.transforms],
            granule_ms=p.granule_ms, member_spws=list(p.member_spws),
            factor=p.estimated_sharing_factor,
            absorbed=None if p.absorbed is None else graph.steps.index(p.absorbed),
            name=p.name))
    return out


def T(ms, off=0):
    return lambda m: m.TumblingEventTimeWindows.of(ms, off)


def SL(size, slide):
    return lambda m: m.SlidingEventTimeWindows.of(size, slide)


GRAPHS = {
    # name: (assigners, keyword arguments of _env, groups planned)
    "tumbling_three": ([T(1_000), T(5_000), T(10_000)], {}, 1),
    "sliding_on_group_gcd": ([SL(10_000, 4_000), T(60_000)], {}, 1),
    "mixed_offsets": ([T(1_000), T(5_000, 500)], {}, 0),
    "different_aggregates": ([T(1_000), T(5_000), T(5_000)],
                             dict(aggregates=["sum", "count", "sum"]), 1),
    "granule_ratio_over_max": ([SL(2_000, 1_001), T(10_000_000)], {}, 0),
    "single_member": ([T(1_000)], {}, 0),
    "second_chain_consumer": ([T(1_000), T(5_000)], dict(second_consumer=True), 1),
    "five_members_one_sliding": ([T(60_000), T(300_000), T(900_000), T(3_600_000),
                                  SL(600_000, 60_000)], {}, 1),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plan_shared_windows_matches_jax(name):
    assigners, kw, groups = GRAPHS[name]
    port = _summary(PORT, assigners, **kw)
    ref = _summary(JAX, assigners, **kw)
    assert port == ref
    assert len(port) == groups
    if name == "tumbling_three":
        p = port[0]
        assert p["granule_ms"] == 1_000 and p["member_spws"] == [1, 5, 10]
        assert 2.5 < p["factor"] <= 3.0
        assert p["absorbed"] is not None and p["transforms"] == ["filter"]
    if name == "second_chain_consumer":
        assert port[0]["absorbed"] is None and port[0]["transforms"] == []
    if name == "five_members_one_sliding":
        assert port[0]["member_spws"] == [1, 5, 15, 60, 10]
    assert tws.MAX_SHARED_SPW == jws.MAX_SHARED_SPW == 4096


def test_describe_matches_jax():
    assigners = GRAPHS["tumbling_three"][0]
    texts = []
    for pkg, mod in ((PORT, tws), (JAX, jws)):
        env, _cfg = _env(pkg, assigners)
        graph = pkg["plan"](env._sinks)
        texts.append(mod.describe(pkg["share"](graph, pkg["chains"](graph)[0])))
    assert texts[0] == texts[1] and "shared-windows[0] g=1000ms x3" in texts[0]


SLICES_ON = {
    # name: (assigner, granule) -> decomposition or ValueError
    "tumbling_on_own_size": (T(60_000), 60_000),
    "tumbling_on_a_divisor": (T(60_000), 1_000),
    "sliding_slide_divides_size": (SL(10_000, 2_000), 1_000),
    "sliding_slide_not_dividing_size": (SL(10_000, 4_000), 2_000),
    "sliding_size_equals_slide": (SL(5_000, 5_000), 1_000),
    "sliding_size_equals_slide_own": (SL(5_000, 5_000), 5_000),
    "granule_not_dividing_slide": (SL(10_000, 4_000), 4_000),
    "granule_not_dividing_size": (T(10_000), 3_000),
    "granule_zero": (T(10_000), 0),
    "granule_negative": (T(10_000), -1_000),
    "session_not_sliceable": (lambda m: m.EventTimeSessionWindows.with_gap(1_000), 1_000),
}


def _slices_on(pkg, name):
    make, granule = SLICES_ON[name]
    try:
        return make(pkg["asg"]).slices_on(granule)
    except ValueError as e:
        return ("ValueError", str(e).split(" — ")[0].replace("EventTimeSessionWindows", "S"))


@pytest.mark.parametrize("name", sorted(SLICES_ON))
def test_slices_on_matches_jax(name):
    got = _slices_on(PORT, name)
    assert got == _slices_on(JAX, name)
    expect = {"tumbling_on_own_size": (1, 1), "tumbling_on_a_divisor": (60, 60),
              "sliding_slide_divides_size": (10, 2),
              "sliding_slide_not_dividing_size": (5, 2),
              "sliding_size_equals_slide": (5, 5), "sliding_size_equals_slide_own": (1, 1)}
    if name in expect:
        assert got == expect[name]
    else:
        assert got[0] == "ValueError"


# ---------------------------------------------------------------------------
# bench.py::correlated_windows_microbench's program through both packages
# ---------------------------------------------------------------------------

CORRELATED_KEYS = 256
CORRELATED_EVENTS = 1 << 15
SIZES_MS = (60_000, 300_000, 3_600_000)


def _correlated(pkg, shared, columnar):
    """The 1m/5m/1h tumbling counts over one keyed stream, 2 h of event time,
    batch 2048: (env, config, sinks)."""
    n = CORRELATED_EVENTS

    def gen(idx):
        camp = (idx * 2654435761) % CORRELATED_KEYS
        col = np.stack([camp, idx % 3], axis=1).astype(np.float32)
        ts = 10_000 + idx * (2 * 3_600_000) // n
        return pkg["batch"](col, ts.astype(np.int64))

    cfg = pkg["cfg"]()
    cfg.set(pkg["opts"].SHARED_PARTIALS, shared)
    cfg.set(pkg["opts"].BATCH_SIZE, 2048)
    cfg.set(pkg["opts"].KEY_CAPACITY, CORRELATED_KEYS)
    cfg.set(pkg["opts"].COLUMNAR_OUTPUT, columnar)
    env = pkg["env"](cfg)
    ds = env.from_source(pkg["source"](gen, n),
                         watermark_strategy=pkg["wm"].for_bounded_out_of_orderness(0))
    keyed = (ds.filter(lambda col: col[:, 1] < 0.5, traceable=True)
             .key_by(pkg["key"], traceable=True))
    sinks = [keyed.window(pkg["asg"].TumblingEventTimeWindows.of(sz)).aggregate("count")
             .collect() for sz in SIZES_MS]
    return env, cfg, sinks


def _rows(results, columnar):
    """Package-neutral rows of one sink: (key, value) in row mode; (window
    start, end, key ids, values) per packed fire in columnar mode."""
    if not columnar:
        return sorted((int(k), int(v)) for k, v in results)
    return sorted((int(w.start), int(w.end), tuple(np.asarray(ids).tolist()),
                   tuple(np.asarray(vals).astype(np.int64).tolist()))
                  for w, ids, vals in results)


def _run_correlated(pkg, shared, columnar):
    env, cfg, sinks = _correlated(pkg, shared, columnar)
    kinds = sorted(type(r).__name__ for r in pkg["runners"](pkg["plan"](env._sinks), cfg)[0])
    env.execute()
    return kinds, [_rows(s.results, columnar) for s in sinks]


@pytest.fixture(scope="module")
def correlated_runs():
    return {(name, shared, columnar): _run_correlated(pkg, shared, columnar)
            for name, pkg in (("port", PORT), ("jax", JAX))
            for shared in (True, False) for columnar in (False, True)}


@pytest.mark.parametrize("columnar", [False, True], ids=["rows", "columnar"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "independent"])
def test_correlated_program_matches_jax(correlated_runs, shared, columnar):
    kinds, rows = correlated_runs[("port", shared, columnar)]
    jax_kinds, jax_rows = correlated_runs[("jax", shared, columnar)]
    assert rows == jax_rows
    assert all(len(r) > 0 for r in rows)
    if shared:
        for k in (kinds, jax_kinds):
            assert k.count("SharedWindowRunner") == 1
            assert k.count("SharedWindowSiblingRunner") == 2
    else:
        assert kinds.count("DeviceChainRunner") == 3 and "SharedWindowRunner" not in kinds


@pytest.mark.parametrize("columnar", [False, True], ids=["rows", "columnar"])
def test_shared_equals_independent_window_by_window(correlated_runs, columnar):
    _k, shared = correlated_runs[("port", True, columnar)]
    _k, independent = correlated_runs[("port", False, columnar)]
    assert shared == independent
    if columnar:
        # 2 h of event time: 120 one-minute windows, 24 five-minute, 2 hours
        assert [len(r) for r in shared] == [121, 25, 3]


def test_correlated_rows_match_a_numpy_model(correlated_runs):
    _k, rows = correlated_runs[("port", True, False)]
    idx = np.arange(CORRELATED_EVENTS, dtype=np.int64)
    camp = (idx * 2654435761) % CORRELATED_KEYS
    ts = 10_000 + idx * (2 * 3_600_000) // CORRELATED_EVENTS
    keep = idx % 3 == 0
    for size, got in zip(SIZES_MS, rows):
        w = ts[keep] // size
        pairs, counts = np.unique(np.stack([w, camp[keep]], 1), axis=0, return_counts=True)
        assert got == sorted((int(k), int(c)) for (_w, k), c in zip(pairs, counts))


def test_shared_runner_fans_watermarks_and_end_to_every_member():
    env, cfg, _sinks = _correlated(PORT, True, False)
    runners, _feeds = PORT["runners"](PORT["plan"](env._sinks), cfg)
    leader = next(r for r in runners if type(r).__name__ == "SharedWindowRunner")
    assert [type(r).__name__ for r in leader.member_runners] == [
        "SharedWindowRunner", "SharedWindowSiblingRunner", "SharedWindowSiblingRunner"]
    seen = []

    class Spy:
        def __init__(self, i):
            self.i = i

        def on_batch_n(self, _o, values, _ts):
            seen.append(("batch", self.i, len(values)))

        def on_watermark_n(self, _o, wm):
            seen.append(("wm", self.i, wm))

        def on_end_n(self, _o):
            seen.append(("end", self.i))

    for i, r in enumerate(leader.member_runners):
        r.downstream = texec._FanOut()
        r.downstream.add(Spy(i), 0)
    leader.on_watermark(5)          # nothing resolved yet: held back
    assert seen == []
    leader._forward_watermark(7)
    leader.on_end()
    assert sorted(seen) == [("end", 0), ("end", 1), ("end", 2),
                            ("wm", 0, 7), ("wm", 1, 7), ("wm", 2, 7)]
    with pytest.raises(AssertionError, match="must not be wired"):
        leader.member_runners[1].on_batch(np.zeros((1, 2), np.float32), np.zeros(1, np.int64))
