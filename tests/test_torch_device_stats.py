"""The port's device plane held against the JAX package's.

`flink_tpu_torch.metrics.device_stats` and `.key_stats`, the phase
counters of the port's pipelines and the device plane of its runtime,
each beside its JAX counterpart (`flink_tpu.metrics.*`, the JAX
pipelines' XLA route, the JAX JobRuntime), on the CPU:

1. The CompileTracker: the same (program, signature) stream, through
   callables whose executable cache grows where the stream says, into both
   packages' trackers on injected clocks gives equal events, causes,
   counts, storm gauge and payloads; the fallback without a cache probe
   too. The cause priorities, `roofline_pct`, `platform_peaks`,
   `merge_compile_payloads`, `compile_event_span` and the empty payload.
2. The key fold: the same [K] loads, ties included (`jax.lax.top_k` keeps
   the lower key id first; the port's fold must too), give equal packed
   vectors, skew, hot keys and group histograms, and [n, K_local] loads the
   same per-device view.
3. Phase totals: the same stream through the JAX pipeline's XLA route and
   the port's plain route gives equal `phase_totals` for the keyed, shared,
   global, grouped (latency mode), partials (the mesh's map-side combiner)
   and sharded pipelines.
4. Compile events of a fused operator whose key ring doubles, where the
   JAX side's executable cache is cold: a geometry (chunk 320, three steps
   a dispatch) that no other test in the repository dispatches, so neither
   package's process-wide cache holds it when this test runs.
5. A default fused job through both packages' JobRuntime: the same device
   metric names, `device_snapshot()` keys and phase counters; and the
   profiler capture on the CPU into tmp_path.

Tolerance: exact (integer counts, equal dicts).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

import flink_tpu.metrics.device_stats as jds
import flink_tpu.metrics.key_stats as jks
import flink_tpu_torch.metrics.device_stats as tds
import flink_tpu_torch.metrics.key_stats as tks
from flink_tpu.api.windowing import assigners as jasg
from flink_tpu.core.time import MAX_WATERMARK
from flink_tpu.parallel import sharded_superscan as jss
from flink_tpu.runtime import fused_window_operator as jfo
from flink_tpu.runtime import fused_window_pipeline as jfp
from flink_tpu.testing.harness import keyed_window_stream
from flink_tpu_torch.api.windowing import assigners as tasg
from flink_tpu_torch.parallel import sharded_superscan as tsp
from flink_tpu_torch.parallel.mesh import Mesh
from flink_tpu_torch.runtime import fused_window_operator as tfo
from flink_tpu_torch.runtime import fused_window_pipeline as tfp


# ---------------------------------------------------------------------------
# 1. the CompileTracker
# ---------------------------------------------------------------------------

class _Program:
    """A dispatch callable both trackers read: `_cache_size()` grows when
    `compile_next` is set (the JAX tracker's probe and the port's), and its
    cost comes through both packages' interfaces (`lower(...).
    cost_analysis()` for JAX, `cost_analysis(...)` for the port)."""

    def __init__(self, flops, nbytes):
        self.size = 0
        self.compile_next = False
        self.flops, self.nbytes = flops, nbytes

    def __call__(self, x):
        if self.compile_next:
            self.size += 1
            self.compile_next = False
        return x + 1

    def _cache_size(self):
        return self.size

    def cost_analysis(self, *_args):
        return {"flops": self.flops, "bytes_accessed": self.nbytes}

    def lower(self, *_args):
        prog = self

        class _Lowered:
            def cost_analysis(self):
                return {"flops": prog.flops, "bytes accessed": prog.nbytes}

        return _Lowered()


class _NoProbe:
    """A callable without an executable-cache probe (the fallback path)."""

    def __call__(self, x):
        return x


def _clock(step):
    t = [100.0]

    def clock():
        t[0] += step
        return t[0]

    return clock


# (program, signature, compiles) in dispatch order: an initial compile, a
# cached dispatch, batch-geometry churn, ring doubling, a dtype change,
# the same signature compiled again (a cache eviction), another change, a
# second program, and a burst of recompiles that trips the storm gauge
STREAM = [
    ("fused_superscan", {"K": 64, "T": 8, "B": 1024, "dtype": "count"}, True),
    ("fused_superscan", {"K": 64, "T": 8, "B": 1024, "dtype": "count"}, False),
    ("fused_superscan", {"K": 64, "T": 1, "B": 1024, "dtype": "count"}, True),
    ("fused_superscan", {"K": 128, "T": 8, "B": 1024, "dtype": "count"}, True),
    ("fused_superscan", {"K": 128, "T": 8, "B": 1024, "dtype": "float32"}, True),
    ("fused_superscan", {"K": 128, "T": 8, "B": 1024, "dtype": "float32"}, True),
    ("fused_superscan", {"K": 128, "T": 8, "B": 1024, "dtype": "float32", "NSB": 8}, True),
    ("global_superscan", {"T": 4, "B": 512, "S": 16, "scope": "global"}, True),
    ("global_superscan", {"T": 4, "B": 512, "S": 16, "scope": "global"}, False),
    ("global_superscan", {"T": 2, "B": 512, "S": 16, "scope": "global"}, True),
]


def _run_stream(pkg, history_size=4):
    tracker = pkg.CompileTracker(history_size=history_size, storm_threshold=3,
                                 storm_window_ms=60_000, clock=_clock(0.25),
                                 wall_clock=_clock(1.0))
    progs = {"fused_superscan": _Program(1000.0, 4096.0),
             "global_superscan": _Program(10.0, 256.0)}
    for program, sig, compiles in STREAM:
        fn = progs[program]
        fn.compile_next = compiles
        assert tracker.call(program, fn, (1,), sig) == 2
    return tracker


def test_tracker_stream_matches_jax():
    jt, pt = _run_stream(jds), _run_stream(tds)
    assert pt.events() == jt.events()
    assert pt.payload() == jt.payload()
    assert (pt.num_compiles, pt.num_recompiles, pt.compile_ms_total) == \
        (jt.num_compiles, jt.num_recompiles, jt.compile_ms_total) == (8, 6, 2000.0)
    assert pt.recompile_storm() == jt.recompile_storm() == 1
    assert pt.bytes_accessed_total() == jt.bytes_accessed_total()
    assert pt.flops_total() == jt.flops_total()
    assert pt.dispatches_total() == jt.dispatches_total() == len(STREAM)
    causes = [e["cause"] for e in pt.events()]
    assert causes == ["cache-eviction", "other:NSB", "initial", "batch-geometry"]
    assert len(pt.events()) == 4      # the ring keeps the newest history_size


def test_tracker_fallback_without_a_cache_probe_matches_jax():
    out = {}
    for name, pkg in (("jax", jds), ("port", tds)):
        t = pkg.CompileTracker(clock=_clock(0.5), wall_clock=_clock(1.0))
        fn = _NoProbe()
        for sig in ({"T": 1, "B": 8}, {"T": 1, "B": 8}, {"T": 2, "B": 8}, {"T": 1, "B": 8}):
            t.call("p", fn, (3,), sig)
        out[name] = (t.events(), t.payload(), t.num_compiles, t.num_recompiles)
    assert out["port"] == out["jax"]
    assert out["port"][2] == 2 and out["port"][3] == 1


def test_tracker_memory_analysis_is_the_callables_own():
    class Mem(_Program):
        def memory_analysis(self, *_args):
            return {"temp_bytes": 64, "output_bytes": 32, "argument_bytes": 128}

    t = tds.CompileTracker(memory_analysis=True)
    fn = Mem(5.0, 50.0)
    fn.compile_next = True
    t.call("p", fn, (1,), {"T": 1})
    assert t.events()[0]["cost"] == {"flops": 5.0, "bytes_accessed": 50.0, "temp_bytes": 64.0,
                                     "output_bytes": 32.0, "argument_bytes": 128.0}


@pytest.mark.parametrize("prev,new", [
    (None, {"K": 1}),
    ({"K": 1, "T": 2}, {"K": 1, "T": 2}),
    ({"K": 1, "dtype": "count"}, {"K": 2, "dtype": "float32"}),
    ({"K": 1, "T": 2}, {"K": 2, "T": 4}),
    ({"K": 1, "T": 2, "B": 8}, {"K": 1, "T": 2, "B": 16}),
    ({"K": 1, "S": 2, "NSB": 4}, {"K": 1, "S": 4, "NSB": 8}),
    ({"raw_dtype": "float32"}, {"raw_dtype": "int32"}),
])
def test_cause_priorities_match_jax(prev, new):
    assert tds.attribute_cause(prev, new) == jds.attribute_cause(prev, new)


@pytest.mark.parametrize("args", [
    (0.0, 0.0, 0.0, 100.0, 1.0),
    (2e9, 1e9, 1.0, 2000.0, 300.0),
    (5e12, 3e15, 0.5, 1200.0, 275.0),     # clipped at 1000%
    (1e6, 2e6, 1e-3, 3350.0, 67.0),
])
def test_roofline_pct_matches_jax(args):
    assert tds.roofline_pct(*args) == jds.roofline_pct(*args)


def test_platform_peaks_are_the_jax_table():
    assert tds.PLATFORM_PEAKS == jds.PLATFORM_PEAKS
    # the card reads the gpu row, anything else the cpu row (the JAX
    # package reads jax.default_backend(), cpu here)
    assert tds.platform_peaks(0.0, 0.0, "cuda") == tds.PLATFORM_PEAKS["gpu"]
    assert tds.platform_peaks(0.0, 0.0, "cpu") == jds.platform_peaks(0.0, 0.0)
    assert tds.platform_peaks(3350.0, 67.0, "cuda") == (3350.0, 67.0)
    assert tds.platform_peaks(3350.0, 0.0, "cpu") == jds.platform_peaks(3350.0, 0.0)


def test_merge_payloads_span_and_empty_payload_match_jax():
    jt, pt = _run_stream(jds, history_size=8), _run_stream(tds, history_size=8)
    other = _run_stream(tds, history_size=8).payload()
    assert tds.merge_compile_payloads([pt.payload(), other], history_size=5) == \
        jds.merge_compile_payloads([jt.payload(), other], history_size=5)
    assert tds.merge_compile_payloads([]) == jds.merge_compile_payloads([])
    assert tds.empty_device_payload() == jds.empty_device_payload()
    for ev in pt.events():
        js, ps = jds.compile_event_span(ev), tds.compile_event_span(ev)
        assert (ps.scope, ps.name) == (js.scope, js.name) == ("device", "XlaCompile")
        assert ps.attributes == js.attributes
        assert (ps.start_ts_ms, ps.end_ts_ms) == (js.start_ts_ms, js.end_ts_ms)


# ---------------------------------------------------------------------------
# 2. the key fold
# ---------------------------------------------------------------------------

def _loads_cases():
    rng = np.random.default_rng(17)
    ties = np.zeros(64, np.int32)
    ties[[3, 9, 40, 41, 63]] = 7          # five keys tied at the top
    ties[[5, 6]] = 2
    uniform = np.full(96, 5, np.int32)     # every key tied
    hot = rng.integers(0, 4, 200).astype(np.int32)
    hot[[17, 150]] = 90
    return {"ties": (ties, 8, 4), "uniform": (uniform, 16, 8),
            "hot_non_multiple": (hot, 12, 5), "empty": (np.zeros(32, np.int32), 4, 3),
            "small_k": (np.array([1, 0, 3], np.int32), 8, 8)}


@pytest.mark.parametrize("case", sorted(_loads_cases()))
def test_key_fold_matches_jax_ties_included(case):
    loads, G, top_k = _loads_cases()[case]
    K = loads.shape[0]
    g, k = min(G, K), min(top_k, K)
    jpacked = np.asarray(jks._fold_fn(K, g, k)(jnp.asarray(loads)))
    ppacked = tks.fold_loads(torch.from_numpy(loads), g, k).numpy()
    assert ppacked.dtype == np.int32
    assert np.array_equal(ppacked, jpacked)
    out = {}
    for name, pkg, arr in (("jax", jks, jnp.asarray(loads)), ("port", tks, torch.from_numpy(loads))):
        c = pkg.KeyStatsCollector(lambda a=arr: a, num_key_groups=G, top_k=top_k,
                                  row_bytes_fn=lambda: 96, interval_ms=0)
        c.collect()
        out[name] = (c.payload(), c.skew(), c.hot_keys(), c.hot_key_load(), c.active_keys())
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("n", [2, 4])
def test_per_device_view_matches_jax(n):
    rng = np.random.default_rng(n)
    m = rng.integers(0, 6, (n, 48)).astype(np.int32)
    m[n - 1, 5] = 70                       # one shard holds the hot key
    flat = m.reshape(-1)
    out = {}
    for name, pkg, arr, marr in (
            ("jax", jks, jnp.asarray(flat), jnp.asarray(m)),
            ("port", tks, torch.from_numpy(flat), torch.from_numpy(m))):
        c = pkg.KeyStatsCollector(lambda a=arr: a, num_key_groups=32, top_k=4,
                                  interval_ms=0, mesh_loads_fn=lambda a=marr: a)
        c.collect()
        out[name] = (c.per_device(), c.mesh_load_skew(), c.payload())
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == n


def test_key_stats_throttle_and_ready_probe_match_jax():
    out = {}
    for name, pkg in (("jax", jks), ("port", tks)):
        ready, clock, folds = [False], [0.0], []

        def loads(_f=folds, _pkg=name):
            _f.append(1)
            return np.ones(8, np.int32)

        c = pkg.KeyStatsCollector(loads, num_key_groups=4, interval_ms=1000,
                                  ready_fn=lambda: ready[0], clock=lambda: clock[0])
        seq = [c.maybe_collect()]
        ready[0] = True
        seq.append(c.maybe_collect())
        clock[0] += 0.5
        seq.append(c.maybe_collect())
        clock[0] += 0.6
        seq.append(c.maybe_collect())
        out[name] = (seq, len(folds))
    assert out["port"] == out["jax"] == ([False, True, False, True], 2)


# ---------------------------------------------------------------------------
# 3. phase totals, the JAX XLA route against the port's plain route
# ---------------------------------------------------------------------------

NUM_KEYS = 128
GEOM = dict(key_capacity=NUM_KEYS, num_slices=16, nsb=4, fires_per_step=4, out_rows=32)


def _stream(seed=5, steps=12, vals=True):
    batches, wms = keyed_window_stream(seed, steps, 500, NUM_KEYS, vals)
    k, v, ts = batches[3]
    batches[3] = (k[:91], None if v is None else v[:91], ts[:91])       # a ragged step
    batches[7] = (k[:0], None if v is None else v[:0], ts[:0])          # an empty one
    return batches, wms


def _drain(pipe, batches, wms, every=4):
    out = []
    for lo in range(0, len(batches), every):
        out.extend(pipe.process_superbatch(batches[lo:lo + every], wms[lo:lo + every]))
    return out


def _phases(pipe, batches, wms, every=4):
    pipe.attach_device_stats(None)
    rows = _drain(pipe, batches, wms, every)
    return [int(x) for x in pipe.phase_totals], len(rows)


def _jmesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("shards",))


def _sliding(m):
    return m.SlidingEventTimeWindows.of(2000, 500)


def _shared(m):
    return [m.SlidingEventTimeWindows.of(2000, 500), m.TumblingEventTimeWindows.of(1000)]


PHASE_CASES = {
    "keyed_count": (lambda m, dev: (jfp if m is jasg else tfp).FusedWindowPipeline(
        _sliding(m), "count", chunk=512, **GEOM, **dev), False),
    "keyed_sum": (lambda m, dev: (jfp if m is jasg else tfp).FusedWindowPipeline(
        _sliding(m), "sum", chunk=512, **GEOM, **dev), True),
    "shared": (lambda m, dev: (jfp if m is jasg else tfp).SharedWindowPipeline(
        _shared(m), "sum", chunk=512, **dict(GEOM, fires_per_step=2), **dev), True),
    "global": (lambda m, dev: (jfp if m is jasg else tfp).FusedGlobalWindowPipeline(
        _sliding(m), "max", num_slices=16, nsb=4, fires_per_step=4, out_rows=32, chunk=512,
        **dev), True),
}


@pytest.mark.parametrize("case", sorted(PHASE_CASES))
def test_phase_totals_match_jax_xla_route(case):
    make, vals = PHASE_CASES[case]
    batches, wms = _stream(vals=vals)
    jp = _phases(make(jasg, {"backend": "xla"}), batches, wms)
    pp = _phases(make(tasg, {"device": "cpu"}), batches, wms)
    assert pp == jp
    assert pp[0][0] > 0 and pp[0][1] > 0 and pp[0][2] > 0 and pp[1] > 0


def test_grouped_phase_totals_match_jax_xla_route():
    """Latency mode: each readback group is a dispatch with its own phase
    buffer; their sum is the whole span's, in both packages."""
    batches, wms = _stream(steps=16)
    out = {}
    for name, m, mod, dev in (("jax", jasg, jfp, {"backend": "xla"}),
                              ("port", tasg, tfp, {"device": "cpu"})):
        whole = mod.FusedWindowPipeline(_sliding(m), "sum", chunk=512, **GEOM, **dev)
        split = mod.FusedWindowPipeline(_sliding(m), "sum", chunk=512, **GEOM, **dev)
        split.readback_steps = 2
        out[name] = (_phases(whole, batches, wms, every=8), _phases(split, batches, wms, every=8))
    assert out["port"] == out["jax"]
    assert out["port"][0] == out["port"][1]


@pytest.mark.parametrize("combine", [False, True], ids=["sharded", "partials"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_phase_totals_match_jax(n, combine):
    """The mesh: the shards' counts summed, as the JAX package sums its
    per-shard counters (fire and purge steps count once per shard); with
    the map-side combiner the ingest count is the sum of the count
    partials (K1's partials entry)."""
    batches, wms = _stream(vals=True)
    jp = _phases(jss.ShardedFusedPipeline(_jmesh(n), _sliding(jasg), "sum", chunk=512,
                                          local_combine=combine, **GEOM), batches, wms)
    port = tsp.ShardedFusedPipeline(Mesh(["cpu"] * n), _sliding(tasg), "sum", chunk=512,
                                    local_combine=combine, **GEOM)
    pp = _phases(port, batches, wms)
    single = _phases(tfp.FusedWindowPipeline(_sliding(tasg), "sum", chunk=512, device="cpu",
                                             **GEOM), batches, wms)
    assert pp == jp
    assert pp[0][0] == single[0][0] and pp[0][1:] == [n * c for c in single[0][1:]]
    loads = port.per_device_key_loads()
    assert tuple(loads.shape) == (n, NUM_KEYS // n)
    assert torch.equal(loads.reshape(-1), port.key_loads())


# ---------------------------------------------------------------------------
# 4. compile events where the JAX cache is cold
# ---------------------------------------------------------------------------

def test_ring_doubling_compile_events_match_jax_on_a_cold_geometry():
    """A geometry no other test dispatches (chunk 320, three steps a
    dispatch), so the first dispatch of each shape compiles in both
    packages: equal events (program, signature, cause, recompile, count)."""
    out = {}
    for name, mod, tracker_mod, m, kw in (("jax", jfo, jds, jasg, {}),
                                          ("port", tfo, tds, tasg, {"device": "cpu"})):
        op = mod.FusedWindowOperator(m.TumblingEventTimeWindows.of(1000), "count",
                                     key_capacity=32, superbatch_steps=3, chunk=320, **kw)
        t = tracker_mod.CompileTracker()
        op.attach_device_stats(t)
        rng = np.random.default_rng(9)
        for s in range(12):
            keys = rng.integers(0, 24 if s < 6 else 100, 160)
            op.process_batch(keys, np.ones(160, np.float32), np.full(160, s * 300, np.int64))
            op.process_watermark(s * 300)
        op.process_watermark(MAX_WATERMARK)
        rows = sorted((int(k), w.start, int(r)) for k, w, r, _t in op.drain_output())
        events = [{k: e[k] for k in ("program", "signature", "cause", "recompile",
                                     "compile_count")} for e in t.events()]
        out[name] = (rows, events, t.num_compiles, t.num_recompiles, op.phase_totals())
    assert out["port"] == out["jax"]
    causes = {e["cause"] for e in out["port"][1] if e["recompile"]}
    assert "ring-doubling" in causes
    assert out["port"][4]["ingestRecords"] == 12 * 160


def test_dispatch_program_cache_size_grows_once_per_key():
    calls = []
    seen = {}
    a = tfp.DispatchProgram(("k", 1), lambda: calls.append(1) or "out", lambda: {"flops": 1.0},
                            lambda: {}, seen=seen)
    assert a._cache_size() == 0
    assert a() == "out" and a._cache_size() == 1
    b = tfp.DispatchProgram(("k", 1), lambda: "again", lambda: {}, lambda: {}, seen=seen)
    assert b._cache_size() == 1 and b() == "again"
    assert tfp.DispatchProgram(("k", 2), lambda: 0, lambda: {}, lambda: {},
                               seen=seen)._cache_size() == 0
    assert a.cost_analysis() == {"flops": 1.0} and calls == [1]


# ---------------------------------------------------------------------------
# 5. whole jobs through both JobRuntimes, and the profiler
# ---------------------------------------------------------------------------

def _device_names(snap):
    device_leaves = {"numCompiles", "numRecompiles", "compileTimeMsTotal", "recompileStorm",
                     "hbmUtilizationPct", "flopsUtilizationPct", "phaseIngestRecords",
                     "phaseFireSteps", "phasePurgeSteps", "keySkew", "activeKeys",
                     "hotKeyLoad", "keyGroupLoad", "keyGroupStateBytes", "meshLoadSkew",
                     "meshDeviceLoad", "keySkewPerDevice", "hotKeyLoadPerDevice"}
    return {k for k in snap if not k.startswith("__")
            and (k.startswith("job.device.") or k == "job.keySkew"
                 or k.rsplit(".", 1)[-1] in device_leaves)}


def _key_tree(obj, depth=3):
    """The nested key structure of a payload (operator uids kept)."""
    if not isinstance(obj, dict) or depth == 0:
        return type(obj).__name__
    return {k: _key_tree(v, depth - 1) for k, v in obj.items()}


@pytest.mark.parametrize("shape", ["fused_count", "fused_sum"])
def test_fused_job_registers_the_jax_device_plane(shape):
    from test_torch_checkpointing import PK as CK, _job, _rows, _runtime

    import flink_tpu.metrics.registry as jreg
    import flink_tpu_torch.metrics.registry as treg

    out = {}
    for pkg, reg in (("jax", jreg), ("port", treg)):
        cfg = CK[pkg].cfg.Configuration({"observability.device.key-stats.interval-ms": 600_000})
        env, sink = _job(pkg, shape, config=cfg)
        rt = _runtime(pkg, env)
        rt.run()
        snap = reg.metrics_snapshot(rt.registry.all_metrics())
        dev = rt.device_snapshot()
        (op,) = [e for e in dev["operators"].values() if "compile" in e]
        out[pkg] = (_rows(sink), _device_names(snap), _key_tree(dev), op["phases"],
                    sorted(op["keys"]), sorted(op["compile"]))
    assert out["port"] == out["jax"]
    names = out["port"][1]
    # (job.keySkew reads None, and the snapshot leaves it out, where the
    # one fold found no resident records: in both packages alike)
    assert {"job.device.numCompiles", "job.device.hbmUtilizationPct",
            "job.device.recompileStorm"} <= names
    assert out["port"][3]["ingestRecords"] > 0


def test_profiler_capture_on_cpu(tmp_path):
    from test_torch_checkpointing import PK as CK, _job, _runtime

    prof_dir = str(tmp_path / "prof")
    cfg = CK["port"].cfg.Configuration({"observability.profiler.enabled": True,
                                        "observability.profiler.dir": prof_dir})
    env, _sink = _job("port", "fused_count", config=cfg)
    rt = _runtime("port", env)
    assert rt.device_snapshot()["profiler"] == {"enabled": True, "captures": 0,
                                                 "last_capture_dir": None}
    rt.run()
    assert rt.device_snapshot()["profiler"] == {"enabled": True, "captures": 1,
                                                 "last_capture_dir": prof_dir}
    (trace,) = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, trace)) as f:
        events = json.load(f)["traceEvents"]
    assert any("superscan" in str(e.get("name", "")) or "index_add" in str(e.get("name", ""))
               for e in events)
