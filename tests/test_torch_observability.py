"""Job metrics, latency markers, emission latency, traces, history and the
doctor of a port job, held against the same job on the JAX package.

The main case is `bench.py::api_path_microbench`'s fused program (a
traceable filter keeping one record in three, a traceable key, 10 s
windows sliding by 1 s, count) at 2^14 records over 256 keys, through
each package's `env.execute_async()` on its MiniCluster, with a latency
marker every batch, a checkpoint at every step (the coordinators' `due`
held true, so the count does not hang on the wall clock), emission latency
on and the doctor on. Equal across the packages: the rows; the sets of
metric names, the device plane's included (`job.device.*`, `job.keySkew`
and the operator gauges of the compile tracker, roofline, phase counters
and key statistics: the port registers the JAX set); every counter-kind
value and every histogram's count, apart from the wall-clock ones
(`deviceTimeMsTotal`, `compileTimeMsTotal`), the compile counts (a
compile is a program geometry's first dispatch in the process, in both
packages, so they depend on what ran before in the worker) and the
operator-scope numRecordsIn the JAX window and sink runners never count
(ROADMAP Queue C: the port counts them, and the test holds them to the
records that reached each runner); the multiset of (scope, name) of the
trace spans, apart from the `device.XlaCompile` spans (one per compile);
and the keys of the three reports.

Then every runner family (fused, per-batch with lateness, session, global
count, oracle, device join, degraded join, latency mode, tiered, shared
windows) through both packages' JobRuntime: the same metric names and
counter values. The twins of tests/test_device_join.py's gauge cases, and
the `observability.*` keys: accepted, read, or raising with their items.

Tolerance: exact (integer counts; rows of integer counts).
"""

import collections
import types

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import flink_tpu.api.datastream as jds
import flink_tpu.api.windowing.assigners as jasg
import flink_tpu.checkpoint.coordinator as jco
import flink_tpu.config as jcfg
import flink_tpu.connectors.sink as jsink
import flink_tpu.connectors.source as jsrc
import flink_tpu.core.watermarks as jwm
import flink_tpu.graph.transformation as jtr
import flink_tpu.metrics.registry as jreg
import flink_tpu.runtime.executor as jex
import flink_tpu_torch.api.datastream as tds
import flink_tpu_torch.api.windowing.assigners as tasg
import flink_tpu_torch.checkpoint.coordinator as tco
import flink_tpu_torch.config as tcfg
import flink_tpu_torch.connectors.sink as tsink
import flink_tpu_torch.connectors.source as tsrc
import flink_tpu_torch.core.watermarks as twm
import flink_tpu_torch.graph.transformation as ttr
import flink_tpu_torch.metrics.registry as treg
import flink_tpu_torch.runtime.executor as tex

PK = {
    "jax": types.SimpleNamespace(
        ds=jds, asg=jasg, co=jco, cfg=jcfg, sink=jsink, src=jsrc, wm=jwm, tr=jtr, reg=jreg,
        ex=jex, kw={}, filter=lambda c: c[:, 1] < 0.5,
        key=lambda c: c[:, 0].astype(jnp.int32)),
    "port": types.SimpleNamespace(
        ds=tds, asg=tasg, co=tco, cfg=tcfg, sink=tsink, src=tsrc, wm=twm, tr=ttr, reg=treg,
        ex=tex, kw={"device": "cpu"}, filter=lambda c: c[:, 1] < 0.5,
        key=lambda c: c[:, 0].to(torch.int32)),
}
N, KEYS, BATCH = 1 << 14, 256, 1024

# the device plane (ROADMAP item D4, ported): the job gauges and the
# operator gauges of a default fused job, in both packages
DEVICE_JOB = {"job.device.numCompiles", "job.device.numRecompiles",
              "job.device.compileTimeMsTotal", "job.device.recompileStorm",
              "job.device.hbmUtilizationPct", "job.device.flopsUtilizationPct", "job.keySkew"}
DEVICE_OPERATOR = {"numCompiles", "numRecompiles", "compileTimeMsTotal", "recompileStorm",
                   "hbmUtilizationPct", "flopsUtilizationPct", "phaseIngestRecords",
                   "phaseFireSteps", "phasePurgeSteps", "keySkew", "activeKeys",
                   "hotKeyLoad", "keyGroupLoad", "keyGroupStateBytes"}
# counter-kind values that read the wall clock
WALL = {"deviceTimeMsTotal", "compileTimeMsTotal"}
# counter-kind values that depend on what the process dispatched before
PROCESS = {"numCompiles", "numRecompiles"}


def _names(snap):
    return {k for k in snap if not k.startswith("__")}


def _compare(jax_snap, port_snap, reached=None):
    """Names equal (the port registers the JAX set, the device plane's
    included); counter-kind values and histogram counts equal, apart from
    the wall-clock ones, the compile counts and the operator-scope
    numRecordsIn (0 in the JAX package unless it counts; the port's equal
    `reached[uid]` where given)."""
    assert _names(port_snap) == _names(jax_snap), sorted(
        _names(port_snap) ^ _names(jax_snap))
    kinds = jax_snap.get("__kinds__", {})
    checked = 0
    for k in sorted(_names(port_snap)):
        leaf = k.rsplit(".", 1)[-1]
        if leaf in WALL or leaf in PROCESS:
            continue
        a, b = jax_snap[k], port_snap[k]
        if k.startswith("job.operator.") and leaf == "numRecordsIn" and a != b:
            uid = k.split(".")[2]
            assert a == 0, (k, a, b)
            if reached is not None:
                assert b == reached[uid], (k, b, reached[uid])
            continue
        if isinstance(a, dict):
            assert a.get("count") == b.get("count"), (k, a, b)
            assert a.get("sentinel", 0) == b.get("sentinel", 0), (k, a, b)
            checked += 1
        elif kinds.get(k) == "counter":
            assert a == b, (k, a, b)
            checked += 1
        assert port_snap["__kinds__"].get(k) == kinds.get(k), k
        assert port_snap.get("__folds__", {}).get(k) == jax_snap.get("__folds__", {}).get(k), k
    return checked


@pytest.fixture
def every_step_checkpoints(monkeypatch):
    for pk in PK.values():
        monkeypatch.setattr(pk.co.CheckpointCoordinator, "due", lambda self: True)


def _api_job(pkg: str, extra=None):
    pk = PK[pkg]

    def gen(idx):
        camp = (idx * 2654435761) % KEYS
        col = np.stack([camp, idx % 3, (idx * 7) % 11], axis=1).astype(np.float32)
        return pk.src.Batch(col, (10_000 + idx * 64_000 // N).astype(np.int64))

    conf = {"execution.step.batch-size": BATCH, "execution.state.key-capacity": KEYS,
            "execution.checkpointing.interval": 1,
            "observability.latency-markers.interval-ms": 0,
            "observability.emission-latency.enabled": True,
            # no outlier can depend on a compile's wall time
            "observability.emission-latency.outlier-floor-ms": 1e15,
            "observability.doctor.enabled": True,
            # one history sample (the first tick): no watchdog span can
            # depend on the wall clock
            "observability.history.interval-ms": 600_000,
            # one key-statistics fold (the first tick with resident state):
            # no gauge can depend on the wall clock (a later fold after the
            # final purge reads no skew, which the snapshot leaves out)
            "observability.device.key-stats.interval-ms": 600_000}
    conf.update(extra or {})
    env = pk.ds.StreamExecutionEnvironment(pk.cfg.Configuration(conf), **pk.kw)
    sink = (env.from_source(pk.src.DataGeneratorSource(gen, N),
                            pk.wm.WatermarkStrategy.for_bounded_out_of_orderness(0))
            .filter(pk.filter, traceable=True).key_by(pk.key, traceable=True)
            .window(pk.asg.SlidingEventTimeWindows.of(10_000, 1_000)).aggregate("count")
            .collect())
    return env, sink


def _run_async(pkg, extra=None):
    env, sink = _api_job(pkg, extra)
    client = env.execute_async()
    client.wait(300)
    snap = PK[pkg].reg.metrics_snapshot(client.metrics.all_metrics())
    return client, snap, sorted((int(k), int(v)) for k, v in sink.results)


def test_fused_job_metrics_spans_and_reports_match_jax(every_step_checkpoints):
    jc, js, jrows = _run_async("jax")
    pc, ps, prows = _run_async("port")
    assert prows == jrows and prows
    uids = {k.split(".")[2] for k in ps if k.startswith("job.operator.")}
    window = next(u for u in uids if u.startswith("window_aggregate"))
    sink = next(u for u in uids if u.startswith("sink"))
    checked = _compare(js, ps, reached={window: N, sink: len(prows)})
    assert checked >= 10
    # the port's own values, beside the JAX package's
    assert ps["job.numRecordsIn"] == N
    assert ps["job.numberOfCompletedCheckpoints"] == pc.num_checkpoints == N // BATCH
    assert ps[f"job.operator.{window}.latencyMs"]["count"] == N // BATCH
    assert ps[f"job.operator.{sink}.pipelineLatencyMs"]["count"] == N // BATCH
    assert ps[f"job.operator.{window}.emissionLatencyMs"]["count"] > 0
    assert np.isfinite(ps["job.p99EmissionLatencyMs"]) and ps["job.p99EmissionLatencyMs"] > 0
    assert ps["job.deviceTimeMsTotal"] > 0
    assert ps[f"job.operator.{window}.deviceDispatches"] > 0
    # the device plane of a default fused job: the JAX names, and the phase
    # counters equal (compared above) and the records that passed the filter
    assert DEVICE_JOB <= set(ps)
    assert {f"job.operator.{window}.{leaf}" for leaf in DEVICE_OPERATOR} <= set(ps)
    assert ps[f"job.operator.{window}.phaseIngestRecords"] == -(-N // 3)
    spans = {pkg: collections.Counter((s.scope, s.name) for s in c.span_log.spans
                                      if (s.scope, s.name) != ("device", "XlaCompile"))
             for pkg, c in (("jax", jc), ("port", pc))}
    assert spans["port"] == spans["jax"]
    assert spans["port"][("checkpointing", "Checkpoint")] == pc.num_checkpoints
    assert all(s.trace_id == pc.trace_id for s in pc.span_log.spans)
    for report in ("latency_report", "history_report", "doctor_report"):
        j, p = getattr(jc, report)(), getattr(pc, report)()
        assert sorted(p) == sorted(j), report
    assert pc.latency_report()["samples"] == jc.latency_report()["samples"]
    assert pc.doctor_report()["verdict"] == jc.doctor_report()["verdict"] == "healthy"
    # one device.XlaCompile span per compile event, and the OTLP payload
    # carries every span
    compiles = sum(1 for s in pc.span_log.spans if (s.scope, s.name) == ("device", "XlaCompile"))
    assert compiles == ps["job.device.numCompiles"]
    payload = pc.otel.payload()["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert len(payload) == sum(spans["port"].values()) + compiles


def test_planes_off_change_what_the_job_reports_like_jax(every_step_checkpoints):
    off = {"observability.emission-latency.enabled": False,
           "observability.device-timing.enabled": False,
           "observability.latency-markers.interval-ms": -1,
           "observability.doctor.enabled": False}
    (jc, js, jrows), (pc, ps, prows) = _run_async("jax", off), _run_async("port", off)
    assert prows == jrows
    _compare(js, ps)
    assert not any(k.endswith((".emissionLatencyMs", ".deviceDispatches")) for k in ps)
    assert "job.p99EmissionLatencyMs" not in ps
    assert all(v["count"] == 0 for k, v in ps.items() if k.endswith(".latencyMs"))
    assert pc.watchdog is None and jc.watchdog is None
    assert pc.latency_report()["samples"] == 0


# -- every runner family through JobRuntime -----------------------------

def _runtime_snap(pkg, shape, conf=None):
    from test_torch_checkpointing import PK as CK, _job, _rows, _runtime

    # one key-statistics fold, as in _api_job
    cfg = CK[pkg].cfg.Configuration(dict({"observability.device.key-stats.interval-ms": 600_000},
                                         **(conf or {})))
    env, sink = _job(pkg, shape, config=cfg)
    rt = _runtime(pkg, env)
    rt.run()
    return PK[pkg].reg.metrics_snapshot(rt.registry.all_metrics()), _rows(sink), rt


FAMILIES = {
    "fused_count": ("fused_count", None),
    "fused_sum": ("fused_sum", None),
    "per_batch_lateness": ("per_batch_lateness", None),
    "session": ("session", None),
    "global_count": ("global_count", None),
    "oracle_reduce": ("oracle_reduce", None),
    "join_q8": ("join_q8", None),
    "join_q8_degraded": ("join_q8_degraded", None),
    "latency_mode": ("fused_count", {"execution.latency.target-ms": 5}),
    "tiered": ("fused_sum", {"state.tier.enabled": True, "state.tier.hot-key-capacity": 8,
                             "state.tier.admission-min-count": 1}),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_each_runner_family_registers_the_jax_metrics(family):
    shape, conf = FAMILIES[family]
    js, jrows, _jrt = _runtime_snap("jax", shape, conf)
    ps, prows, prt = _runtime_snap("port", shape, conf)
    assert prows == jrows
    # every runner counts what it was handed: the sources' records into
    # the first runners, each runner's output into the next
    reached = {}
    for r in prt.runners:
        c = r.records_in_counter
        assert c is not None
        reached[r.uid] = c.count
    _compare(js, ps, reached=reached)
    leaves = {k.rsplit(".", 1)[-1] for k in ps}
    if family == "latency_mode":
        assert {"latencyModeActive", "currentBatchRung", "inflightDepth",
                "ladderRecompiles"} <= leaves
    if family == "tiered":
        assert {"vocabSize", "residentKeys", "evictions", "promotions", "spilledBytes",
                "changelogBytes", "tierHotFillRatio"} <= leaves
        assert any(v > 0 for k, v in ps.items() if k.endswith(".evictions"))
    if family.startswith("join"):
        assert {"joinRingOccupancy", "joinMatchesEmitted", "joinFallbackReason"} <= leaves


def test_shared_windows_fan_markers_out_to_every_member_like_jax():
    """One SharedWindowRunner, its sibling's sink: each member's sink sees
    every marker, as in the JAX runner."""
    out = {}
    for pkg, pk in PK.items():
        env = pk.ds.StreamExecutionEnvironment(pk.cfg.Configuration({
            "execution.step.batch-size": 256, "execution.state.key-capacity": KEYS,
            "observability.latency-markers.interval-ms": 0}), **pk.kw)

        def gen(idx, pk=pk):
            col = np.stack([(idx * 2654435761) % KEYS, idx % 3, idx % 5],
                           axis=1).astype(np.float32)
            return pk.src.Batch(col, (10_000 + idx * 8).astype(np.int64))

        keyed = (env.from_source(pk.src.DataGeneratorSource(gen, 1 << 12),
                                 pk.wm.WatermarkStrategy.for_bounded_out_of_orderness(0))
                 .key_by(pk.key, traceable=True))
        sinks = [keyed.window(pk.asg.TumblingEventTimeWindows.of(ms)).aggregate("count")
                 .collect() for ms in (1_000, 5_000)]
        rt = pk.ex.JobRuntime(pk.tr.plan(env._sinks), env.config, **pk.kw)
        rt.run()
        kinds = sorted(type(r).__name__ for r in rt.runners)
        snap = pk.reg.metrics_snapshot(rt.registry.all_metrics())
        out[pkg] = (kinds, {k: v["count"] for k, v in snap.items()
                            if k.endswith(".latencyMs") or k.endswith(".pipelineLatencyMs")},
                    [sorted(map(tuple, s.results)) for s in sinks])
    assert out["port"] == out["jax"]
    assert "SharedWindowRunner" in out["port"][0]
    assert all(c == (1 << 12) // 256 for k, c in out["port"][1].items() if "sink" in k)


# -- twins of tests/test_device_join.py's gauge cases -------------------

def _join_env(pkg, device=True):
    pk = PK[pkg]
    conf = pk.cfg.Configuration()
    conf.set(pk.cfg.ExecutionOptions.BATCH_SIZE, 16)
    conf.set(pk.cfg.ExecutionOptions.DEVICE_JOINS, device)
    return pk.ds.StreamExecutionEnvironment(conf, **pk.kw)


def _join_stream(pkg, env, pairs):
    pk = PK[pkg]
    ts_map = {i: p[1] for i, p in enumerate(pairs)}
    s = env.from_collection(list(enumerate(p[0] for p in pairs)),
                            timestamp_fn=lambda iv: ts_map[iv[0]],
                            watermark_strategy=pk.wm.WatermarkStrategy.for_monotonous_timestamps())
    return s.map(lambda iv: iv[1], name="unwrap")


def test_runner_registers_the_join_gauge_family():
    out = {}
    for pkg, pk in PK.items():
        env = _join_env(pkg)
        sink = (_join_stream(pkg, env, [(("k", 1), 100)])
                .join(_join_stream(pkg, env, [(("k", 2), 200)]))
                .where(lambda v: v[0]).equal_to(lambda v: v[0])
                .window(pk.asg.TumblingEventTimeWindows.of(1000))
                .apply(lambda l, r: (l[0], l[1], r[1])).collect())
        rt = pk.ex.JobRuntime(pk.tr.plan(env._sinks + getattr(env, "_roots", [])),
                              env.config, **pk.kw)
        rt.run()
        metrics = rt.registry.all_metrics()
        keys = [k for k in metrics if k.rsplit(".", 1)[-1] in (
            "joinRingOccupancy", "joinMatchesEmitted", "joinFallbackReason")]
        out[pkg] = ({k.rsplit(".", 1)[-1]: metrics[k].value() for k in keys},
                    len(sink.results),
                    {k: pk.reg.metrics_snapshot(metrics)["__folds__"][k] for k in keys})
    assert out["port"] == out["jax"]
    by_leaf, n, _folds = out["port"]
    assert len(by_leaf) == 3 and by_leaf["joinMatchesEmitted"] == n == 1
    assert by_leaf["joinFallbackReason"] == 0


def test_join_gauges_fold_and_survive_the_device_payload_filters():
    """The port has no cluster (ROADMAP item 14) to fold shards with; what
    the cluster folds by is each gauge's declared fold and kind, which
    ride metrics_snapshot: the join family declares the JAX package's
    (joinFallbackReason MAX, occupancy and matches SUM, matches a
    counter), and survives the snapshot as plain numbers."""
    out = {}
    for pkg, pk in PK.items():
        env = _join_env(pkg)
        (_join_stream(pkg, env, [(("k", i % 3), 100 * i) for i in range(20)])
         .join(_join_stream(pkg, env, [(("k", i % 3), 100 * i + 50) for i in range(20)]))
         .where(lambda v: v[0]).equal_to(lambda v: v[0])
         .window(pk.asg.TumblingEventTimeWindows.of(500))
         .apply(lambda l, r: (l[0], l[1], r[1])).collect())
        rt = pk.ex.JobRuntime(pk.tr.plan(env._sinks + getattr(env, "_roots", [])),
                              env.config, **pk.kw)
        rt.run()
        snap = pk.reg.metrics_snapshot(rt.registry.all_metrics())
        fam = {k.split(".", 3)[-1]: (snap[k], snap["__folds__"][k], snap["__kinds__"][k])
               for k in snap if k.rsplit(".", 1)[-1] in (
                   "joinRingOccupancy", "joinMatchesEmitted", "joinFallbackReason",
                   "stateBytes", "stateKeyCount", "numLateRecordsDropped",
                   "currentWatermark", "emissionLatencyMs")}
        out[pkg] = {k: (v if not isinstance(v, dict) else v["count"], f, kd)
                    for k, (v, f, kd) in fam.items()}
    assert out["port"] == out["jax"]
    leaves = {k.rsplit(".", 1)[-1]: v for k, v in out["port"].items()}
    assert leaves["joinFallbackReason"][1] == "max"
    assert leaves["joinRingOccupancy"][1] == leaves["joinMatchesEmitted"][1] == "sum"
    assert leaves["joinMatchesEmitted"][2] == "counter"


def test_sql_fused_selected_gauge_counts_the_join():
    out = {}
    for pkg, pk in PK.items():
        mod = "flink_tpu" if pkg == "jax" else "flink_tpu_torch"
        table_env = __import__(f"{mod}.table.table_env", fromlist=["TableEnvironment"])
        env = _join_env(pkg)
        tenv = table_env.TableEnvironment(env)
        tenv.from_rows("orders", [{"user": f"u{i % 3}", "amount": float(i), "rowtime": i * 100}
                                  for i in range(10)],
                       table_env.TableSchema(["user", "amount", "rowtime"], rowtime="rowtime"))
        tenv.from_rows("users", [{"user": f"u{i}", "city": f"city{i}", "ts": i * 100}
                                 for i in range(3)],
                       table_env.TableSchema(["user", "city", "ts"], rowtime="ts"))
        tenv.sql_query("SELECT a.user, b.city, a.amount FROM orders AS a "
                       "JOIN users AS b ON a.user = b.user "
                       "WHERE a.amount > 1 WINDOW TUMBLE(INTERVAL '10' SECOND)").collect()
        rt = pk.ex.JobRuntime(pk.tr.plan(env._sinks), env.config, **pk.kw)
        gauge = rt.registry.all_metrics().get("job.sqlFusedSelected")
        out[pkg] = None if gauge is None else gauge.value()
    assert out["port"] == out["jax"] == 1


# -- the observability.* keys --------------------------------------------

def test_every_ported_observability_key_is_the_jax_option():
    ported = {o.key: o for o in vars(tcfg.ObservabilityOptions).values()
              if isinstance(o, tcfg.ConfigOption)}
    jax = {o.key: o for o in vars(jcfg.ObservabilityOptions).values()
           if isinstance(o, jcfg.ConfigOption)}
    # observability.shipping.* came with the cluster: every key is
    # the port's now
    assert set(ported) == set(jax)
    for key, opt in ported.items():
        assert (opt.default, opt.type) == (jax[key].default, jax[key].type), key
        tcfg.Configuration({key: opt.default})


@pytest.mark.parametrize("key,value", [
    ("observability.device.enabled", False),
    ("observability.device.key-stats.top-k", 3),
    ("observability.profiler.enabled", True),
    ("observability.profiler.dir", "profiles"),
])
def test_device_plane_keys_are_accepted_and_read(key, value):
    """The device plane's keys (ROADMAP item D4, ported), which raised
    before: accepted, and read back as set."""
    conf = tcfg.Configuration({key: value})
    opt = next(o for o in vars(tcfg.ObservabilityOptions).values()
               if isinstance(o, tcfg.ConfigOption) and o.key == key)
    assert conf.get(opt) == value


@pytest.mark.parametrize("key,item", [
    # the cluster ships metrics at this interval (ported with the cluster,
    # tests/test_torch_cluster.py): accepted and read back as set (the
    # case keeps its original id)
    pytest.param("observability.shipping.interval-ms", None,
                 id="observability.shipping.interval-ms-item 14"),
    # the autoscaler and the mesh's autoscale are ported
    # (tests/test_torch_mesh_control.py runs them): accepted and read back
    # as set (the cases keep their original ids)
    pytest.param("autoscaler.enabled", None, id="autoscaler.enabled-item 13b"),
    pytest.param("autoscaler.policy", None, id="autoscaler.policy-item 13b"),
    pytest.param("parallel.mesh.autoscale", None, id="parallel.mesh.autoscale-item 13b"),
])
def test_unported_planes_still_raise_naming_their_item(key, item):
    if item is None:
        opt = next(o for cls in (tcfg.AutoscalerOptions, tcfg.ParallelOptions,
                                 tcfg.ObservabilityOptions)
                   for o in vars(cls).values()
                   if isinstance(o, tcfg.ConfigOption) and o.key == key)
        # a value other than the default, read back as set
        value = ("learning" if key == "autoscaler.policy" else
                 opt.default + 250 if opt.type is int else not opt.default)
        conf = tcfg.Configuration({key: value})
        assert conf.get(opt) == value and tcfg.Configuration().get(opt) != value
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A, {item}"):
        tcfg.Configuration({key: True})


def test_checkpoint_and_exception_history_sizes_are_read():
    conf = tcfg.Configuration({"observability.checkpoint-history.size": 2,
                               "observability.exception-history.size": 3,
                               "execution.checkpointing.interval": 1,
                               "execution.step.batch-size": BATCH,
                               "execution.state.key-capacity": KEYS})
    env, _sink = _api_job("port")
    env.config = conf
    client = env.execute_async()
    client.wait(120)
    assert client.checkpoint_stats._history_size == 2
    assert client.exceptions.entries.maxlen == 3
    assert len(client.checkpoint_stats.payload()["history"]) == 2


def test_restart_and_checkpoint_spans_match_jax(every_step_checkpoints):
    """One host failure at 60% of the input: the same JobRestart span (its
    attempt, delay, cause and restoredCheckpoint) and the same checkpoint
    spans in both packages, and the port's gauges read its live attempt."""
    from test_torch_checkpointing import N as CN, PK as CK, _job, _rows

    out = {}
    for pkg in PK:
        state = {"failed": False}

        def failing(base, state=state):
            def gen(idx):
                if not state["failed"] and idx[0] >= int(CN * 0.6):
                    state["failed"] = True
                    raise RuntimeError("injected host failure")
                return base(idx)
            return gen

        cfg = CK[pkg].cfg.Configuration({"execution.checkpointing.interval": 1,
                                         "restart-strategy.type": "fixed-delay",
                                         "restart-strategy.initial-backoff": 1})
        env, sink = _job(pkg, "fused_count", gen=failing, config=cfg)
        client = env.execute_async("restart")
        client.wait(120)
        spans = client.span_log.spans
        restarts = [{k: v for k, v in s.attributes.items()} for s in spans
                    if (s.scope, s.name) == ("recovery", "JobRestart")]
        snap = PK[pkg].reg.metrics_snapshot(client.metrics.all_metrics())
        out[pkg] = (_rows(sink), client.num_restarts, restarts,
                    collections.Counter((s.scope, s.name, s.attributes.get("status"))
                                        for s in spans if s.scope == "checkpointing"),
                    snap["job.numRestarts"], snap["job.numberOfCompletedCheckpoints"],
                    snap["job.numRecordsIn"])
    port, jax = out["port"], out["jax"]
    assert port[:6] == jax[:6]
    assert port[1] == 1 and port[2][0]["restoredCheckpoint"] is True
    # the port's job gauge reads the live attempt (restored, then run to
    # the end); the JAX one still reads the dead first attempt
    assert port[6] == CN and jax[6] < CN
