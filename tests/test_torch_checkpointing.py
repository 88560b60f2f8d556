"""Job checkpoints, restart strategies and savepoints on the port, held
against the JAX package (`flink_tpu/checkpoint/`, `runtime/minicluster.py`,
`tests/test_checkpointing.py`).

Both packages run on the CPU (the port with device="cpu"), fed the same
numpy-made inputs. Storage, restart strategies and the coordinator run
side by side on injected clocks; job captures taken at the same step
boundary are compared array for array; a capture of either package is
restored into the other's runtime and run to the end; the five scenarios
of tests/test_checkpointing.py run on the port's MiniCluster. Every wait is
on a threading.Event: no sleep, no wall-clock ratio.

Tolerance: exact (rows are integer counts and integer-valued sums).
"""

import dataclasses
import os
import pickle
import threading
import types
from collections import Counter

import numpy as np
import pytest

pytest.importorskip("jax")

import flink_tpu.api.datastream as jds
import flink_tpu.api.windowing.assigners as jasg
import flink_tpu.api.windowing.triggers as jtrig
import flink_tpu.checkpoint.coordinator as jco
import flink_tpu.checkpoint.restart as jrs
import flink_tpu.checkpoint.storage as jst
import flink_tpu.config as jcfg
import flink_tpu.connectors.sink as jsink
import flink_tpu.connectors.source as jsrc
import flink_tpu.core.watermarks as jwm
import flink_tpu.graph.transformation as jtr
import flink_tpu.metrics.checkpoint_stats as jstats
import flink_tpu.runtime.executor as jex
import flink_tpu.utils.arrays as jarr

import flink_tpu_torch.api.datastream as tds
import flink_tpu_torch.api.windowing.assigners as tasg
import flink_tpu_torch.api.windowing.triggers as ttrig
import flink_tpu_torch.checkpoint.coordinator as tco
import flink_tpu_torch.checkpoint.restart as trs
import flink_tpu_torch.checkpoint.storage as tst
import flink_tpu_torch.config as tcfg
import flink_tpu_torch.connectors.sink as tsink
import flink_tpu_torch.connectors.source as tsrc
import flink_tpu_torch.core.watermarks as twm
import flink_tpu_torch.graph.transformation as ttr
import flink_tpu_torch.metrics.checkpoint_stats as tstats
import flink_tpu_torch.runtime.executor as tex
import flink_tpu_torch.utils.arrays as tarr
from flink_tpu_torch.runtime.minicluster import JobStatus, MiniCluster
from jax_native_twins import jax_native_library  # noqa: E402,F401

PK = {
    "jax": types.SimpleNamespace(
        ds=jds, asg=jasg, trig=jtrig, co=jco, rs=jrs, st=jst, cfg=jcfg, sink=jsink, src=jsrc,
        wm=jwm, tr=jtr, stats=jstats, ex=jex, arr=jarr, dev={}),
    "port": types.SimpleNamespace(
        ds=tds, asg=tasg, trig=ttrig, co=tco, rs=trs, st=tst, cfg=tcfg, sink=tsink, src=tsrc,
        wm=twm, tr=ttr, stats=tstats, ex=tex, arr=tarr, dev={"device": "cpu"}),
}
BOTH = ("jax", "port")

# the shapes a job checkpoint crosses: the fused operator (host-keyed),
# the per-batch operator with lateness, device sessions, the global count
# window, the per-record oracle; each over a record or a numeric column
SHAPES = ("fused_count", "fused_sum", "per_batch_lateness", "session", "global_count",
          "oracle_reduce", "join_q8", "join_q8_degraded")
# two-source jobs: NEXMark q8's windowed equi-join on the device join ring,
# and the same with 8 key lanes for 13 keys, which degrades to the host
# join on the first batch (its captures are in host mode)
JOINS = ("join_q8", "join_q8_degraded")
N = 2400
BATCH = 80
KEYS = 13


def _gen(pk, columnar: bool):
    def gen(idx):
        ts = (idx * 11 + (idx % 5) * 3).astype(np.int64)
        if columnar:
            return pk.src.Batch((idx * 7919) % KEYS, ts)
        recs = [(int(i * 7919 % KEYS), float(i % 4), int(t)) for i, t in zip(idx, ts)]
        return pk.src.Batch(pk.arr.obj_array(recs), ts)

    return gen


def _job(pkg: str, shape: str, *, n=N, gen=None, sink=None, config=None):
    """(env, sink) of one job shape in one package; `gen` wraps the
    source's generator (failure injection, gates)."""
    pk = PK[pkg]
    cfg = config if config is not None else pk.cfg.Configuration()
    cfg.set(pk.cfg.ExecutionOptions.BATCH_SIZE, BATCH)
    if shape == "per_batch_lateness":
        cfg.set(pk.cfg.ExecutionOptions.FUSED_WINDOWS, False)
    if shape == "join_q8_degraded":
        cfg.set(pk.cfg.ExecutionOptions.KEY_CAPACITY, 8)
    env = pk.ds.StreamExecutionEnvironment(cfg, **pk.dev)
    base = _gen(pk, shape == "fused_count")
    source = pk.src.DataGeneratorSource(base if gen is None else gen(base), n, num_splits=3)
    ds = env.from_source(source, pk.wm.WatermarkStrategy.for_bounded_out_of_orderness(20))
    sink = sink if sink is not None else pk.sink.CollectSink()
    if shape in JOINS:
        def auctions(idx):
            ts = (idx * 11 + (idx % 7) * 2).astype(np.int64)
            recs = [(int(i * 31 % KEYS), -float(i % 3), int(t)) for i, t in zip(idx, ts)]
            return pk.src.Batch(pk.arr.obj_array(recs), ts)

        other = env.from_source(
            pk.src.DataGeneratorSource(auctions if gen is None else gen(auctions), n,
                                       num_splits=3),
            pk.wm.WatermarkStrategy.for_bounded_out_of_orderness(20))
        (ds.join(other).where(lambda r: r[0]).equal_to(lambda r: r[0])
         .window(pk.asg.TumblingEventTimeWindows.of(300))
         .apply(lambda p, a: (p[0], p[1], a[1], a[2])).sink_to(sink))
        return env, sink
    if shape == "fused_count":
        out = (ds.key_by(lambda c: c, vectorized=True)
               .window(pk.asg.SlidingEventTimeWindows.of(400, 100)).count())
    else:
        keyed = ds.key_by(lambda r: r[0])
        if shape == "fused_sum":
            out = keyed.window(pk.asg.TumblingEventTimeWindows.of(300)).sum(lambda r: r[1])
        elif shape == "per_batch_lateness":
            out = (keyed.window(pk.asg.SlidingEventTimeWindows.of(400, 200))
                   .allowed_lateness(100).count())
        elif shape == "session":
            out = keyed.window(pk.asg.EventTimeSessionWindows.with_gap(120)).count()
        elif shape == "global_count":
            out = (keyed.window(pk.asg.GlobalWindows.create())
                   .trigger(pk.trig.CountTrigger.of(7)).count())
        else:
            out = (keyed.window(pk.asg.TumblingEventTimeWindows.of(300))
                   .reduce(lambda a, b: (a[0], a[1] + b[1], b[2])))
    out.sink_to(sink)
    return env, sink


def _runtime(pkg: str, env):
    pk = PK[pkg]
    graph = pk.tr.plan(env._sinks)
    if pkg == "port":
        return pk.ex.JobRuntime(graph, env.config, "cpu")
    return pk.ex.JobRuntime(graph, env.config)


def _norm(v):
    """A row in plain Python values (numpy scalars unwrapped)."""
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    if hasattr(v, "item"):
        return v.item()
    return v


def _rows(sink):
    return sorted((_norm(r) for r in sink.results), key=repr)


class _Stop(Exception):
    pass


class _CaptureAt:
    """A stand-in coordinator: captures at the `at`-th step boundary and
    stops the run there."""

    def __init__(self, at: int):
        self.at, self.n, self.snap = at, 0, None

    def register_on_complete(self, fn):
        pass

    def unregister_on_complete(self, fn):
        pass

    def maybe_trigger(self, capture):
        self.n += 1
        if self.n == self.at:
            self.snap = capture()
            raise _Stop()


def _capture(pkg: str, shape: str, at: int) -> dict:
    env, _sink = _job(pkg, shape)
    grab = _CaptureAt(at)
    with pytest.raises(_Stop):
        _runtime(pkg, env).run(coordinator=grab)
    return grab.snap


def _assert_same(a, b, path="capture"):
    """Equal keys, equal values of equal types, numpy arrays equal in
    dtype, shape and content; dataclasses (splits, windows) by name and
    fields. Dict keys match by repr (a window key is each package's own
    TimeWindow class)."""
    if isinstance(a, dict):
        assert isinstance(b, dict), path
        ka, kb = {repr(k): k for k in a}, {repr(k): k for k in b}
        assert set(ka) == set(kb), (path, set(ka) ^ set(kb))
        for r, k in ka.items():
            _assert_same(a[k], b[kb[r]], f"{path}[{r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (path, a.dtype, b.dtype)
        if a.dtype == object:
            _assert_same(a.tolist(), b.tolist(), path)
        else:
            assert np.array_equal(a, b), path
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        _assert_same(dataclasses.asdict(a), dataclasses.asdict(b), path)
    else:
        assert type(a).__name__ == type(b).__name__ and a == b, (path, a, b)


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------

def _storages(tmp_path):
    return {pkg: {"memory": PK[pkg].st.MemoryCheckpointStorage(),
                  "fs": PK[pkg].st.FsCheckpointStorage(str(tmp_path / pkg))}
            for pkg in BOTH}


@pytest.mark.parametrize("kind", ["memory", "fs"])
def test_storage_roundtrip_and_listing_match_jax(tmp_path, kind):
    stores = _storages(tmp_path)
    seen = {}
    for pkg in BOTH:
        st = stores[pkg][kind]
        st.save(1, {"x": np.arange(5), "y": {"nested": [1, 2, 3]}})
        st.save(2, {"x": np.arange(3), "y": None})
        st.save(3, {"x": np.arange(2, dtype=np.float32)})
        ids = [cid for cid, _ in st.list_checkpoints()]
        cid, handle = st.latest()
        loaded = st.load(handle)
        st.discard(1)
        seen[pkg] = (ids, cid, loaded["x"].tolist(), loaded["x"].dtype.str,
                     [c for c, _ in st.list_checkpoints()], st.last_save_bytes > 0)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [1, 2, 3] and seen["port"][4] == [2, 3]


@pytest.mark.parametrize("kind", ["memory", "fs"])
def test_corrupt_checkpoint_raises_typed_error_in_both(tmp_path, kind):
    stores = _storages(tmp_path)
    for pkg in BOTH:
        st = stores[pkg][kind]
        st.save(1, {"v": 1})
        st.save(2, {"v": np.arange(100)})
        if kind == "fs":
            path = os.path.join(st.directory, "chk-2", "_metadata")
            with open(path, "r+b") as f:
                f.truncate(7)
        else:
            st._store[2] = st._store[2][:7]
        with pytest.raises(PK[pkg].st.CorruptCheckpointError):
            st.load(st.latest()[1])
        with pytest.raises(PK[pkg].st.CorruptCheckpointError):
            st.load("mem:9" if kind == "memory" else os.path.join(st.directory, "nope"))
        # the coordinator's rewind skips the torn checkpoint
        co = PK[pkg].co.CheckpointCoordinator(st, 1000)
        assert co.latest_snapshot() == {"v": 1}


def test_port_storage_refuses_tensors(tmp_path):
    import torch

    for st in (tst.MemoryCheckpointStorage(), tst.FsCheckpointStorage(str(tmp_path))):
        with pytest.raises(TypeError, match="numpy arrays and plain data"):
            st.save(1, {"runners": {"op": [np.zeros(2), {"ring": torch.zeros(3)}]}})
        assert st.list_checkpoints() == []


def test_jax_checkpoint_file_loads_through_the_class_mapping(tmp_path):
    snap = _capture("jax", "fused_sum", 9)
    jst.FsCheckpointStorage(str(tmp_path)).save(4, snap)
    port_store = tst.FsCheckpointStorage(str(tmp_path))
    cid, handle = port_store.latest()
    loaded = port_store.load(handle)
    assert cid == 4
    split = loaded["sources"][next(iter(loaded["sources"]))]["current_split"]
    assert type(split) is tsrc.SourceSplit
    # the file's classes resolve to the port's, never to flink_tpu's
    assert "flink_tpu." not in pickle.dumps(loaded).decode("latin-1")
    # and the loaded capture continues to the uninterrupted run's rows
    env, sink = _job("port", "fused_sum")
    rt = _runtime("port", env)
    rt.restore(loaded)
    rt.run()
    ref_env, ref_sink = _job("jax", "fused_sum")
    ref_env.execute()
    assert _rows(sink) == _rows(ref_sink) and len(sink.results) > 0


@pytest.mark.parametrize("shape", JOINS)
def test_jax_join_checkpoint_file_loads_through_the_class_mapping(tmp_path, shape):
    """A JAX join capture in a checkpoint file (device mode, and host mode
    after a degrade) names no flink_tpu class beyond the mapped ones; the
    port loads it and runs on to the JAX job's rows."""
    import pickletools

    snap = _capture("jax", shape, 9)
    runner = next(v for k, v in snap["runners"].items() if k.startswith("window_join"))
    assert runner["mode"] == ("host" if shape == "join_q8_degraded" else "device")
    jst.FsCheckpointStorage(str(tmp_path)).save(3, snap)
    path = tmp_path / "chk-3" / "_metadata"
    named = {a for op, a, _p in pickletools.genops(path.read_bytes())
             if op.name in ("GLOBAL", "STACK_GLOBAL") and a}
    strings = [a for op, a, _p in pickletools.genops(path.read_bytes())
               if isinstance(a, str) and a.startswith("flink_tpu")]
    assert named <= {" ".join(k) for k in tst._JAX_CLASSES}
    assert set(strings) <= {m for m, _n in tst._JAX_CLASSES} | {
        n for _m, n in tst._JAX_CLASSES}, strings
    port_store = tst.FsCheckpointStorage(str(tmp_path))
    loaded = port_store.load(port_store.latest()[1])
    env, sink = _job("port", shape)
    rt = _runtime("port", env)
    rt.restore(loaded)
    rt.run()
    ref_env, ref_sink = _job("jax", shape)
    ref_env.execute()
    assert _rows(sink) == _rows(ref_sink) and len(sink.results) > 0


@pytest.mark.parametrize("foreign", ["flink_tpu.config.Configuration",
                                     "flink_tpu.runtime.executor.JobRuntime"])
def test_checkpoint_naming_another_flink_tpu_class_is_refused(tmp_path, foreign):
    module, name = foreign.rsplit(".", 1)
    # a pickle whose one GLOBAL opcode names the class: the unpickler must
    # refuse it at find_class, before anything is imported or built
    blob = b"\x80\x04c" + module.encode() + b"\n" + name.encode() + b"\n."
    path = tmp_path / "chk-1"
    path.mkdir()
    (path / "_metadata").write_bytes(blob)
    store = tst.FsCheckpointStorage(str(tmp_path))
    with pytest.raises(pickle.UnpicklingError, match=f"{module}.{name}"):
        store.load(store.latest()[1])
    with pytest.raises(pickle.UnpicklingError, match="does not map"):
        tst.loads(blob)


# ---------------------------------------------------------------------------
# restart strategies and the coordinator
# ---------------------------------------------------------------------------

RESTART_CONFIGS = {
    "none": {"restart-strategy.type": "none"},
    "fixed-delay": {"restart-strategy.type": "fixed-delay", "restart-strategy.max-attempts": 5,
                    "restart-strategy.initial-backoff": 7},
    "failure-rate": {"restart-strategy.type": "failure-rate",
                     "restart-strategy.max-attempts": 3},
    "exponential-delay": {"restart-strategy.type": "exponential-delay",
                          "restart-strategy.max-attempts": 9,
                          "restart-strategy.initial-backoff": 50,
                          "restart-strategy.max-backoff": 3000,
                          "restart-strategy.backoff-multiplier": "1.5"},
    "defaults": {},
}


@pytest.mark.parametrize("name", sorted(RESTART_CONFIGS))
def test_restart_strategy_from_config_gives_jax_delays(name, monkeypatch):
    delays = {}
    for pkg in BOTH:
        # failure-rate reads its clock at construction: a fixed clock, so
        # every failure lands inside the 60 s window
        monkeypatch.setattr(PK[pkg].rs.time, "monotonic", lambda: 100.0)
        strategy = PK[pkg].rs.restart_strategy_from_config(
            PK[pkg].cfg.Configuration(dict(RESTART_CONFIGS[name])))
        assert type(strategy).__name__.startswith(
            {"none": "No", "fixed-delay": "Fixed", "failure-rate": "Failure"}.get(
                name, "Exponential"))
        delays[pkg] = [strategy.next_delay_ms(a) for a in range(1, 13)]
    assert delays["port"] == delays["jax"]


@pytest.mark.parametrize("kind", ["fixed", "exponential", "failure_rate"])
def test_restart_strategies_match_jax_on_an_injected_clock(kind):
    out = {}
    for pkg in BOTH:
        rs = PK[pkg].rs
        clock = [0.0]
        if kind == "fixed":
            s = rs.FixedDelayRestartStrategy(4, 10)
        elif kind == "exponential":
            s = rs.ExponentialDelayRestartStrategy(10, 100, 1000, 2.0)
        else:
            s = rs.FailureRateRestartStrategy(2, 1000, 5, clock=lambda: clock[0])
        seq = []
        for attempt in range(1, 13):
            clock[0] = attempt * 0.4          # the window slides for failure-rate
            seq.append(s.next_delay_ms(attempt))
        out[pkg] = seq
    assert out["port"] == out["jax"]
    assert rs.NoRestartStrategy().next_delay_ms(1) is None


def _drive_coordinator(pkg: str, tolerable: int):
    """The same trigger sequence on an injected clock: captures fail at
    steps 3, 4, 5 and 9; retention 2. Returns what each step gave."""
    pk = PK[pkg]
    clock = [0.0]
    stats_clock = [1000.0]
    store = pk.st.MemoryCheckpointStorage()
    stats = pk.stats.CheckpointStatsTracker(history_size=4, clock=lambda: stats_clock[0])
    co = pk.co.CheckpointCoordinator(store, 100, max_retained=2, clock=lambda: clock[0],
                                     stats=stats, tolerable_failures=tolerable)
    completed = []
    co.register_on_complete(completed.append)
    trace = []
    for step in range(1, 13):
        clock[0] = step * 0.06
        stats_clock[0] += 1.0

        def capture(step=step):
            if step in (3, 4, 5, 9):
                raise OSError(f"disk full at {step}")
            return {"step": step, "arr": np.full(3, step)}

        try:
            got = co.maybe_trigger(capture)
            trace.append(("ok", got))
        except Exception as e:  # noqa: BLE001 — recorded, compared
            trace.append(("raised", type(e).__name__, str(e)))
    gauges = stats.gauge_values()
    return (trace, completed, [c for c, _ in store.list_checkpoints()],
            co.latest_snapshot(), co.num_completed, gauges)


@pytest.mark.parametrize("tolerable", [0, 1, 3])
def test_coordinator_trigger_tolerance_and_retention_match_jax(tolerable):
    port, jax = (_drive_coordinator(pkg, tolerable) for pkg in ("port", "jax"))
    _assert_same(port[0], jax[0], "trace")
    assert port[1:3] == jax[1:3]
    _assert_same(port[3], jax[3], "latest")
    assert port[4:] == jax[4:]


def test_coordinator_takes_no_traces():
    """The coordinator's lifecycle spans came with the metric planes: with
    `traces=` it reports the JAX coordinator's spans, a failed persist
    closing them FAILED, on the same injected clock."""
    import flink_tpu.metrics.traces as jtraces
    import flink_tpu_torch.metrics.traces as ttraces

    class FlakyStorage:
        def __init__(self, st):
            self.inner, self.calls = st.MemoryCheckpointStorage(), 0

        def save(self, cid, data):
            self.calls += 1
            if self.calls == 2:
                raise OSError("disk full")
            return self.inner.save(cid, data)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    out = {}
    for pkg, traces in (("jax", jtraces), ("port", ttraces)):
        pk = PK[pkg]
        mem = traces.InMemoryTraceReporter()
        reg = traces.TraceRegistry(trace_id="t" * 32)
        reg.add_reporter(mem)
        clock = [0.0]
        co = pk.co.CheckpointCoordinator(FlakyStorage(pk.st), 10, clock=lambda: clock[0],
                                          traces=reg, tolerable_failures=1)
        ids = []
        for _ in range(3):
            clock[0] += 0.02
            ids.append(co.maybe_trigger(lambda: {"x": np.arange(3)}))
        out[pkg] = (ids, [(s.scope, s.name, s.trace_id, s.attributes) for s in mem.spans])
    assert out["port"] == out["jax"]
    assert [a.get("status") for _sc, n, _t, a in out["port"][1] if n == "Checkpoint"] == [
        "COMPLETED", "FAILED", "COMPLETED"]


def test_exception_history_and_root_cause_match_jax():
    out = {}
    for pkg in BOTH:
        stats = PK[pkg].stats
        h = stats.ExceptionHistory(size=2, clock=lambda: 5.0)
        try:
            try:
                raise KeyError("inner")
            except KeyError as e:
                raise RuntimeError("outer [chaos-injected:x]") from e
        except RuntimeError as e:
            h.record_failure(repr(e), task="op", restart_number=0, exception=e)
            chain = stats.root_cause_chain(e)
        h.begin_recovery(1, cause="c", events_at_failure=10)
        h.complete_recovery(restored_checkpoint_id=3, restore_duration_ms=1.5,
                            events_replayed=4)
        out[pkg] = (h.payload(), h.gauge_values(), chain)
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# job captures across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_capture_at_the_same_step_equals_jax(shape):
    jax_snap = _capture("jax", shape, 13)
    port_snap = _capture("port", shape, 13)
    assert port_snap["records_in"] == 13 * BATCH
    _assert_same(jax_snap, port_snap)


def _to_jax(obj):
    """The JAX package's restore takes its own windows and splits: map the
    port's (as tests/test_torch_oracle_window_operator.py does); the port's
    restore maps the JAX package's itself."""
    if isinstance(obj, dict):
        return {_to_jax(k): _to_jax(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_jax(v) for v in obj)
    if isinstance(obj, np.ndarray) and obj.dtype == object:
        return jarr.obj_array([_to_jax(v) for v in obj])
    if type(obj).__name__ == "TimeWindow" and type(obj).__module__.startswith("flink_tpu_torch"):
        import flink_tpu.core.time as jtime

        return jtime.TimeWindow(obj.start, obj.end)
    if type(obj) is tsrc.SourceSplit:
        return jsrc.SourceSplit(obj.split_id, _to_jax(obj.payload))
    return obj


@pytest.mark.parametrize("direction", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("shape", SHAPES)
def test_cross_restore_continues_to_the_other_package_rows(shape, direction):
    src, dst = direction
    snap = _capture(src, shape, 17)
    if dst == "jax":
        snap = _to_jax(snap)
    env, sink = _job(dst, shape)
    rt = _runtime(dst, env)
    rt.restore(snap)
    rt.run()
    ref_env, ref_sink = _job(src, shape)
    ref_env.execute()
    assert rt.records_in == N * (2 if shape in JOINS else 1)
    assert len(sink.results) > 0 and _rows(sink) == _rows(ref_sink)


# ---------------------------------------------------------------------------
# tests/test_checkpointing.py's scenarios on the port's MiniCluster
# ---------------------------------------------------------------------------

def _gen_source(count=2000, keys=7, hook=None):
    def gen(idx):
        if hook is not None:
            hook(idx)
        values = [(int(i % keys), 1.0, int(i * 10)) for i in idx]
        return tsrc.Batch(tarr.obj_array(values), (idx * 10).astype(np.int64))

    return tsrc.DataGeneratorSource(gen, count=count, num_splits=8)


def _pipeline(env, fail_once_at=None, sink_dir=None, source=None):
    """keyed tumbling count over the datagen source; an optional one-shot
    failure injected in a map function."""
    state = {"failed": False}

    def maybe_fail(x):
        if fail_once_at is not None and not state["failed"] and x[2] >= fail_once_at:
            state["failed"] = True
            raise RuntimeError("injected failure")
        return x

    stream = env.from_source(source or _gen_source(),
                             watermark_strategy=twm.WatermarkStrategy.for_monotonous_timestamps())
    (stream.map(maybe_fail).key_by(lambda x: x[0])
     .window(tasg.TumblingEventTimeWindows.of(1000)).count()
     .sink_to(tsink.FileSink(sink_dir, prefix="out")))
    return env


def _read_results(sink_dir):
    lines = []
    for name in sorted(os.listdir(sink_dir)):
        if name.startswith("."):
            continue
        with open(os.path.join(sink_dir, name)) as f:
            lines.extend(ln for ln in f.read().splitlines() if ln)
    return sorted(lines)


def _expected_results(count=2000):
    c = Counter()
    for i in range(count):
        c[(i % 7, (i * 10) // 1000)] += 1
    return sorted(f"({k}, {v})" for (k, _w), v in c.items())


def test_exactly_once_crash_recovery(tmp_path):
    sink_dir = str(tmp_path / "out")
    chk_dir = str(tmp_path / "chk")
    config = tcfg.Configuration()
    config.set(tcfg.CheckpointingOptions.INTERVAL_MS, 1)       # checkpoint every step
    config.set(tcfg.CheckpointingOptions.DIRECTORY, chk_dir)
    config.set(tcfg.ExecutionOptions.BATCH_SIZE, 100)
    config.set(tcfg.RestartOptions.INITIAL_BACKOFF_MS, 1)
    env = tds.StreamExecutionEnvironment(config, device="cpu")
    _pipeline(env, fail_once_at=12_000, sink_dir=sink_dir)
    client = env.execute_async("exactly-once")
    assert client.wait(60) == JobStatus.FINISHED
    assert client.num_restarts == 1 and client.num_checkpoints > 1
    assert _read_results(sink_dir) == _expected_results()
    assert tst.FsCheckpointStorage(chk_dir).list_checkpoints()
    restored = client.checkpoint_stats.payload()["latest"]["restored"]["checkpoint_id"]
    assert restored is not None and restored >= 1
    (rec,) = client.exceptions.payload()["recoveries"]
    assert rec["restored_checkpoint_id"] == restored and "injected failure" in rec["cause"]
    # the kept error's frames were cleared: it holds no runtime
    tb = client.error.__traceback__
    while tb is not None:
        assert "runtime" not in tb.tb_frame.f_locals
        tb = tb.tb_next


def test_no_restart_fails_job(tmp_path):
    config = tcfg.Configuration()
    config.set(tcfg.RestartOptions.STRATEGY, "none")
    env = tds.StreamExecutionEnvironment(config, device="cpu")
    _pipeline(env, fail_once_at=0, sink_dir=str(tmp_path / "out"))
    client = env.execute_async()
    with pytest.raises(RuntimeError, match="failed"):
        client.wait(30)
    assert client.status() == JobStatus.FAILED
    assert client.exceptions.latest()["exception"] == "RuntimeError('injected failure')"


def test_cancellation(tmp_path):
    config = tcfg.Configuration()
    config.set(tcfg.ExecutionOptions.BATCH_SIZE, 10)
    started, release = threading.Event(), threading.Event()

    def hook(idx):
        # the second batch holds the job until the test has cancelled it
        if idx[0] == 10:
            started.set()
            assert release.wait(30)

    env = tds.StreamExecutionEnvironment(config, device="cpu")
    stream = env.from_source(_gen_source(100_000, 3, hook),
                             watermark_strategy=twm.WatermarkStrategy.for_monotonous_timestamps())
    (stream.key_by(lambda x: x[0]).window(tasg.TumblingEventTimeWindows.of(1000)).count()
     .sink_to(tsink.FileSink(str(tmp_path / "out"))))
    client = env.execute_async()
    assert started.wait(30)
    client.cancel()
    release.set()
    assert client.wait(30) == JobStatus.CANCELED
    assert client.records_in < 100_000


def test_savepoint_and_resume(tmp_path):
    sp_path = str(tmp_path / "savepoint")
    config = tcfg.Configuration()
    config.set(tcfg.ExecutionOptions.BATCH_SIZE, 50)
    reached, go, taken = threading.Event(), threading.Event(), threading.Event()

    def hook(idx):
        # hold the first job at record 1500 until the savepoint is asked
        # for, and at record 2000 until it is written
        if idx[0] == 1500:
            reached.set()
            assert go.wait(30)
        elif idx[0] == 2000:
            assert taken.wait(30)

    source = _gen_source(4000, 7, hook)
    env = tds.StreamExecutionEnvironment(config, device="cpu")
    _pipeline(env, sink_dir=str(tmp_path / "out1"), source=source)
    client = env.execute_async("sp-source-job")
    assert reached.wait(30)
    writer = threading.Thread(target=lambda: client.trigger_savepoint(sp_path, timeout=30))
    writer.start()
    go.set()
    writer.join(30)
    client.cancel()
    taken.set()
    assert client.wait(30) == JobStatus.CANCELED
    # resume a NEW job from the savepoint
    sink2 = str(tmp_path / "out2")
    env2 = tds.StreamExecutionEnvironment(config, device="cpu")
    _pipeline(env2, sink_dir=sink2, source=source)
    client2 = MiniCluster.get_shared().submit(ttr.plan(env2._sinks), config, "resumed",
                                              savepoint_restore_path=sp_path, device="cpu")
    assert client2.wait(60) == JobStatus.FINISHED
    assert client2.records_in == 4000
    store = tst.FsCheckpointStorage(sp_path)
    sp_data = store.load(store.latest()[1])
    assert sp_data["savepoint"] is True
    assert 1500 <= sp_data["records_in"] < 2000
    # job 1 committed nothing (cancelled); job 2 emits each window at most
    # once (as a multiset of the uninterrupted run's lines), none lost
    # after the savepoint
    results2 = _read_results(sink2)
    assert 0 < len(results2) <= 7 * 40
    assert not Counter(results2) - Counter(_expected_results(4000))


def test_savepoint_from_the_jax_package_resumes_on_the_port(tmp_path):
    """A savepoint written by the JAX package's JobRuntime resumes as a
    port job on the MiniCluster, through the class mapping."""
    sp = str(tmp_path / "sp")
    env, _sink = _job("jax", "fused_count")
    rt = _runtime("jax", env)
    steps = []

    def savepoint_request():
        steps.append(1)
        if len(steps) == 11:
            rt._write_savepoint(sp)
            raise _Stop()

    with pytest.raises(_Stop):
        rt.run(savepoint_request=savepoint_request)
    env2, sink2 = _job("port", "fused_count")
    client = MiniCluster.get_shared().submit(ttr.plan(env2._sinks), env2.config, "from-jax",
                                             savepoint_restore_path=sp, device="cpu")
    assert client.wait(60) == JobStatus.FINISHED
    assert client.records_in == N
    ref_env, ref_sink = _job("jax", "fused_count")
    ref_env.execute()
    assert _rows(sink2) == _rows(ref_sink)


def test_storage_roundtrip(tmp_path):
    for storage in (tst.MemoryCheckpointStorage(), tst.FsCheckpointStorage(str(tmp_path / "c"))):
        data = {"x": np.arange(5), "y": {"nested": [1, 2, 3]}}
        storage.save(1, dict(data))
        storage.save(2, {"x": np.arange(3), "y": None})
        assert [cid for cid, _ in storage.list_checkpoints()] == [1, 2]
        cid, handle = storage.latest()
        assert cid == 2
        loaded = storage.load(handle)
        assert list(loaded["x"]) == [0, 1, 2]
        storage.discard(1)
        assert [cid for cid, _ in storage.list_checkpoints()] == [2]


@pytest.mark.parametrize("shape", SHAPES)
def test_every_shape_recovers_exactly_once_on_the_minicluster(tmp_path, shape):
    """One host failure in the source at ~60% of the input, checkpoints
    every step into a directory: the recovered job's collected rows equal
    an uninterrupted run's (the sink's rows before the cut ride the
    checkpoint)."""
    state = {"failed": False}

    def failing(base):
        def gen(idx):
            if not state["failed"] and idx[0] >= int(N * 0.6):
                state["failed"] = True
                raise RuntimeError("injected host failure")
            return base(idx)
        return gen

    cfg = tcfg.Configuration({"execution.checkpointing.interval": 1,
                              "execution.checkpointing.dir": str(tmp_path / "chk"),
                              "restart-strategy.type": "fixed-delay",
                              "restart-strategy.initial-backoff": 1})
    env, sink = _job("port", shape, gen=failing, config=cfg)
    client = env.execute_async(shape)
    assert client.wait(120) == JobStatus.FINISHED
    assert client.num_restarts == 1 and client.records_in == N * (2 if shape in JOINS else 1)
    ref_env, ref_sink = _job("port", shape)
    ref_env.execute()
    assert len(sink.results) > 0 and _rows(sink) == _rows(ref_sink)


def test_tiered_job_checkpoints_incrementally_and_recovers(tmp_path):
    """api_tiered's zipf-like churn at a small size through the
    coordinator: a checkpoint every step is a (base, offset) changelog
    handle, one host failure restores from it, and the rows equal the
    untiered job's; the median interval changelog bytes stay below a
    quarter of the base (millikey_microbench's incremental_ratio bar)."""
    import statistics

    from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator

    n, keys = 1 << 13, 4000
    state = {"failed": False}

    def source(fail: bool):
        def gen(idx):
            if fail and not state["failed"] and idx[0] >= int(n * 0.6):
                state["failed"] = True
                raise RuntimeError("injected host failure")
            # log-uniform keys (zipf-like, s = 1): hot keys repeat, the
            # tail churns the hot tier
            k = (np.float64(keys) ** ((idx * 0.6180339887) % 1.0)).astype(np.int64) - 1
            return tsrc.Batch(k, (10_000 + idx * 4).astype(np.int64))
        return tsrc.DataGeneratorSource(gen, n)

    def job(tiered: bool):
        conf = {"execution.step.batch-size": 256, "execution.state.key-capacity": keys}
        if tiered:
            conf.update({"state.tier.enabled": True, "state.tier.hot-key-capacity": 256,
                         "state.tier.admission-min-count": 2,
                         "state.tier.cold-dir": str(tmp_path / "cold"),
                         "state.changelog.enabled": True,
                         "state.changelog.dir": str(tmp_path / "changelog"),
                         "execution.checkpointing.interval": 1,
                         "execution.checkpointing.dir": str(tmp_path / "chk"),
                         "restart-strategy.type": "fixed-delay",
                         "restart-strategy.initial-backoff": 1})
        env = tds.StreamExecutionEnvironment(tcfg.Configuration(conf), device="cpu")
        sink = tsink.CollectSink()
        (env.from_source(source(tiered), twm.WatermarkStrategy.for_bounded_out_of_orderness(0))
         .key_by(lambda c: c, vectorized=True)
         .window(tasg.SlidingEventTimeWindows.of(2000, 500)).count().sink_to(sink))
        return env, sink

    env, sink = job(True)
    client = env.execute_async("tiered")
    assert client.wait(120) == JobStatus.FINISHED
    assert client.num_restarts == 1
    ops = [r.op for r in client._runtime.runners
           if isinstance(getattr(r, "op", None), FusedWindowOperator)]
    assert ops[0].tier_payload()["evictions"] > 0
    tier = ops[0].tier
    store = tst.FsCheckpointStorage(str(tmp_path / "chk"))
    snap = store.load(store.latest()[1])
    (runner_snap,) = [r for r in snap["runners"].values() if "operator" in r]
    assert "tier_changelog" in runner_snap["operator"]
    ratio = statistics.median(tier.interval_bytes_history) / tier.last_base_bytes()
    assert ratio < 0.25, ratio
    ref_env, ref_sink = job(False)
    ref_env.execute()
    assert sorted(sink.results) == sorted(ref_sink.results) and len(sink.results) > 0


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------

def _options(cls):
    return {v.key: v.default for v in vars(cls).values() if hasattr(v, "key")}


@pytest.mark.parametrize("group", ["CheckpointingOptions", "RestartOptions"])
def test_every_checkpointing_and_restart_key_is_accepted_with_jax_defaults(group):
    jax_opts, port_opts = _options(getattr(jcfg, group)), _options(getattr(tcfg, group))
    assert port_opts == jax_opts
    for key, default in jax_opts.items():
        tcfg.Configuration({key: default if default is not None else "x"})


@pytest.mark.parametrize("key", ["state.checkpoints.dir", "state.savepoints.dir",
                                 "state.checkpoints.num-retained"])
def test_state_checkpoint_keys_raise_as_unknown(key):
    with pytest.raises(NotImplementedError) as info:
        tcfg.Configuration({key: "/tmp/x"})
    assert "the module that reads it" in str(info.value)
    assert "item 16" not in str(info.value)


@pytest.mark.parametrize("key,item", [
    ("chaos.enabled", "item 14"), ("security.ssl.internal.enabled", "item 14"),
    # the autoscaler moved to item 13b with the rest of the mesh (the case
    # keeps its original id)
    pytest.param("autoscaler.enabled", "item 13b", id="autoscaler.enabled-item 15")])
def test_minicluster_planes_still_deferred_raise_naming_their_item(key, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A, {item}"):
        tcfg.Configuration({key: True})


@pytest.mark.parametrize("call,item", [
    # the reports are ported (tests/test_torch_observability.py runs them
    # on jobs): before its job thread wires the planes a client returns the
    # JAX client's empty reports (the cases keep their original ids)
    pytest.param("latency_report", None, id="latency_report-item 15"),
    pytest.param("history_report", None, id="history_report-item 15"),
    pytest.param("doctor_report", None, id="doctor_report-item 15"),
    ("rescale_mesh", "item 13"), ("security", "item 14")])
def test_minicluster_surfaces_still_deferred_raise(call, item):
    from flink_tpu.runtime.minicluster import JobClient as JaxJobClient
    from flink_tpu_torch.runtime.minicluster import JobClient

    if item is None:
        assert getattr(JobClient("j", "n"), call)() == getattr(JaxJobClient("j", "n"), call)()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A, {item}"):
        if call == "security":
            MiniCluster(security=object())
        elif call == "rescale_mesh":
            # rescale_mesh itself is ported (test_torch_multichip_runtime.py
            # runs it); its sibling, the device-loss degrade of a mesh job,
            # is still queued
            JobClient("j", "n").rescale_mesh(2)
            tcfg.Configuration({"parallel.mesh.degrade-on-device-loss": True})
        else:
            getattr(JobClient("j", "n"), call)()


def test_a_failed_attempt_releases_its_operators(tmp_path, monkeypatch):
    """After a restart nothing keeps the failed attempt's pipeline (and so
    its rings) alive: not the kept error's frames, not the coordinator."""
    import weakref

    import flink_tpu_torch.runtime.fused_window_pipeline as tfp

    pipes = []
    init = tfp.FusedWindowPipeline.__init__

    def tracked(self, *a, **kw):
        init(self, *a, **kw)
        pipes.append(weakref.ref(self))

    monkeypatch.setattr(tfp.FusedWindowPipeline, "__init__", tracked)
    state = {"failed": False}

    def failing(base):
        def gen(idx):
            if not state["failed"] and idx[0] >= int(N * 0.6):
                state["failed"] = True
                raise RuntimeError("injected host failure")
            return base(idx)
        return gen

    cfg = tcfg.Configuration({"execution.checkpointing.interval": 1,
                              "execution.checkpointing.dir": str(tmp_path / "chk"),
                              "restart-strategy.type": "fixed-delay",
                              "restart-strategy.initial-backoff": 1})
    env, sink = _job("port", "fused_count", gen=failing, config=cfg)
    client = env.execute_async("release")
    assert client.wait(60) == JobStatus.FINISHED and client.num_restarts == 1
    assert len(pipes) == 2
    assert pipes[0]() is None and pipes[1]() is not None
    assert "injected host failure" in repr(client.error)
