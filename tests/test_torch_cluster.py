"""The port's distributed cluster held against the JAX package's.

Twins of tests/test_distributed.py and tests/test_slot_sharing.py: each
scenario runs on the JAX package's JobManager and TaskExecutors and on the
port's (TaskExecutors on device="cpu"), over the same spec built in each
package, and the two clusters' rows must be equal (and equal to the
oracle the JAX tests use). The JAX side runs `operator="oracle"` specs
and the JAX tests' own sizes, so no heavy JAX compile enters the run.
Heartbeat intervals are the JAX tests' short ones; the TaskExecutor-loss
scenarios time a beat out after 3 s where the JAX tests take 1.2-1.5 s
(under six test workers a live TaskExecutor's beats lagged past 1.2 s and
it was declared lost too). Every wait has a deadline. Each package's
planes run with one ephemeral secret.
"""

import os
import time

import numpy as np
import pytest

pytest.importorskip("jax")

import flink_tpu.runtime.cluster as jcl  # noqa: E402
import flink_tpu.runtime.rpc as jrpc  # noqa: E402
import flink_tpu_torch.runtime.cluster as tcl  # noqa: E402
import flink_tpu_torch.runtime.rpc as trpc  # noqa: E402
from flink_tpu.testing import harness as jharness  # noqa: E402
from flink_tpu_torch.testing import harness as tharness  # noqa: E402

PKGS = {
    "jax": dict(cl=jcl, rpc=jrpc, harness=jharness, te_kw={}, root="flink_tpu"),
    "port": dict(cl=tcl, rpc=trpc, harness=tharness, te_kw={"device": "cpu"},
                 root="flink_tpu_torch"),
}


def _mod(pkg, name):
    import importlib

    return importlib.import_module(f"{PKGS[pkg]['root']}.{name}")


class _Cluster:
    """A JobManager and TaskExecutors of one package, stopped on exit."""

    def __init__(self, pkg, *, n_tms=1, slots=1, tm_kw=None, **jm_kw):
        p = PKGS[pkg]
        self.pkg, self.p = pkg, p
        self.sec = p["harness"].ephemeral_transport_security()
        self.svcs = [p["rpc"].RpcService(security=self.sec)]
        jm_kw.setdefault("heartbeat_interval", 0.2)
        jm_kw.setdefault("heartbeat_timeout", 10.0)
        self.jm = p["cl"].JobManagerEndpoint(self.svcs[0], **jm_kw)
        self.tes = []
        for _ in range(n_tms):
            self.add_tm(slots, **(tm_kw or {}))
        self.client = self.svcs[0].gateway(self.svcs[0].address, "jobmanager")

    def add_tm(self, slots=1, **kw):
        svc = self.p["rpc"].RpcService(security=self.sec)
        te = self.p["cl"].TaskExecutorEndpoint(svc, slots=slots, **self.p["te_kw"], **kw)
        te.connect(self.svcs[0].address)
        self.svcs.append(svc)
        self.tes.append(te)
        return te

    def kill_tm(self, te):
        i = self.tes.index(te)
        te.stop()
        self.svcs[i + 1].stop()

    def wait(self, job_id, done=("FINISHED", "FAILED"), timeout=60.0):
        deadline = time.time() + timeout
        st = None
        while time.time() < deadline:
            st = self.client.job_status(job_id)
            if st["status"] in done:
                return st
            time.sleep(0.1)
        raise AssertionError(f"timed out waiting for {done}: {st}")

    def wait_for(self, predicate, timeout, what):
        deadline = time.time() + timeout
        while time.time() < deadline:
            got = predicate()
            if got:
                return got
            time.sleep(0.1)
        raise AssertionError(f"timed out waiting for {what}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for te in self.tes:
            te.stop()
        self.jm.heartbeats.stop()
        for s in self.svcs:
            s.stop()


def _collect(result):
    return {(k, tuple(w)[0]): r for k, w, r, _ in result}


def _spec(pkg, factory, assigner=None, **kw):
    A = _mod(pkg, "api.windowing.assigners")
    return PKGS[pkg]["cl"].DistributedJobSpec(
        name=kw.pop("name", "dist"), source_factory=factory,
        assigner=assigner(A) if assigner else A.TumblingEventTimeWindows.of(2000),
        aggregate=kw.pop("aggregate", "sum"), max_parallelism=16, **kw)


def _expected(pkg, spec, parallelism):
    """The workload through one oracle operator (test_distributed._expected)."""
    agg = _mod(pkg, "ops.aggregators").resolve(spec.aggregate).python_equivalent()
    op = _mod(pkg, "runtime.oracle_window_operator").OracleWindowOperator(
        spec.assigner, agg, max_parallelism=spec.max_parallelism)
    shard_batches = [spec.source_factory(i, parallelism) for i in range(parallelism)]
    for s in range(len(shard_batches[0])):
        wms = []
        for b in shard_batches:
            keys, vals, ts, wm = b[s]
            for i in range(len(keys)):
                op.process_record(keys[i], float(vals[i]), int(ts[i]))
            wms.append(wm)
        op.process_watermark(min(wms))
    op.process_watermark((1 << 63) - 1)
    return {(k, w.start): r for k, w, r, _ in op.drain_output()}


def _wordcount(n_steps=6, batch=40, n_keys=7):
    def source_factory(shard, num_shards):
        rng = np.random.default_rng(100 + shard)
        batches = []
        for s in range(n_steps):
            keys = np.asarray([f"k{v}" for v in rng.integers(0, n_keys, batch)], dtype=object)
            vals = np.ones(batch, dtype=np.float64)
            ts = (s * 1000 + rng.integers(0, 1000, batch)).astype(np.int64)
            batches.append((keys, vals, ts, s * 1000 + 500))
        return batches

    return source_factory


class _SlowList(list):
    """Source batches that pace the step loop (picklable)."""

    def __init__(self, items, delay):
        super().__init__(items)
        self.delay = delay

    def __getitem__(self, i):
        time.sleep(self.delay)
        return super().__getitem__(i)


class _GatedList(list):
    """Batches paced lightly, blocking at `gate_step` until `resume_flag`
    exists (the test decides when the stream may end)."""

    def __init__(self, items, gate_step, resume_flag, delay=0.08):
        super().__init__(items)
        self.gate_step, self.resume_flag, self.delay = gate_step, resume_flag, delay

    def __getitem__(self, i):
        time.sleep(self.delay)
        if i >= self.gate_step:
            deadline = time.time() + 120
            while not os.path.exists(self.resume_flag):
                if time.time() > deadline:
                    raise RuntimeError("resume flag never appeared")
                time.sleep(0.05)
        return super().__getitem__(i)


# ---------------------------------------------------------------------------
# DistributedJobSpec twins
# ---------------------------------------------------------------------------

def test_end_to_end_on_two_task_executors():
    got = {}
    for pkg in PKGS:
        spec = _spec(pkg, _wordcount())
        with _Cluster(pkg, n_tms=2) as c:
            job = c.client.submit_job(spec.to_bytes(), 2)
            st = c.wait(job, timeout=30)
            assert st["status"] == "FINISHED", st
            got[pkg] = _collect(c.client.job_result(job))
        assert got[pkg] == _expected(pkg, spec, 2)
    assert got["port"] == got["jax"] and got["port"]


def test_checkpointed_failover_is_exactly_once(tmp_path):
    """A TaskExecutor is stopped after a completed checkpoint; the job
    restarts on a replacement and its rows equal the JAX cluster's."""
    got = {}
    for pkg in PKGS:
        base = _wordcount(n_steps=40, batch=30)

        def slow(shard, num_shards, _base=base):
            return _SlowList(_base(shard, num_shards), delay=0.05)

        spec = _spec(pkg, slow)
        with _Cluster(pkg, n_tms=2, checkpoint_dir=str(tmp_path / pkg / "chk"),
                      restart_attempts=3, restart_delay=0.2, heartbeat_timeout=3.0,
                      adaptive=False) as c:
            job = c.client.submit_job(spec.to_bytes(), 2)
            c.wait_for(lambda: c.client.trigger_checkpoint(job)
                       and c.client.job_status(job)["checkpoints"], 30, "a checkpoint")
            c.kill_tm(c.tes[1])
            c.add_tm()
            st = c.wait(job, timeout=60)
            assert st["status"] == "FINISHED" and st["restarts"] >= 1, st
            got[pkg] = _collect(c.client.job_result(job))
            exc = c.client.job_exceptions(job)
            assert exc["recoveries"][-1]["restored_checkpoint_id"] is not None
            assert c.client.job_checkpoints(job)["counts"]["completed"] >= 1
        assert got[pkg] == _expected(pkg, _spec(pkg, _wordcount(n_steps=40, batch=30)), 2)
    assert got["port"] == got["jax"]


def test_savepoint_and_resubmit(tmp_path):
    got = {}
    for pkg in PKGS:
        def slow_source(shard, num_shards):
            rng = np.random.default_rng(100 + shard)
            batches = []
            for s in range(600):
                keys = np.asarray([f"k{v}" for v in rng.integers(0, 5, 30)], dtype=object)
                ts = (s * 500 + rng.integers(0, 500, 30)).astype(np.int64)
                batches.append((keys, np.ones(30), ts, s * 500 + 250))
            return _SlowList(batches, delay=0.001)

        spec = _spec(pkg, slow_source, name="savepointed")
        sp_dir = str(tmp_path / pkg / "sp")
        with _Cluster(pkg, n_tms=1, slots=2) as c:
            job = c.client.submit_job(spec.to_bytes(), 2)
            cp = c.wait_for(lambda: c.client.job_status(job)["status"] == "RUNNING"
                            and c.client.trigger_savepoint(job, sp_dir), 30, "a savepoint")
            assert cp is not None
            c.wait_for(lambda: c.client.job_status(job)["savepoints"], 30, "the savepoint")
            c.client.cancel_job(job)
            job2 = c.client.submit_job(spec.to_bytes(), 2, sp_dir)
            st = c.wait(job2, timeout=40)
            assert st["status"] == "FINISHED", st
            got[pkg] = _collect(c.client.job_result(job2))
        assert got[pkg] == _expected(pkg, spec, 2)
    assert got["port"] == got["jax"]


def _partition_invariant(n_steps=30, batch=60, n_keys=9):
    def source_factory(shard, num_shards):
        out = []
        for s in range(n_steps):
            rng = np.random.default_rng(1000 + s)
            keys = np.asarray([f"k{v}" for v in rng.integers(0, n_keys, batch)], dtype=object)
            ts = (s * 1000 + rng.integers(0, 1000, batch)).astype(np.int64)
            sl = slice(shard, None, num_shards)
            out.append((keys[sl], np.ones(batch)[sl], ts[sl], s * 1000 + 500))
        return out

    return source_factory


def test_rescales_down_after_task_executor_loss(tmp_path):
    """No replacement joins: the adaptive scheduler restarts the job at
    parallelism 1 from the checkpoint, re-sharding state by key group."""
    got = {}
    for pkg in PKGS:
        resume = str(tmp_path / f"resume-{pkg}")
        base = _partition_invariant()

        def gated(shard, num_shards, _base=base, _resume=resume):
            return _GatedList(_base(shard, num_shards), gate_step=20, resume_flag=_resume)

        spec = _spec(pkg, gated, name="rescale-job")
        with _Cluster(pkg, n_tms=2, tm_kw={"shipping_interval_ms": 200},
                      checkpoint_dir=str(tmp_path / pkg / "chk"), restart_attempts=3,
                      restart_delay=0.3, heartbeat_timeout=3.0) as c:
            job = c.client.submit_job(spec.to_bytes(), 2)
            c.wait_for(lambda: c.client.trigger_checkpoint(job)
                       and c.client.job_status(job)["checkpoints"], 60, "a checkpoint")
            c.kill_tm(c.tes[1])
            c.wait_for(lambda: (lambda s: s["restarts"] >= 1 and s["status"] == "RUNNING"
                                and s["parallelism"] == 1)(c.client.job_status(job)),
                       60, "the rescale to one task executor")
            open(resume, "w").close()
            st = c.wait(job, timeout=90)
            assert st["status"] == "FINISHED" and st["parallelism"] == 1, st
            got[pkg] = _collect(c.client.job_result(job))
        assert got[pkg] == _expected(pkg, _spec(pkg, _partition_invariant()), 1)
    assert got["port"] == got["jax"]


def test_local_recovery_restores_from_the_task_executor_copy(tmp_path):
    got, local = {}, {}
    for pkg in PKGS:
        flag = str(tmp_path / f"failed-once-{pkg}")

        def batches():
            rng = np.random.default_rng(500)
            out = []
            for s in range(14):
                keys = np.asarray([f"k{v}" for v in rng.integers(0, 5, 40)], dtype=object)
                ts = (s * 1000 + rng.integers(0, 1000, 40)).astype(np.int64)
                out.append((keys, np.ones(40), ts, s * 1000 + 500))
            return out

        def source_factory(shard, num_shards, _flag=flag, _batches=batches):
            import os as _os

            class _FailOnce(list):
                def __getitem__(self, i):
                    time.sleep(0.1)
                    if i >= 10 and not _os.path.exists(_flag):
                        open(_flag, "w").write("x")
                        raise RuntimeError("injected task failure")
                    return list.__getitem__(self, i)

            return _FailOnce(_batches())

        spec = _spec(pkg, source_factory, name="local-recovery")
        with _Cluster(pkg, n_tms=1, checkpoint_dir=str(tmp_path / pkg / "chk"),
                      restart_attempts=3, restart_delay=0.2, heartbeat_timeout=5.0) as c:
            job = c.client.submit_job(spec.to_bytes(), 1)
            c.wait_for(lambda: c.client.trigger_checkpoint(job)
                       and c.client.job_status(job)["checkpoints"], 20, "a checkpoint")
            st = c.wait(job, timeout=60)
            assert st["status"] == "FINISHED" and st["restarts"] >= 1, st
            local[pkg] = c.tes[0].num_local_restores
            got[pkg] = _collect(c.client.job_result(job))
        assert got[pkg] == _expected(pkg, _spec(pkg, lambda s, n, _b=batches: _b()), 1)
    assert local["port"] >= 1 and local["jax"] >= 1
    assert got["port"] == got["jax"]


def test_device_session_operator_on_two_shards():
    """The port's TpuSessionWindowOperator (K3/K4's plain versions on the
    CPU) per shard against the JAX cluster's oracle operator."""
    gap = 1000

    def source_factory(shard, num_shards):
        rng = np.random.default_rng(50 + shard)
        batches, t = [], 0
        for s in range(6):
            keys = np.asarray([f"k{v}" for v in rng.integers(0, 6, 30)], dtype=object)
            ts = (t + rng.integers(0, 600, 30)).astype(np.int64)
            batches.append((keys, np.ones(30), ts, t + 300))
            t += 600 + (gap * 2 if s % 2 else 0)
        return batches

    got = {}
    for pkg, operator in (("port", "device"), ("jax", "oracle")):
        spec = _spec(pkg, source_factory, name=f"sessions-{operator}", operator=operator,
                     assigner=lambda A: A.EventTimeSessionWindows.with_gap(gap))
        with _Cluster(pkg, n_tms=2) as c:
            job = c.client.submit_job(spec.to_bytes(), 2)
            st = c.wait(job, timeout=40)
            assert st["status"] == "FINISHED", st
            got[pkg] = sorted((k, tuple(w), round(float(r), 4))
                              for k, w, r, _ in c.client.job_result(job))
    assert got["port"] == got["jax"] and got["port"]


# ---------------------------------------------------------------------------
# GraphJobSpec twins: a general graph with failover, and two stages
# ---------------------------------------------------------------------------

def _graph_job(pkg, flag, inject, n=40):
    """test_distributed's union -> map -> keyed tumbling count graph."""
    ds = _mod(pkg, "api.datastream")
    cfg_mod = _mod(pkg, "config")
    A = _mod(pkg, "api.windowing.assigners")
    W = _mod(pkg, "core.watermarks")
    conf = cfg_mod.Configuration()
    conf.set(cfg_mod.ExecutionOptions.BATCH_SIZE, 4)
    kw = {"device": "cpu"} if pkg == "port" else {}
    env = ds.StreamExecutionEnvironment(conf, **kw)

    def mk(pairs):
        ts = {i: p[1] for i, p in enumerate(pairs)}
        return env.from_collection(
            list(enumerate(p[0] for p in pairs)), timestamp_fn=lambda iv: ts[iv[0]],
            watermark_strategy=W.WatermarkStrategy.for_monotonous_timestamps(),
        ).map(lambda iv: iv[1])

    a = mk([(f"k{i % 3}", i * 250) for i in range(n)])
    b = mk([(f"k{i % 3}", i * 250 + 100) for i in range(n)])

    def maybe_boom(v, _flag=flag, _inject=inject):
        import os as _os
        import time as _time

        _time.sleep(0.01)
        if _inject and not _os.path.exists(_flag):
            maybe_boom.count = getattr(maybe_boom, "count", 0) + 1
            if maybe_boom.count > 60:
                open(_flag, "w").write("x")
                raise RuntimeError("injected graph task failure")
        return v

    sink = (a.union(b).map(maybe_boom).key_by(lambda v: v)
            .window(A.TumblingEventTimeWindows.of(2000)).count().collect())
    plan = _mod(pkg, "graph.transformation").plan
    return env, sink, PKGS[pkg]["cl"].GraphJobSpec("graph-job", plan(env._sinks), conf)


def test_general_graph_job_with_failover(tmp_path):
    got, ref = {}, {}
    for pkg in PKGS:
        _e, _s, spec = _graph_job(pkg, str(tmp_path / f"boomed-{pkg}"), True)
        with _Cluster(pkg, n_tms=1, checkpoint_dir=str(tmp_path / pkg / "chk"),
                      checkpoint_interval=0.2, restart_attempts=3, restart_delay=0.2,
                      heartbeat_timeout=5.0) as c:
            job = c.client.submit_job(spec.to_bytes(), 1)
            st = c.wait(job, timeout=60)
            assert st["status"] == "FINISHED" and st["restarts"] >= 1, st
            assert c.tes[0].num_local_restores >= 1
            got[pkg] = sorted(c.client.job_result(job))
        env, sink, _spec_ = _graph_job(pkg, str(tmp_path / "unused"), False)
        env.execute()
        ref[pkg] = sorted(sink.results)
        assert got[pkg] == ref[pkg] and ref[pkg]
    assert got["port"] == got["jax"]


def _two_stage(pkg, n, batch, wire_format=None, slow=False, flag=None):
    """test_slot_sharing's pipeline: the window in its own slot-sharing
    group; with `flag`, a map after the window fails once."""
    ds = _mod(pkg, "api.datastream")
    cfg_mod = _mod(pkg, "config")
    A = _mod(pkg, "api.windowing.assigners")
    W = _mod(pkg, "core.watermarks")
    conf = cfg_mod.Configuration()
    conf.set(cfg_mod.ExecutionOptions.BATCH_SIZE, batch)
    if wire_format:
        conf.set(cfg_mod.ExchangeOptions.WIRE_FORMAT, wire_format)
    kw = {"device": "cpu"} if pkg == "port" else {}
    env = ds.StreamExecutionEnvironment(conf, **kw)

    def project(v, _slow=slow):
        import time as _time

        if _slow:
            _time.sleep(0.01)
        return v[0]

    windowed = (env.from_collection(
        [(f"k{i % 3}", i * 250) for i in range(n)], timestamp_fn=lambda v: v[1],
        watermark_strategy=W.WatermarkStrategy.for_monotonous_timestamps())
        .map(project).key_by(lambda v: v)
        .window(A.TumblingEventTimeWindows.of(2000)).count())
    windowed.slot_sharing_group("agg")

    def maybe_boom(v, _flag=flag):
        import os as _os

        if _flag and not _os.path.exists(_flag):
            maybe_boom.count = getattr(maybe_boom, "count", 0) + 1
            if maybe_boom.count > 5:
                open(_flag, "w").write("x")
                raise RuntimeError("injected stage failure")
        return v

    sink = windowed.map(maybe_boom).collect()
    plan = _mod(pkg, "graph.transformation").plan
    return env, sink, PKGS[pkg]["cl"].GraphJobSpec("two-stage", plan(env._sinks), conf)


@pytest.mark.parametrize("wire_format", ["binary", "pickle"])
def test_two_stage_pipeline_on_both_wire_formats(tmp_path, wire_format):
    got = {}
    for pkg in PKGS:
        _e, _s, spec = _two_stage(pkg, 40, 8, wire_format)
        local_env, local_sink, _ = _two_stage(pkg, 40, 8)
        local_env.execute()
        with _Cluster(pkg, n_tms=1, slots=2, checkpoint_dir=str(tmp_path / pkg / "chk"),
                      checkpoint_interval=0.2, restart_attempts=1) as c:
            job = c.client.submit_job(spec.to_bytes(), 1)
            st = c.wait(job, timeout=60)
            assert st["status"] == "FINISHED", st
            got[pkg] = sorted(c.client.job_result(job))
            st = c.client.job_status(job)
            assert (st["stages"], st["parallelism"], st["tasks"]) == (2, 2, 2)
        assert got[pkg] == sorted(local_sink.results)
    assert got["port"] == got["jax"] and got["port"]


def test_two_stage_checkpointed_failover(tmp_path):
    got = {}
    for pkg in PKGS:
        _e, _s, spec = _two_stage(pkg, 120, 8, slow=True, flag=str(tmp_path / f"boom-{pkg}"))
        local_env, local_sink, _ = _two_stage(pkg, 120, 8)
        local_env.execute()
        with _Cluster(pkg, n_tms=1, slots=2, checkpoint_dir=str(tmp_path / pkg / "chk"),
                      checkpoint_interval=0.15, restart_attempts=3,
                      restart_delay=0.2) as c:
            job = c.client.submit_job(spec.to_bytes(), 1)
            st = c.wait(job, timeout=90)
            assert st["status"] == "FINISHED" and st["restarts"] >= 1, st
            assert st["checkpoints"], "no aligned checkpoint completed"
            got[pkg] = sorted(c.client.job_result(job))
        assert got[pkg] == sorted(local_sink.results)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_barrier_aligner_semantics(pkg):
    """The same barrier and end-of-stream sequence aligns the same way in
    both packages."""
    BarrierAligner = _mod(pkg, "runtime.stages").BarrierAligner
    done = []
    a = BarrierAligner(["x0", "x1"], True, done.append)
    a.on_barrier("x0", 7)
    assert a.paused("x0") and not a.paused("x1") and done == []
    a.on_barrier(BarrierAligner.SOURCE_GATE, 7)
    assert done == []
    a.on_barrier("x1", 7)
    assert done == [7] and not a.paused("x0") and not a.paused("x1")
    a.on_barrier("x0", 8)
    a.on_barrier("x1", 8)
    a.on_barrier(BarrierAligner.SOURCE_GATE, 8)
    assert done == [7, 8]
    b = BarrierAligner(["y0", "y1"], False, done.append)
    b.on_barrier("y0", 3)
    b.on_eos("y1")
    assert done == [7, 8, 3] and not b.paused("y0")


def test_stage_output_sends_device_columns_as_numpy():
    """The device edge: a stage's output batch of tensors leaves as numpy
    columns, so no tensor reaches the frame codec."""
    import torch

    from flink_tpu_torch.runtime.stages import _host_columns

    vals, ts = _host_columns(torch.arange(6, dtype=torch.float32).reshape(3, 2),
                             torch.tensor([1, 2, 3]))
    assert isinstance(vals, np.ndarray) and isinstance(ts, np.ndarray)
    assert vals.tolist() == [[0, 1], [2, 3], [4, 5]] and ts.tolist() == [1, 2, 3]
    same = np.zeros(2)
    assert _host_columns(same, same)[0] is same


def test_task_executor_without_a_gpu_raises_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is cuda")
    svc = trpc.RpcService(security=tharness.ephemeral_transport_security())
    try:
        with pytest.raises(RuntimeError, match="no GPU"):
            tcl.TaskExecutorEndpoint(svc)
    finally:
        svc.stop()
