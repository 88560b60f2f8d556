"""The cluster half of the chaos plane and the JobManager's autoscaler loop,
against the JAX package's.

The four cluster drills themselves run in both packages in
test_torch_chaos_scenarios.py (their cases keep the ids they had while the
port raised for them). Here: the drills' shared workload (the paced source,
the spec, the oracle fold and the result collection) equal to the JAX
package's, and `JobManagerEndpoint._autoscaler_loop` driven as JAX
tests/test_autoscaler.py drives it, with one change: the coordinator's
clock and the busy signal are injected, the same in both packages. The
clock advances one interval per observation the loop forwards, and the
busy, backpressured, idle and records-in gauges of each observation come
from a script, so the two packages' decision logs are equal whatever the
wall clock does. Observations start once the job has a completed
checkpoint (a rescale rewinds to one), and end with the script; then the
source stops pacing and the job runs to its end, its rows against the
oracle fold.
"""

import time

import numpy as np
import pytest

pytest.importorskip("jax")

import flink_tpu.chaos.scenarios as jscen  # noqa: E402
import flink_tpu_torch.chaos.scenarios as tscen  # noqa: E402

#: labels of the sources whose pacing the test has switched off
UNPACED = set()


class ReleasablePacedSource(tscen.PacedKeyedSource):
    """PacedKeyedSource whose pacing stops once its label is in UNPACED
    (the TaskExecutors unpickle their own copy; the label is shared)."""

    def __init__(self, label: str, *args, **kwargs):
        self.label = label
        super().__init__(*args, **kwargs)

    @property
    def interval_s(self):
        return 0.0 if self.label in UNPACED else self._interval_s

    @interval_s.setter
    def interval_s(self, value):
        self._interval_s = value


def test_the_paced_source_and_its_oracle_are_the_jax_packages():
    t = tscen.PacedKeyedSource(steps=6, batch=40, n_keys=9, interval_s=0.0)
    j = jscen.PacedKeyedSource(steps=6, batch=40, n_keys=9, interval_s=0.0)
    for s in range(6):
        for a, b in zip(t.global_step(s), j.global_step(s)):
            np.testing.assert_array_equal(a, b)
    for shards in (1, 2, 3):
        for shard in range(shards):
            tb, jb = t(shard, shards), j(shard, shards)
            assert len(tb) == len(jb) == 6
            for s in range(6):
                for a, b in zip(tb[s], jb[s]):
                    np.testing.assert_array_equal(a, b)
    want = tscen._dist_expected(t)
    assert want == jscen._dist_expected(j) and sum(want.values()) == 6 * 40
    ts, js = tscen._dist_spec(t, "x"), jscen._dist_spec(j, "x")
    assert (ts.aggregate, ts.max_parallelism, ts.operator) == \
        (js.aggregate, js.max_parallelism, js.operator) == ("sum", 16, "oracle")
    assert ts.assigner.size == js.assigner.size == 1000
    rows = [(3, (1000, 2000), 4.0, 1999), (1, (0, 1000), 2.0, 999)]
    assert tscen._collect_dist(rows) == jscen._collect_dist(rows) == {(3, 1000): 4.0,
                                                                      (1, 0): 2.0}
    assert tscen._collect_dist(None) == jscen._collect_dist(None) == {}


def test_the_paced_source_paces_steps_in_wall_time():
    src = tscen.PacedKeyedSource(steps=4, batch=8, n_keys=3, interval_s=0.05)
    batches = src(0, 1)
    t0 = time.monotonic()
    for s in range(4):
        batches[s]
    assert time.monotonic() - t0 >= 0.14


# the coordinator's script: saturated until the scale-up, idle after it
INTERVAL_MS = 50
SCRIPT = [0.95] * 4 + [0.1] * 14


class ScriptedObservations:
    """Wraps a coordinator's `observe`: forwards the loop's observations of
    a job once it has a completed checkpoint, each one interval later on
    the injected clock, its busy ratio (and idle, backpressured, records
    in) from SCRIPT; drops the rest."""

    def __init__(self, jm, coordinator):
        self.jm, self.coordinator = jm, coordinator
        self.now, self.i = 0.0, 0
        self.real = coordinator.observe
        coordinator.observe = self.observe

    def clock(self):
        return self.now

    def observe(self, job_id, parallelism, metrics, max_slots=None):
        if not self.jm._jobs[job_id].completed or self.i >= len(SCRIPT):
            return None
        busy = SCRIPT[self.i]
        self.i += 1
        self.now += INTERVAL_MS / 1000.0
        metrics = dict(metrics, **{"job.busyTimeMsPerSecond": busy * 1000.0,
                                   "job.backPressuredTimeMsPerSecond": 0.0,
                                   "job.idleTimeMsPerSecond": (1.0 - busy) * 1000.0,
                                   "job.numRecordsIn": 100.0 * self.i})
        return self.real(job_id, parallelism, metrics, max_slots=max_slots)


def _autoscaler_drill(pkg, tmp_path):
    """JAX tests/test_autoscaler.py's cluster (one JobManager with the
    autoscaler enabled, one TaskExecutor of 4 slots), the paced job at
    parallelism 1, the coordinator's clock and busy signal scripted."""
    if pkg == "jax":
        from flink_tpu.config import AutoscalerOptions, Configuration
        from flink_tpu.runtime.cluster import JobManagerEndpoint, TaskExecutorEndpoint
        from flink_tpu.runtime.rpc import RpcService
        from flink_tpu.scheduler import AutoscalerCoordinator
        from flink_tpu.testing.harness import ephemeral_transport_security
        te_kw, scen = {}, jscen
    else:
        from flink_tpu_torch.config import AutoscalerOptions, Configuration
        from flink_tpu_torch.runtime.cluster import JobManagerEndpoint, TaskExecutorEndpoint
        from flink_tpu_torch.runtime.rpc import RpcService
        from flink_tpu_torch.scheduler import AutoscalerCoordinator
        from flink_tpu_torch.testing.harness import ephemeral_transport_security
        te_kw, scen = {"device": "cpu"}, tscen
    cfg = (Configuration()
           .set(AutoscalerOptions.ENABLED, True)
           .set(AutoscalerOptions.POLICY, "threshold")
           .set(AutoscalerOptions.MIN_PARALLELISM, 1)
           .set(AutoscalerOptions.MAX_PARALLELISM, 4)
           .set(AutoscalerOptions.INTERVAL_MS, INTERVAL_MS)
           .set(AutoscalerOptions.SIGNAL_WINDOW, 3)
           .set(AutoscalerOptions.STABILIZATION_INTERVAL_MS, 3 * INTERVAL_MS)
           .set(AutoscalerOptions.SCALE_UP_THRESHOLD, 0.85)
           .set(AutoscalerOptions.SCALE_DOWN_THRESHOLD, 0.45))
    label = f"{pkg}-{time.monotonic_ns()}"
    source = ReleasablePacedSource(label, steps=300, batch=40, n_keys=9, interval_s=0.04)
    sec = ephemeral_transport_security(f"autoscaler-{pkg}")
    svc_jm, svc_tm = RpcService(security=sec), RpcService(security=sec)
    jm = JobManagerEndpoint(svc_jm, checkpoint_dir=str(tmp_path / pkg),
                            checkpoint_interval=0.1, heartbeat_interval=0.2,
                            heartbeat_timeout=15.0, autoscaler_config=cfg)
    te = TaskExecutorEndpoint(svc_tm, slots=4, shipping_interval_ms=50, **te_kw)
    try:
        scripted = None
        coordinator = AutoscalerCoordinator.from_config(
            cfg, rescale_executor=jm._rescale_job, clock=lambda: scripted.clock())
        scripted = ScriptedObservations(jm, coordinator)
        jm.autoscaler = coordinator
        te.connect(svc_jm.address)
        client = svc_jm.gateway(svc_jm.address, "jobmanager")
        job_id = client.submit_job(scen._dist_spec(source, "autoscaled").to_bytes(), 1)
        assert scen._await(lambda: scripted.i >= len(SCRIPT), 60.0), scripted.i
        UNPACED.add(label)
        st = scen._await_job(client, job_id, timeout_s=60.0)
        rows = scen._collect_dist(client.job_result(job_id))
        return st, client.job_autoscaler(job_id), rows, scen._dist_expected(source)
    finally:
        te.stop()
        jm.stop()
        svc_jm.stop()
        svc_tm.stop()


DECISION_FIELDS = ("action", "parallelism", "target", "reason", "outcome",
                   "throughput_before", "repeats")


def _decisions(auto):
    return [dict({f: d[f] for f in DECISION_FIELDS},
                 utilization=d["signals"]["utilization"], samples=d["signals"]["samples"],
                 claimed_duration=d["duration_ms"] is not None)
            for d in auto["decisions"]]


def test_the_autoscaler_loop_decides_as_the_jax_packages(tmp_path):
    port = _autoscaler_drill("port", tmp_path)
    jax = _autoscaler_drill("jax", tmp_path)
    for st, auto, rows, want in (port, jax):
        assert st["status"] == "FINISHED" and st["restarts"] == 0, st
        assert st["rescales"] == 2 and st["parallelism"] == 1, st
        assert rows == want and rows
        assert auto["num_rescales"] == 2 and auto["enabled"] is True
    decisions = _decisions(port[1])
    assert decisions == _decisions(jax[1])
    assert [(d["action"], d["parallelism"], d["target"], d["outcome"]) for d in decisions] == \
        [("scale-down", 2, 1, "executed"), ("scale-up", 1, 2, "executed")]
    assert decisions[1]["utilization"] == pytest.approx(0.95)
    assert decisions[0]["utilization"] == pytest.approx(0.1)
