"""MiniCluster: in-process job management with failure recovery.

Counterpart of the core of `flink_tpu/runtime/minicluster.py`. Jobs are
submitted asynchronously and each runs its attempts on its own
`jobmaster-<id>` thread. On a failure the restart strategy
(checkpoint/restart.py) decides the backoff or the job's terminal failure,
and each retry restores the latest completed checkpoint (whole-pipeline
restart: a linear topology has one region). Savepoints are triggered
through the client and written through the same capture path; they are
never discarded by the cluster.

On the card the job thread builds and launches the kernels itself, and a
failed attempt gives its device memory back before the next one starts:
its in-flight work is waited on, and the frames of the kept error are
cleared (the error's type, message and cause chain stay), so neither the
error nor the coordinator keeps the dead attempt's rings alive.

A live mesh rescale (`JobClient.rescale_mesh`) rides the same attempt
loop: at the next step boundary the running attempt hands over a
step-aligned capture (`MeshRescaleRequested`), and the job master
rebuilds the runtime over the new shard count and restores the capture —
exactly-once, with no restart counted. The mesh's control loops ride it
too:

- the skew rebalancer (parallel.mesh.skew-rebalance,
  scheduler/rebalancer.py, `client.rebalancer`): polled at every step
  boundary, its interval gate first and only then the per-key-group load
  readback; a new assignment comes back as a capture at the same size,
  and the rebuilt attempt applies the table AFTER its restore (a restore
  that adopts a grown K rebuilds the table at identity; applying first
  would discard the move, and the rebalancer would re-decide it forever).
  The recovery is recorded with kind "rebalance";
- the autoscaler (autoscaler.enabled, scheduler/autoscaler.py,
  `client.autoscaler`): with parallel.mesh.autoscale its executor parks a
  mesh rescale the run loop takes at the next step boundary, clamped as
  the rebuilt operators will clamp; without a mesh it observes only;
- the device-loss degrade (parallel.mesh.degrade-on-device-loss): an
  attempt that fails with a device error (`_is_device_loss`) restarts
  over half its shards, re-sharding the latest checkpoint. A real CUDA
  error is sticky: it poisons the whole CUDA context, so on one card the
  degraded attempt fails too and the restart strategy ends the job; the
  degrade keeps a job alive where the lost shards were other devices, or
  where the failure was injected.

A rescale or rebalance that fails midway stamps no completion: the job
takes the plain restart path instead, at the identity table.

Observability, as the JAX MiniCluster wires it: each job has a metric
registry (`client.metrics`, shared by its attempts), a trace registry with
the job's trace id (`client.traces`), an OTLP/JSON export
(`client.otel`), a bounded span log (`client.span_log`), a metric history
sampled at the step boundary (`client.history`) and the health watchdog
(`client.watchdog`, observability.doctor.enabled). The checkpoint and
exception trackers register their gauges on the job group, checkpoints and
restarts report spans, and the client serves `latency_report`,
`history_report` and `doctor_report` in the JAX package's shapes.

A job config with `chaos.enabled` installs its fault plan (`chaos.*`,
chaos/plan.py) for that job and uninstalls it when the job ends; a plan
already installed (a drill's `testing.harness.fault_injection`) is never
stacked. `security=` is the cluster's transport identity
(security/transport.py), which runtime/rest.py derives its bearer token
from.
"""

from __future__ import annotations

import enum
import gc
import threading
import time
import uuid
from typing import Dict, Optional

from flink_tpu_torch.chaos import plan as _chaos
from flink_tpu_torch.checkpoint.coordinator import CheckpointCoordinator
from flink_tpu_torch.checkpoint.restart import restart_strategy_from_config
from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage, MemoryCheckpointStorage
from flink_tpu_torch.config import (
    AutoscalerOptions,
    CheckpointingOptions,
    Configuration,
    ObservabilityOptions,
    ParallelOptions,
)
from flink_tpu_torch.graph.transformation import StepGraph
from flink_tpu_torch.metrics.checkpoint_stats import (
    CheckpointStatsTracker,
    ExceptionHistory,
    failing_task,
)
from flink_tpu_torch.metrics.doctor import HealthWatchdog, diagnose
from flink_tpu_torch.metrics.emission_latency import build_latency_report
from flink_tpu_torch.metrics.history import MetricHistory
from flink_tpu_torch.metrics.otel import OtlpJsonTraceReporter
from flink_tpu_torch.metrics.registry import MetricRegistry, metrics_snapshot
from flink_tpu_torch.metrics.traces import (
    InMemoryTraceReporter,
    Span,
    TraceRegistry,
    job_trace_id,
)
from flink_tpu_torch.parallel import mesh as mesh_lib
from flink_tpu_torch.runtime.executor import (
    JobCancelledException,
    JobRuntime,
    MeshRescaleRequested,
)
from flink_tpu_torch.scheduler.autoscaler import AutoscalerCoordinator
from flink_tpu_torch.scheduler.rebalancer import SkewRebalancer
from flink_tpu_torch.utils.device import resolve_device


def _effective_mesh_target(runtime: JobRuntime, target: int, device) -> Optional[int]:
    """Clamp a mesh-rescale target exactly as the rebuilt operators will:
    to the devices `parallel/mesh.py::visible_devices` gives, then down to
    the largest divisor of the operators' construction-time key capacity
    (not a grown K: a rebuilt operator starts from its construction
    capacity again). None: the job has no operator that can run on a
    mesh."""
    cap = runtime.mesh_capacity()
    if cap is None:
        return None
    return mesh_lib.usable_mesh_size(max(1, int(target)),
                                     len(mesh_lib.visible_devices(device)), cap)


def _is_device_loss(e: BaseException) -> bool:
    """Does this failure look like the device plane died under the job?
    torch's own device error (a type named AcceleratorError, or a
    RuntimeError whose message carries "CUDA error", as torch's and the
    kernel wrappers' launch errors do), or a chaos drill's device-scoped
    marker. Walks the cause chain, cycle-safe, so wrapping never hides
    the origin."""
    seen = set()
    cur: Optional[BaseException] = e
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if type(cur).__name__ == "AcceleratorError":
            return True
        if isinstance(cur, RuntimeError) and "CUDA error" in str(cur):
            return True
        if f"{_chaos.INJECTED_MARKER}:device" in str(cur):
            return True
        cur = cur.__cause__ or cur.__context__
    return False


class JobStatus(enum.Enum):
    CREATED = "CREATED"
    RUNNING = "RUNNING"
    RESTARTING = "RESTARTING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    CANCELED = "CANCELED"


def _release_attempt(device) -> float:
    """Release a failed attempt, on every failure path: its in-flight
    dispatches finish before its buffers go (after a sticky CUDA error the
    wait raises it again, and the next attempt fails the same way until the
    strategy ends the job), and whatever of it sits in reference cycles is
    collected. Returns the milliseconds it took."""
    t0 = time.perf_counter()
    if device.type == "cuda":
        import torch

        try:
            torch.cuda.synchronize(device)
        except RuntimeError:
            pass
    gc.collect()
    return (time.perf_counter() - t0) * 1000.0


def _release_frames(exc: Optional[BaseException]) -> None:
    """Clear the locals of every finished frame the error (and its cause
    chain) holds: a failed attempt's frames reference its runtime, and
    through it the operators' device rings and pinned staging buffers.
    Reading `f_locals` after the clear drops the cleared names from the
    dict snapshot an earlier read (failing_task's) cached on the frame."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        tb = exc.__traceback__
        while tb is not None:
            try:
                tb.tb_frame.clear()
                tb.tb_frame.f_locals
            except RuntimeError:
                pass        # the frame still runs (the attempt loop's own)
            tb = tb.tb_next
        exc = exc.__cause__ or exc.__context__


class JobClient:
    """Client handle of a submitted job: status, cancel, savepoint, the
    checkpoint and exception histories, queryable state."""

    def __init__(self, job_id: str, job_name: str):
        self.job_id = job_id
        self.job_name = job_name
        self._status = JobStatus.CREATED
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._savepoint_path: Optional[str] = None
        self._savepoint_done = threading.Event()
        self.error: Optional[BaseException] = None
        self.records_in = 0
        self.num_restarts = 0
        self.num_checkpoints = 0
        self.checkpoint_stats: Optional[CheckpointStatsTracker] = None
        self.exceptions: Optional[ExceptionHistory] = None
        self._runtime: Optional[JobRuntime] = None
        # live mesh rescales performed, and the last one's duration
        self.mesh_rescales = 0
        self.last_mesh_rescale_duration_ms = 0.0
        self._mesh_rescale_target: Optional[int] = None
        # the skew rebalancer's completed routing-table swaps and the policy
        # object that decides them; the autoscaler, when the job enables it
        self.mesh_rebalances = 0
        self.last_mesh_rebalance_duration_ms = 0.0
        self.rebalancer: Optional[SkewRebalancer] = None
        self.autoscaler: Optional[AutoscalerCoordinator] = None
        # observability planes, wired when the job thread starts
        self.metrics: Optional[MetricRegistry] = None
        self.traces: Optional[TraceRegistry] = None
        self.span_log: Optional[InMemoryTraceReporter] = None
        self.history: Optional[MetricHistory] = None
        self.watchdog: Optional[HealthWatchdog] = None
        self.doctor_window_ms = 60000.0
        self._attempt_gauges: list = []

    def _drop_attempt_gauges(self) -> None:
        """Drop the ended attempt's gauges from the job's registry: their
        closures hold its operators (and so their device state), and the
        next attempt registers its own under the same names. (The JAX
        MiniCluster keeps the first attempt's, which then read a dead
        runtime: ROADMAP Queue C.)"""
        if self.metrics is not None:
            self.metrics.unregister(self._attempt_gauges)
        self._attempt_gauges = []

    def _spans(self) -> list:
        log = self.span_log
        return [sp.to_dict() for sp in log.spans] if log is not None else []

    def latency_report(self) -> dict:
        """Emission latency and stall attribution (the /jobs/:id/latency
        shape): per-operator log-bucket histograms and watermark lag from
        the live registry, outlier EmissionStall spans attributed against
        the job's checkpoint and restart spans."""
        snap = metrics_snapshot(self.metrics.all_metrics()) if self.metrics else {}
        return build_latency_report(snap, self._spans())

    def history_report(self, metric: Optional[str] = None,
                       since: Optional[float] = None) -> dict:
        """The metric history rings (the /jobs/:id/history?metric=&since=
        shape): counters as windowed rates, gauges as values, histograms as
        per-sample p50/p99 sub-series."""
        if self.history is None:
            return {"enabled": False, "series": {}, "sample_count": 0}
        payload = self.history.payload(
            metric=metric or None,
            since_ms=float(since) if since not in (None, "") else None)
        payload["enabled"] = True
        return payload

    def doctor_report(self) -> dict:
        """Ranked bottleneck diagnosis (the /jobs/:id/doctor shape): the job
        doctor over the history rings and this job's span log."""
        if self.history is None:
            return {"verdict": "unknown", "score": 0.0, "diagnoses": [],
                    "window_ms": self.doctor_window_ms, "samples": 0,
                    "watchdog_events": 0}
        return diagnose(self.history, self._spans(), window_ms=self.doctor_window_ms)

    # -- status -----------------------------------------------------------
    def status(self) -> JobStatus:
        return self._status

    def _set_status(self, status: JobStatus) -> None:
        with self._lock:
            self._status = status
        if status in (JobStatus.FINISHED, JobStatus.FAILED, JobStatus.CANCELED):
            self._done.set()

    def wait(self, timeout: Optional[float] = None) -> JobStatus:
        self._done.wait(timeout)
        if not self._done.is_set():
            raise TimeoutError(f"job {self.job_id} still {self._status}")
        if self._status == JobStatus.FAILED and self.error is not None:
            raise RuntimeError(f"job {self.job_id} failed") from self.error
        return self._status

    # -- operations -------------------------------------------------------
    def cancel(self) -> None:
        self._cancel.set()

    def trigger_savepoint(self, path: str, timeout: float = 30.0) -> str:
        """Requests a savepoint at the next step boundary; blocks until it
        is written."""
        self._savepoint_done.clear()
        self._savepoint_path = path
        if not self._savepoint_done.wait(timeout):
            raise TimeoutError("savepoint not taken (job finished or stalled?)")
        return path

    def _poll_savepoint_request(self) -> Optional[str]:
        path = self._savepoint_path
        if path is not None:
            self._savepoint_path = None
            return path
        return None

    def rescale_mesh(self, devices: int) -> None:
        """Request a live mesh-size rescale of a RUNNING mesh job: at the
        next step boundary the job captures its state, rebuilds over
        `devices` shards, and restores — exactly-once, no restart counted.
        No-op on jobs without parallel.mesh.enabled."""
        self._mesh_rescale_target = max(1, int(devices))

    def _poll_mesh_rescale(self) -> Optional[int]:
        t = self._mesh_rescale_target
        if t is not None:
            self._mesh_rescale_target = None
        return t

    # -- queryable state ----------------------------------------------------
    def query_state(self, uid: str, key) -> dict:
        """Point lookup into the RUNNING job's keyed state (the JAX
        client's shapes), per operator:
          fused window operator (`query_state_for`, which folds its rings
          and buffered steps): {"slices": {abs_slice: {field: value,
          "count": n}}, "watermark": wm};
          per-batch window operator (its key dictionary's row): the same;
          oracle window operator and heap-state operators: {"states":
          {name: {repr(namespace): value}}, "watermark": wm};
          rolling keyed reduce: {"value": current}."""
        runtime = self._runtime
        if runtime is None:
            raise RuntimeError("job has no running attempt")
        for r in runtime.runners:
            if getattr(r, "uid", None) != uid:
                continue
            op = getattr(r, "op", None)
            if op is not None and hasattr(op, "query_state_for"):
                return {"slices": op.query_state_for(key),
                        "watermark": op.current_watermark}
            if op is not None and hasattr(op, "state") and hasattr(op.state, "keydict"):
                return {"slices": _keydict_slices(op.state, key),
                        "watermark": op.current_watermark}
            if op is not None and hasattr(op, "state"):  # oracle and heap operators
                backend = op.state
                backend.set_current_key(key)
                states = {}
                for name in backend.descriptors:
                    for ns in backend.namespaces_for_key(name, key):
                        states.setdefault(name, {})[repr(ns)] = backend.get(name, ns)
                wm = getattr(op, "timer_service", None)
                return {"states": states, "watermark": wm.current_watermark if wm else None}
            if hasattr(r, "state"):  # the rolling reduce
                r.state.set_current_key(key)
                return {"value": r.state.get("rolling")}
        raise KeyError(f"no queryable operator {uid!r}")


def _keydict_slices(state, key) -> dict:
    """One key's live slices of a per-batch window operator's [S, K] ring
    ({abs_slice: {field: value, "count": n}}), read back from the device."""
    kid = state.keydict.lookup(key)
    if kid is None:
        return {}
    count = state.count[:, kid].cpu().numpy()
    acc = {k: v[:, kid].cpu().numpy() for k, v in state.acc.items()}
    f = state.frontiers
    slices = {}
    if f.min_used is not None:
        lo = f.min_used if f.purged_to is None else max(f.purged_to, f.min_used)
        for s in range(lo, f.max_used + 1):
            pos = s % state.S
            if count[pos] > 0:
                entry = {name: arr[pos].item() for name, arr in acc.items()}
                entry["count"] = int(count[pos])
                slices[s] = entry
    return slices


class MiniCluster:
    _shared: Optional["MiniCluster"] = None

    def __init__(self, security=None):
        self.jobs: Dict[str, JobClient] = {}
        # the cluster's transport-security identity (auth ON by default):
        # in-process jobs never cross a socket, but everything layered on a
        # MiniCluster that DOES (distributed hand-off) shares this one
        # resolved secret/cluster-id
        from flink_tpu_torch.security.transport import SecurityConfig

        self.security = SecurityConfig.resolve() if security is None else security

    @classmethod
    def get_shared(cls) -> "MiniCluster":
        if cls._shared is None:
            cls._shared = MiniCluster()
        return cls._shared

    def submit(
        self,
        graph: StepGraph,
        config: Configuration,
        job_name: Optional[str] = None,
        savepoint_restore_path: Optional[str] = None,
        device=None,
    ) -> JobClient:
        """Start the job on its own thread. `device` as for env.execute():
        CUDA unless the caller asks for the CPU; without a GPU this raises
        here, in the caller's thread."""
        device = resolve_device(device)
        job_id = uuid.uuid4().hex[:16]
        client = JobClient(job_id, job_name or f"job-{job_id}")
        self.jobs[job_id] = client
        thread = threading.Thread(
            target=self._run_job,
            args=(client, graph, config, savepoint_restore_path, device),
            name=f"jobmaster-{job_id}",
            daemon=True,
        )
        thread.start()
        return client

    # ------------------------------------------------------------------
    def _run_job(self, client: JobClient, graph: StepGraph, config: Configuration,
                 savepoint_restore_path: Optional[str], device) -> None:
        """Run the job's attempts under its config's fault plan, if any. The
        plan is uninstalled when THIS job ends: a process-wide hook leaking
        past the drill would fault every later job."""
        chaos_plan = _chaos.FaultPlan.from_config(config)
        installed = False
        if chaos_plan is not None and _chaos.active_plan() is None:
            _chaos.install_plan(chaos_plan)
            installed = True
        try:
            self._run_attempts(client, graph, config, savepoint_restore_path, device)
        finally:
            if installed and _chaos.active_plan() is chaos_plan:
                _chaos.uninstall_plan()

    def _run_attempts(self, client: JobClient, graph: StepGraph, config: Configuration,
                      savepoint_restore_path: Optional[str], device) -> None:
        """The attempt loop (the JAX `_run_job_inner`'s): coordinator,
        restart strategy, restore, backoff and the savepoint hook. A
        failure of any attempt is caught here and counted against the
        strategy: this is the job's failover boundary."""
        self._wire_observability(client, config)
        self._wire_mesh_control(client, config, device)
        interval = config.get(CheckpointingOptions.INTERVAL_MS)
        chk_dir = config.get(CheckpointingOptions.DIRECTORY)
        storage = FsCheckpointStorage(chk_dir) if chk_dir else MemoryCheckpointStorage()
        coordinator = (
            CheckpointCoordinator(
                storage, interval, config.get(CheckpointingOptions.MAX_RETAINED),
                traces=client.traces, stats=client.checkpoint_stats,
                tolerable_failures=config.get(
                    CheckpointingOptions.TOLERABLE_FAILED_CHECKPOINTS))
            if interval > 0 else None)
        if coordinator is not None:
            coordinator.register_on_complete(
                lambda _cp, c=client, co=coordinator:
                    setattr(c, "num_checkpoints", co.num_completed))
        strategy = restart_strategy_from_config(config)
        attempt = 0
        restore_snap = None
        restore_ms = 0.0
        # the open recovery span: from the failure until the rebuilt attempt
        # runs, so a post-restore emission stall can be attributed to it
        restart_span = None

        def running(restored: bool) -> None:
            # the rebuilt attempt runs: failure -> RUNNING is the downtime
            # the recovery timeline records
            nonlocal restart_span
            if restart_span is not None:
                client.traces.report(restart_span.set_attribute(
                    "restoredCheckpoint", restored).end())
                restart_span = None

        # the next attempt's mesh size after a live rescale or a device-loss
        # degrade (None: the configured size); what the next attempt
        # completes: "rescale" (its start) and "rebalance" (its start and
        # assignment), each popped by the attempt once it has stamped it
        mesh_override: Optional[int] = None
        pending: dict = {}
        mesh_enabled = config.get(ParallelOptions.MESH_ENABLED)
        degrade = mesh_enabled and config.get(ParallelOptions.MESH_DEGRADE_ON_DEVICE_LOSS)
        if savepoint_restore_path is not None:
            try:
                sp_storage = FsCheckpointStorage(savepoint_restore_path)
                latest = sp_storage.latest()
                if latest is None:
                    raise FileNotFoundError(f"no savepoint at {savepoint_restore_path}")
                t_restore = time.perf_counter()
                restore_snap = sp_storage.load(latest[1])
                restore_ms = (time.perf_counter() - t_restore) * 1000.0
            except Exception as e:  # noqa: BLE001 — the job fails, not the thread
                client.error = e
                client._set_status(JobStatus.FAILED)
                return

        while True:
            cfg = config
            if mesh_override is not None:
                cfg = config.clone().set(ParallelOptions.MESH_DEVICES, mesh_override)
            try:
                self._attempt(client, graph, cfg, device, coordinator, restore_snap,
                              restore_ms, pending, running)
                client._set_status(JobStatus.FINISHED)
                return
            except JobCancelledException:
                client._set_status(JobStatus.CANCELED)
                return
            except MeshRescaleRequested as mr:
                # a deliberate live rescale or skew rebalance, not a
                # failure: rebuild over the new size (the same size for a
                # rebalance) and restore the step-aligned capture (no
                # restart counted, no backoff)
                if client._runtime is not None:
                    client.records_in = client._runtime.records_in
                client._runtime = None
                client._drop_attempt_gauges()
                mesh_override = mr.target
                restore_snap, restore_ms = mr.snapshot, 0.0
                if mr.routing is not None:
                    pending["rebalance"] = {"t0": time.perf_counter(), "assign": mr.routing}
                    cause = f"mesh key-group rebalance over {mr.target} device(s)"
                    kind = "rebalance"
                else:
                    pending["rescale"] = time.perf_counter()
                    cause = f"mesh rescale to {mr.target} device(s)"
                    kind = "rescale"
                client._set_status(JobStatus.RESTARTING)
                client.exceptions.begin_recovery(
                    client.num_restarts, cause=cause, events_at_failure=client.records_in,
                    kind=kind)
                del mr
                continue
            except BaseException as e:  # noqa: BLE001 — failover boundary
                # a rescale or rebalance that failed midway stamps no
                # completion: the restarted attempt restores the canonical
                # checkpoint at the identity table, and the rebalancer
                # re-decides from live skew
                pending.clear()
                attempt += 1
                failed_mesh = (client._runtime.mesh_devices()
                               if client._runtime is not None else 1)
                if degrade and failed_mesh > 1 and _is_device_loss(e):
                    # a lost device: restart over half the shards, the
                    # canonical [K, S] checkpoint re-sharded over them
                    mesh_override = max(1, failed_mesh // 2)
                client._runtime = None
                client._drop_attempt_gauges()
                client.exceptions.record_failure(
                    repr(e), task=failing_task(e) or client.job_name,
                    restart_number=attempt - 1, exception=e)
                _release_frames(e)
                client.error = e
                del e
                failed_ms = time.time() * 1000.0
                release_ms = _release_attempt(device)
                delay = strategy.next_delay_ms(attempt)
                if delay is None:
                    client._set_status(JobStatus.FAILED)
                    return
                client.num_restarts = attempt
                client._set_status(JobStatus.RESTARTING)
                # the port's downtime runs from the failure caught to
                # RUNNING, the release of the failed attempt included (the
                # JAX package has no such step); the recovery record also
                # reports the release on its own
                client.exceptions.begin_recovery(
                    attempt, cause=repr(client.error), events_at_failure=client.records_in,
                    failed_at_ms=failed_ms, release_ms=release_ms)
                if restart_span is not None:
                    # the previous recovery never reached RUNNING: close its
                    # span so the trace stays bounded
                    client.traces.report(restart_span.set_attribute(
                        "reachedRunning", False).end())
                restart_span = (client.traces.span("recovery", "JobRestart")
                                .set_start(failed_ms)
                                .set_attribute("attempt", attempt)
                                .set_attribute("delayMs", delay)
                                .set_attribute("cause", repr(client.error)[:200]))
                time.sleep(delay / 1000.0)
                t_restore = time.perf_counter()
                restore_snap = coordinator.latest_snapshot() if coordinator else None
                restore_ms = (time.perf_counter() - t_restore) * 1000.0

    @staticmethod
    def _wire_observability(client: JobClient, config: Configuration) -> None:
        """The job's metric and trace planes (the JAX `_run_job_inner`'s):
        a registry its attempts share, a trace registry carrying the job's
        trace id with an OTLP/JSON export and a bounded span log, the
        checkpoint and exception trackers' gauges on the job group, the
        metric history and the health watchdog."""
        client.metrics = MetricRegistry()
        client.trace_id = job_trace_id(client.job_id)
        client.traces = TraceRegistry(trace_id=client.trace_id)
        client.otel = OtlpJsonTraceReporter(service_name="flink-tpu-torch")
        client.traces.add_reporter(client.otel)
        # the raw span log for the latency report's stall attribution and
        # the doctor (bounded: a long-running job must not grow it)
        client.span_log = InMemoryTraceReporter(max_spans=512)
        client.traces.add_reporter(client.span_log)
        client.history = MetricHistory(
            interval_ms=config.get(ObservabilityOptions.HISTORY_INTERVAL_MS),
            retention_points=config.get(ObservabilityOptions.HISTORY_RETENTION_POINTS))
        client.doctor_window_ms = float(config.get(ObservabilityOptions.DOCTOR_WINDOW_MS))
        client.watchdog = None
        if config.get(ObservabilityOptions.DOCTOR_ENABLED):
            def _health_sink(scope, name, start_ms, end_ms, attrs, _c=client):
                _c.traces.report(Span(scope, name, start_ms, end_ms,
                                      dict(attrs, jobId=_c.job_id)))

            client.watchdog = HealthWatchdog(
                _health_sink,
                min_gap_ms=float(config.get(ObservabilityOptions.DOCTOR_WATCHDOG_MIN_GAP_MS)),
                p99_breach_ms=config.get(ObservabilityOptions.DOCTOR_P99_BREACH_MS))
        job_group = client.metrics.group("job")
        client.checkpoint_stats = CheckpointStatsTracker(
            history_size=config.get(ObservabilityOptions.CHECKPOINT_HISTORY_SIZE))
        client.checkpoint_stats.register_metrics(job_group)
        client.exceptions = ExceptionHistory(
            size=config.get(ObservabilityOptions.EXCEPTION_HISTORY_SIZE))
        client.exceptions.register_metrics(job_group)

    @staticmethod
    def _wire_mesh_control(client: JobClient, config: Configuration, device) -> None:
        """The mesh's control loops (the JAX `_run_job_inner`'s): the
        rebalance gauges whenever the mesh is on (0 and the table version
        until a rebalance: one gauge surface for every mesh job), the skew
        rebalancer with parallel.mesh.skew-rebalance, and the autoscaler
        with autoscaler.enabled, holding a real executor when the mesh size
        is its axis (parallel.mesh.autoscale)."""
        mesh_enabled = config.get(ParallelOptions.MESH_ENABLED)
        job_group = client.metrics.group("job")
        if mesh_enabled:
            # per-mesh facts every shard would report alike: folded by max
            job_group.gauge("meshRebalances", lambda: client.mesh_rebalances,
                            fold="max", kind="counter")
            job_group.gauge("lastRebalanceDurationMs",
                            lambda: client.last_mesh_rebalance_duration_ms, fold="max")
            job_group.gauge("routingTableVersion",
                            lambda: (client._runtime is not None
                                     and client._runtime.mesh_routing_version()) or 0,
                            fold="max")
        if mesh_enabled and config.get(ParallelOptions.MESH_SKEW_REBALANCE):
            client.rebalancer = SkewRebalancer(
                skew_threshold=config.get(ParallelOptions.MESH_REBALANCE_SKEW_THRESHOLD),
                interval_ms=config.get(ParallelOptions.MESH_REBALANCE_INTERVAL_MS))
        if not config.get(AutoscalerOptions.ENABLED):
            return
        mesh_executor = None
        if mesh_enabled and config.get(ParallelOptions.MESH_AUTOSCALE):
            def mesh_executor(job_id, target, reason):
                rt = client._runtime
                if rt is None:
                    return False, "no running attempt"
                # the clamp the rebuild will apply, first: an unreachable
                # target reads as rejected instead of costing a rebuild
                # that changes nothing
                eff = _effective_mesh_target(rt, int(target), device)
                if eff is None:
                    return False, "job has no mesh-capable operator"
                cur = rt.mesh_devices()
                if eff == cur:
                    return False, f"mesh already at {cur} device(s)"
                client._mesh_rescale_target = eff
                return True, f"mesh rescale {cur} -> {eff} requested"

        client.autoscaler = AutoscalerCoordinator.from_config(
            config, rescale_executor=mesh_executor)
        # registered without a mesh executor too (a constant 0), so every
        # autoscaled job has one gauge surface
        job_group.gauge("numRescales", lambda: client.mesh_rescales, fold="max",
                        kind="counter")
        job_group.gauge("lastRescaleDurationMs",
                        lambda: client.last_mesh_rescale_duration_ms, fold="max")
        client._autoscaler_metrics = lambda: metrics_snapshot(client.metrics.all_metrics())

    def _attempt(self, client: JobClient, graph: StepGraph, config: Configuration, device,
                 coordinator, restore_snap: Optional[dict], restore_ms: float,
                 pending: Optional[dict] = None, running=None) -> None:
        """One attempt: build the runtime, restore, run to the end. Its
        locals (the runtime above all) die with its frame. `pending`: what
        this attempt completes, each entry popped once stamped, so a later
        attempt never applies it again: "rescale" (the start of a live
        mesh rescale), "rebalance" ({"t0", "assign"}: a skew rebalance,
        whose table goes on after the restore); `running(restored)`:
        called once the attempt runs."""
        pending = {} if pending is None else pending
        rescale_t0 = pending.get("rescale")
        rebalance = pending.get("rebalance")
        runtime = JobRuntime(graph, config, device, registry=client.metrics,
                             traces=client.traces)
        client._attempt_gauges = runtime.gauge_keys
        client._runtime = runtime  # queryable state
        if coordinator is not None:
            # each attempt gets its full tolerable-failed-checkpoints budget
            coordinator.reset_failure_streak()
            coordinator.state_bytes_fn = runtime.operator_state_bytes
        if restore_snap is not None:
            runtime.restore(restore_snap)
            if rescale_t0 is None and rebalance is None:
                # a rescale or rebalance restores its own capture, not a
                # stored checkpoint
                client.checkpoint_stats.report_restore(restore_snap.get("checkpoint_id"),
                                                       restore_ms)
        if rescale_t0 is not None:
            # the rebuilt attempt serves at the new size: stamp the rescale
            # and close the autoscaler's loop, tagged with the size reached
            duration_ms = (time.perf_counter() - rescale_t0) * 1000.0
            client.mesh_rescales += 1
            client.last_mesh_rescale_duration_ms = duration_ms
            if client.autoscaler is not None:
                client.autoscaler.rescale_completed(client.job_id, duration_ms,
                                                    target=runtime.mesh_devices())
            del pending["rescale"]
        if rebalance is not None:
            # the table goes on AFTER the restore (which may have adopted a
            # grown K and rebuilt the table at identity); the capture is
            # canonical [K, S], so re-laying its rows is pure placement
            runtime.set_mesh_routing(rebalance["assign"])
            client.mesh_rebalances += 1
            client.last_mesh_rebalance_duration_ms = (
                (time.perf_counter() - rebalance["t0"]) * 1000.0)
            if client.rebalancer is not None:
                # the new placement gets fresh traffic before it is judged
                client.rebalancer.rebalance_completed()
            del pending["rebalance"]
        client._set_status(JobStatus.RUNNING)
        client.exceptions.complete_recovery(
            restored_checkpoint_id=(restore_snap or {}).get("checkpoint_id"),
            restore_duration_ms=restore_ms,
            events_replayed=(client.records_in - restore_snap.get("records_in", 0)
                             if restore_snap is not None else client.records_in))
        if running is not None:
            running(restore_snap is not None)

        mesh_enabled = config.get(ParallelOptions.MESH_ENABLED)
        mesh_autoscale = mesh_enabled and config.get(ParallelOptions.MESH_AUTOSCALE)

        def cancel_check():
            client.records_in = runtime.records_in  # progress gauge
            if client.autoscaler is not None:
                # throttled: a registry snapshot only when an interval tick
                # is due; on a mesh job the parallelism the policy sees is
                # the mesh size, the axis its executor rescales
                client.autoscaler.maybe_observe(
                    client.job_id, runtime.mesh_devices() if mesh_autoscale else 1,
                    client._autoscaler_metrics)
            # the history's tick: the cheap due() gate every step, the
            # registry snapshot only when an interval is due
            if client.history.due():
                client.history.sample(metrics_snapshot(client.metrics.all_metrics()))
                if client.watchdog is not None:
                    client.watchdog.observe(client.history)
            return client._cancel.is_set()

        def savepoint_request():
            path = client._poll_savepoint_request()
            if path is not None:
                runtime._write_savepoint(path)
                client._savepoint_done.set()
            return None  # the runtime's capture is already written

        def rescale_request():
            # a manual target arrives unclamped: clamp it as the rebuilt
            # operators will, so an unreachable target (or one landing on
            # the current size) never costs a rebuild that changes nothing
            t = client._poll_mesh_rescale()
            if t is None:
                return None
            eff = _effective_mesh_target(runtime, t, device)
            return None if eff is None or eff == runtime.mesh_devices() else eff

        def rebalance_request():
            # the interval gate first (a clock read a step); only a due
            # tick pays the per-group load readback and the replan
            reb = client.rebalancer
            if not reb.due():
                return None
            info = runtime.mesh_group_loads()
            if info is None:
                return None
            loads, assign, n = info
            return reb.maybe_decide(loads, assign, n)

        try:
            runtime.run(coordinator=coordinator, cancel_check=cancel_check,
                        savepoint_request=savepoint_request,
                        rescale_request=rescale_request if mesh_enabled else None,
                        rebalance_request=(rebalance_request
                                           if client.rebalancer is not None else None))
            client.records_in = runtime.records_in
        finally:
            if coordinator is not None:
                coordinator.state_bytes_fn = None
