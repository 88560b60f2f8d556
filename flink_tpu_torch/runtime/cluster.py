"""Distributed cluster runtime: JobManager + TaskExecutors over RPC + DCN.

The multi-host counterpart of the in-process MiniCluster — the analogue of
the reference's control plane (Dispatcher.submitJob Dispatcher.java:835,
JobMaster.java:155) and data plane (TaskExecutor.submitTask
TaskExecutor.java:660) re-expressed for stepped dataflow:

- A **JobManager** endpoint accepts TaskExecutor registrations (slot offers),
  persists submitted job specs in the blob server (JAR-shipping analogue,
  BlobServer.java:88), deploys one shard per slot with the full peer
  exchange-address map, coordinates **step-aligned checkpoints** (the
  barrier is a step boundary: every shard snapshots after processing step
  s_target-1, giving a consistent cut for free — SURVEY.md §7 stage 5), and
  drives **failover**: a TaskExecutor heartbeat timeout fails the job,
  cancels surviving tasks and redeploys attempt n+1 from the latest
  completed checkpoint (RestartPipelinedRegionFailoverStrategy analogue at
  whole-job granularity — stepped all-to-all makes every shard one region).
- A **TaskExecutor** endpoint runs one shard per deployed task: pull a
  source batch, bucket records by key-group owner
  (KeyGroupStreamPartitioner analogue), all-to-all the buckets over the
  credit-controlled exchange (dataplane.py), merge one batch per input
  channel per step with min-combined watermarks (StatusWatermarkValve
  semantics), and feed the shard's keyed window operator.

Exactly-once: snapshots hold (source step cursor, operator state); restart
rewinds sources to the checkpointed step and replays — in-flight exchange
batches need no persistence because they are regenerated (the stepped
equivalent of replaying from the source offset in the snapshot).

Counterpart of `flink_tpu/runtime/cluster.py`, copied whole (chaos seams
and the autoscaler loop included). The port's TaskExecutor resolves its
device once (`TaskExecutorEndpoint(device=)`, CUDA unless the caller asks
for the CPU; `main --device`) and runs every task on it: the JobRuntime of
a graph job or stage (the fused window and so kernel K1), and the device
operators of a sharded job (`TpuWindowOperator`, `TpuSessionWindowOperator`
on K3/K4). Snapshots and shipped metrics are host data (numpy and plain
values). An ended task freezes its gauges, which let go of its runtime,
and a task of a redeployed attempt starts only after the superseded
attempt's task on the same TaskExecutor has ended and been collected, so
the dead attempt's device rings are not alive beside the new ones.
"""

from __future__ import annotations

import gc
import logging
import pickle
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.chaos import plan as _chaos
from flink_tpu_torch.lint.contracts import absorbs_faults

_LOG = logging.getLogger(__name__)


#: reply timeout for gateways carrying PAYLOAD-shipping calls — deploys
#: restoring large snapshots, checkpoint acks the JM persists before
#: replying, blob fetches. The default 10s wedge detector would hard-fail
#: a genuinely big (and non-retryable) transfer; control-plane-only
#: gateways keep the tight default.
PAYLOAD_REPLY_TIMEOUT_S = 120.0


def _swallow(site: str, exc: BaseException) -> None:
    """Best-effort control-plane calls (cancel fan-out, decline-on-behalf,
    state release, loop ticks) deliberately survive peer failures — but
    never SILENTLY (lint CONC005 no-silent-swallow): every swallowed
    exception is debug-logged with its site so a misbehaving plane is
    diagnosable without a debugger."""
    _LOG.debug("swallowed %r at %s", exc, site)

from flink_tpu_torch.core.keygroups import (
    KeyGroupRange,
    key_group_range_for_operator,
    key_groups_for_hashes,
    key_hash,
    operator_index_for_key_group,
)
from flink_tpu_torch.core.time import MAX_WATERMARK, MIN_WATERMARK
from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage
from flink_tpu_torch.metrics.checkpoint_stats import (
    CheckpointStatsTracker,
    ExceptionHistory,
    operator_bytes_from_snapshot,
    snapshot_bytes_estimate,
)
from flink_tpu_torch.metrics.registry import Gauge, MetricRegistry, metrics_snapshot
from flink_tpu_torch.metrics.task_io import backpressure_level
from flink_tpu_torch.metrics.traces import Span, job_trace_id
from flink_tpu_torch.runtime.blob import BlobCache, BlobServerEndpoint
from flink_tpu_torch.runtime.dataplane import (
    ExchangeServer,
    OutputChannel,
    SequenceLostError,
)
from flink_tpu_torch.runtime.heartbeat import HeartbeatManager
from flink_tpu_torch.runtime.rpc import (
    RetryPolicy,
    RpcEndpoint,
    RpcGateway,
    RpcService,
    current_trace_id,
    trace_context,
)
from flink_tpu_torch.security.framing import trusted_loads
from flink_tpu_torch.state import key_groups


# ---------------------------------------------------------------------------
# job specification (shipped through the blob server)
# ---------------------------------------------------------------------------

class _PickledSpec:
    """Serialization shared by job specs: cloudpickle (when present) ships
    closures/lambdas the way the reference ships user JARs; plain picklable
    specs need only stdlib.

    Specs are code by definition (they carry user closures), so they bypass
    the transport allowlist — but only ever deserialize AFTER the carrying
    connection authenticated (security/framing.py trusted_loads): the
    user-JAR trust model of the reference."""

    def to_bytes(self) -> bytes:
        try:
            import cloudpickle

            return cloudpickle.dumps(self)
        except ImportError:
            return pickle.dumps(self, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def from_bytes(b: bytes):
        return trusted_loads(b)


@dataclass
class DistributedJobSpec(_PickledSpec):
    """A keyed windowed-aggregation pipeline, the distributed hot path.

    source_factory(shard, num_shards) -> list of (keys, vals, ts, wm) step
    batches for that shard's partition of the source."""

    name: str
    source_factory: Callable[[int, int], List[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]]
    assigner: Any
    aggregate: Any
    allowed_lateness: int = 0
    max_parallelism: int = 128
    operator: str = "oracle"          # 'oracle' | 'device'
    # declared source volume (records) for AUTO parallelism: submitting
    # with parallelism=0 derives the task count from this, the
    # AdaptiveBatchScheduler analogue (scheduler/adaptivebatch/ derives
    # per-stage parallelism from produced bytes)
    source_records_hint: Optional[int] = None
    # device-operator construction knobs (e.g. session num_slices /
    # key_capacity for skewed/out-of-order streams)
    operator_options: Optional[Dict[str, Any]] = None
    # optional per-job Configuration (exchange.wire-format,
    # exchange.reconnect.window-ms, observability.sampling.interval-ms...)
    config: Optional[Any] = None


@dataclass
class GraphJobSpec(_PickledSpec):
    """A general StepGraph job for the distributed runtime.

    The keyed-window hot path runs sharded through DistributedJobSpec; any
    OTHER planned pipeline (multi-input DAGs, joins, side outputs, CEP,
    process functions...) ships as its full StepGraph and executes as one
    JobRuntime task on a TaskExecutor — the cluster analogue of submitting
    an arbitrary JobGraph: full operator coverage with cluster supervision
    (checkpoints, failover, local recovery) at task granularity."""

    name: str
    graph: Any          # graph.transformation.StepGraph
    config: Any         # flink_tpu_torch.config.Configuration


def merge_shard_snapshots(handles: Dict[int, dict]) -> dict:
    """Fold per-shard snapshots into one logical-state snapshot for
    rescaling: heap tables union by key group (disjoint by construction,
    the StateAssignmentOperation analogue — state/key_groups.py holds the
    shared remap primitives), timers concatenate, the collect-sink results
    concatenate. Each new shard restores from this and filters to its own
    KeyGroupRange (state/heap.py restore; timers via
    filter_timers_for_range)."""
    ok, why = key_groups.reshardable(handles)
    if not ok:
        raise ValueError(why)
    shards = sorted(handles)
    ops = [handles[s]["operator"] for s in shards]
    merged_op = {
        "state": key_groups.merge_keyed_state(
            [op.get("state", {}) for op in ops]),
        "timers": key_groups.merge_timers([op.get("timers") for op in ops]),
    }
    results: list = []
    for s in shards:
        results.extend(handles[s].get("results", []))
    step = handles[min(handles)]["step"]
    return {"operator": merged_op, "results": results, "step": step, "merged": True}


@dataclass
class _JobState:
    job_id: str
    blob_key: str
    parallelism: int
    spec_name: str
    # rescale eligibility, captured at submit: keyed DistributedJobSpec
    # jobs re-shard by key group up to the spec's key-group count; graph
    # jobs snapshot whole runtimes and cannot change task count
    keyed: bool = True
    spec_max_parallelism: int = 128
    status: str = "CREATED"            # CREATED/RUNNING/RESTARTING/FINISHED/FAILED/CANCELED
    requested_parallelism: int = 0
    attempt: int = 0
    assignment: Dict[int, str] = field(default_factory=dict)   # shard -> tm_id
    finished: Dict[int, list] = field(default_factory=dict)    # shard -> results
    restarts: int = 0
    # checkpointing
    next_checkpoint_id: int = 1
    pending: Dict[int, dict] = field(default_factory=dict)     # cp_id -> {shard: handle}
    pending_target: Dict[int, int] = field(default_factory=dict)
    completed: List[Tuple[int, dict, int]] = field(default_factory=list)  # (cp_id, handles, step)
    cp_origins: Dict[int, Dict[int, str]] = field(default_factory=dict)    # cp_id -> {shard: tm_id}
    steps: Dict[int, int] = field(default_factory=dict)        # shard -> last reported step
    stages: int = 1      # >1: GraphJobSpec split into pipeline stages (slot
    #                      sharing groups); shard index = stage index
    source_stages: List[int] = field(default_factory=list)  # trigger targets
    savepoint_paths: Dict[int, Tuple[str, int]] = field(
        default_factory=dict)   # cp_id -> (target dir, retry margin)
    completed_savepoints: List[str] = field(default_factory=list)
    failed_savepoints: List[str] = field(default_factory=list)
    # observability plane: per-job correlation id, latest per-shard metric
    # snapshot shipped by the TMs, and the bounded span feed (JM trigger
    # spans + TM ack spans, all carrying trace_id)
    trace_id: str = ""
    metric_snapshots: Dict[int, dict] = field(default_factory=dict)
    spans: List[dict] = field(default_factory=list)
    # history plane: bounded metric time-series rings sampled
    # from the shard-folded snapshots on the schedule tick, plus the
    # threshold watchdog emitting health.* spans into `spans` (both
    # metrics-layer objects — Any avoids a dataclass-level import)
    history: Any = None
    watchdog: Any = None
    # fault-tolerance observability: per-checkpoint stat records + lifetime
    # counters, and the bounded exception/restart history that replaced the
    # single overwritten failure string (sizes set by the JM at submit)
    stats: CheckpointStatsTracker = field(default_factory=CheckpointStatsTracker)
    exceptions: ExceptionHistory = field(default_factory=ExceptionHistory)
    # elastic autoscaling (scheduler/): deliberate rescale bookkeeping —
    # lifetime count, last redeploy duration, and the perf_counter stamp of
    # an in-flight rescale (cleared when the new attempt reaches RUNNING)
    num_rescales: int = 0
    last_rescale_duration_ms: float = 0.0
    rescale_started: Optional[float] = None
    # stuck-task watchdog: per-shard (last reported step, monotonic stamp
    # of the last time it ADVANCED) — cleared on every (re)deploy
    progress: Dict[int, Tuple[int, float]] = field(default_factory=dict)
    # execution.checkpointing.tolerable-failed-checkpoints accounting:
    # consecutive persist/coordination failures; reset by a completion
    consecutive_cp_failures: int = 0

    @property
    def failure(self) -> Optional[str]:
        """Latest failure cause (legacy single-string view of the bounded
        exception history)."""
        latest = self.exceptions.latest()
        return latest["exception"] if latest is not None else None


_MAX_JOB_SPANS = 1024


def _shard_combine(key: str) -> str:
    """DEPRECATED name-heuristic fold fallback.

    Fold kinds are now DECLARED at registration (`MetricGroup.gauge(...,
    fold=...)` in metrics/registry.py) and shipped in each snapshot's
    reserved ``__folds__`` entry — `aggregate_shard_metrics` reads the
    declaration and only reaches here for keys without one (old TMs,
    unmigrated third-party gauges), emitting a once-per-key
    DeprecationWarning. This function is the ONLY place the `current*`
    prefix rule and the exemption tuples may be consulted for folding;
    new metric families must declare instead of growing this heuristic
    (the `_TIER_GAUGES`-omission bug class).

    The heuristic itself: per-task fractions (ratios, pool occupancy,
    busy/idle/backPressured TimeMsPerSecond — each bounded per task)
    average; watermark positions take the MIN (the job-level combined
    watermark is what EVERY subtask has reached — averaging would report
    progress a straggler shard has not made); skew/storm/hot-key gauges
    take the MAX (the job's skew is its worst shard); everything else
    (counters, totals, and THROUGHPUT rates like numRecordsInPerSecond,
    which is work done) sums. Matches on the full key, not just the
    leaf: per-channel gauges like exchange.inPoolUsage.<n> have a
    numeric leaf."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf.startswith("current") and leaf not in _LATENCY_MAX_GAUGES:
        # the current* prefix means "watermark position" (fold MIN: the
        # straggler defines job progress) — EXCEPT currentBatchRung,
        # which is a controller geometry, where the job-level view is the
        # largest rung any shard is still dispatching (worst latency)
        return "min"
    if leaf == "joinFallbackReason":
        # a catalogued reason CODE, not a count: the job-level view is
        # "did ANY shard degrade, and why" — summing codes across shards
        # would fabricate a different (or uncatalogued) code
        return "max"
    if leaf in ("keySkew", "recompileStorm", "hotKeyLoad", "meshLoadSkew",
                "meshDevices") or leaf in _PER_DEVICE_MAX_GAUGES \
            or leaf in _REBALANCE_GAUGES or leaf in _LATENCY_MAX_GAUGES:
        # meshDevices included: each shard reports ITS mesh size — summing
        # across shards would misreport a plain 2-shard job as a 2-device
        # mesh (the job-level view is the largest mesh any shard runs).
        # The skew-rebalance family folds MAX for the same shape reason:
        # rebalance counts, table versions, and durations are per-mesh
        # facts every shard of that mesh reports identically — summing
        # would multiply them by the shard count
        return "max"
    if "Ratio" in leaf or leaf.endswith("TimeMsPerSecond") \
            or leaf.endswith("UtilizationPct") or "inPoolUsage" in key:
        return "mean"
    return "sum"


#: gauges shipped as {device_index: value} maps by mesh shards
#: (metrics/key_stats.py): each is a MAX-rule family, and the fold must
#: take the max across the shard's OWN mesh devices FIRST — the generic
#: dict branch below merges per stat key, which for a per-device map means
#: whichever device index collides across shards wins and the job-level
#: scalar silently becomes device 0's view
#: exactly the maps metrics/key_stats.py registers on mesh operators —
#: keep the two lists in lockstep (compile tracking is per-process SPMD,
#: one program for the whole mesh, so it has no per-device form)
_PER_DEVICE_MAX_GAUGES = ("keySkewPerDevice", "hotKeyLoadPerDevice",
                          "meshDeviceLoad")

#: skew-rebalance gauge family (parallel.mesh.skew-rebalance, registered
#: by the in-process job master): per-mesh facts every shard reports
#: identically, so they fold MAX (the _TIER_GAUGES-omission lesson: a
#: family missing from BOTH the fold rule and the device payload filters
#: silently reads as 0 / absent at the job level)
_REBALANCE_GAUGES = ("meshRebalances", "routingTableVersion",
                     "lastRebalanceDurationMs")

#: state-tier gauge family (state/tier_manager.py, registered by the
#: window-step runner): counters and sizes SUM across shards — each shard
#: owns its contiguous key range, so the job-level vocabulary/eviction/
#: spilled view is the total, never the worst shard — while
#: tierHotFillRatio (a per-shard fraction) takes the generic "Ratio" MEAN
#: rule. Listed here so the distributed /jobs/:id/device payload filter
#: carries them; the fold itself needs no extra rule (sum is the default).
_TIER_GAUGES = ("vocabSize", "residentKeys", "evictions", "promotions",
                "spilledBytes", "changelogBytes", "tierHotFillRatio")

#: device-join gauge family (runtime/device_join_operator.py, registered
#: per join operator): ring occupancy and matches emitted are per-shard
#: counts over owned key ranges, so they SUM (the default rule);
#: joinFallbackReason is a catalogued reason code and folds MAX above.
#: Listed here so both /jobs/:id/device payload filters carry the family
#: (the _TIER_GAUGES-omission lesson again: a family missing from the
#: filters silently reads as absent at the job level).
_JOIN_GAUGES = ("joinRingOccupancy", "joinMatchesEmitted",
                "joinFallbackReason")

#: emission-latency plane (metrics/emission_latency.py, registered per
#: windowed operator + the job-level p99 gauge): emissionLatencyMs ships
#: as a FLAT log-bucket snapshot and folds BUCKET-WISE (merge_snapshots —
#: the generic dict envelope would sum counts but max the percentiles,
#: which overstates the merged tail); watermarkLagMs and the job p99 are
#: worst-shard facts and fold MAX. One shared tuple feeds the fold rule
#: AND both /jobs/:id/device-style payload filters (the _TIER_GAUGES-
#: omission lesson: a family missing from either silently reads 0/absent
#: job-level).
#: latency-mode controller gauges (scheduler/latency_controller.py via
#: FusedWindowOperator.latency_gauges, registered only when
#: execution.latency.target-ms is on): rung depth, in-flight ring depth,
#: and distinct ladder geometries are per-shard controller facts whose
#: job-level view is the worst shard (the deepest rung / fullest ring /
#: most geometries compiled), so the whole family folds MAX; the tuple
#: also feeds _LATENCY_GAUGES below so both /jobs/:id/device payload
#: filters carry it (the _TIER_GAUGES-omission lesson yet again).
_LATENCY_CONTROLLER_GAUGES = ("latencyModeActive", "currentBatchRung",
                              "inflightDepth", "ladderRecompiles")
_LATENCY_MAX_GAUGES = ("watermarkLagMs",
                       "p99EmissionLatencyMs") + _LATENCY_CONTROLLER_GAUGES
_LATENCY_HISTOGRAMS = ("emissionLatencyMs",)
_LATENCY_GAUGES = _LATENCY_MAX_GAUGES + _LATENCY_HISTOGRAMS

#: the ONE leaf-name set both /jobs/:id/device payload filters consult
#: (the consolidation of the scattered per-filter tuple unions — the
#: _TIER_GAUGES-omission lesson: two hand-maintained filters drift, one
#: derived set cannot)
_DEVICE_PAYLOAD_LEAVES = frozenset(
    ("keySkew", "activeKeys", "hotKeyLoad", "keyGroupLoad",
     "keyGroupStateBytes", "hbmUtilizationPct", "flopsUtilizationPct",
     "meshLoadSkew", "meshDevices")
    + _TIER_GAUGES + _PER_DEVICE_MAX_GAUGES + _REBALANCE_GAUGES
    + _JOIN_GAUGES + _LATENCY_GAUGES)


def _is_device_payload_key(key: str) -> bool:
    """Does `key` belong in a /jobs/:id/device payload (job-level fold
    and per-shard alike)? Reserved ``__`` metadata never does."""
    if key.startswith("__"):
        return False
    return (".device." in key or "keySkew" in key or "meshLoadSkew" in key
            or key.rsplit(".", 1)[-1] in _DEVICE_PAYLOAD_LEAVES)


#: keys that already fell back to the name heuristic (warn once per key,
#: not once per heartbeat fold)
_WARNED_UNDECLARED: set = set()


def _fold_for(key: str, declared: Dict[str, str]) -> str:
    """Declared fold kind, else the DEPRECATED name heuristic (warns once
    per key)."""
    how = declared.get(key)
    if how is not None:
        return how
    if key not in _WARNED_UNDECLARED:
        _WARNED_UNDECLARED.add(key)
        import warnings

        warnings.warn(
            f"metric {key!r} declares no fold kind; falling back to the "
            "deprecated name heuristic — register it with "
            "gauge(..., fold=...) (metrics/registry.py)",
            DeprecationWarning, stacklevel=3)
    return _shard_combine(key)


def aggregate_shard_metrics(per_shard: Dict[int, dict]) -> dict:
    """Fold per-shard metric snapshots into one job-level view.

    The fold kind per key comes from the snapshots' reserved ``__folds__``
    declarations (registered with the metric — metrics/registry.py);
    undeclared keys fall back to the deprecated `_shard_combine` name
    heuristic with a warning. Dict-valued metrics fold by declaration
    too: ``"emission"`` merges log buckets exactly, ``"per-device-max"``
    maxes over the shard's device map first, and everything else takes
    the approximate envelope — max-of-p99 / min-of-min / summed count
    (cheap percentile union; exact merging would need the reservoirs,
    which stay TM-local) — marked ``"approx": true`` in the folded
    payload so readers never mistake it for the exact bucket-wise merge
    emission histograms get."""
    from flink_tpu_torch.metrics.emission_latency import (
        merge_snapshots as _merge_emission,
    )

    declared: Dict[str, str] = {}
    for snap in per_shard.values():
        folds = snap.get("__folds__")
        if isinstance(folds, dict):
            declared.update(folds)

    scalars: Dict[str, List[float]] = {}
    emission: Dict[str, list] = {}
    agg: dict = {}
    for snap in per_shard.values():
        for key, val in snap.items():
            if key.startswith("__"):    # reserved metadata, not a metric
                continue
            leaf = key.rsplit(".", 1)[-1]
            if isinstance(val, dict):
                how = declared.get(key)
                if how == "emission" or (how is None
                                         and leaf in _LATENCY_HISTOGRAMS):
                    # emission-latency histograms carry their log buckets,
                    # so the fold is EXACT: merge bucket counts, recompute
                    # the percentiles — never the generic envelope below
                    emission.setdefault(key, []).append(val)
                    continue
                if how == "per-device-max" or (
                        how is None and leaf in _PER_DEVICE_MAX_GAUGES):
                    # per-mesh-device map: fold across THIS shard's
                    # devices first (MAX — the job's view of a skew/storm/
                    # hot-key family is its worst device, and device
                    # indexes repeat across shards so elementwise merging
                    # would be meaningless), then MAX across shards
                    devs = [v for v in val.values()
                            if isinstance(v, (int, float))]
                    if devs:
                        scalars.setdefault(key, []).append(float(max(devs)))
                    continue
                cur = agg.setdefault(key, {})
                # honest labeling: the envelope is approximate (exact
                # quantile merging needs the TM-local reservoirs)
                cur["approx"] = True
                for stat, v in val.items():
                    if not isinstance(v, (int, float)):
                        continue
                    if stat == "count":
                        cur[stat] = cur.get(stat, 0) + v
                    elif stat == "min":
                        cur[stat] = min(cur.get(stat, v), v)
                    else:   # max / mean / percentiles: upper envelope
                        cur[stat] = max(cur.get(stat, v), v)
            elif isinstance(val, (int, float)):
                scalars.setdefault(key, []).append(val)
    wm_skews = []
    for key, vals in scalars.items():
        how = _fold_for(key, declared)
        if how == "max":
            agg[key] = max(vals)
        elif how == "min":
            agg[key] = min(vals)
            # job-level watermark skew: max-min currentWatermark across the
            # subtasks of one operator — how far the combined (MIN) watermark
            # trails the fastest subtask, i.e. the straggler's lag in event
            # time. The job gauge is the worst skew over all operators.
            # Subtasks still at the MIN_WATERMARK sentinel (no watermark
            # yet) are excluded: differencing against -(1<<63) would export
            # a ~9.2e18 garbage value that wrecks dashboards and alerts.
            if key.rsplit(".", 1)[-1] == "currentWatermark":
                real = [v for v in vals if v > MIN_WATERMARK]
                wm_skews.append(max(real) - min(real) if len(real) >= 2
                                else 0.0)
        elif how == "mean":
            agg[key] = sum(vals) / len(vals)
        else:
            agg[key] = sum(vals)
    for key, snaps in emission.items():
        agg[key] = _merge_emission(snaps)
    if wm_skews:
        agg["job.watermarkSkewMs"] = max(wm_skews)
    return agg


class JobManagerEndpoint(RpcEndpoint):
    """Dispatcher + JobMaster in one endpoint (M2+M3 scope)."""

    def __init__(
        self,
        rpc: RpcService,
        *,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: float = 0.0,
        restart_attempts: int = 2,
        restart_delay: float = 0.2,
        heartbeat_interval: float = 0.5,
        heartbeat_timeout: float = 3.0,
        adaptive: bool = True,
        auto_records_per_task: int = 1 << 20,
        checkpoint_history_size: int = 10,
        exception_history_size: int = 16,
        autoscaler_config=None,
        tolerable_failed_checkpoints: int = 0,
        stuck_task_timeout_ms: int = 0,
        history_interval_ms: int = 1000,
        history_retention_points: int = 256,
        doctor_enabled: bool = True,
        doctor_window_ms: float = 60000.0,
        watchdog_min_gap_ms: float = 5000.0,
        p99_breach_ms: float = 0.0,
    ):
        super().__init__(name="jobmanager")
        self.rpc = rpc
        self.auto_records_per_task = auto_records_per_task
        # observability.history.* / observability.doctor.*: the
        # JM samples each job's shard-folded snapshot into bounded rings on
        # the schedule tick and runs the threshold watchdog over them
        self.history_interval_ms = history_interval_ms
        self.history_retention_points = history_retention_points
        self.doctor_enabled = doctor_enabled
        self.doctor_window_ms = doctor_window_ms
        self.watchdog_min_gap_ms = watchdog_min_gap_ms
        self.p99_breach_ms = p99_breach_ms
        # execution.checkpointing.tolerable-failed-checkpoints: consecutive
        # checkpoint failures absorbed (FAILED stats record + gauge) before
        # the job takes the restart path
        self.tolerable_failed_checkpoints = tolerable_failed_checkpoints
        # execution.watchdog.stuck-task-timeout-ms: 0 = watchdog off
        self.stuck_task_timeout_ms = stuck_task_timeout_ms
        # observability.checkpoint-history.size / .exception-history.size
        self.checkpoint_history_size = checkpoint_history_size
        self.exception_history_size = exception_history_size
        self.blob = BlobServerEndpoint()
        rpc.register(self)
        rpc.register(self.blob)
        self.checkpoint_interval = checkpoint_interval
        self.restart_attempts = restart_attempts
        self.adaptive = adaptive
        self.restart_delay = restart_delay
        self._storage = FsCheckpointStorage(checkpoint_dir) if checkpoint_dir else None
        self._tms: Dict[str, dict] = {}
        self._jobs: Dict[str, _JobState] = {}
        self.heartbeats = HeartbeatManager(
            interval=heartbeat_interval, timeout=heartbeat_timeout,
            on_dead=self._on_tm_dead,
        )
        if checkpoint_interval > 0:
            threading.Thread(target=self._checkpoint_loop, daemon=True,
                             name="checkpoint-trigger").start()
        # periodic scheduling retry: jobs parked in RESTARTING (e.g. a deploy
        # hit a dead-but-undetected worker) get re-attempted without needing
        # a registration event
        self._stopped = threading.Event()
        threading.Thread(target=self._schedule_loop, daemon=True,
                         name="schedule-retry").start()
        # elastic autoscaler (scheduler/ — AdaptiveScheduler analogue): a
        # controller thread samples each RUNNING job's aggregated gauges
        # into the signal windows and executes policy-driven rescales via
        # _rescale_job; `autoscaler_config` is a Configuration carrying the
        # autoscaler.* group (None or enabled=false leaves it off)
        self.autoscaler = None
        self._autoscaler_interval = 1.0
        if autoscaler_config is not None:
            from flink_tpu_torch.config import AutoscalerOptions
            from flink_tpu_torch.scheduler import AutoscalerCoordinator

            if autoscaler_config.get(AutoscalerOptions.ENABLED):
                self.autoscaler = AutoscalerCoordinator.from_config(
                    autoscaler_config, rescale_executor=self._rescale_job)
                self._autoscaler_interval = autoscaler_config.get(
                    AutoscalerOptions.INTERVAL_MS) / 1000.0
                threading.Thread(target=self._autoscaler_loop, daemon=True,
                                 name="autoscaler").start()

    @absorbs_faults('background autoscaler tick: a failed tick is logged and retried next interval; job failover, not this timer thread, owns fault propagation')
    def _autoscaler_loop(self) -> None:
        while not self._stopped.wait(self._autoscaler_interval):
            try:
                self.run_in_main_thread(self._autoscale_tick).result(timeout=30)
            except Exception as e:
                _swallow("autoscaler_loop", e)

    def _autoscale_tick(self) -> None:
        """One controller evaluation (JM main thread — the coordinator's
        rescale executor mutates job state inline, like every other
        scheduling mutation). Only keyed single-vertex jobs are eligible:
        staged pipelines snapshot per-stage runtimes, not key-group state."""
        for job_id, job in list(self._jobs.items()):
            if job.status != "RUNNING" or job.stages != 1 or not job.keyed:
                continue
            metrics, per_shard, _ = self._aggregated_job_metrics(job)
            if not per_shard:
                continue
            self.autoscaler.observe(
                job_id, job.parallelism, metrics,
                # slots the job could occupy, capped by its key-group count
                max_slots=min(len(self._free_slots()) + job.parallelism,
                              job.spec_max_parallelism),
            )

    @absorbs_faults('JM schedule tick: a failed tick is logged and the loop retries; task failures surface through the failover path, not this timer thread')
    def _schedule_loop(self) -> None:
        while not self._stopped.wait(max(self.restart_delay, 0.2)):
            try:
                self.run_in_main_thread(self._schedule_tick).result(timeout=30)
            except Exception as e:
                _swallow("schedule_loop", e)

    def _schedule_tick(self) -> None:
        self._try_schedule_all()
        self._watchdog_tick()
        self._history_tick()

    @absorbs_faults('metrics history sampling is best-effort observability; a failed sample must not take down the scheduler tick')
    def _history_tick(self) -> None:
        """Sample each RUNNING job's shard-folded snapshot into its
        history rings (JM main thread, riding the existing schedule tick
        — the processing-time tick of the distributed path) and let the
        health watchdog inspect the fresh window. The cheap due() gate
        runs first so an idle tick costs two comparisons."""
        for job in list(self._jobs.values()):
            if (job.status != "RUNNING" or job.history is None
                    or not job.metric_snapshots or not job.history.due()):
                continue
            try:
                agg, per_shard, _ = self._aggregated_job_metrics(job)
                kinds: Dict[str, str] = {}
                for snap in per_shard.values():
                    k = snap.get("__kinds__")
                    if isinstance(k, dict):
                        kinds.update(k)
                job.history.sample(agg, kinds=kinds)
                if job.watchdog is not None:
                    job.watchdog.observe(job.history)
            except Exception as e:
                _swallow("history_tick", e)

    def _watchdog_tick(self) -> None:
        """Stuck-task watchdog (JM main thread): a task whose heartbeat-
        reported step counter has not advanced for
        `stuck_task_timeout_ms` while its TM keeps heartbeating is wedged
        INSIDE a live process — invisible to heartbeat failure detection
        — and is failed through the normal attributed restart path. TM
        loss and finished shards are excluded (their own paths own them)."""
        if self.stuck_task_timeout_ms <= 0:
            return
        now = time.monotonic()
        for job in list(self._jobs.values()):
            if job.status != "RUNNING":
                continue
            for shard, (step, stamped) in list(job.progress.items()):
                if shard in job.finished:
                    continue
                tm_id = job.assignment.get(shard)
                if tm_id is None or not self.heartbeats.is_alive(tm_id):
                    continue      # dead TM: the heartbeat path handles it
                stalled_ms = (now - stamped) * 1000.0
                if stalled_ms >= self.stuck_task_timeout_ms:
                    self._fail_job(
                        job,
                        f"shard {shard} stuck at step {step}: no progress "
                        f"for {stalled_ms:.0f} ms while TM {tm_id} stayed "
                        "alive (stuck-task watchdog)",
                        task=f"shard-{shard}", task_manager=tm_id)
                    break         # one failover per job per tick

    def stop(self) -> None:
        self._stopped.set()
        self.heartbeats.stop()
        super().stop()

    # ---- TaskExecutor registration / liveness (M5/M8/M10 scope) ----------
    def register_task_executor(self, tm_id: str, rpc_address: str,
                               exchange_address: str, slots: int = 1) -> dict:
        self._tms[tm_id] = {
            "rpc": rpc_address, "exchange": exchange_address, "slots": slots,
            # deploy_task ships restore snapshots: payload reply budget
            "gateway": self.rpc.gateway(
                rpc_address, "taskexecutor",
                reply_timeout=PAYLOAD_REPLY_TIMEOUT_S),
        }
        self.heartbeats.monitor(tm_id)
        try:
            self._try_schedule_all()
        except Exception as e:
            _swallow("register.try_schedule", e)  # scheduling trouble must
            #                                      not fail the registration
        return {"registered": True, "jm_blob": "blob"}

    def heartbeat_tm(self, tm_id: str, steps: Optional[dict] = None,
                     metrics: Optional[dict] = None,
                     spans: Optional[list] = None) -> bool:
        # chaos seam: a heartbeat-scope drop rule partitions this TM from
        # the JM's liveness view — beats (and the steps/metrics riding
        # them) vanish exactly as on a one-way network partition
        hook = _chaos.HOOK
        if hook is not None and hook("heartbeat", tm_id) == "drop":
            return False
        self.heartbeats.receive_heartbeat(tm_id)
        # keys are (job_id, shard, attempt) — the attempt guard keeps an
        # in-flight heartbeat snapshotted before a rescale's cancel from
        # re-landing AFTER the redeploy cleared job.steps/metric_snapshots
        # (a dead higher shard would otherwise pollute the aggregates and
        # the autoscaler's signal windows for the whole new attempt);
        # 2-tuple keys (older TMs) are accepted unguarded
        if steps:
            now = time.monotonic()
            for (job_id, shard, *att), step in steps.items():
                job = self._jobs.get(job_id)
                if job is not None and (not att or att[0] == job.attempt):
                    job.steps[shard] = step
                    # watchdog progress stamp: refreshed only when the
                    # step ADVANCES (a frozen counter is what stuck means)
                    prev = job.progress.get(shard)
                    if prev is None or prev[0] != step:
                        job.progress[shard] = (step, now)
        if metrics:
            # TM-shipped metric snapshots (authenticated RPC plane): latest
            # snapshot per shard wins — the JM serves aggregates, history
            # lives in whatever scrapes /metrics
            for (job_id, shard, *att), snap in metrics.items():
                job = self._jobs.get(job_id)
                if job is not None and (not att or att[0] == job.attempt):
                    job.metric_snapshots[shard] = snap
        if spans:
            for sd in spans:
                job = self._jobs.get(sd.get("attributes", {}).get("jobId"))
                if job is not None:
                    job.spans.append(sd)
                    del job.spans[:-_MAX_JOB_SPANS]
        return True

    def peer_alive(self, job_id: str, attempt: int, shard: int) -> bool:
        """Is the TM hosting `shard` of `job_id` (attempt `attempt`) still
        registered and heartbeating? A task seeing a dataplane error asks
        this to distinguish a transient peer blip (TM alive → bounded
        reconnect window) from real TM loss (→ escalate to the restart
        path immediately; reconnecting to a dead peer only burns the
        window)."""
        job = self._jobs.get(job_id)
        if job is None or job.attempt != attempt or job.status != "RUNNING":
            return False
        tm_id = job.assignment.get(shard)
        return (tm_id is not None and tm_id in self._tms
                and self.heartbeats.is_alive(tm_id))

    def _on_tm_dead(self, tm_id: str) -> None:
        self.run_in_main_thread(self._handle_tm_dead, tm_id)

    def _handle_tm_dead(self, tm_id: str) -> None:
        self._tms.pop(tm_id, None)
        self.heartbeats.unmonitor(tm_id)
        for job in self._jobs.values():
            if job.status == "RUNNING" and tm_id in job.assignment.values():
                self._fail_job(
                    job, f"task executor {tm_id} lost (heartbeat timeout)",
                    task_manager=tm_id)

    # ---- job lifecycle (M2/M3) -------------------------------------------
    def submit_job(self, spec_bytes: bytes, parallelism: int,
                   savepoint_path: Optional[str] = None) -> str:
        blob_key = self.blob.put(spec_bytes)
        spec = DistributedJobSpec.from_bytes(spec_bytes)
        stages = 1
        source_stages: List[int] = []
        if isinstance(spec, GraphJobSpec):
            from flink_tpu_torch.runtime.stages import (
                num_stages,
                source_stage_indices,
                validate_stages,
            )

            validate_stages(spec.graph)
            stages = num_stages(spec.graph)
            source_stages = source_stage_indices(spec.graph)
            if parallelism not in (1, stages):
                raise ValueError(
                    "GraphJobSpec jobs deploy one task per slot-sharing "
                    f"group ({stages} stage(s)); keyed sharded execution "
                    "uses DistributedJobSpec"
                )
            parallelism = stages
        if parallelism == 0 and not isinstance(spec, GraphJobSpec):
            # AUTO parallelism (AdaptiveBatchScheduler analogue,
            # scheduler/adaptivebatch/): derive the task count from the
            # declared source volume — one task per auto_records_per_task
            # records — clamped to max_parallelism; with no volume hint,
            # size to the currently free slots (elastic default)
            hint = getattr(spec, "source_records_hint", None)
            if hint is not None:
                parallelism = -(-int(hint) // self.auto_records_per_task)
            else:
                parallelism = max(len(self._free_slots()), 1)
            parallelism = max(1, min(parallelism, spec.max_parallelism))
        elif parallelism <= 0:
            raise ValueError("parallelism must be positive (0 = AUTO is "
                             "only defined for DistributedJobSpec)")
        job_id = uuid.uuid4().hex[:16]
        job = _JobState(
            job_id, blob_key, parallelism, spec.name,
            keyed=not isinstance(spec, GraphJobSpec),
            spec_max_parallelism=getattr(spec, "max_parallelism", 128),
            requested_parallelism=parallelism, stages=stages,
            source_stages=source_stages, trace_id=job_trace_id(job_id),
            stats=CheckpointStatsTracker(
                history_size=self.checkpoint_history_size),
            exceptions=ExceptionHistory(size=self.exception_history_size),
        )
        # history plane + watchdog: rings live on the JM job
        # state (the folded view is assembled here); watchdog breaches
        # land in job.spans through the same _job_span path as every
        # other JM control-plane span
        from flink_tpu_torch.metrics.doctor import HealthWatchdog
        from flink_tpu_torch.metrics.history import MetricHistory

        job.history = MetricHistory(
            interval_ms=self.history_interval_ms,
            retention_points=self.history_retention_points)
        if self.doctor_enabled:
            def _health_sink(scope, name, start_ms, end_ms, attrs,
                             _job=job):
                self._job_span(_job, scope, name, start_ms, **attrs)

            job.watchdog = HealthWatchdog(
                _health_sink, min_gap_ms=self.watchdog_min_gap_ms,
                p99_breach_ms=self.p99_breach_ms)
        if savepoint_path is not None:
            # start FROM a savepoint (execution.savepoint.path analogue):
            # seed the restore chain with the written snapshot set — the
            # first schedule restores every shard from it
            st = FsCheckpointStorage(savepoint_path)
            latest = st.latest()
            if latest is None:
                raise ValueError(f"no savepoint found at {savepoint_path!r}")
            data = st.load(latest[1])
            handles = data["shards"]
            # validate the snapshot set against the submitted spec up front:
            # a mismatched savepoint would otherwise surface as an opaque
            # KeyError deep inside _try_schedule/merge_shard_snapshots
            staged_handles = any(
                isinstance(h, dict) and "runtime" in h for h in handles.values()
            )
            if isinstance(spec, GraphJobSpec):
                if set(handles) != set(range(stages)) or not all(
                    isinstance(h, dict) and "runtime" in h
                    for h in handles.values()
                ):
                    raise ValueError(
                        f"savepoint at {savepoint_path!r} does not hold "
                        f"per-stage runtime snapshots for stages "
                        f"0..{stages - 1} (found keys {sorted(handles)}"
                        f"{'' if staged_handles else ', keyed snapshots'}); "
                        "staged jobs can only resume from a staged savepoint "
                        "with a matching stage count (within a stage, state "
                        "is matched by operator uid, as in the reference's "
                        "savepoint uid mapping)"
                    )
            elif staged_handles:
                raise ValueError(
                    f"savepoint at {savepoint_path!r} holds per-stage runtime "
                    "snapshots from a GraphJobSpec job; it cannot seed a "
                    "keyed DistributedJobSpec (key-group state is required "
                    "to re-shard)"
                )
            job.completed.append((0, handles, data["step"]))
        self._jobs[job_id] = job
        self._try_schedule(self._jobs[job_id])
        return job_id

    def job_status(self, job_id: str) -> dict:
        job = self._jobs[job_id]
        return {
            "status": job.status, "attempt": job.attempt, "name": job.spec_name,
            "parallelism": job.parallelism, "stages": job.stages,
            "tasks": len(job.assignment),
            "savepoints": list(job.completed_savepoints),
            "savepoints_failed": list(job.failed_savepoints),
            "failure": job.failure, "restarts": job.restarts,
            "rescales": job.num_rescales,
            "checkpoints": [c[0] for c in job.completed],
            "trace_id": job.trace_id,
        }

    # ---- observability queries (served to REST via rest.py jm bridge) ----
    def list_jobs(self) -> list:
        return [
            {"id": job_id, "name": job.spec_name, "status": job.status}
            for job_id, job in self._jobs.items()
        ]

    def _aggregated_job_metrics(self, job: "_JobState"
                                ) -> "tuple[dict, dict, dict]":
        """One fold of the TM-shipped per-shard snapshots plus the JM-side
        control-plane gauges: checkpoint stats, restart/downtime, and
        rescale counters live on the coordinator, not on any TM. Both
        /jobs/:id/metrics and the autoscaler tick read THIS recipe — the
        signal extractor needs e.g. job.lastCheckpointDuration as its
        rescale-cost proxy, and a fold maintained twice would let the
        autoscaler's view silently diverge from what /metrics reports."""
        per_shard = {int(s): dict(snap)
                     for s, snap in job.metric_snapshots.items()}
        agg = aggregate_shard_metrics(per_shard)
        jm_gauges = job.stats.gauge_values(prefix="job.")
        jm_gauges.update(job.exceptions.gauge_values(prefix="job."))
        jm_gauges["job.numRescales"] = job.num_rescales
        jm_gauges["job.lastRescaleDurationMs"] = job.last_rescale_duration_ms
        # swallowed-ping accounting (heartbeat.py): a climbing value is the
        # early signal of a flapping/partitioned control plane
        jm_gauges["job.heartbeatMissedPings"] = self.heartbeats.missed_pings
        if "job.watermarkSkewMs" in agg:
            jm_gauges["job.watermarkSkewMs"] = agg["job.watermarkSkewMs"]
        agg.update(jm_gauges)
        return agg, per_shard, jm_gauges

    def job_metrics(self, job_id: str) -> dict:
        """Aggregated + per-shard metric view of the TM-shipped snapshots,
        plus the JM-side control-plane gauges (`jm`), which ride as their
        own labeled snapshot in /metrics."""
        job = self._jobs[job_id]
        agg, per_shard, jm_gauges = self._aggregated_job_metrics(job)
        return {
            "job": agg,
            "per_shard": per_shard,
            "jm": jm_gauges,
            "trace_id": job.trace_id,
        }

    def job_checkpoints(self, job_id: str) -> dict:
        """Checkpoint statistics payload (/jobs/:id/checkpoints shape):
        counts, summary, latest completed/failed/restored, bounded
        per-checkpoint history."""
        return self._jobs[job_id].stats.payload()

    def job_checkpoint(self, job_id: str, checkpoint_id: int) -> dict:
        """One retained checkpoint's record (/jobs/:id/checkpoints/:cid)."""
        rec = self._jobs[job_id].stats.checkpoint(int(checkpoint_id))
        if rec is None:
            raise KeyError(
                f"no retained stats for checkpoint {checkpoint_id} "
                f"of job {job_id}")
        return rec

    def job_exceptions(self, job_id: str) -> dict:
        """Bounded exception history + recovery timeline
        (/jobs/:id/exceptions shape)."""
        return self._jobs[job_id].exceptions.payload()

    def job_spans(self, job_id: str) -> list:
        """Span feed (plain dicts) for the job: JM trigger/complete spans
        and TM-shipped ack spans, all stamped with the job's trace_id."""
        return list(self._jobs[job_id].spans)

    def job_latency(self, job_id: str) -> dict:
        """Emission-latency + stall-attribution report
        (/jobs/:id/latency shape, identical to the MiniCluster's so one
        dashboard panel reads both): the shard-folded emissionLatencyMs
        histograms (bucket-wise merge) and watermarkLagMs MAX from
        _aggregated_job_metrics, attributed against the job's span feed —
        TM-shipped EmissionStall outliers vs JM/TM control-plane spans."""
        from flink_tpu_torch.metrics.emission_latency import build_latency_report

        job = self._jobs[job_id]
        agg, _per_shard, _jm = self._aggregated_job_metrics(job)
        return build_latency_report(agg, list(job.spans))

    def job_history(self, job_id: str, metric: Optional[str] = None,
                    since: Optional[float] = None) -> dict:
        """Metric time-series rings (/jobs/:id/history?metric=&since=
        shape, identical to the MiniCluster's): per-key bounded point
        lists sampled from the shard-folded snapshots — counters as
        windowed rates, gauges as values, histograms as per-sample
        p50/p99 sub-series."""
        job = self._jobs[job_id]
        if job.history is None:
            return {"enabled": False, "series": {}, "sample_count": 0}
        payload = job.history.payload(
            metric=metric or None,
            since_ms=float(since) if since not in (None, "") else None)
        payload["enabled"] = True
        return payload

    def job_doctor(self, job_id: str) -> dict:
        """Ranked bottleneck diagnosis (/jobs/:id/doctor shape, identical
        to the MiniCluster's): the job doctor joined over the history
        rings and the span feed."""
        from flink_tpu_torch.metrics.doctor import diagnose

        job = self._jobs[job_id]
        if job.history is None:
            return {"verdict": "unknown", "score": 0.0, "diagnoses": [],
                    "window_ms": self.doctor_window_ms, "samples": 0,
                    "watchdog_events": 0}
        return diagnose(job.history, list(job.spans),
                        window_ms=self.doctor_window_ms)

    def job_backpressure(self, job_id: str) -> dict:
        """Per-shard busy/idle/backPressured ratios from the latest shipped
        snapshots (JobVertexBackPressureHandler analogue)."""
        job = self._jobs[job_id]
        subtasks = []
        worst = 0.0
        for shard in sorted(job.metric_snapshots):
            snap = job.metric_snapshots[shard]
            ratio = float(snap.get("job.backPressuredTimeRatio", 0.0))
            worst = max(worst, ratio)
            idle_ratio = float(snap.get("job.idleTimeRatio", 0.0))
            subtasks.append({
                "subtask": shard,
                "backPressuredRatio": ratio,
                "busyRatio": float(snap.get("job.busyTimeRatio", 0.0)),
                "idleRatio": idle_ratio,
                "backpressureLevel": backpressure_level(ratio),
                # idle-subtask indicator: a subtask spending nearly all its
                # loop time waiting is starved (skewed keys / slow source)
                "idle": idle_ratio >= 0.95,
            })
        return {
            "status": "ok" if subtasks else "deprecated",
            "backpressureLevel": backpressure_level(worst),
            "subtasks": subtasks,
        }

    def _job_span(self, job: _JobState, scope: str, name: str,
                  start_ms: float, **attrs) -> None:
        now = time.time() * 1000.0
        attrs.setdefault("jobId", job.job_id)
        job.spans.append(Span(scope, name, start_ms, now, attrs,
                              trace_id=job.trace_id).to_dict())
        del job.spans[:-_MAX_JOB_SPANS]

    def job_result(self, job_id: str) -> Optional[list]:
        job = self._jobs[job_id]
        if job.status != "FINISHED":
            return None
        out: list = []
        for shard in sorted(job.finished):
            out.extend(job.finished[shard])
        return out

    def cancel_job(self, job_id: str) -> None:
        job = self._jobs[job_id]
        self._cancel_tasks(job)
        job.status = "CANCELED"
        self._release_job_local_state(job)

    # ---- elastic rescaling (scheduler/ executor half) ---------------------
    def rescale_job(self, job_id: str, parallelism: int,
                    reason: str = "manual") -> dict:
        """RPC: deliberate live rescale to `parallelism` — the operator- or
        policy-triggered generalization of the rescale-down-on-TM-loss
        path. Returns {"accepted": bool, "detail": str}."""
        accepted, detail = self._rescale_job(job_id, int(parallelism), reason)
        return {"accepted": accepted, "detail": detail}

    def _rescale_job(self, job_id: str, target: int,
                     reason: str) -> Tuple[bool, str]:
        """Rescale executor: rewind to the latest completed checkpoint and
        remap key-groups onto the new slot set (both directions). The
        mechanics reuse the failover path — cancel the attempt, mark the
        job RESCALING, let _try_schedule merge + re-shard the snapshot —
        so a rescale gets the same recovery-timeline entry (kind
        'rescale'), restore accounting, and exactly-once replay semantics
        as a restart, without consuming the restart-attempts budget."""
        job = self._jobs.get(job_id)
        if job is None:
            return False, f"unknown job {job_id}"
        if job.status != "RUNNING":
            return False, f"job is {job.status}, not RUNNING"
        if job.stages != 1 or not job.keyed:
            return False, ("only keyed jobs can rescale: staged/graph "
                           "pipelines snapshot whole runtimes, not "
                           "key-group state")
        if not job.completed:
            return False, "no completed checkpoint to rewind to"
        if target < 1:
            return False, f"parallelism must be positive, got {target}"
        if target > job.spec_max_parallelism:
            return False, (f"target {target} exceeds the job's "
                           f"max-parallelism (key-group count) "
                           f"{job.spec_max_parallelism}")
        if target == job.parallelism:
            return False, f"already at parallelism {target}"
        capacity = len(self._free_slots()) + job.parallelism
        if target > capacity:
            return False, f"{target} slots needed, {capacity} available"
        _cp_id, handles, _step = job.completed[-1]
        if set(handles) != set(range(target)):
            ok, why = key_groups.reshardable(handles)
            if not ok:
                return False, why
        old = job.parallelism
        job.num_rescales += 1
        job.rescale_started = time.perf_counter()
        # in-flight checkpoints belong to the attempt being cancelled: the
        # attempt guard rejects their remaining acks and checkpoint ids are
        # never reused, so without this sweep (the _fail_job analogue) the
        # stats records would sit IN_PROGRESS forever in /jobs/:id/checkpoints
        for cp_id in list(job.pending):
            job.stats.report_failed(
                cp_id, f"superseded by rescale {old}->{target}",
                benign=True)
        self._cancel_tasks(job)
        job.parallelism = target
        job.status = "RESCALING"
        # the rescale rides the recovery timeline (it IS a rewind+redeploy)
        # tagged kind='rescale'; numRestarts counts it, as the reference's
        # reactive mode does, but restart_attempts is not consumed
        job.exceptions.begin_recovery(
            job.restarts, kind="rescale",
            cause=f"rescale {old}->{target}: {reason}",
            steps_at_failure=max(job.steps.values(), default=0))
        self._job_span(job, "autoscaler", "JobRescale", time.time() * 1000.0,
                       fromParallelism=old, toParallelism=target,
                       reason=reason[:200])
        self._try_schedule(job)
        return True, f"rescaling {old}->{target}"

    def job_autoscaler(self, job_id: str) -> dict:
        """Autoscaler view (/jobs/:id/autoscaler): decision log + rescale
        counters. Manual rescale_job calls count in num_rescales even with
        no coordinator attached."""
        from flink_tpu_torch.scheduler import empty_autoscaler_payload

        job = self._jobs[job_id]
        if self.autoscaler is not None:
            payload = self.autoscaler.payload(
                job_id, num_rescales=job.num_rescales,
                last_rescale_duration_ms=job.last_rescale_duration_ms)
        else:
            payload = empty_autoscaler_payload()
            payload.update(num_rescales=job.num_rescales,
                           last_rescale_duration_ms=job.last_rescale_duration_ms)
        payload["parallelism"] = job.parallelism
        return payload

    def job_device(self, job_id: str) -> dict:
        """Device-plane view (/jobs/:id/device) of a distributed job: the
        job-level fold of the TM-shipped device gauges (compile counters
        sum, storm/skew take the worst shard, roofline percentages
        average) plus the 'device'-scope compile-event spans the TMs
        shipped on the heartbeat — shape-compatible with the MiniCluster
        payload so one dashboard panel reads both."""
        from flink_tpu_torch.metrics.device_stats import empty_device_payload

        job = self._jobs[job_id]
        agg, per_shard, _ = self._aggregated_job_metrics(job)

        def _num(key, cast=float, default=0):
            v = agg.get(key)
            return cast(v) if isinstance(v, (int, float)) else default

        events = []
        for sd in job.spans:
            if sd.get("scope") != "device":
                continue
            attrs = sd.get("attributes") or {}
            events.append({
                "program": attrs.get("program"),
                "signature": attrs.get("signature"),
                "cause": attrs.get("cause"),
                "recompile": bool(attrs.get("recompile", False)),
                "compile_count": attrs.get("compileCount"),
                "duration_ms": attrs.get("durationMs"),
                "wall_ts_ms": sd.get("end_ts_ms"),
                "shard": attrs.get("shard"),
            })
        payload = empty_device_payload()
        payload["compile"].update(
            numCompiles=_num("job.device.numCompiles", int),
            numRecompiles=_num("job.device.numRecompiles", int),
            compileTimeMsTotal=_num("job.device.compileTimeMsTotal"),
            recompileStorm=_num("job.device.recompileStorm", int),
            events=events[-64:],
        )
        device_keys = {k: v for k, v in agg.items()
                       if _is_device_payload_key(k)}
        payload["metrics"] = device_keys
        payload["per_shard"] = {
            s: {k: v for k, v in snap.items() if _is_device_payload_key(k)}
            for s, snap in per_shard.items()
        }
        payload["enabled"] = bool(device_keys or events)
        return payload

    # ---- scheduling (M4-lite: deploy when slots cover parallelism) -------
    def _try_schedule_all(self) -> None:
        for job in self._jobs.values():
            if job.status in ("CREATED", "RESTARTING", "RESCALING"):
                self._try_schedule(job)

    def _free_slots(self) -> List[str]:
        """Slots not currently occupied by a deployed job. Counting total
        capacity here would let two jobs (or a job racing its own restart)
        oversubscribe a TM; the reference's slot pool likewise tracks
        allocation state per slot (DeclarativeSlotPoolBridge)."""
        used: Dict[str, int] = {}
        for job in self._jobs.values():
            if job.status == "RUNNING":
                for tm_id in job.assignment.values():
                    used[tm_id] = used.get(tm_id, 0) + 1
        slots = []
        for tm_id, tm in self._tms.items():
            free = tm["slots"] - used.get(tm_id, 0)
            if free > 0:
                slots.extend([tm_id] * free)
        return slots

    def _try_schedule(self, job: _JobState) -> None:
        if job.status not in ("CREATED", "RESTARTING", "RESCALING"):
            return  # already scheduled (e.g. a TM registration raced the
            # delayed-restart thread) or terminal
        slots = self._free_slots()
        if len(slots) < job.parallelism:
            # AdaptiveScheduler semantics: a restarting job with a completed
            # checkpoint scales DOWN to the available slots rather than
            # waiting (Executing->Restarting->Executing with lower
            # parallelism, scheduler/adaptive/AdaptiveScheduler.java:192);
            # state re-shards by key-group range on restore
            # stage-split jobs cannot rescale: shard index = stage index
            # (their snapshots are per-stage runtimes, not key-group state)
            if not (self.adaptive and slots and job.completed
                    and job.status == "RESTARTING" and job.stages == 1):
                return  # WaitingForResources
            job.parallelism = len(slots)
        elif (self.adaptive and job.status == "RESTARTING" and job.completed
              and job.stages == 1 and len(slots) > job.parallelism):
            job.parallelism = min(len(slots), job.requested_parallelism)
        restore = None
        restore_step = 0
        local_cp = None        # checkpoint id eligible for task-local restore
        if job.completed:
            cp_id, handles, step = job.completed[-1]
            restore, restore_step = handles, step
            local_cp = cp_id
            if set(handles) != set(range(job.parallelism)):
                # parallelism changed since the checkpoint: re-shard
                try:
                    merged = merge_shard_snapshots(handles)
                except ValueError:
                    # unmergeable (device) snapshots: keep the checkpointed
                    # parallelism and wait for enough slots instead
                    job.parallelism = len(handles)
                    if len(slots) < job.parallelism:
                        return
                    merged = None
                if merged is not None:
                    # pre-split per shard: shipping the whole merged state
                    # to every shard would serialize ~parallelism copies
                    # of the job state over the deploy RPCs
                    restore = key_groups.split_merged_snapshot(
                        merged, job.spec_max_parallelism, job.parallelism)
                    local_cp = None  # re-sharded state has no local copy
        job.attempt += 1
        job.assignment = {shard: slots[shard] for shard in range(job.parallelism)}
        peers = {
            shard: self._tms[tm]["exchange"] for shard, tm in job.assignment.items()
        }
        job.finished = {}
        job.steps = {}
        job.progress = {}   # watchdog stamps belong to the dead attempt
        # the new attempt gets its full tolerable-failed-checkpoints
        # budget — carrying an exhausted streak over would re-fail the
        # restarted job on its first isolated persist hiccup
        job.consecutive_cp_failures = 0
        # drop the dead attempt's shipped snapshots: after a rescale-down a
        # stale higher-shard snapshot would keep inflating the aggregates
        # (and the autoscaler's signals) forever
        job.metric_snapshots.clear()
        job.pending.clear()
        job.pending_target.clear()
        # in-flight savepoints belong to the dead attempt: report them as
        # failed (the stale attempt's decline/ack can never complete them)
        for path, _m in job.savepoint_paths.values():
            job.failed_savepoints.append(
                f"{path}: job restarted before the cut completed")
        job.savepoint_paths.clear()
        origins = job.cp_origins.get(local_cp, {}) if local_cp is not None else {}
        restored_cp = job.completed[-1][0] if job.completed else None
        t_deploy = time.perf_counter()
        for shard, tm_id in job.assignment.items():
            # local recovery: a shard redeployed onto the TM that produced
            # its snapshot restores from the TM-local copy — the snapshot is
            # not re-shipped over the wire
            use_local = local_cp is not None and origins.get(shard) == tm_id
            try:
                self._tms[tm_id]["gateway"].deploy_task(
                    job.job_id, job.attempt, shard, job.parallelism, job.blob_key,
                    self.rpc.address, peers,
                    None if use_local else (restore[shard] if restore else None),
                    restore_step,
                    local_cp if use_local else None,
                )
            except Exception:
                # undetected-dead worker: evict it, cancel the partial
                # attempt, go back to WaitingForResources. If this deploy
                # was a deliberate rescale it has degraded into a plain
                # restart (which may land at a different parallelism):
                # the later redeploy must not stamp a rescale completion
                # for a shape change that never took effect
                job.rescale_started = None
                self._tms.pop(tm_id, None)
                self.heartbeats.unmonitor(tm_id)
                self._cancel_tasks(job)
                job.status = "RESTARTING"
                return
        job.status = "RUNNING"
        # recovery timeline: the attempt is live again — rewound checkpoint
        # id, restore (redeploy) duration, rewind depth in steps, and
        # downtime measured fail -> RUNNING. A restart with no completed
        # checkpoint replays from scratch (restored_cp None). The savepoint-
        # seeded first schedule records the restore but has no open
        # recovery, so complete_recovery is a no-op there.
        restore_ms = (time.perf_counter() - t_deploy) * 1000.0
        if restore is not None:
            job.stats.report_restore(restored_cp, restore_ms)
        job.exceptions.complete_recovery(
            restored_checkpoint_id=restored_cp,
            restore_duration_ms=restore_ms,
            restored_step=restore_step,
        )
        if job.rescale_started is not None:
            # deliberate rescale complete: stamp decision-to-RUNNING
            # duration (lastRescaleDurationMs) and restart the autoscaler's
            # stabilization window from completion time
            job.last_rescale_duration_ms = (
                time.perf_counter() - job.rescale_started) * 1000.0
            job.rescale_started = None
            if self.autoscaler is not None:
                # target disambiguates: a manual rescale_job RPC also
                # lands here, and its duration must not stamp a pending
                # coordinator decision for a different parallelism
                self.autoscaler.rescale_completed(
                    job.job_id, job.last_rescale_duration_ms,
                    target=job.parallelism)

    def _cancel_tasks(self, job: _JobState) -> None:
        for tm_id in set(job.assignment.values()):
            tm = self._tms.get(tm_id)
            if tm is not None:
                try:
                    tm["gateway"].cancel_task(job.job_id)
                except Exception as e:
                    _swallow("cancel_tasks", e)

    def _fail_job(self, job: _JobState, reason: str,
                  task: Optional[str] = None,
                  task_manager: Optional[str] = None) -> None:
        job.exceptions.record_failure(
            reason, task=task, task_manager=task_manager,
            restart_number=job.restarts)
        # in-flight checkpoints belong to the dead attempt: their acks can
        # never complete, so their stat records flip to FAILED now
        for cp_id in list(job.pending):
            job.stats.report_failed(cp_id, f"job failure: {reason}",
                                    benign=True)
        self._cancel_tasks(job)
        if job.restarts >= self.restart_attempts:
            job.status = "FAILED"
            self._release_job_local_state(job)
            return
        job.restarts += 1
        job.status = "RESTARTING"
        job.exceptions.begin_recovery(
            job.restarts, cause=reason,
            steps_at_failure=max(job.steps.values(), default=0))
        self._job_span(job, "recovery", "JobRestart", time.time() * 1000.0,
                       attempt=job.restarts, cause=reason[:200])

        def delayed():
            time.sleep(self.restart_delay)
            self.run_in_main_thread(self._try_schedule, job)

        threading.Thread(target=delayed, daemon=True,
                         name=f"restart-delay-{job.job_id[:6]}").start()

    # ---- task callbacks ---------------------------------------------------
    def _release_job_local_state(self, job: _JobState) -> None:
        """Best-effort: tell every TM to drop its task-local snapshot copies
        for a terminally finished job (the copies exist only for recovery)."""
        def _release(gateways=[tm["gateway"] for tm in self._tms.values()],
                     job_id=job.job_id):
            for gw in gateways:
                try:
                    gw.release_job_state(job_id)
                except Exception as e:
                    _swallow("release_job_state", e)

        # off the JM main thread: the TM handler is one-directional, but a
        # dead TM's connect timeout must not stall scheduling
        threading.Thread(target=_release, daemon=True,
                         name=f"release-state-{job.job_id[:6]}").start()

    def task_finished(self, job_id: str, attempt: int, shard: int, results: list) -> None:
        job = self._jobs.get(job_id)
        if job is None or attempt != job.attempt or job.status != "RUNNING":
            # the attempt guard misses a cancelled-but-racing task of the
            # CURRENT attempt (rescale/restart cancels first, bumps the
            # attempt only at redeploy) — a finish landing then must not
            # flip a RESCALING/RESTARTING job to FINISHED
            return
        job.finished[shard] = results
        # abort in-flight checkpoints this shard never snapshotted: a
        # finished task can never ack, so the pending entry would hang
        # forever (reference pre-FLIP-147 behavior: no checkpoints once a
        # task finishes; savepoints report failure instead of hanging)
        for cp_id in [c for c, p in job.pending.items() if shard not in p]:
            self.decline_checkpoint(
                job_id, attempt, shard, cp_id,
                f"shard {shard} finished before snapshotting")
        if len(job.finished) == job.parallelism:
            job.status = "FINISHED"
            self._release_job_local_state(job)

    def task_failed(self, job_id: str, attempt: int, shard: int, error: str) -> None:
        job = self._jobs.get(job_id)
        if job is None or attempt != job.attempt or job.status != "RUNNING":
            return
        self._fail_job(job, f"shard {shard}: {error}",
                       task=f"shard-{shard}",
                       task_manager=job.assignment.get(shard))

    # ---- checkpoint coordination (S7 analogue, step-aligned) -------------
    def trigger_savepoint(self, job_id: str, path: str) -> Optional[int]:
        """User-requested savepoint (CheckpointCoordinator savepoint
        analogue): rides the normal trigger/align/ack machinery; on
        completion the snapshot set is ALSO written to `path` (durable,
        user-owned, never subsumed). Async: poll job_status()'s
        'savepoints' for the written path. The target step is computed
        from heartbeat-stale progress, so a fast job can outrun it —
        declines re-trigger automatically with a doubled margin until the
        cut lands (or the job ends)."""
        job = self._jobs.get(job_id)
        if job is None or job.status != "RUNNING":
            return None
        cp_id = self.trigger_checkpoint(job_id, for_savepoint=True)
        if cp_id is not None:
            job.savepoint_paths[cp_id] = (path, 2)
        return cp_id

    def trigger_checkpoint(self, job_id: str, for_savepoint: bool = False,
                           margin: int = 2) -> Optional[int]:
        job = self._jobs.get(job_id)
        if job is None or job.status != "RUNNING":
            return None
        if self._storage is None and not for_savepoint:
            return None   # periodic checkpoints need configured storage;
            #               savepoints carry their own target directory
        if len(job.steps) < job.parallelism:
            return None
        if job.finished:
            # a finished shard can never snapshot; a new trigger would
            # only be aborted by task_finished's own guard anyway
            return None
        if job.stages > 1:
            # aligned-barrier checkpoint (CheckpointBarrier analogue): the
            # trigger goes to the SOURCE stages only; they snapshot at
            # their next step boundary and emit barriers into the
            # exchanges, downstream stages align, snapshot, forward, ack.
            # All target TMs are resolved BEFORE allocating the cp: a
            # half-delivered trigger would emit barriers that a
            # multi-input downstream stage could never align.
            if not job.source_stages:
                return None
            gws = {}
            for shard in job.source_stages:
                tm = self._tms.get(job.assignment.get(shard))
                if tm is None:
                    return None
                gws[shard] = tm["gateway"]
            cp_id = job.next_checkpoint_id
            job.next_checkpoint_id += 1
            job.pending[cp_id] = {}
            job.pending_target[cp_id] = max(job.steps.values())
            trig_t0 = time.time() * 1000.0
            job.stats.report_pending(cp_id, is_savepoint=for_savepoint,
                                     trigger_ts_ms=trig_t0)
            with trace_context(job.trace_id):
                for shard, gw in gws.items():
                    # margin is honored for symmetry with the keyed branch,
                    # but staged source gates CONSUME past-target requests
                    # at their next step boundary instead of declining them
                    # (the barrier defines the cut, not the step number), so
                    # staged savepoints never outrun-decline and never need
                    # the doubled-margin retry loop
                    gw.trigger_checkpoint(
                        job.job_id, job.attempt, cp_id,
                        job.steps.get(shard, 0) + margin, shard,
                    )
            self._job_span(job, "checkpointing", "CheckpointTrigger",
                           trig_t0, checkpointId=cp_id)
            return cp_id
        gws2 = {}
        for shard, tm_id in job.assignment.items():
            tm = self._tms.get(tm_id)
            if tm is None:
                return None
            gws2[shard] = tm["gateway"]
        cp_id = job.next_checkpoint_id
        job.next_checkpoint_id += 1
        # the cut must land at ONE common step across shards; heartbeat
        # staleness means fast jobs may already be past it — margin covers
        # the lag (savepoint declines re-trigger with a doubled margin)
        target = max(job.steps.values()) + margin
        job.pending[cp_id] = {}
        job.pending_target[cp_id] = target
        trig_t0 = time.time() * 1000.0
        job.stats.report_pending(cp_id, is_savepoint=for_savepoint,
                                 trigger_ts_ms=trig_t0)
        with trace_context(job.trace_id):
            for shard, gw in gws2.items():
                gw.trigger_checkpoint(job.job_id, job.attempt, cp_id, target,
                                      shard)
        self._job_span(job, "checkpointing", "CheckpointTrigger",
                       trig_t0, checkpointId=cp_id)
        return cp_id

    @absorbs_faults('savepoint write failure is recorded in job.failed_savepoints and reported; re-raising on the RPC thread would kill the JM endpoint, not surface the checkpoint failure')
    def ack_checkpoint(self, job_id: str, attempt: int, shard: int,
                       checkpoint_id: int, snapshot: dict) -> None:
        job = self._jobs.get(job_id)
        if job is None or attempt != job.attempt:
            return
        pending = job.pending.get(checkpoint_id)
        if pending is None:
            return
        pending[shard] = snapshot
        # per-task ack record: latency from the trigger timestamp + the
        # shard snapshot's in-memory footprint (the persisted artifact is
        # the whole set, sized below)
        job.stats.report_ack(checkpoint_id, f"shard-{shard}",
                             state_size_bytes=snapshot_bytes_estimate(snapshot))
        if len(pending) == job.parallelism:
            handles = job.pending.pop(checkpoint_id)
            step = job.pending_target.pop(checkpoint_id)
            persist_ms = None
            state_bytes = None
            if self._storage is not None:
                t_save = time.perf_counter()
                try:
                    self._storage.save(
                        checkpoint_id,
                        {"job": job_id, "shards": handles, "step": step}
                    )
                except BaseException as e:  # noqa: BLE001 — record; tolerate
                    # or fail over per tolerable-failed-checkpoints
                    # the entry already left job.pending, so _fail_job's
                    # pending sweep can never reach it — flip it here or the
                    # record stays PENDING forever (local-path _abort parity)
                    job.stats.report_failed(
                        checkpoint_id, f"persist failed: {e!r}")
                    if not isinstance(e, Exception) \
                            or isinstance(e, _chaos.InjectedCrash):
                        # interpreter-level exceptions and chaos crash
                        # faults are never "a tolerated brownout" — they
                        # must reach the failure machinery (plan.py's
                        # InjectedCrash contract)
                        raise
                    sp_fail = job.savepoint_paths.pop(checkpoint_id, None)
                    if sp_fail is not None:
                        job.failed_savepoints.append(
                            f"{sp_fail[0]}: persist failed: {e!r}")
                    job.consecutive_cp_failures += 1
                    if (job.consecutive_cp_failures
                            > self.tolerable_failed_checkpoints):
                        # beyond tolerance: restart through the normal
                        # attributed path (the JM owns the persist — the
                        # acking task did nothing wrong, so the failure is
                        # handled here instead of re-raising into its RPC)
                        self._fail_job(
                            job,
                            f"checkpoint {checkpoint_id} persist failed "
                            f"({job.consecutive_cp_failures} consecutive, "
                            f"tolerable "
                            f"{self.tolerable_failed_checkpoints}): {e!r}")
                        return
                    # tolerated brownout: the job keeps running; the next
                    # periodic trigger retries with a fresh checkpoint id
                    return
                persist_ms = (time.perf_counter() - t_save) * 1000.0
                state_bytes = self._storage.last_save_bytes
                self._job_span(job, "checkpointing", "CheckpointPersist",
                               time.time() * 1000.0 - persist_ms,
                               checkpointId=checkpoint_id,
                               stateSizeBytes=state_bytes)
            sp = job.savepoint_paths.pop(checkpoint_id, None)
            if sp is not None:
                # the checkpoint is complete regardless of the savepoint
                # write: a bad user path must not fail the acking task (and
                # thereby the healthy job)
                sp_path, _margin = sp
                try:
                    FsCheckpointStorage(sp_path).save(
                        checkpoint_id,
                        {"job": job_id, "shards": handles, "step": step,
                         "savepoint": True},
                    )
                    job.completed_savepoints.append(sp_path)
                except OSError as e:
                    job.failed_savepoints.append(
                        f"{sp_path}: {e}")
            job.consecutive_cp_failures = 0   # tolerance is CONSECUTIVE
            job.completed.append((checkpoint_id, handles, step))
            # per-operator breakdown from the stateBytes gauges the TMs
            # already ship on the heartbeat (latest snapshot per shard)
            per_op: Dict[str, int] = {}
            for snap_metrics in job.metric_snapshots.values():
                operator_bytes_from_snapshot(snap_metrics, into=per_op)
            job.stats.report_completed(
                checkpoint_id,
                async_duration_ms=persist_ms,
                state_size_bytes=state_bytes,
                operator_bytes=per_op,
            )
            self._job_span(job, "checkpointing", "CheckpointComplete",
                           time.time() * 1000.0, checkpointId=checkpoint_id,
                           status="COMPLETED", step=step)
            # local recovery (S11): remember which TM produced each shard's
            # snapshot, so a redeploy to the same TM can restore from its
            # task-local copy (TaskLocalStateStoreImpl analogue)
            job.cp_origins[checkpoint_id] = dict(job.assignment)
            # retain a bounded history in JM memory (durable copies live in
            # checkpoint storage); discard superseded ones
            while len(job.completed) > 3:
                old_id, _, _ = job.completed.pop(0)
                job.cp_origins.pop(old_id, None)
                if self._storage is not None:
                    self._storage.discard(old_id)

    def fetch_shard_restore(self, job_id: str, checkpoint_id: int, shard: int) -> dict:
        """Local-recovery fallback: a TM whose task-local copy is missing
        pulls the shard snapshot from the JM's retained checkpoints."""
        job = self._jobs.get(job_id)
        if job is not None:
            for cp_id, handles, _step in job.completed:
                if cp_id == checkpoint_id and shard in handles:
                    return handles[shard]
        raise KeyError(
            f"no retained snapshot for job {job_id} cp {checkpoint_id} shard {shard}"
        )

    def decline_checkpoint(self, job_id: str, attempt: int, shard: int,
                           checkpoint_id: int, reason: str) -> None:
        job = self._jobs.get(job_id)
        if job is not None and attempt == job.attempt:
            if job.pending.pop(checkpoint_id, None) is not None:
                job.stats.report_failed(
                    checkpoint_id, f"declined by shard {shard}: {reason}",
                    benign=True)   # outrun declines retry by design
            job.pending_target.pop(checkpoint_id, None)
            sp = job.savepoint_paths.pop(checkpoint_id, None)
            if sp is None:
                return
            path, margin = sp
            if job.status == "RUNNING" and reason.startswith("at step"):
                # the job outran the target step: retry the savepoint with
                # a doubled margin until the common cut lands
                new_cp = self.trigger_checkpoint(
                    job_id, for_savepoint=True,
                    margin=min(margin * 2, 1 << 14))
                if new_cp is not None:
                    job.savepoint_paths[new_cp] = (path, margin * 2)
                    return
            # permanent (a task finished / job no longer running): report
            # instead of re-triggering at RPC speed forever
            job.failed_savepoints.append(f"{path}: {reason}")

    @absorbs_faults("checkpoint trigger timer: a failed trigger is logged and retried next interval; the coordinator's decline/timeout path owns checkpoint-failure semantics")
    def _checkpoint_loop(self) -> None:
        while True:
            time.sleep(self.checkpoint_interval)
            for job_id, job in list(self._jobs.items()):
                if job.status == "RUNNING":
                    try:
                        self.run_in_main_thread(self.trigger_checkpoint, job_id).result()
                    except Exception as e:
                        _swallow("checkpoint_loop", e)


# ---------------------------------------------------------------------------
# TaskExecutor
# ---------------------------------------------------------------------------

class _ShardTask:
    """One running shard: the stepped source→shuffle→window loop."""

    def __init__(self, te: "TaskExecutorEndpoint", job_id: str, attempt: int,
                 shard: int, parallelism: int, spec: DistributedJobSpec,
                 jm_gateway, peers: Dict[int, str], restore: Optional[dict],
                 restore_step: int, restore_local_cp: Optional[int] = None):
        self.te = te
        self.job_id = job_id
        self.attempt = attempt
        self.shard = shard
        self.parallelism = parallelism
        self.spec = spec
        self.jm = jm_gateway
        self.peers = peers
        self.restore = restore
        self.restore_step = restore_step
        self.restore_local_cp = restore_local_cp
        self.cancelled = threading.Event()
        self.done = threading.Event()
        # tasks of earlier attempts of this job on this TaskExecutor, ended
        # and collected before this task builds its device state
        self.superseded: List["_ShardTask"] = []
        self.current_step = restore_step
        self._cp_requests: List[Tuple[int, int]] = []   # (cp_id, target_step)
        self._cp_lock = threading.Lock()
        # observability: per-task metric registry (shipped to the JM on the
        # heartbeat) and span buffer. The correlation id is DERIVED from the
        # job id — the id already rides every RPC frame of this job, so JM
        # and TM agree on the trace id with zero extra context shipping.
        self.registry = MetricRegistry()
        self.spans: List[dict] = []
        self._span_lock = threading.Lock()
        self.trace_id = job_trace_id(job_id)
        # trace ctx the JM's trigger RPC carried, per checkpoint id (equals
        # the derived id in practice; kept separate so a caller-supplied
        # context always wins, as with a real traceparent header)
        self._cp_trace: Dict[int, str] = {}
        self.thread = threading.Thread(
            target=self._run_safe, daemon=True,
            name=f"task-{job_id[:6]}-a{attempt}-s{shard}",
        )

    def start(self) -> None:
        self.thread.start()

    def record_span(self, scope: str, name: str, start_ms: float, **attrs) -> None:
        """Buffer one span (plain dict) for the next heartbeat shipment.
        Checkpoint spans prefer the trace ctx their trigger RPC carried."""
        attrs.setdefault("jobId", self.job_id)
        attrs.setdefault("shard", self.shard)
        tid = self._cp_trace.get(attrs.get("checkpointId"), self.trace_id)
        with self._span_lock:
            self.spans.append(Span(scope, name, start_ms, time.time() * 1000.0,
                                   attrs, trace_id=tid).to_dict())
            del self.spans[:-256]

    def _wire_emission_spans(self, rt) -> None:
        """Outlier EmissionStall spans from this task's windowed operators
        ride the heartbeat span buffer (record_span) to the JM's span feed
        exactly like checkpoint-ack spans — the distributed half of the
        /jobs/:id/latency stall attribution (the MiniCluster half wires
        the TraceRegistry in JobRuntime instead)."""
        for r in rt.runners:
            t = getattr(r, "emission_tracker", None)
            if t is not None and t.span_sink is None:
                t.span_sink = (lambda scope, name, s, e, a, _self=self:
                               _self.record_span(scope, name, s, **a))

    def drain_spans(self) -> List[dict]:
        """Atomically take the buffered spans (heartbeat shipping); the
        caller re-inserts on a failed shipment (restore_spans)."""
        with self._span_lock:
            out, self.spans = self.spans, []
        return out

    def restore_spans(self, spans: List[dict]) -> None:
        with self._span_lock:
            self.spans[:0] = spans
            del self.spans[:-256]

    def request_checkpoint(self, cp_id: int, target_step: int,
                           trace_id: Optional[str] = None) -> None:
        if trace_id is not None:
            self._cp_trace[cp_id] = trace_id
            if len(self._cp_trace) > 64:
                for k in sorted(self._cp_trace)[:-64]:
                    self._cp_trace.pop(k, None)
        with self._cp_lock:
            if not self.done.is_set():
                self._cp_requests.append((cp_id, target_step))
                return
        # The task loop has exited: a queued request would never be
        # processed, leaving the JM's pending entry dangling forever —
        # decline on the task's behalf. The decline must NOT run inline:
        # request_checkpoint executes on the TM endpoint main thread while
        # the JM main thread is blocked in its trigger RPC to us, so a
        # synchronous jm.decline_checkpoint here is a circular RPC wait
        # (JM-main -> TM-main -> JM-main) that deadlocks both processes.
        @absorbs_faults("best-effort decline for an already-finished task; the JM's checkpoint timeout covers a lost decline")
        def _decline():
            try:
                self.jm.decline_checkpoint(
                    self.job_id, self.attempt, self.shard, cp_id,
                    "task already finished",
                )
            except Exception as e:
                _swallow("decline_after_finish", e)

        threading.Thread(target=_decline, daemon=True,
                         name=f"cp-decline-{self.job_id[:6]}-s{self.shard}").start()

    def _resolve_local_restore(self) -> None:
        """Local recovery (S11): restore from the TM-local copy of the
        snapshot this shard acked — nothing re-ships over the wire. Runs on
        the task thread, NOT deploy_task (which executes on the TM main
        thread while the JM main thread awaits the deploy reply — a
        synchronous JM fetch there would be a circular RPC)."""
        if self.restore is not None or self.restore_local_cp is None:
            return
        local = self.te._local_state.get((self.job_id, self.shard))
        if local is not None and local[0] == self.restore_local_cp:
            self.restore = local[1]
            self.te.num_local_restores += 1
        else:
            # local copy lost (e.g. the TM process restarted): pull the
            # shard snapshot from the JM's retained checkpoints
            self.restore = self.jm.fetch_shard_restore(
                self.job_id, self.restore_local_cp, self.shard
            )

    @absorbs_faults('stage failover boundary: the failure is reported to the JM as task FAILED and rides the normal restart path — which is exactly where the chaos contract routes injected faults')
    def _run_graph_stage(self) -> None:
        """One stage of a slot-sharing-group-split StepGraph (this task's
        shard index = stage index). The stage's sub-graph runs as a normal
        JobRuntime; cross-stage edges are exchange channels (stages.py), so
        the stages of the job execute CONCURRENTLY as a pipeline with
        credit backpressure — the PIPELINED-result-partition analogue.

        Checkpoints use aligned barriers (stages.py module docstring): the
        JM trigger is this stage's '__source__' barrier (consumed at a step
        boundary); channel barriers arrive inline with data; when the
        aligner completes, the snapshot is taken ON the run-loop thread,
        barriers are forwarded into every out-channel, and the JM is
        acked. Restore = per-stage snapshot + source rewind; FIFO channels
        mean no channel state is part of the cut."""
        from flink_tpu_torch.config import ExchangeOptions
        from flink_tpu_torch.metrics.exchange import register_channel_metrics
        from flink_tpu_torch.runtime.dataplane import BatchDebloater, OutputChannel
        from flink_tpu_torch.runtime.executor import (
            JobCancelledException,
            JobRuntime,
            SinkRunner,
        )
        from flink_tpu_torch.runtime.stages import (
            BarrierAligner,
            build_stage_graph,
            cross_edges,
            stage_has_original_sources,
        )

        cfg = self.spec.config
        wire_fmt = cfg.get(ExchangeOptions.WIRE_FORMAT)
        stage_idx = self.shard
        edges = cross_edges(self.spec.graph)
        ins: Dict[str, object] = {}
        outs: Dict[str, OutputChannel] = {}
        out_order: List[str] = []
        debloaters: Dict[str, BatchDebloater] = {}
        for e in edges:
            cid = f"{self.job_id}/a{self.attempt}/{e.edge_id}"
            if e.dst_stage == stage_idx:
                ins[e.edge_id] = self.te.exchange.channel(cid)
            if e.src_stage == stage_idx:
                outs[e.edge_id] = OutputChannel(
                    self.peers[e.dst_stage], cid,
                    security=self.te.exchange.security,
                    wire_format=wire_fmt)
                out_order.append(e.edge_id)
                if cfg.get(ExchangeOptions.DEBLOAT_ENABLED):
                    debloaters[e.edge_id] = BatchDebloater(
                        target_latency_s=cfg.get(
                            ExchangeOptions.DEBLOAT_TARGET_LATENCY_MS) / 1000.0)
        # input-side ring occupancy (inPoolUsage analogue): persistently
        # full = THIS stage is the bottleneck, empty = starved by upstream;
        # per-channel byte counters/rates on both ends (numBytesIn/Out)
        exch_group = self.registry.group("job", "exchange")
        for eid, ch in ins.items():
            exch_group.gauge(f"inPoolUsage.{eid}", ch.occupancy, fold="mean")
            register_channel_metrics(exch_group, eid, inbound=ch)
        for eid, och in outs.items():
            register_channel_metrics(exch_group, eid, outbound=och)

        task = self
        rt_box: list = [None]

        def on_aligned(cp_id: int) -> None:
            ack_t0 = time.time() * 1000.0
            rt = rt_box[0]
            snap = {"runtime": rt.capture(), "step": task.current_step}
            for eid in out_order:                 # forward BEFORE new data
                while True:      # backpressure-tolerant, cancellation-aware
                    try:
                        outs[eid].send(("barrier", cp_id), timeout=1.0)
                        break
                    except TimeoutError:
                        if task.cancelled.is_set():
                            raise JobCancelledException()
            task.te._local_state[(task.job_id, task.shard)] = (cp_id, snap)
            task.jm.ack_checkpoint(
                task.job_id, task.attempt, task.shard, cp_id, snap)
            task.record_span("checkpointing", "CheckpointAck", ack_t0,
                             checkpointId=cp_id)

        has_sources = stage_has_original_sources(self.spec.graph, stage_idx)
        aligner = BarrierAligner(list(ins), has_sources, on_aligned)

        graph = build_stage_graph(
            self.spec.graph, stage_idx, ins, outs, self.cancelled,
            aligner=aligner, debloaters=debloaters,
        )
        rt = JobRuntime(graph, self.spec.config, self.te.device,
                        registry=self.registry)
        self._wire_emission_spans(rt)
        rt_box[0] = rt
        self._resolve_local_restore()
        if self.restore is not None:
            rt.restore(self.restore["runtime"])
            self.current_step = self.restore["step"]

        class _StepCounter:
            """Step progress for heartbeats + the '__source__' barrier: a
            JM trigger due at this step boundary enters the aligner (for a
            pure source stage that completes the alignment immediately)."""

            def register_on_complete(self, fn):
                pass

            def unregister_on_complete(self, fn):
                pass

            def maybe_trigger(self, capture):
                task.current_step += 1
                if not has_sources:
                    return
                with task._cp_lock:
                    due = [r for r in task._cp_requests
                           if r[1] <= task.current_step]
                    task._cp_requests = [
                        r for r in task._cp_requests
                        if r[1] > task.current_step
                    ]
                for cp_id, _target in due:
                    aligner.on_barrier(BarrierAligner.SOURCE_GATE, cp_id)

        try:
            rt.run(coordinator=_StepCounter(),
                   cancel_check=lambda: self.cancelled.is_set())
        except JobCancelledException:
            return
        finally:
            # the stage's input source (kept by the spec's graph) reaches
            # the runtime through the aligner's callback: cut that edge, so
            # an ended stage's device rings go with its thread
            rt_box[0] = None
            for ch in outs.values():
                try:
                    ch.end()     # duplicate eos is harmless; frees receivers
                    ch.close()
                except Exception as e:
                    _swallow("stage_channel_close", e)
        if self.cancelled.is_set():
            return
        results: list = []
        for r in rt.runners:
            if isinstance(r, SinkRunner) and hasattr(r.writer, "store"):
                results.extend(r.writer.store)
        self.jm.task_finished(self.job_id, self.attempt, self.shard, results)

    def _run_graph(self) -> None:
        """One-task execution of a general StepGraph under cluster
        supervision: step-aligned checkpoint requests snapshot the whole
        JobRuntime (sources + every runner), failover restores it."""
        from flink_tpu_torch.runtime.executor import (
            JobCancelledException,
            JobRuntime,
            SinkRunner,
        )

        rt = JobRuntime(self.spec.graph, self.spec.config, self.te.device,
                        registry=self.registry)
        self._wire_emission_spans(rt)
        self._resolve_local_restore()
        if self.restore is not None:
            rt.restore(self.restore["runtime"])
            self.current_step = self.restore["step"]

        task = self

        class _Coord:
            def __init__(self):
                self.on_complete = []

            def register_on_complete(self, fn):
                self.on_complete.append(fn)

            def unregister_on_complete(self, fn):
                # the port's JobRuntime lets go of its sinks when its run
                # ends, so a finished attempt is not kept alive from here
                if fn in self.on_complete:
                    self.on_complete.remove(fn)

            def maybe_trigger(self, capture):
                task.current_step += 1
                with task._cp_lock:
                    due = [r for r in task._cp_requests
                           if r[1] <= task.current_step]
                    task._cp_requests = [
                        r for r in task._cp_requests if r[1] > task.current_step
                    ]
                for cp_id, _target in due:
                    ack_t0 = time.time() * 1000.0
                    snap = {"runtime": capture(), "step": task.current_step}
                    task.te._local_state[(task.job_id, task.shard)] = (
                        cp_id, snap)
                    task.jm.ack_checkpoint(
                        task.job_id, task.attempt, task.shard, cp_id, snap)
                    task.record_span("checkpointing", "CheckpointAck",
                                     ack_t0, checkpointId=cp_id)
                    # single-shard job: the ack completes the checkpoint
                    # inside the JM before returning, so completion
                    # callbacks (2PC sink epoch commits) fire now
                    for fn in self.on_complete:
                        fn(cp_id)

        try:
            rt.run(coordinator=_Coord(),
                   cancel_check=lambda: self.cancelled.is_set())
        except JobCancelledException:
            return
        if self.cancelled.is_set():
            return
        results: list = []
        for r in rt.runners:
            if isinstance(r, SinkRunner) and hasattr(r.writer, "store"):
                results.extend(r.writer.store)
        self.jm.task_finished(self.job_id, self.attempt, self.shard, results)

    def _channel_id(self, src: int) -> str:
        return f"{self.job_id}/a{self.attempt}/{src}->{self.shard}"

    @absorbs_faults('task failover boundary: the exception is reported to the JM as task FAILED and rides the restart path; injected faults surfacing as task failure IS the chaos model')
    def _run_safe(self) -> None:
        try:
            self._release_superseded()
            self._run()
        except Exception as e:  # noqa: BLE001 — reported to the JM
            if not self.cancelled.is_set():
                try:
                    self.jm.task_failed(self.job_id, self.attempt, self.shard, repr(e))
                except Exception as e2:
                    _swallow("report_task_failed", e2)
        finally:
            # close the request_checkpoint race: anything still queued when
            # the loop exits is declined here, and everything arriving later
            # is declined inline by request_checkpoint (gated on `done`)
            with self._cp_lock:
                self.done.set()
                leftover, self._cp_requests = self._cp_requests, []
            for cp_id, target in leftover:
                try:
                    self.jm.decline_checkpoint(
                        self.job_id, self.attempt, self.shard, cp_id,
                        f"task exited before target step {target}",
                    )
                except Exception as e:
                    _swallow("decline_leftover", e)
            # the TaskExecutor keeps an ended task (its last metrics ship on
            # the heartbeat) until a later attempt supersedes it, or for good
            # once the job ends: frozen gauges let go of the runtime, so its
            # device rings are freed with the task's thread
            for metric in self.registry.all_metrics().values():
                if isinstance(metric, Gauge):
                    metric.freeze()

    def _release_superseded(self) -> None:
        """Wait for the cancelled tasks of earlier attempts (they leave at
        their next step boundary or credit wait) and collect them, so their
        runtimes' device rings are freed before this attempt allocates its
        own: a redeployed attempt holds no more device memory than the
        first."""
        old, self.superseded = self.superseded, []
        for t in old:
            t.thread.join(timeout=60.0)
            if t.thread.is_alive():
                raise RuntimeError(
                    f"superseded task {t.thread.name} did not stop within 60 s")
        if old and self.te.device.type == "cuda":
            # the rings are device memory: collect the dead runtime's
            # cycles now (on the CPU they are host memory, left to gc)
            import torch

            del old, t
            gc.collect()
            torch.cuda.synchronize(self.te.device)

    def _make_operator(self):
        from flink_tpu_torch.ops.aggregators import resolve
        from flink_tpu_torch.runtime.oracle_window_operator import OracleWindowOperator

        kg_range = key_group_range_for_operator(
            self.spec.max_parallelism, self.parallelism, self.shard
        )
        if self.spec.operator == "device":
            # imported only on the device path, as in the JAX package
            from flink_tpu_torch.api.windowing.assigners import (
                EventTimeSessionWindows,
            )

            if isinstance(self.spec.assigner, EventTimeSessionWindows) \
                    and self.spec.allowed_lateness == 0:
                # sessions scale past one chip the cluster way: each shard
                # owns a key-group range and runs its own device session
                # operator (sessions never cross keys, so no cross-shard
                # merge exists by construction). allowed_lateness falls
                # back to the oracle below — same gate as the single-node
                # operator selection. Sync emissions: the task loop drains
                # every step, so deferral would only disable the closable
                # precheck.
                from flink_tpu_torch.runtime.tpu_session_operator import (
                    TpuSessionWindowOperator,
                )

                return TpuSessionWindowOperator(
                    self.spec.assigner, self.spec.aggregate,
                    device=self.te.device,
                    **(self.spec.operator_options or {}),
                )
            if not isinstance(self.spec.assigner, EventTimeSessionWindows):
                from flink_tpu_torch.runtime.tpu_window_operator import (
                    TpuWindowOperator,
                )

                return TpuWindowOperator(
                    self.spec.assigner, self.spec.aggregate,
                    allowed_lateness=self.spec.allowed_lateness,
                    device=self.te.device,
                )
            # sessions WITH lateness: only the oracle implements the exact
            # late-merge semantics — fall through
        agg = resolve(self.spec.aggregate)
        return OracleWindowOperator(
            self.spec.assigner,
            agg.python_equivalent() if agg is not None else self.spec.aggregate,
            allowed_lateness=self.spec.allowed_lateness,
            max_parallelism=self.spec.max_parallelism,
            key_group_range=kg_range,
        )

    @absorbs_faults('per-record send/close handlers inside the task body feed the same failover boundary as _run_safe: failures surface as task FAILED and ride the restart path')
    def _run(self) -> None:
        if isinstance(self.spec, GraphJobSpec):
            from flink_tpu_torch.runtime.stages import num_stages

            if num_stages(self.spec.graph) > 1:
                return self._run_graph_stage()
            return self._run_graph()
        from flink_tpu_torch.config import ObservabilityOptions
        from flink_tpu_torch.metrics.task_io import TaskIOMetrics

        # DistributedJobSpec carries no Configuration; honor the sampling
        # knob when a config rides the spec, else use the option default
        cfg = getattr(self.spec, "config", None)
        sampling_ms = (cfg.get(ObservabilityOptions.SAMPLING_INTERVAL_MS)
                       if cfg is not None
                       else ObservabilityOptions.SAMPLING_INTERVAL_MS.default)

        P = self.parallelism
        batches = self.spec.source_factory(self.shard, P)
        op = self._make_operator()
        # task-scope observability for the keyed hot path: throughput,
        # busy/idle/backPressured ratios (busy = partition/send + operator
        # sections; credit waits measured at the senders are subtracted;
        # cross-shard channel-merge polling is idle — the self-partition
        # never waits; checkpoint snapshot/ack time counts as neither, so
        # utilization tracks offered load, not checkpoint cost), plus the
        # window operator's HBM footprint / key cardinality gauges
        job_group = self.registry.group("job")
        records_in = job_group.counter("numRecordsIn")
        io = TaskIOMetrics()
        io.register(job_group)
        op_group = self.registry.group("job", "operator", "keyed-window")
        for gauge_name, attr in (("stateBytes", "state_bytes"),
                                 ("stateKeyCount", "state_key_count")):
            fn = getattr(op, attr, None)
            if fn is not None:
                op_group.gauge(gauge_name, fn, fold="sum")
        op_group.gauge("numLateRecordsDropped",
                       lambda: getattr(op, "num_late_records_dropped", 0),
                       fold="sum", kind="counter")
        # device-plane observability: compile tracking where the operator
        # exposes the attach surface (fused/sharded paths), key-skew
        # telemetry wherever per-key counts are device-resident. The
        # gauges ship to the JM on the heartbeat snapshots (job.device.*,
        # job.keySkew feeds scheduler/signals.py); compile events ride the
        # span buffer as 'device'-scope spans.
        key_stats = None
        O = ObservabilityOptions

        def _opt(option):
            return cfg.get(option) if cfg is not None else option.default

        if _opt(O.DEVICE_STATS_ENABLED):
            attach = getattr(op, "attach_device_stats", None)
            if attach is not None:
                from flink_tpu_torch.metrics.device_stats import CompileTracker

                def _emit_compile_span(ev, task=self):
                    task.record_span(
                        "device", "XlaCompile",
                        ev["wall_ts_ms"] - ev["duration_ms"],
                        program=ev.get("program"),
                        signature=ev.get("signature"),
                        cause=ev.get("cause"),
                        recompile=bool(ev.get("recompile", False)),
                        compileCount=int(ev.get("compile_count", 1)),
                        durationMs=float(ev.get("duration_ms", 0.0)),
                    )

                tracker = CompileTracker(
                    history_size=_opt(O.DEVICE_RECOMPILE_HISTORY_SIZE),
                    storm_threshold=_opt(O.DEVICE_RECOMPILE_STORM_THRESHOLD),
                    storm_window_ms=_opt(O.DEVICE_RECOMPILE_STORM_WINDOW_MS),
                    cost_analysis=_opt(O.DEVICE_COST_ANALYSIS_ENABLED),
                    memory_analysis=_opt(O.DEVICE_MEMORY_ANALYSIS_ENABLED),
                    on_event=_emit_compile_span,
                )
                attach(tracker)
                tracker.register(self.registry.group("job", "device"))
            loads_fn = getattr(op, "key_loads", None)
            if loads_fn is not None:
                from flink_tpu_torch.metrics.key_stats import KeyStatsCollector

                key_stats = KeyStatsCollector(
                    loads_fn,
                    num_key_groups=self.spec.max_parallelism,
                    top_k=_opt(O.DEVICE_KEY_STATS_TOP_K),
                    row_bytes_fn=getattr(op, "state_row_bytes", None),
                    ready_fn=getattr(op, "key_stats_ready", None),
                    interval_ms=_opt(O.DEVICE_KEY_STATS_INTERVAL_MS),
                    # mesh operators expose per-device local loads; the
                    # shipped {device: value} maps fold MAX across this
                    # shard's devices in aggregate_shard_metrics
                    mesh_loads_fn=(
                        getattr(op, "per_device_key_loads", None)
                        if getattr(op, "mesh_devices", lambda: 1)() > 1
                        else None),
                )
                key_stats.register(op_group)
                # the job-level gauge the autoscaler's signal extractor
                # reads (absent on builds without device stats — the
                # signal is OPTIONAL there, never implicit zero)
                job_group.gauge("keySkew", key_stats.skew, fold="max")
        results: list = []
        self._resolve_local_restore()
        if self.restore is not None:
            op_snap = self.restore["operator"]
            if self.restore.get("merged"):
                # rescaled restore: keep only timers whose key falls in this
                # shard's key-group range (state filters itself by range)
                kg_range = key_group_range_for_operator(
                    self.spec.max_parallelism, P, self.shard
                )
                op_snap = {
                    "state": op_snap["state"],
                    "timers": key_groups.filter_timers_for_range(
                        op_snap["timers"], kg_range,
                        self.spec.max_parallelism),
                }
            op.restore(op_snap)
            # the collect-sink is stateful: outputs emitted before the
            # checkpoint are part of the cut (post-checkpoint emissions of
            # the failed attempt are discarded and re-fired on replay)
            results.extend(self.restore.get("results", []))

        # output channels to every OTHER shard; the self-partition takes a
        # local fast path (a plain deque — producer and consumer are this
        # same thread, strictly send-then-poll per step). Riding the
        # loopback socket instead costs an encode/MAC/decode round trip
        # through the exchange thread per step, and under CPU saturation
        # that transit wait reads as idle — capping a saturated p=1 job's
        # utilization far below 1.0 and blinding the autoscaler.
        from flink_tpu_torch.config import ExchangeOptions
        from flink_tpu_torch.metrics.exchange import register_channel_metrics

        wire_fmt = (cfg.get(ExchangeOptions.WIRE_FORMAT) if cfg is not None
                    else ExchangeOptions.WIRE_FORMAT.default)
        reconnect_window_ms = (
            cfg.get(ExchangeOptions.RECONNECT_WINDOW_MS) if cfg is not None
            else ExchangeOptions.RECONNECT_WINDOW_MS.default)
        exch_metrics_group = self.registry.group("job", "exchange")
        self_parts: deque = deque()
        outs: Dict[int, OutputChannel] = {}
        for dst in range(P):
            if dst == self.shard:
                continue
            outs[dst] = OutputChannel(
                self.peers[dst], f"{self.job_id}/a{self.attempt}/{self.shard}->{dst}",
                security=self.te.exchange.security, wire_format=wire_fmt,
            )
            io.add_backpressure_source(
                lambda ch=outs[dst]: ch.backpressured_s)
            register_channel_metrics(exch_metrics_group, str(dst),
                                     outbound=outs[dst])
        ins = {src: self.te.exchange.channel(self._channel_id(src))
               for src in range(P) if src != self.shard}
        for src, ch in ins.items():
            job_group.gauge(f"exchange.inPoolUsage.{src}", ch.occupancy,
                            fold="mean")
            register_channel_metrics(exch_metrics_group, str(src), inbound=ch)
        job_group.gauge("numDataplaneReconnects", lambda: sum(
            ch.num_reconnects for ch in outs.values()),
            fold="sum", kind="counter")
        # liveness probe for the reconnect window: its OWN tight-timeout
        # gateway — the task's main jm gateway runs at the 120s payload
        # reply budget, and a peer_alive probe blocking that long on a
        # wedged JM would stretch the "bounded" reconnect window ~24x
        probe_timeout = max(min(reconnect_window_ms / 1000.0 / 2, 2.0), 0.5)
        probe_jm = RpcGateway(
            self.jm.address, "jobmanager", timeout=probe_timeout,
            security=self.te.rpc.security,
            # single attempt: the retry deadline (8s) would stretch the
            # reconnect window just like the payload reply budget; the
            # send_part loop is the retry policy here
            retry=RetryPolicy(max_attempts=1))

        def send_part(dst: int, part) -> None:
            """Transient-fault hardening on the keyed exchange: a send
            failing with a connection error gets a BOUNDED reconnect
            window (exchange.reconnect.window-ms) — but only while the JM
            confirms the peer TM is still heartbeating, and only when the
            re-run open/credit negotiation proves seq continuity (no frame
            lost). Anything else re-raises into the normal task-failure →
            checkpoint-rewind restart path. Credit-starvation TimeoutError
            is NOT a connection fault and never reconnects (a reconnect
            re-grants credits, which would tunnel through backpressure)."""
            try:
                outs[dst].send(part)
                return
            except _chaos.InjectedCrash:
                raise
            except TimeoutError:
                raise
            except OSError as first_err:
                if reconnect_window_ms <= 0:
                    raise
                deadline = time.monotonic() + reconnect_window_ms / 1000.0
                backoff = 0.05
                last_err = first_err
                while not self.cancelled.is_set():
                    if time.monotonic() >= deadline:
                        raise last_err
                    try:
                        alive = probe_jm.peer_alive(
                            self.job_id, self.attempt, dst)
                    except Exception as e:
                        _swallow("peer_alive_probe", e)
                        alive = True   # an unreachable JM is its own story
                    if not alive:
                        raise last_err   # real TM loss: fail over now
                    try:
                        outs[dst].reconnect()
                        outs[dst].send(part)
                        return
                    except TimeoutError:
                        raise
                    except SequenceLostError:
                        raise   # provably unrecoverable: re-dialing can
                        #         never heal a lost frame — fail over NOW
                    except OSError as e:
                        last_err = e
                        time.sleep(min(
                            backoff,
                            max(deadline - time.monotonic(), 0.0)))
                        backoff = min(backoff * 2, 1.0)
                raise last_err

        step = self.restore_step
        n_steps = len(batches)
        try:
            while not self.cancelled.is_set():
                # ---- step-aligned checkpoint barrier -----------------------
                # (snapshot/ack/persist time deliberately sits OUTSIDE the
                # busy accounting: utilization must track offered load, not
                # checkpoint cost — a result-heavy job checkpointing often
                # would otherwise read busy while idle and mislead the
                # autoscaler in both directions)
                with self._cp_lock:
                    due = [r for r in self._cp_requests if r[1] <= step]
                    self._cp_requests = [r for r in self._cp_requests if r[1] > step]
                for cp_id, target in due:
                    if target == step:
                        ack_t0 = time.time() * 1000.0
                        snap = {"operator": op.snapshot(), "step": step,
                                "results": list(results)}
                        # task-local state store (S11): keep the latest
                        # snapshot on this TM for cheap local recovery
                        self.te._local_state[(self.job_id, self.shard)] = (
                            cp_id, snap)
                        self.jm.ack_checkpoint(
                            self.job_id, self.attempt, self.shard, cp_id, snap
                        )
                        self.record_span("checkpointing", "CheckpointAck",
                                         ack_t0, checkpointId=cp_id)
                    else:  # already past the target: cannot form the cut
                        self.jm.decline_checkpoint(
                            self.job_id, self.attempt, self.shard, cp_id,
                            f"at step {step} > target {target}",
                        )

                if step >= n_steps:
                    break
                loop_t0 = time.perf_counter()
                keys, vals, ts, wm = batches[step]

                # ---- keyBy partition: bucket by owning shard ---------------
                busy_t0 = time.perf_counter()
                hashes = np.asarray([key_hash(k) for k in keys], dtype=np.int64)
                kgs = key_groups_for_hashes(hashes, self.spec.max_parallelism)
                owner = (kgs.astype(np.int64) * P) // self.spec.max_parallelism
                for dst in range(P):
                    m = owner == dst
                    part = (keys[m], vals[m], ts[m], int(wm), step)
                    if dst == self.shard:
                        self_parts.append(part)
                    else:
                        send_part(dst, part)
                busy_dt = time.perf_counter() - busy_t0

                # ---- merge one batch per input channel (min watermark) -----
                # (channel polling is the task's IDLE time — excluded from
                # busy; credit waits inside send() above are subtracted by
                # TaskIOMetrics via the senders' backpressured_s)
                parts = []
                wms = []
                for src in range(P):
                    if src == self.shard:
                        got = self_parts.popleft()   # sent above, same thread
                    else:
                        got = None
                        while True:  # short waits so cancellation stays responsive
                            try:
                                got = ins[src].poll(timeout=0.5)
                                break
                            except TimeoutError:
                                if self.cancelled.is_set():
                                    return
                        if got is None:
                            raise RuntimeError(
                                f"channel from shard {src} ended early")
                    k, v, t, w, s = got
                    assert s == step, f"step skew: got {s} expected {step}"
                    parts.append((k, v, t))
                    wms.append(w)
                busy_t0 = time.perf_counter()
                mk = np.concatenate([p[0] for p in parts])
                mv = np.concatenate([p[1] for p in parts])
                mt = np.concatenate([p[2] for p in parts])
                combined_wm = min(wms)
                records_in.inc(len(mk))

                if hasattr(op, "process_batch") and len(mk):
                    # columnar feeding for device operators: ONE batched
                    # ingest instead of a per-record python loop (the
                    # oracle has no batch form — sessions with lateness
                    # fall back to it even under operator='device')
                    op.process_batch(
                        mk, np.asarray(mv, dtype=np.float32),
                        np.asarray(mt, dtype=np.int64))
                else:
                    for i in range(len(mk)):
                        op.process_record(mk[i], float(mv[i]), int(mt[i]))
                if key_stats is not None:
                    # one clock compare when not due; a due fold runs
                    # BEFORE the watermark's purge sweep
                    key_stats.maybe_collect()
                if combined_wm > MIN_WATERMARK:
                    op.process_watermark(combined_wm)
                results.extend(op.drain_output())
                busy_dt += time.perf_counter() - busy_t0
                io.record_step(busy_dt, time.perf_counter() - loop_t0)
                io.maybe_sample(sampling_ms)

                step += 1
                self.current_step = step

            # checkpoints targeted past the end of the stream are declined
            # by the `done` drain in _run_safe's finally block
            if not self.cancelled.is_set():
                op.process_watermark(MAX_WATERMARK)
                results.extend(op.drain_output())
                out = [
                    (k, (w.start, w.end), r, t) for k, w, r, t in results
                ]
                self.jm.task_finished(self.job_id, self.attempt, self.shard, out)
        finally:
            for ch in outs.values():
                try:
                    ch.end()
                    ch.close()
                except Exception as e:
                    _swallow("channel_close", e)


class TaskExecutorEndpoint(RpcEndpoint):
    """TM RPC endpoint (D1 scope): deploy/cancel/checkpoint tasks."""

    def __init__(self, rpc: RpcService, *, tm_id: Optional[str] = None,
                 slots: int = 1, shipping_interval_ms: int = 500,
                 config=None, device=None):
        # the device every task of this TM runs on: CUDA unless the caller
        # asks for the CPU (raises without a GPU, before anything starts);
        # torch is imported here, not with the module, so importing the
        # control plane (REST readers, the CLI, tools) loads no torch
        from flink_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        super().__init__(name="taskexecutor")
        self.tm_id = tm_id or f"tm-{uuid.uuid4().hex[:8]}"
        self.rpc = rpc
        self.slots = slots
        # observability.shipping.interval-ms: how often metric snapshots and
        # span buffers piggyback on the heartbeat
        self.shipping_interval_ms = shipping_interval_ms
        self._last_ship = 0.0
        # one SecurityConfig governs both of this TM's planes: the exchange
        # handshakes with the same cluster secret as the RPC service.
        # `config` (a Configuration, e.g. from the taskmanager's --conf)
        # sets the TM-level exchange knobs: what wire format this receiver
        # advertises and the credit-coalescing grain.
        exch_kw = {}
        if config is not None:
            from flink_tpu_torch.config import ExchangeOptions

            exch_kw = dict(
                wire_format=config.get(ExchangeOptions.WIRE_FORMAT),
                credit_batch=config.get(ExchangeOptions.CREDIT_BATCH),
            )
        self.exchange = ExchangeServer(security=rpc.security, **exch_kw)
        self._tasks: Dict[Tuple[str, int, int], _ShardTask] = {}
        # task-local state store (S11): latest acked snapshot per (job, shard)
        self._local_state: Dict[Tuple[str, int], Tuple[int, dict]] = {}
        self.num_local_restores = 0
        self._jm_gateway = None
        self._blob: Optional[BlobCache] = None
        rpc.register(self)
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()

    def connect(self, jm_address: str) -> None:
        gw = self.rpc.gateway(jm_address, "jobmanager")
        self._jm_gateway = gw
        self._blob = BlobCache(self.rpc.gateway(
            jm_address, "blob", reply_timeout=PAYLOAD_REPLY_TIMEOUT_S))
        gw.register_task_executor(self.tm_id, self.rpc.address, self.exchange.address, self.slots)
        if self._hb_thread is None:
            self._hb_thread = threading.Thread(target=self._hb_loop, daemon=True,
                                               name=f"hb-{self.tm_id}")
            self._hb_thread.start()

    @absorbs_faults('heartbeat sender: a failed beat is retried next interval and the JM-side liveness timeout owns the death verdict; re-raising would kill the beat thread and falsify liveness')
    def _hb_loop(self) -> None:
        # beat at least every 0.5s (liveness), faster when the shipping
        # interval asks for fresher metric/step snapshots — a sub-500ms
        # observability.shipping.interval-ms was previously unreachable,
        # which left the autoscaler's signal windows up to one full beat
        # stale and starved fast-stepping jobs of checkpoint-target margin
        beat_s = min(0.5, max(self.shipping_interval_ms, 50) / 1000.0)
        # wait() not sleep(): a stopped endpoint's thread must exit — a
        # leaked loop keeps dialing the dead JM at up to 5 Hz forever
        # (real TM processes run until killed, but in-process tests stack
        # dozens of endpoints per run)
        while not self._hb_stop.wait(beat_s):
            try:
                steps = {
                    (t.job_id, t.shard, t.attempt): t.current_step
                    for t in self._tasks.values()
                    if not t.cancelled.is_set()
                }
                metrics = None
                spans = None
                drained: List[Tuple["_ShardTask", List[dict]]] = []
                now = time.monotonic()
                shipping = (now - self._last_ship) * 1000.0 \
                    >= self.shipping_interval_ms
                if shipping:
                    metrics = {}
                    spans = []
                    for t in list(self._tasks.values()):
                        if t.cancelled.is_set():
                            continue
                        snap = metrics_snapshot(t.registry.all_metrics())
                        if snap:
                            metrics[(t.job_id, t.shard, t.attempt)] = snap
                        sp = t.drain_spans()
                        if sp:
                            spans.extend(sp)
                            drained.append((t, sp))
                try:
                    self._jm_gateway.heartbeat_tm(self.tm_id, steps,
                                                  metrics, spans)
                except Exception:
                    # shipment failed: put the drained spans back for the
                    # next beat (bounded by the task buffer cap); _last_ship
                    # stays untouched so metrics re-ship on the next beat
                    # instead of waiting out another full interval
                    for t, sp in drained:
                        t.restore_spans(sp)
                    raise
                if shipping:
                    self._last_ship = now
            except Exception as e:
                _swallow("hb_loop", e)

    # ---- RPC methods ------------------------------------------------------
    def ping(self) -> str:
        return self.tm_id

    def deploy_task(self, job_id: str, attempt: int, shard: int, parallelism: int,
                    blob_key: str, jm_address: str, peers: Dict[int, str],
                    restore: Optional[dict], restore_step: int,
                    restore_local_cp: Optional[int] = None) -> bool:
        spec = DistributedJobSpec.from_bytes(self._blob.get(blob_key))
        # acks ship shard snapshots and block on the JM-side persist
        jm = self.rpc.gateway(jm_address, "jobmanager",
                              reply_timeout=PAYLOAD_REPLY_TIMEOUT_S)
        task = _ShardTask(self, job_id, attempt, shard, parallelism, spec, jm,
                          peers, restore, restore_step,
                          restore_local_cp=restore_local_cp)
        # superseded attempts can never be checkpointed or resumed: cancel
        # and drop them so restarts don't grow the task table without bound
        # (a still-running old-attempt thread would otherwise be unreachable
        # by cancel_task/stop once evicted)
        keep = {}
        for k, t in self._tasks.items():
            if k[0] == job_id and k[1] < attempt:
                t.cancelled.set()
                task.superseded.append(t)
            else:
                keep[k] = t
        self._tasks = keep
        self._tasks[(job_id, attempt, shard)] = task
        task.start()
        return True

    def trigger_checkpoint(self, job_id: str, attempt: int, cp_id: int,
                           target_step: int, shard: Optional[int] = None) -> bool:
        """Deliver a checkpoint request to this TM's task(s) of the job.
        `shard` addresses ONE task — required when a TM hosts several tasks
        of the job (fanning the request to co-located tasks would duplicate
        source barriers on multi-stage jobs); None keeps the legacy
        broadcast for old callers."""
        trace_id = current_trace_id()   # ctx the JM attached to this frame
        for (jid, att, sh), task in self._tasks.items():
            if jid == job_id and att == attempt and not task.cancelled.is_set() \
                    and (shard is None or sh == shard):
                task.request_checkpoint(cp_id, target_step, trace_id)
        return True

    def release_job_state(self, job_id: str) -> bool:
        """Drop task-local snapshot copies for a TERMINALLY finished job
        (sent by the JM on FINISHED/FAILED/CANCELED — failover cancels must
        NOT release, that is exactly when local recovery needs the copies)."""
        for key in [k for k in self._local_state if k[0] == job_id]:
            self._local_state.pop(key, None)
        return True

    def cancel_task(self, job_id: str) -> bool:
        for (jid, _att, _shard), task in self._tasks.items():
            if jid == job_id:
                task.cancelled.set()
        return True

    def stop(self) -> None:
        self._hb_stop.set()
        for task in self._tasks.values():
            task.cancelled.set()
        self.exchange.stop()
        super().stop()


# ---------------------------------------------------------------------------
# process entrypoints (M1 analogue: ClusterEntrypoint mains)
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> None:
    """`python -m flink_tpu_torch.runtime.cluster jobmanager|taskmanager ...`"""
    import argparse

    from flink_tpu_torch.security.transport import SecurityConfig

    p = argparse.ArgumentParser(prog="flink_tpu_torch.runtime.cluster")
    sub = p.add_subparsers(dest="role", required=True)
    jm = sub.add_parser("jobmanager")
    jm.add_argument("--host", default="127.0.0.1")
    jm.add_argument("--port", type=int, default=6123)
    jm.add_argument("--checkpoint-dir", default=None)
    jm.add_argument("--checkpoint-interval", type=float, default=0.0)
    tm = sub.add_parser("taskmanager")
    tm.add_argument("--jobmanager", required=True, help="host:port of the JM RPC service")
    tm.add_argument("--slots", type=int, default=1)
    tm.add_argument(
        "--device", default=None,
        help="device the TaskManager's tasks run on (default: cuda; raises "
             "without a GPU unless given --device cpu)")
    for sp in (jm, tm):
        sp.add_argument(
            "--conf", default=None,
            help="configuration file (JSON or `key: value` subset); the "
                 "security.* option group resolves from it, layered under "
                 "FLINK_TPU_* env dynamic properties")
        sp.add_argument(
            "--secret-file", default=None,
            help="file holding the cluster transport secret "
                 "(default: FLINK_TPU_SECURITY_TRANSPORT_SECRET[_FILE] env, "
                 "else an auto-generated per-user secret)")
        sp.add_argument(
            "--cluster-id", default=None,
            help="handshake cluster identity (security.transport.cluster-id)")
        sp.add_argument(
            "--insecure", action="store_true",
            help="disable transport auth (legacy plaintext wire; local "
                 "debugging only)")
    args = p.parse_args(argv)

    if args.insecure:
        security = SecurityConfig.disabled()
    else:
        # layering: conf file (with env dynamic properties) is the base;
        # --secret-file/--cluster-id overlay it, so e.g. ssl.internal.*
        # from --conf still applies when the secret comes from a flag
        security = None   # process default: env > per-user secret file
        if args.conf:
            from flink_tpu_torch.config import Configuration

            security = SecurityConfig.resolve(
                Configuration.load(args.conf).add_all(Configuration.from_env()))
        if args.secret_file or args.cluster_id:
            import dataclasses as _dc
            import os as _os

            from flink_tpu_torch.security.transport import (
                ENV_CLUSTER_ID,
                _env_or_default_secret,
                _read_secret_file,
            )

            # the flag-less fields must match what env-only processes of
            # the same cluster resolve (_process_default), or a flag-started
            # JM and an env-started TM could never authenticate
            base = security if security is not None else SecurityConfig(
                enabled=True, secret=_env_or_default_secret(),
                cluster_id=_os.environ.get(ENV_CLUSTER_ID, "flink-tpu"))
            overlay = {}
            if args.secret_file:
                overlay["secret"] = _read_secret_file(args.secret_file)
            if args.cluster_id:
                overlay["cluster_id"] = args.cluster_id
            security = _dc.replace(base, enabled=True, **overlay)

    def _install_chaos_from_conf(conf) -> None:
        # chaos.* config group: a --conf-driven fault drill (default off).
        # Installed process-wide exactly once; every injected fault carries
        # the injected-attribution marker (docs/robustness.md).
        plan = _chaos.FaultPlan.from_config(conf)
        if plan is not None and _chaos.active_plan() is None:
            _chaos.install_plan(plan)
            print(f"chaos plane ENABLED: {len(plan.rules)} rule(s), "
                  f"seed {plan.seed}", flush=True)

    if args.role == "jobmanager":
        # a submitted job spec names classes whose modules import torch:
        # import it before serving, or unpickling the first spec (seconds,
        # much of it in one native load) holds up the heartbeats its 3 s
        # timeout watches, and the TaskExecutors are declared lost
        import torch  # noqa: F401

        svc = RpcService(args.host, args.port, security=security)
        hist_kw = {}
        if args.conf:
            from flink_tpu_torch.config import (
                CheckpointingOptions,
                Configuration,
                ObservabilityOptions,
                WatchdogOptions,
            )

            conf = Configuration.load(args.conf).add_all(Configuration.from_env())
            hist_kw = dict(
                checkpoint_history_size=conf.get(
                    ObservabilityOptions.CHECKPOINT_HISTORY_SIZE),
                exception_history_size=conf.get(
                    ObservabilityOptions.EXCEPTION_HISTORY_SIZE),
                # autoscaler.* group (scheduler/): enabled=false is inert
                autoscaler_config=conf,
                tolerable_failed_checkpoints=conf.get(
                    CheckpointingOptions.TOLERABLE_FAILED_CHECKPOINTS),
                stuck_task_timeout_ms=conf.get(
                    WatchdogOptions.STUCK_TASK_TIMEOUT_MS),
                # observability.history.* / observability.doctor.* group
                history_interval_ms=conf.get(
                    ObservabilityOptions.HISTORY_INTERVAL_MS),
                history_retention_points=conf.get(
                    ObservabilityOptions.HISTORY_RETENTION_POINTS),
                doctor_enabled=conf.get(
                    ObservabilityOptions.DOCTOR_ENABLED),
                doctor_window_ms=float(conf.get(
                    ObservabilityOptions.DOCTOR_WINDOW_MS)),
                watchdog_min_gap_ms=float(conf.get(
                    ObservabilityOptions.DOCTOR_WATCHDOG_MIN_GAP_MS)),
                p99_breach_ms=conf.get(
                    ObservabilityOptions.DOCTOR_P99_BREACH_MS),
            )
            _install_chaos_from_conf(conf)
        JobManagerEndpoint(
            svc,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_interval=args.checkpoint_interval,
            **hist_kw,
        )
        print(f"jobmanager listening on {svc.address}", flush=True)
    else:
        svc = RpcService(security=security)
        ship_ms = 500
        conf = None
        if args.conf:
            from flink_tpu_torch.config import Configuration, ObservabilityOptions

            conf = Configuration.load(args.conf).add_all(Configuration.from_env())
            ship_ms = conf.get(ObservabilityOptions.SHIPPING_INTERVAL_MS)
            _install_chaos_from_conf(conf)
        te = TaskExecutorEndpoint(svc, slots=args.slots,
                                  shipping_interval_ms=ship_ms, config=conf,
                                  device=args.device)
        te.connect(args.jobmanager)
        print(f"taskmanager {te.tm_id} registered with {args.jobmanager} "
              f"(rpc {svc.address}, exchange {te.exchange.address})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    # run the module under its own name: run as __main__, its classes would
    # be __main__'s, and a GraphJobSpec unpickled from a client (which names
    # flink_tpu_torch.runtime.cluster) would fail the task's isinstance test
    from flink_tpu_torch.runtime.cluster import main as _main

    _main()
