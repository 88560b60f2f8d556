"""Checkpoint, failure and recovery statistics.

Counterpart of `flink_tpu/metrics/checkpoint_stats.py`, for the in-process
MiniCluster: the checkpoint coordinator feeds a `CheckpointStatsTracker`
(capture = sync phase, persist = async phase), and the MiniCluster records
exception and recovery entries in an `ExceptionHistory` around each
attempt; `JobClient` carries both, and `register_metrics` puts each
tracker's standard gauges on the job's metric group. Plain data and plain
callables, no import of the runtime: stats flow outward through these
trackers. The distributed JobManager (runtime/cluster.py) feeds one
tracker per job from the trigger/ack/decline RPCs, with per-task state
sizes from `snapshot_bytes_estimate` and per-operator bytes from
`operator_bytes_from_snapshot`. The REST routes serve `payload()`, or the
empty payloads below for a job without a tracker.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

# the chaos plane's marker in an injected failure's message: the exception
# history tags such failures `injected: true`
from flink_tpu_torch.chaos.plan import INJECTED_MARKER

# checkpoint lifecycle states (CheckpointStatsStatus analogue)
PENDING = "PENDING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"

_OPERATOR_PREFIX = "job.operator."
_STATE_BYTES_LEAF = ".stateBytes"


def snapshot_bytes_estimate(obj: Any) -> int:
    """Recursive size estimate of a snapshot payload: arrays and tensors
    count their buffer (`nbytes`), bytes-likes their length, containers
    recurse. Used for per-task state sizes in the distributed path, where
    the snapshot is in hand but the persisted artifact lives on the JM."""
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    if isinstance(obj, str):
        return len(obj)
    if isinstance(obj, dict):
        return sum(
            snapshot_bytes_estimate(k) + snapshot_bytes_estimate(v)
            for k, v in obj.items()
        )
    if isinstance(obj, (list, tuple, set, frozenset)):
        return sum(snapshot_bytes_estimate(v) for v in obj)
    if obj is None or isinstance(obj, (int, float, bool)):
        return 8
    try:
        return sys.getsizeof(obj)
    except TypeError:
        return 8


def operator_bytes_from_snapshot(metric_snapshot: Dict[str, Any],
                                 into: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """Fold one task's plain-data metric snapshot into a per-operator state
    byte map: `job.operator.<uid>.stateBytes` keys sum per uid (shards of
    the same operator add up). This is how the JM builds the per-operator
    breakdown of a completed checkpoint from gauges the TMs already ship."""
    out: Dict[str, int] = into if into is not None else {}
    for key, val in metric_snapshot.items():
        if (key.startswith(_OPERATOR_PREFIX) and key.endswith(_STATE_BYTES_LEAF)
                and isinstance(val, (int, float))):
            uid = key[len(_OPERATOR_PREFIX):-len(_STATE_BYTES_LEAF)]
            out[uid] = out.get(uid, 0) + int(val)
    return out


def root_cause_chain(exc: Optional[BaseException], limit: int = 8) -> List[str]:
    """`repr`-level cause chain of an exception, outermost first — the
    ExceptionHistoryEntry root-cause view (explicit `raise ... from` causes
    preferred, falling back to implicit context the way traceback does)."""
    chain: List[str] = []
    seen = set()
    while exc is not None and id(exc) not in seen and len(chain) < limit:
        seen.add(id(exc))
        chain.append(f"{type(exc).__name__}: {exc}")
        exc = exc.__cause__ or (
            exc.__context__ if not exc.__suppress_context__ else None)
    return chain


def failing_task(exc: Optional[BaseException]) -> Optional[str]:
    """Best-effort task attribution for an in-process failure: the uid of
    the innermost traceback frame whose `self` is a runner/operator with a
    `uid` attribute — i.e. which operator the exception escaped from."""
    if exc is None:
        return None
    uid = None
    tb = exc.__traceback__
    while tb is not None:
        owner = tb.tb_frame.f_locals.get("self")
        got = getattr(owner, "uid", None)
        if isinstance(got, str):
            uid = got
        tb = tb.tb_next
    return uid


class CheckpointStats:
    """One checkpoint's lifecycle record (AbstractCheckpointStats analogue).

    Plain mutable holder; the tracker owns all mutation under its lock."""

    __slots__ = (
        "checkpoint_id", "status", "is_savepoint", "trigger_ts_ms",
        "sync_duration_ms", "async_duration_ms", "end_to_end_duration_ms",
        "state_size_bytes", "operator_bytes", "task_acks", "failure_cause",
        "completion_ts_ms",
    )

    def __init__(self, checkpoint_id: int, trigger_ts_ms: float,
                 is_savepoint: bool = False):
        self.checkpoint_id = checkpoint_id
        self.status = PENDING
        self.is_savepoint = is_savepoint
        self.trigger_ts_ms = trigger_ts_ms
        self.sync_duration_ms: Optional[float] = None    # capture phase
        self.async_duration_ms: Optional[float] = None   # persist phase
        self.end_to_end_duration_ms: Optional[float] = None
        self.state_size_bytes: int = 0
        self.operator_bytes: Dict[str, int] = {}
        # task -> {"ack_latency_ms", "state_size_bytes"} (distributed path)
        self.task_acks: Dict[str, Dict[str, float]] = {}
        self.failure_cause: Optional[str] = None
        self.completion_ts_ms: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.checkpoint_id,
            "status": self.status,
            "is_savepoint": self.is_savepoint,
            "trigger_timestamp_ms": self.trigger_ts_ms,
            "sync_duration_ms": self.sync_duration_ms,
            "async_duration_ms": self.async_duration_ms,
            "end_to_end_duration_ms": self.end_to_end_duration_ms,
            "state_size_bytes": self.state_size_bytes,
            "operators": dict(self.operator_bytes),
            "tasks": {t: dict(a) for t, a in self.task_acks.items()},
            "num_acknowledged": len(self.task_acks),
            "failure_cause": self.failure_cause,
            "completion_timestamp_ms": self.completion_ts_ms,
        }


class CheckpointStatsTracker:
    """Bounded per-checkpoint history + lifetime counters + the standard
    gauges (CheckpointStatsTracker/CheckpointStatsHistory analogue).

    Thread-safe: the JM main thread / job thread report, REST and metric
    reporters read concurrently."""

    def __init__(self, history_size: int = 10, clock: Callable[[], float] = time.time):
        self._clock = clock           # wall seconds
        self._history_size = max(int(history_size), 1)
        self._records: Dict[int, CheckpointStats] = {}
        self._order: deque = deque()  # checkpoint ids, oldest first
        self._lock = threading.Lock()
        self.num_completed = 0
        self.num_failed = 0
        # failed-or-declined records since the last completion — the gauge
        # behind execution.checkpointing.tolerable-failed-checkpoints
        # dashboards (the enforcing counters live on the coordinator/JM,
        # which distinguish real failures from benign savepoint declines)
        self.consecutive_failed = 0
        self._last_completed: Optional[CheckpointStats] = None
        self._last_failed: Optional[CheckpointStats] = None
        # {"checkpoint_id", "restore_timestamp_ms", "restore_duration_ms"}
        self.last_restore: Optional[Dict[str, Any]] = None

    # -- reporting ---------------------------------------------------------
    def report_pending(self, checkpoint_id: int, *, is_savepoint: bool = False,
                       trigger_ts_ms: Optional[float] = None) -> CheckpointStats:
        rec = CheckpointStats(
            checkpoint_id,
            self._clock() * 1000.0 if trigger_ts_ms is None else trigger_ts_ms,
            is_savepoint,
        )
        with self._lock:
            if checkpoint_id not in self._records:
                # a failed trigger's id is re-used by the next attempt —
                # replace the record, never duplicate the ring slot
                self._order.append(checkpoint_id)
            self._records[checkpoint_id] = rec
            while len(self._order) > self._history_size:
                self._records.pop(self._order.popleft(), None)
        return rec

    def report_ack(self, checkpoint_id: int, task: str,
                   state_size_bytes: int = 0) -> None:
        """One task acknowledged (distributed path): latency is measured
        from the trigger timestamp — the aligned-barrier + capture + RPC
        cost as seen by the coordinator."""
        now_ms = self._clock() * 1000.0
        with self._lock:
            rec = self._records.get(checkpoint_id)
            if rec is None:
                return
            rec.task_acks[str(task)] = {
                "ack_latency_ms": max(now_ms - rec.trigger_ts_ms, 0.0),
                "state_size_bytes": int(state_size_bytes),
            }

    def report_completed(self, checkpoint_id: int, *,
                         sync_duration_ms: Optional[float] = None,
                         async_duration_ms: Optional[float] = None,
                         state_size_bytes: Optional[int] = None,
                         operator_bytes: Optional[Dict[str, int]] = None) -> None:
        now_ms = self._clock() * 1000.0
        with self._lock:
            rec = self._records.get(checkpoint_id)
            if rec is None:       # evicted from the ring: still count it
                rec = CheckpointStats(checkpoint_id, now_ms)
            if rec.status == FAILED:
                # a straggler ack completing the set after the job already
                # failed the checkpoint must not resurrect the record (and
                # double-count it in both tallies); a re-trigger of the id
                # goes through report_pending, which resets the record
                return
            rec.status = COMPLETED
            rec.completion_ts_ms = now_ms
            rec.sync_duration_ms = sync_duration_ms
            rec.async_duration_ms = async_duration_ms
            rec.end_to_end_duration_ms = max(now_ms - rec.trigger_ts_ms, 0.0)
            if state_size_bytes is not None:
                rec.state_size_bytes = int(state_size_bytes)
            elif rec.task_acks:
                rec.state_size_bytes = int(sum(
                    a.get("state_size_bytes", 0) for a in rec.task_acks.values()))
            if operator_bytes:
                rec.operator_bytes = {k: int(v) for k, v in operator_bytes.items()}
            self.num_completed += 1
            self.consecutive_failed = 0
            self._last_completed = rec

    def report_failed(self, checkpoint_id: int, failure_cause: str,
                      benign: bool = False) -> None:
        """`benign` marks failures that are NOT storage/capture faults —
        savepoint outrun declines (which retry by design) and the sweeps
        that fail in-flight records when a job restarts or rescales. They
        count in num_failed (the record IS failed) but never in the
        consecutiveFailedCheckpoints gauge, which must mirror what
        tolerable-failed-checkpoints enforcement counts — a gauge
        climbing on benign declines would page operators on healthy jobs."""
        now_ms = self._clock() * 1000.0
        with self._lock:
            rec = self._records.get(checkpoint_id)
            if rec is None:
                rec = CheckpointStats(checkpoint_id, now_ms)
            if rec.status == COMPLETED:
                return            # late decline must not un-complete
            rec.status = FAILED
            rec.completion_ts_ms = now_ms
            rec.end_to_end_duration_ms = max(now_ms - rec.trigger_ts_ms, 0.0)
            rec.failure_cause = str(failure_cause)
            self.num_failed += 1
            if not benign:
                self.consecutive_failed += 1
            self._last_failed = rec

    def report_restore(self, checkpoint_id: Optional[int],
                       restore_duration_ms: float) -> None:
        """A (re)start restored from `checkpoint_id` — feeds the
        lastCheckpointRestoreTimestamp gauge and the latest.restored view."""
        with self._lock:
            self.last_restore = {
                "checkpoint_id": checkpoint_id,
                "restore_timestamp_ms": self._clock() * 1000.0,
                "restore_duration_ms": float(restore_duration_ms),
            }

    # -- reading -----------------------------------------------------------
    def _pending_count(self) -> int:
        """PENDING records in the ring; call with the lock held."""
        return sum(1 for r in self._records.values() if r.status == PENDING)

    def checkpoint(self, checkpoint_id: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._records.get(checkpoint_id)
            return rec.to_dict() if rec is not None else None

    def gauge_values(self, prefix: str = "") -> Dict[str, float]:
        """The standard checkpoint gauges as a plain dict (the names the
        reference registers on the job metric group)."""
        with self._lock:
            last = self._last_completed
            restore_ts = (self.last_restore or {}).get("restore_timestamp_ms", 0)
            return {
                prefix + "numberOfCompletedCheckpoints": self.num_completed,
                prefix + "numberOfFailedCheckpoints": self.num_failed,
                prefix + "consecutiveFailedCheckpoints": self.consecutive_failed,
                prefix + "numberOfInProgressCheckpoints": self._pending_count(),
                prefix + "lastCheckpointDuration": (
                    last.end_to_end_duration_ms if last is not None else 0),
                prefix + "lastCheckpointSize": (
                    last.state_size_bytes if last is not None else 0),
                prefix + "lastCheckpointRestoreTimestamp": restore_ts,
            }

    def register_metrics(self, group) -> None:
        """Register the standard gauges on a metric group (names per the
        reference's CheckpointStatsTracker.registerMetrics). Completed and
        failed totals are monotone (kind "counter": the history plane
        records checkpoint rates); the last* family are point-in-time facts
        that fold MAX."""
        for name, fold, kind in (
                ("numberOfCompletedCheckpoints", "sum", "counter"),
                ("numberOfFailedCheckpoints", "sum", "counter"),
                ("consecutiveFailedCheckpoints", "max", None),
                ("numberOfInProgressCheckpoints", "sum", None),
                ("lastCheckpointDuration", "max", None),
                ("lastCheckpointSize", "max", None),
                ("lastCheckpointRestoreTimestamp", "max", None)):
            group.gauge(name, lambda n=name: self.gauge_values()[n],
                        fold=fold, kind=kind)

    def payload(self) -> Dict[str, Any]:
        """REST /jobs/:id/checkpoints body (CheckpointingStatistics shape:
        counts + summary + latest + bounded history, newest first)."""
        with self._lock:
            history = [self._records[cid].to_dict()
                       for cid in reversed(self._order)
                       if cid in self._records]
            completed_e2e = [r.end_to_end_duration_ms
                             for r in self._records.values()
                             if r.status == COMPLETED
                             and r.end_to_end_duration_ms is not None]
            completed_size = [r.state_size_bytes for r in self._records.values()
                              if r.status == COMPLETED]
            summary: Dict[str, Any] = {}
            for name, vals in (("end_to_end_duration_ms", completed_e2e),
                               ("state_size_bytes", completed_size)):
                if vals:
                    summary[name] = {
                        "min": min(vals), "max": max(vals),
                        "avg": sum(vals) / len(vals),
                    }
            pending = self._pending_count()
            return {
                "counts": {
                    "total": self.num_completed + self.num_failed + pending,
                    "in_progress": pending,
                    "completed": self.num_completed,
                    "failed": self.num_failed,
                },
                "summary": summary,
                "latest": {
                    "completed": (self._last_completed.to_dict()
                                  if self._last_completed else None),
                    "failed": (self._last_failed.to_dict()
                               if self._last_failed else None),
                    "restored": dict(self.last_restore)
                    if self.last_restore else None,
                },
                "history": history,
            }


def empty_checkpoints_payload() -> Dict[str, Any]:
    """What /jobs/:id/checkpoints returns for a job with no tracker (e.g.
    checkpointing disabled) — same shape, all zeros."""
    return {
        "counts": {"total": 0, "in_progress": 0, "completed": 0, "failed": 0},
        "summary": {},
        "latest": {"completed": None, "failed": None, "restored": None},
        "history": [],
    }


class ExceptionHistory:
    """Bounded per-job failure + recovery history (ExceptionHistoryEntry /
    JobExceptionsHandler analogue, with the RestartTimeGauge/DownTimeGauge
    signals folded into one recovery-timeline record per restart).

    A failure appends an exception entry (timestamp, task/TaskManager
    attribution, root-cause chain, restart number). If the job restarts,
    `begin_recovery` opens a timeline record at failure time and
    `complete_recovery` closes it when the new attempt reaches RUNNING —
    capturing restore duration, the checkpoint id rewound to, steps/events
    replayed, and downtime (fail → RUNNING)."""

    def __init__(self, size: int = 16, clock: Callable[[], float] = time.time):
        self._clock = clock
        self.entries: deque = deque(maxlen=max(int(size), 1))
        self.recoveries: deque = deque(maxlen=max(int(size), 1))
        self._open_recovery: Optional[Dict[str, Any]] = None
        # lifetime restart count: the numRestarts gauge must keep climbing
        # after the bounded recovery ring starts evicting (a flapping job is
        # exactly when the restart rate matters)
        self._num_restarts = 0
        self._lock = threading.Lock()

    # -- failures ----------------------------------------------------------
    def record_failure(self, cause: str, *, task: Optional[str] = None,
                       task_manager: Optional[str] = None,
                       restart_number: int = 0,
                       exception: Optional[BaseException] = None) -> Dict[str, Any]:
        chain = (root_cause_chain(exception)
                 if exception is not None else [str(cause)])
        entry = {
            "timestamp_ms": self._clock() * 1000.0,
            "exception": str(cause),
            "root_cause_chain": chain,
            "task": task,
            "task_manager": task_manager,
            "restart_number": int(restart_number),
            # chaos attribution: true when the failure was injected by an
            # installed FaultPlan (marker survives the distributed path's
            # repr()-over-RPC shipping) — scenarios assert WHERE the
            # runtime blamed each injected fault
            "injected": (INJECTED_MARKER in str(cause)
                         or any(INJECTED_MARKER in c for c in chain)),
        }
        with self._lock:
            self.entries.append(entry)
        return entry

    def latest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self.entries[-1]) if self.entries else None

    # -- recovery timeline -------------------------------------------------
    def begin_recovery(self, restart_number: int, *, cause: str,
                       steps_at_failure: Optional[int] = None,
                       events_at_failure: Optional[int] = None,
                       kind: str = "restart",
                       failed_at_ms: Optional[float] = None,
                       release_ms: Optional[float] = None) -> None:
        """`kind` distinguishes failure-driven restarts from deliberate
        autoscaler rescales — both rewind to a checkpoint and redeploy, so
        both ride this timeline (and both count toward numRestarts, as the
        reference's reactive mode does). `failed_at_ms` (default now) is
        when the failure was caught; `release_ms` (recorded where
        given) is the part of the downtime spent releasing the failed
        attempt before the restart."""
        with self._lock:
            self._num_restarts += 1
            self._open_recovery = {
                "kind": str(kind),
                "restart_number": int(restart_number),
                "failed_at_ms": (self._clock() * 1000.0 if failed_at_ms is None
                                 else float(failed_at_ms)),
                "cause": str(cause),
                "injected": INJECTED_MARKER in str(cause),
                "steps_at_failure": steps_at_failure,
                "events_at_failure": events_at_failure,
                "restored_checkpoint_id": None,
                "restore_duration_ms": None,
                "steps_replayed": None,
                "events_replayed": None,
                "running_at_ms": None,
                "downtime_ms": None,
            }
            if release_ms is not None:
                self._open_recovery["release_ms"] = float(release_ms)

    def complete_recovery(self, *, restored_checkpoint_id: Optional[int] = None,
                          restore_duration_ms: Optional[float] = None,
                          steps_replayed: Optional[int] = None,
                          events_replayed: Optional[int] = None,
                          restored_step: Optional[int] = None) -> None:
        """Close the open recovery record: the restarted attempt reached
        RUNNING. No-op when no recovery is open (initial schedules).
        `restored_step` derives steps_replayed from the failure-time step
        recorded by begin_recovery (rewind depth in steps)."""
        with self._lock:
            rec = self._open_recovery
            if rec is None:
                return
            self._open_recovery = None
            now_ms = self._clock() * 1000.0
            if (steps_replayed is None and restored_step is not None
                    and rec["steps_at_failure"] is not None):
                steps_replayed = max(rec["steps_at_failure"] - restored_step, 0)
            rec["restored_checkpoint_id"] = restored_checkpoint_id
            rec["restore_duration_ms"] = restore_duration_ms
            rec["steps_replayed"] = steps_replayed
            rec["events_replayed"] = events_replayed
            rec["running_at_ms"] = now_ms
            rec["downtime_ms"] = max(now_ms - rec["failed_at_ms"], 0.0)
            self.recoveries.append(rec)

    # -- reading -----------------------------------------------------------
    def gauge_values(self, prefix: str = "") -> Dict[str, float]:
        with self._lock:
            last = self.recoveries[-1] if self.recoveries else None
            return {
                prefix + "numRestarts": self._num_restarts,
                prefix + "lastRestartDowntimeMs": (
                    last["downtime_ms"] if last else 0),
                prefix + "lastCheckpointRestoreDurationMs": (
                    (last.get("restore_duration_ms") or 0) if last else 0),
            }

    def register_metrics(self, group) -> None:
        for name, fold, kind in (
                ("numRestarts", "sum", "counter"),
                ("lastRestartDowntimeMs", "max", None),
                ("lastCheckpointRestoreDurationMs", "max", None)):
            group.gauge(name, lambda n=name: self.gauge_values()[n],
                        fold=fold, kind=kind)

    def payload(self) -> Dict[str, Any]:
        """REST /jobs/:id/exceptions body: root exception + bounded entry
        list (newest first) + the recovery timeline (newest first)."""
        with self._lock:
            entries = [dict(e) for e in reversed(self.entries)]
            recoveries = [dict(r) for r in reversed(self.recoveries)]
            if self._open_recovery is not None:
                recoveries.insert(0, dict(self._open_recovery))
            root = entries[0] if entries else None
            return {
                "root_exception": root["exception"] if root else None,
                "timestamp_ms": root["timestamp_ms"] if root else None,
                "entries": entries,
                "recoveries": recoveries,
            }


def empty_exceptions_payload() -> Dict[str, Any]:
    return {"root_exception": None, "timestamp_ms": None,
            "entries": [], "recoveries": []}
