"""Checkpoint coordinator: step-aligned consistent snapshots.

Counterpart of `flink_tpu/checkpoint/coordinator.py`. In the stepped
runtime a barrier is a step boundary: between two steps the whole pipeline
is quiescent, so alignment is free and a checkpoint is

  1. capture the source positions (splits and reader offsets) and every
     stateful runner's snapshot (device state pulled to the host),
  2. persist it atomically to a CheckpointStorage,
  3. on success, notify completion: two-phase-commit sinks commit the
     epoch.

Exactly-once = replayable source positions + a state snapshot +
transactional sinks.

With `traces` (a TraceRegistry) every checkpoint reports the JAX
coordinator's lifecycle spans: `checkpointing.Checkpoint` with its status,
and its `CheckpointCapture` and `CheckpointPersist` phases.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from flink_tpu_torch.chaos.plan import InjectedCrash
from flink_tpu_torch.checkpoint.storage import CheckpointStorage, CorruptCheckpointError


class CheckpointFailuresExhaustedError(RuntimeError):
    """More consecutive checkpoint failures than
    execution.checkpointing.tolerable-failed-checkpoints allows: raised
    from trigger() so the job's restart strategy takes over."""


class CheckpointCoordinator:
    def __init__(
        self,
        storage: CheckpointStorage,
        interval_ms: int,
        max_retained: int = 3,
        clock: Callable[[], float] = time.monotonic,
        traces=None,
        stats=None,
        tolerable_failures: int = 0,
    ):
        self.storage = storage
        self.interval_s = interval_ms / 1000.0
        self.max_retained = max_retained
        self._clock = clock
        self._last_trigger = clock()
        self._next_id = 1
        self.num_completed = 0
        # execution.checkpointing.tolerable-failed-checkpoints: consecutive
        # capture/persist failures absorbed (FAILED stats record, job keeps
        # running) before trigger() escalates to the restart strategy
        self.tolerable_failures = tolerable_failures
        self.traces = traces  # TraceRegistry: checkpoint lifecycle spans
        self._consecutive_failures = 0
        self._on_complete: List[Callable[[int], None]] = []
        # CheckpointStatsTracker (metrics/checkpoint_stats.py): stats flow
        # outward through it; the checkpoint layer never reaches into the
        # runtime
        self.stats = stats
        # optional per-operator state-bytes provider, re-pointed at every
        # attempt's JobRuntime
        self.state_bytes_fn: Optional[Callable[[], Dict[str, int]]] = None

    def register_on_complete(self, fn: Callable[[int], None]) -> None:
        self._on_complete.append(fn)

    def unregister_on_complete(self, fn: Callable[[int], None]) -> None:
        """Drop a completion callback (an attempt's sink commit when the
        attempt ends: the coordinator outlives restarts, and a callback
        left behind would keep the dead attempt's runtime, with its device
        state, alive)."""
        if fn in self._on_complete:
            self._on_complete.remove(fn)

    def reset_failure_streak(self) -> None:
        """A new job attempt starts with its FULL failure tolerance: the
        coordinator outlives restarts, and carrying the exhausted streak
        over would make the first isolated failure of the restarted attempt
        escalate again."""
        self._consecutive_failures = 0

    def set_next_id(self, next_id: int) -> None:
        self._next_id = max(self._next_id, next_id)

    def due(self) -> bool:
        return self.interval_s > 0 and (self._clock() - self._last_trigger) >= self.interval_s

    def maybe_trigger(self, capture_fn: Callable[[], dict]) -> Optional[int]:
        if not self.due():
            return None
        return self.trigger(capture_fn)

    def trigger(self, capture_fn: Callable[[], dict]) -> Optional[int]:
        """Returns the completed checkpoint id, or None when a failure was
        TOLERATED (within tolerable_failures: the stats record is FAILED,
        the job keeps running, the next interval retries with a fresh id).
        Beyond tolerance the phase error is re-raised (chained into
        CheckpointFailuresExhaustedError) for the restart strategy."""
        cid = self._next_id
        span = self.traces.span("checkpointing", "Checkpoint") if self.traces else None
        if self.stats is not None:
            self.stats.report_pending(cid)
        # sync phase: pull device state to the host + source positions
        cap_span = (self.traces.span("checkpointing", "CheckpointCapture")
                    if self.traces else None)
        t_cap = self._clock()
        try:
            data = capture_fn()
        except BaseException as e:  # noqa: BLE001 — record, close spans,
            return self._failed(cid, e, span, cap_span)  # tolerate/raise
        sync_ms = (self._clock() - t_cap) * 1000.0
        if cap_span is not None:
            self.traces.report(cap_span.set_attribute("checkpointId", cid).end())
        data["checkpoint_id"] = cid
        # async phase: persist to checkpoint storage; a failed persist flips
        # the record to FAILED (and closes the spans with the cause) instead
        # of leaving it PENDING
        persist_span = (self.traces.span("checkpointing", "CheckpointPersist")
                        if self.traces else None)
        t_save = self._clock()
        try:
            self.storage.save(cid, data)
        except BaseException as e:  # noqa: BLE001
            return self._failed(cid, e, span, persist_span)
        async_ms = (self._clock() - t_save) * 1000.0
        self._consecutive_failures = 0   # tolerance counts CONSECUTIVE
        if persist_span is not None:
            self.traces.report(persist_span.set_attribute("checkpointId", cid).end())
        self._next_id += 1
        self._last_trigger = self._clock()
        self.num_completed += 1
        if self.stats is not None:
            per_op = None
            if self.state_bytes_fn is not None:
                try:
                    per_op = self.state_bytes_fn()
                except Exception:
                    per_op = None
            self.stats.report_completed(
                cid,
                sync_duration_ms=sync_ms,
                async_duration_ms=async_ms,
                state_size_bytes=getattr(self.storage, "last_save_bytes", None),
                operator_bytes=per_op,
            )
        for fn in list(self._on_complete):
            fn(cid)
        self._retain()
        if span is not None:
            self.traces.report(span.set_attribute("checkpointId", cid)
                               .set_attribute("status", "COMPLETED").end())
        return cid

    def _failed(self, cid: int, exc: BaseException, span=None, phase_span=None) -> None:
        """A checkpoint phase raised: record FAILED, close the spans, then either TOLERATE
        (within tolerable_failures: bump the failed id so the retry never
        reuses it, restart the interval clock, return None) or re-raise for
        the restart strategy. Non-Exception BaseExceptions
        (KeyboardInterrupt, SystemExit) and InjectedCrash are never
        tolerated: tolerance is for storage faults, not for interpreter
        shutdown or chaos process-death models."""
        self._abort(cid, exc, span, phase_span)
        if not isinstance(exc, Exception) or isinstance(exc, InjectedCrash):
            raise exc
        self._consecutive_failures += 1
        if self._consecutive_failures <= self.tolerable_failures:
            self._next_id = cid + 1
            self._last_trigger = self._clock()   # no hot-loop retriggering
            return None
        if self.tolerable_failures > 0:
            raise CheckpointFailuresExhaustedError(
                f"checkpoint {cid} failed; {self._consecutive_failures} "
                f"consecutive failures exceed tolerable-failed-checkpoints "
                f"{self.tolerable_failures}") from exc
        raise exc

    def _abort(self, cid: int, exc: BaseException, span, phase_span) -> None:
        """Flip the tracker record to FAILED and close the open spans with
        the failure attribute."""
        if self.stats is not None:
            self.stats.report_failed(cid, repr(exc))
        if phase_span is not None:
            self.traces.report(phase_span.set_attribute("checkpointId", cid)
                               .set_attribute("status", "FAILED").end())
        if span is not None:
            self.traces.report(span.set_attribute("checkpointId", cid)
                               .set_attribute("status", "FAILED")
                               .set_attribute("failureCause", repr(exc)[:200]).end())

    def _retain(self) -> None:
        cps = self.storage.list_checkpoints()
        while len(cps) > self.max_retained:
            cid, _ = cps.pop(0)
            self.storage.discard(cid)

    def latest_snapshot(self) -> Optional[dict]:
        """Newest LOADABLE snapshot: a torn or corrupt checkpoint artifact
        (CorruptCheckpointError) is SKIPPED and the rewind continues to the
        previous complete checkpoint instead of crash-looping the restart
        path on an unreadable file. None when nothing loadable remains (the
        job replays from scratch, still exactly-once)."""
        for _cid, handle in reversed(self.storage.list_checkpoints()):
            try:
                return self.storage.load(handle)
            except CorruptCheckpointError:
                continue
        return None
