"""AutoscalerCoordinator: the control loop between signals and rescales.

Counterpart of `flink_tpu/scheduler/autoscaler.py`, copied: feeds the
per-job signal windows (signals.py), asks the configured policy
(policy.py) for a decision, executes it through an injected rescale
executor (on the MiniCluster: a live mesh rescale, a step-aligned capture
re-sharded over another shard count; injected as a callable so this layer
never imports the runtime), and keeps the bounded per-job decision log:
signals seen, action taken, outcome, rescale duration, and the observed
before/after throughput that feeds the learning policy. The clock is
injected. The JobManager's autoscaler tick and the /jobs/:id/autoscaler
route are ROADMAP.md item 14 (the cluster).

Thread model: one lock guards all mutable coordinator state. `observe` is
driven by a MiniCluster run loop; the executor callback runs inside
`observe`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional

from flink_tpu_torch.scheduler.policy import (
    ScalingDecision,
    ScalingPolicy,
    build_policy,
)
from flink_tpu_torch.scheduler.signals import SignalAggregator, SignalEstimate

#: rescale_executor(job_id, target_parallelism, reason)
#: -> (accepted: bool, detail: str)
RescaleExecutor = Callable[[str, int, str], "tuple[bool, str]"]


def empty_autoscaler_payload() -> Dict[str, Any]:
    """REST /jobs/:id/autoscaler body for a job with no autoscaler."""
    return {
        "enabled": False,
        "policy": None,
        "min_parallelism": None,
        "max_parallelism": None,
        "stabilization_interval_ms": None,
        "num_rescales": 0,
        "last_rescale_duration_ms": 0.0,
        "decisions": [],
    }


class _JobScalingState:
    """Per-job bookkeeping (guarded by the coordinator lock)."""

    def __init__(self, decision_log_size: int):
        self.decisions: Deque[Dict[str, Any]] = deque(
            maxlen=max(int(decision_log_size), 1))
        self.first_seen: Optional[float] = None
        self.last_action_at: Optional[float] = None
        self.last_parallelism: Optional[int] = None
        # executed rescale awaiting its post-stabilization throughput
        # measurement (feeds policy.record_outcome)
        self.pending_outcome: Optional[Dict[str, Any]] = None
        # a rescale_completed that fired before its decision entry landed
        # (the executor redeploys synchronously inside observe): the
        # duration parks here until the entry is logged
        self.unclaimed_duration: Optional[float] = None


class AutoscalerCoordinator:
    def __init__(
        self,
        policy: Optional[ScalingPolicy] = None,
        *,
        min_parallelism: int = 1,
        max_parallelism: int = 0,
        stabilization_interval_ms: int = 30_000,
        interval_ms: int = 1000,
        signal_window: int = 6,
        decision_log_size: int = 32,
        rescale_executor: Optional[RescaleExecutor] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policy = policy if policy is not None else build_policy("threshold")
        self.min_parallelism = max(int(min_parallelism), 1)
        self.max_parallelism = int(max_parallelism)   # 0 = unbounded here
        self.stabilization_s = max(int(stabilization_interval_ms), 0) / 1000.0
        self.interval_s = max(int(interval_ms), 1) / 1000.0
        self.decision_log_size = decision_log_size
        self.rescale_executor = rescale_executor
        self._clock = clock
        # outcome settling wants a multi-sample window (one stalled
        # snapshot pair reads ~0 throughput), but must stay reachable
        # when the configured window itself is smaller than 3
        self._settle_min_samples = min(3, max(int(signal_window), 1))
        self._signals = SignalAggregator(window=signal_window)
        self._jobs: Dict[str, _JobScalingState] = {}
        self._last_observed: Dict[str, float] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, config, *,
                    rescale_executor: Optional[RescaleExecutor] = None,
                    clock: Callable[[], float] = time.monotonic,
                    ) -> "AutoscalerCoordinator":
        from flink_tpu_torch.config import AutoscalerOptions as A

        window = max(int(config.get(A.SIGNAL_WINDOW)), 1)
        policy = build_policy(
            config.get(A.POLICY),
            scale_up_threshold=config.get(A.SCALE_UP_THRESHOLD),
            scale_down_threshold=config.get(A.SCALE_DOWN_THRESHOLD),
            # the warm-up bar must fit inside the configured window, or a
            # signal-window below 3 would leave the policy "warming up
            # (2/3 samples)" forever — a silently inert autoscaler
            min_samples=min(3, window),
            min_gain=config.get(A.LEARNING_MIN_GAIN),
            patience=config.get(A.LEARNING_PATIENCE),
        )
        return cls(
            policy,
            min_parallelism=config.get(A.MIN_PARALLELISM),
            max_parallelism=config.get(A.MAX_PARALLELISM),
            stabilization_interval_ms=config.get(A.STABILIZATION_INTERVAL_MS),
            interval_ms=config.get(A.INTERVAL_MS),
            signal_window=window,
            decision_log_size=config.get(A.DECISION_HISTORY_SIZE),
            rescale_executor=rescale_executor,
            clock=clock,
        )

    # -- observation --------------------------------------------------------
    def maybe_observe(self, job_id: str, parallelism: int,
                      metrics_fn: Callable[[], Dict[str, object]],
                      max_slots: Optional[int] = None,
                      ) -> Optional[ScalingDecision]:
        """Throttled observe for callers on a hot loop (MiniCluster run
        loop): snapshots are only built when a sampling tick is due."""
        now = self._clock()
        with self._lock:
            last = self._last_observed.get(job_id)
            if last is not None and now - last < self.interval_s:
                return None
            self._last_observed[job_id] = now
        return self.observe(job_id, parallelism, metrics_fn(),
                            max_slots=max_slots)

    def observe(self, job_id: str, parallelism: int,
                metrics: Dict[str, object],
                max_slots: Optional[int] = None,
                ) -> Optional[ScalingDecision]:
        """Feed one metric snapshot; returns the decision when the policy
        proposed an action this tick (executed or not), else None."""
        now = self._clock()
        estimate = self._signals.observe(job_id, metrics, now)
        with self._lock:
            state = self._jobs.get(job_id)
            if state is None:
                state = self._jobs[job_id] = _JobScalingState(
                    self.decision_log_size)
            if state.first_seen is None:
                state.first_seen = now
            if (state.last_parallelism is not None
                    and state.last_parallelism != parallelism):
                # attempt changed shape under us (rescale or failover):
                # old-window samples describe the previous deployment
                self._signals.reset(job_id)
                estimate = self._signals.estimate(job_id)
            state.last_parallelism = parallelism
            pending = state.pending_outcome
            if pending is not None and pending["to"] != parallelism:
                # the job is not running at this rescale's target: a
                # failover landed somewhere else mid-stabilization, or a
                # failed redeploy restarted the OLD shape (no parallelism
                # change, so the shape guard above never fires). Either
                # way, measuring THIS deployment's throughput as the
                # rescale's outcome would poison the learning history
                state.pending_outcome = None
            self._settle_outcome(job_id, state, estimate, now)
            if state.pending_outcome is not None:
                # the last executed rescale hasn't settled its
                # post-stabilization throughput yet: a new decision now
                # would overwrite the pending measurement, so back-to-back
                # rescales would never feed the learning history
                return None
            since = now - (state.last_action_at
                           if state.last_action_at is not None
                           else state.first_seen)
            if since < self.stabilization_s:
                return None
        # policy evaluation outside the lock: pure function over the
        # estimate, and the executor below may re-enter JM state
        effective_max = self._effective_max(parallelism, max_slots)
        decision = self.policy.decide(
            estimate, parallelism, self.min_parallelism, effective_max)
        if not decision.is_action:
            return None
        entry: Dict[str, Any] = {
            "timestamp_ms": time.time() * 1000.0,
            "parallelism": parallelism,
            "action": decision.action,
            "target": decision.target,
            "reason": decision.reason,
            "signals": estimate.as_dict(),
            "outcome": "observe-only",
            "duration_ms": None,
            "throughput_before": estimate.throughput_per_s,
            "throughput_after": None,
            "repeats": 1,
        }
        if self.rescale_executor is not None:
            with self._lock:
                # a duration parked before this call belongs to some
                # foreign rescale (e.g. a manual RPC with no decision
                # entry) — it must not be claimed as this decision's
                state.unclaimed_duration = None
            accepted, detail = self.rescale_executor(
                job_id, decision.target, decision.reason)
            if accepted:
                entry["outcome"] = "executed"
            else:
                entry["outcome"] = f"rejected: {detail}"
        with self._lock:
            newest = state.decisions[0] if state.decisions else None
            if (entry["outcome"] != "executed" and newest is not None
                    and newest["outcome"] == entry["outcome"]
                    and newest["action"] == entry["action"]
                    and newest["target"] == entry["target"]
                    and newest["parallelism"] == entry["parallelism"]):
                # a decision the executor keeps refusing (or observe-only
                # mode) refires every tick by design — coalesce identical
                # repeats in place so they cannot churn real rescale
                # history out of the bounded log
                newest.update(
                    timestamp_ms=entry["timestamp_ms"],
                    signals=entry["signals"], reason=entry["reason"],
                    throughput_before=entry["throughput_before"],
                    repeats=newest.get("repeats", 1) + 1,
                )
            else:
                state.decisions.appendleft(entry)
            if entry["outcome"] == "executed":
                state.last_action_at = self._clock()
                if state.unclaimed_duration is not None:
                    entry["duration_ms"] = state.unclaimed_duration
                    state.unclaimed_duration = None
                state.pending_outcome = {
                    "entry": entry,
                    "action": decision.action,
                    "from": parallelism,
                    "to": decision.target,
                    "before": estimate.throughput_per_s,
                }
                self._signals.reset(job_id)
        return decision

    def _effective_max(self, parallelism: int,
                       max_slots: Optional[int]) -> int:
        bounds = [b for b in (self.max_parallelism or None, max_slots)
                  if b is not None]
        return max(min(bounds), 1) if bounds else max(parallelism * 2, 1)

    def _settle_outcome(self, job_id: str, state: _JobScalingState,
                        estimate: SignalEstimate, now: float) -> None:
        """Post-stabilization throughput of an executed rescale closes the
        loop into the policy (LearningPolicy damping). Lock held.

        The window accumulated samples DURING stabilization — including
        the redeploy's restore dead time, when the counter sits flat. A
        window half-filled with that dead time reads half the steady
        rate, so the first tick past the stabilization interval only ARMS
        the measurement (clears the window); the outcome settles on
        samples taken wholly after it."""
        pending = state.pending_outcome
        if pending is None or state.last_action_at is None:
            return
        if now - state.last_action_at < self.stabilization_s:
            return
        if not pending.get("armed"):
            pending["armed"] = True
            self._signals.reset(job_id)
            return
        if estimate.samples < self._settle_min_samples:
            # a short window is one shipping stall wide — a stalled
            # snapshot pair would record ~0 throughput into the learning
            # history for a perfectly healthy rescale
            return
        state.pending_outcome = None
        after = estimate.throughput_per_s
        pending["entry"]["throughput_after"] = after
        self.policy.record_outcome(
            pending["action"], pending["from"], pending["to"],
            pending["before"], after)

    # -- executor feedback ---------------------------------------------------
    def rescale_completed(self, job_id: str, duration_ms: float,
                          target: Optional[int] = None) -> None:
        """Called by the executor when the redeploy finished: stamps the
        decision entry and restarts the stabilization window from
        completion (not decision) time. The rescale counters themselves
        live with the executor (the JM's per-job state), which also sees
        rescales this coordinator never initiated (manual RPC calls) —
        `target` (the completed parallelism) keeps such a completion from
        stamping a pending decision for a different parallelism."""
        with self._lock:
            state = self._jobs.get(job_id)
            if state is None:
                return
            state.last_action_at = self._clock()
            for entry in state.decisions:
                if (entry["outcome"] == "executed"
                        and entry["duration_ms"] is None
                        and (target is None or entry["target"] == target)):
                    entry["duration_ms"] = float(duration_ms)
                    break
            else:
                # redeploy finished inside the executor call, before the
                # decision entry landed — observe() claims it on append
                state.unclaimed_duration = float(duration_ms)

    # -- exposure ------------------------------------------------------------
    def payload(self, job_id: str, *, num_rescales: int = 0,
                last_rescale_duration_ms: float = 0.0) -> Dict[str, Any]:
        """REST /jobs/:id/autoscaler body: config, counters, decision log
        (newest first) with the signals each decision saw. The rescale
        counters are the caller's (the JM counts every rescale, including
        manual ones this coordinator never saw); the observe-only default
        of 0 is exact — nothing rescales without an executor."""
        with self._lock:
            state = self._jobs.get(job_id)
            return {
                "enabled": True,
                "policy": self.policy.name,
                "min_parallelism": self.min_parallelism,
                "max_parallelism": self.max_parallelism or None,
                "stabilization_interval_ms": int(self.stabilization_s * 1000),
                "num_rescales": int(num_rescales),
                "last_rescale_duration_ms": float(last_rescale_duration_ms),
                "decisions": ([dict(d) for d in state.decisions]
                              if state else []),
            }
