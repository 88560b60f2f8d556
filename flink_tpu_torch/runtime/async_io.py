"""Async I/O operator: concurrent external lookups with ordered/unordered
result emission, timeouts, and retry strategies.

Capability parity with AsyncWaitOperator
(flink-streaming-java .../api/operators/async/AsyncWaitOperator.java) and
AsyncDataStream.ordered/unorderedWait: user async functions run with bounded
concurrency (`capacity` — the operator's in-flight buffer), results re-enter
the stream either in input order (ordered) or completion order (unordered);
per-element timeout and fixed-delay/exponential retries.

Here the "async" substrate is a thread pool (the stepped runtime is
synchronous between device steps): a batch fans out to the pool, and the
step completes when the batch's futures resolve — the same batch-level
amortization the AsyncExecutionController applies to state requests (D12).

Counterpart of `flink_tpu/runtime/async_io.py`, copied.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.utils.arrays import obj_array


@dataclasses.dataclass(frozen=True)
class RetryStrategy:
    """Fixed-delay retry with optional exponential backoff
    (AsyncRetryStrategies analogue)."""

    max_attempts: int = 1
    delay_ms: float = 0.0
    multiplier: float = 1.0

    def delay_for(self, attempt: int) -> float:
        return self.delay_ms * (self.multiplier ** (attempt - 1)) / 1000.0


NO_RETRY = RetryStrategy()


class AsyncFunction:
    """User contract: async_invoke returns the result (runs on a pool
    thread); raise to signal failure (retried per strategy)."""

    def async_invoke(self, value) -> Any:
        raise NotImplementedError

    def timeout_value(self, value) -> Any:
        """Fallback on timeout; default: raise (fails the job)."""
        raise TimeoutError(f"async I/O timed out for {value!r}")


class _LambdaAsync(AsyncFunction):
    def __init__(self, fn):
        self._fn = fn

    def async_invoke(self, value):
        return self._fn(value)


def as_async_function(fn) -> AsyncFunction:
    return fn if isinstance(fn, AsyncFunction) else _LambdaAsync(fn)


class AsyncExecutor:
    """Batch-level async fan-out engine shared by the runner and direct use."""

    def __init__(
        self,
        fn,
        *,
        capacity: int = 100,
        timeout_ms: Optional[float] = None,
        ordered: bool = True,
        retry: RetryStrategy = NO_RETRY,
    ):
        self.fn = as_async_function(fn)
        self.capacity = capacity
        self.timeout_s = timeout_ms / 1000.0 if timeout_ms else None
        self.ordered = ordered
        self.retry = retry
        self._pool = ThreadPoolExecutor(max_workers=capacity)

    def close(self) -> None:
        self._pool.shutdown(wait=False)

    def _invoke_with_retries(self, value):
        attempt = 1
        while True:
            try:
                return self.fn.async_invoke(value)
            except Exception:
                if attempt >= max(self.retry.max_attempts, 1):
                    raise
                time.sleep(self.retry.delay_for(attempt))
                attempt += 1

    def process(self, values: Iterable) -> List[Tuple[int, Any]]:
        """Returns (input_index, result) pairs — in input order when ordered,
        completion order otherwise."""
        values = list(values)
        results: List[Tuple[int, Any]] = []
        pending: dict[Future, int] = {}
        it = iter(enumerate(values))
        exhausted = False
        deadline_of: dict[Future, float] = {}

        def submit_next() -> bool:
            nonlocal exhausted
            try:
                i, v = next(it)
            except StopIteration:
                exhausted = True
                return False
            f = self._pool.submit(self._invoke_with_retries, v)
            pending[f] = i
            if self.timeout_s is not None:
                deadline_of[f] = time.monotonic() + self.timeout_s
            return True

        while not exhausted and len(pending) < self.capacity:
            if not submit_next():
                break
        while pending:
            wait_timeout = None
            if deadline_of:
                wait_timeout = max(min(deadline_of.values()) - time.monotonic(), 0)
            done, _ = wait(pending, timeout=wait_timeout, return_when=FIRST_COMPLETED)
            now = time.monotonic()
            if not done:  # a deadline expired with nothing completing
                expired = [f for f, d in deadline_of.items() if d <= now]
                for f in expired:
                    i = pending.pop(f)
                    deadline_of.pop(f, None)
                    f.cancel()
                    results.append((i, self.fn.timeout_value(values[i])))
                    if not exhausted:
                        submit_next()
                continue
            for f in done:
                i = pending.pop(f)
                deadline_of.pop(f, None)
                results.append((i, f.result()))
                if not exhausted:
                    submit_next()
        if self.ordered:
            results.sort(key=lambda p: p[0])
        return results


class AsyncMapRunner:
    """Step runner for DataStream.async_map (built by the executor).

    Duck-typed to executor.StepRunner (imported lazily there to avoid a
    module cycle); the input-gate shims below keep it wireable in the
    runner DAG."""

    downstream = None
    num_inputs = 1
    records_in_counter = None   # numRecordsIn, once register_metrics ran
    _marker_hist = None         # latencyMs, once register_metrics ran

    def on_batch_n(self, ordinal, values, timestamps):
        self.on_batch(values, timestamps)

    def on_watermark_n(self, ordinal, watermark):
        self.on_watermark(watermark)

    def on_end_n(self, ordinal):
        self.on_end()

    def on_marker(self, wall_ms):
        # record-then-forward, like every other runner (StepRunner.on_marker):
        # without the histogram here, a slow async stage would show up as
        # latency at the operator AFTER it
        h = getattr(self, "_marker_hist", None)
        if h is not None:
            import time as _time

            h.update(_time.time() * 1000.0 - wall_ms)
        if self.downstream:
            self.downstream.on_marker(wall_ms)

    def on_processing_time(self, now_ms):
        pass

    def __init__(self, transform, _config):
        cfg = transform.config
        self.executor = AsyncExecutor(
            cfg["fn"],
            capacity=cfg.get("capacity", 100),
            timeout_ms=cfg.get("timeout_ms"),
            ordered=cfg.get("ordered", True),
            retry=cfg.get("retry", NO_RETRY),
        )
        self.uid = transform.uid

    def register_metrics(self, group) -> None:
        self.records_in_counter = group.counter("numRecordsIn")
        self._marker_hist = group.histogram("latencyMs")

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        out = self.executor.process(values)
        if out and self.downstream:
            vals = obj_array([r for _, r in out])
            ts = np.asarray([int(timestamps[i]) for i, _ in out], dtype=np.int64)
            self.downstream.on_batch(vals, ts)

    def on_watermark(self, watermark: int) -> None:
        if self.downstream:
            self.downstream.on_watermark(watermark)

    def on_end(self) -> None:
        self.executor.close()
        if self.downstream:
            self.downstream.on_end()

    def snapshot(self) -> dict:
        return {}

    def restore(self, snap: dict) -> None:
        pass
