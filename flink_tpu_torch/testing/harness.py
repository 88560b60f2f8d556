"""Operator test harness: drive an operator without any cluster.

Counterpart of `flink_tpu/testing/harness.py`, copied: `fault_injection`,
the transport security helpers (`ephemeral_transport_security`,
`transport_security`), `KeyedWindowOperatorHarness` and
`keyed_window_stream`.

Mirrors the reference's workhorse testing pattern
(AbstractStreamOperatorTestHarness.java /
KeyedOneInputStreamOperatorTestHarness.java): push records and watermarks,
inspect emitted output and snapshots. Works for both the oracle operator and
the device-backed operator (duck-typed: process_record / process_watermark /
drain_output / snapshot / restore)."""

from __future__ import annotations

import contextlib
import secrets as _secrets
from typing import Any, Callable, List, Tuple


def ephemeral_transport_security(cluster_id: str = "flink-tpu-test"):
    """A fresh random-secret SecurityConfig for one test cluster, isolated
    from the per-user default secret (two clusters built from separate
    calls cannot authenticate to each other)."""
    from flink_tpu_torch.security.transport import SecurityConfig

    return SecurityConfig.with_secret(_secrets.token_hex(16), cluster_id)


@contextlib.contextmanager
def fault_injection(plan=None, *, rules=None, seed: int = 0):
    """Install a chaos FaultPlan for the duration of the block (the chaos
    scenarios' and tests' entry point). Pass a built
    :class:`flink_tpu_torch.chaos.FaultPlan`, or `rules` (a list of FaultRule
    field dicts) + `seed` to build one. Yields the plan so the body can
    assert `plan.total_fired` / `plan.report()` afterwards; always
    uninstalls, even when the body raises."""
    from flink_tpu_torch.chaos import FaultPlan, install_plan, uninstall_plan

    if plan is None:
        plan = FaultPlan.from_rules(list(rules or []), seed=seed)
    install_plan(plan)
    try:
        yield plan
    finally:
        uninstall_plan()


@contextlib.contextmanager
def transport_security(sec=None):
    """Context manager pinning the PROCESS-DEFAULT SecurityConfig — every
    RpcService/ExchangeServer/OutputChannel/RpcGateway constructed inside
    (without an explicit `security=`) uses `sec`. Tests run with auth on by
    default; this is how a test opts into a known secret or into
    SecurityConfig.disabled() for the legacy wire."""
    from flink_tpu_torch.security.transport import _set_process_default

    sec = ephemeral_transport_security() if sec is None else sec
    prev = _set_process_default(sec)
    try:
        yield sec
    finally:
        _set_process_default(prev)


class KeyedWindowOperatorHarness:
    def __init__(self, operator, key_selector: Callable[[Any], Any] = None,
                 value_selector: Callable[[Any], Any] = None):
        self.op = operator
        self.key_selector = key_selector or (lambda v: v[0])
        self.value_selector = value_selector or (lambda v: v[1])
        self.watermark = None

    def process_element(self, value, timestamp: int) -> None:
        self.op.process_record(self.key_selector(value), self.value_selector(value), timestamp)

    def process_elements(self, *records: Tuple[Any, int]) -> None:
        for value, ts in records:
            self.process_element(value, ts)

    def process_watermark(self, watermark: int) -> None:
        self.watermark = watermark
        self.op.process_watermark(watermark)

    def set_processing_time(self, time: int) -> None:
        self.op.advance_processing_time(time)

    def extract_output(self) -> List[Tuple[Any, Any, Any, int]]:
        """Returns (key, window, result, timestamp) tuples emitted so far."""
        return self.op.drain_output()

    def extract_results(self) -> List[Tuple[Any, Any]]:
        """(key, result) pairs, window/ts dropped."""
        return [(k, r) for k, _w, r, _t in self.extract_output()]

    def side_output(self, tag_id: str) -> List:
        return list(self.op.side_output.get(tag_id, []))

    def snapshot(self) -> dict:
        return self.op.snapshot()

    def restore(self, snap: dict) -> None:
        self.op.restore(snap)


def keyed_window_stream(seed: int, steps: int, batch: int, num_keys: int,
                        with_vals: bool = False, ms_per_batch: float = 400.0,
                        jitter_ms: int = 120, wm_lag_ms: int = 150):
    """Deterministic keyed test stream shared by the sharded-superscan tests
    and the multi-device dryrun: sorted random timestamps per batch with backward
    jitter strictly below the watermark lag, so late-drop behavior is
    deterministic across operators. Returns (batches, watermarks) where
    batches[t] = (keys, vals|None, ts)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    batches, wms = [], []
    t_cursor = 0.0
    for _ in range(steps):
        keys = rng.integers(0, num_keys, size=batch).astype(np.int32)
        base = t_cursor + np.sort(rng.random(batch)) * ms_per_batch
        ts = np.maximum(
            base.astype(np.int64) - rng.integers(0, jitter_ms, batch), 0)
        vals = (rng.integers(0, 9, size=batch).astype(np.float32)
                if with_vals else None)
        batches.append((keys, vals, ts))
        wms.append(int(base[-1]) - wm_lag_ms)
        t_cursor += ms_per_batch
    return batches, wms
