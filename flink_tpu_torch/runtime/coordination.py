"""OperatorCoordinator SPI (D15).

The reference pairs job-scope coordinators with operators
(runtime/operators/coordination/OperatorCoordinator.java): the operator
sends OperatorEvents up, the coordinator reacts (and can send events back
down), and the coordinator's state rides checkpoints alongside the
operator's. Split enumerators are the flagship implementation there; here
enumerators already live with the source driver, and this module provides
the GENERIC event bus for user operators: a ProcessFunction (or any
operator function) that defines ``create_coordinator()`` gets one
coordinator instance per job, a gateway to reach it, and callbacks for
events the coordinator pushes back.

Counterpart of `flink_tpu/runtime/coordination.py`, copied.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class OperatorCoordinator:
    """One coordinator instance per (job, operator uid)."""

    def start(self, context: "CoordinatorContext") -> None:
        """Called once before the job runs; keep the context for replies."""

    def handle_event(self, event: Any) -> None:
        """An OperatorEvent arrived from the operator."""

    def checkpoint(self) -> dict:
        """State to ride the job checkpoint (restored via restore())."""
        return {}

    def restore(self, snap: dict) -> None:
        pass

    def close(self) -> None:
        pass


class CoordinatorContext:
    """Coordinator-side handle: push events back to the operator."""

    def __init__(self, deliver: Callable[[Any], None]):
        self._deliver = deliver

    def send_to_operator(self, event: Any) -> None:
        self._deliver(event)


class CoordinatorGateway:
    """Operator-side handle: push events up to the coordinator.

    In this single-control-plane runtime delivery is a direct call on the
    job thread (the reference routes the same contract through RPC)."""

    def __init__(self, coordinator: OperatorCoordinator):
        self._coordinator = coordinator

    def send_event(self, event: Any) -> None:
        self._coordinator.handle_event(event)


def wire(fn: Any) -> Optional[OperatorCoordinator]:
    """If the operator function declares create_coordinator(), instantiate
    and wire the bidirectional event bus:

    - fn.coordinator_gateway.send_event(ev)  -> coordinator.handle_event
    - context.send_to_operator(ev) -> fn.handle_coordinator_event (if any)

    The coordinator is paired with the FUNCTION INSTANCE (idempotent): a
    second JobRuntime built over the same graph reuses the same
    coordinator rather than silently re-pointing the gateway — shared
    function objects mean shared coordinator state, exactly like shared
    operator state."""
    factory = getattr(fn, "create_coordinator", None)
    if factory is None:
        return None
    existing = getattr(fn, "_operator_coordinator", None)
    if existing is not None:
        return existing
    coordinator = factory()

    def deliver(event: Any) -> None:
        handler = getattr(fn, "handle_coordinator_event", None)
        if handler is not None:
            handler(event)

    coordinator.start(CoordinatorContext(deliver))
    fn.coordinator_gateway = CoordinatorGateway(coordinator)
    fn._operator_coordinator = coordinator
    return coordinator
