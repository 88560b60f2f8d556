"""Exactly-once contract annotations.

Counterpart of the runtime decorators of `flink_tpu/lint/contracts.py`:
an operator declares its in-flight structures and the methods that drain
them on the class itself, so an analysis of the source can require every
checkpoint capture to reach a drain. The decorators only attach metadata;
they stay dependency-free.

``@inflight_ring("_inflight", drained_by="_resolve_inflight")``
    Class decorator: instances own in-flight state in ``attr``, which the
    named method empties.

``@drains("_inflight", ...)``
    Method decorator: the method drains the named attributes too.

``@absorbs_faults("reason")``
    Function decorator: the function's broad exception handlers absorb
    faults on purpose, for the reason given (refused when empty).
"""

from __future__ import annotations

#: metadata attribute names
RING_ATTR = "__lint_inflight_rings__"
DRAINS_ATTR = "__lint_drains__"
ABSORBS_ATTR = "__lint_absorbs_faults__"


def inflight_ring(attr: str, *, drained_by: str):
    """Declare that the decorated class owns in-flight state in ``attr``
    which ``drained_by`` (a method name) empties."""
    if not attr or not drained_by:
        raise ValueError("inflight_ring requires attr and drained_by")

    def deco(cls):
        rings = list(getattr(cls, RING_ATTR, ()))
        rings.append((attr, drained_by))
        setattr(cls, RING_ATTR, tuple(rings))
        return cls

    return deco


def drains(*attrs: str):
    """Mark the decorated method as a drain for the named attributes."""
    if not attrs:
        raise ValueError("drains requires at least one attribute name")

    def deco(fn):
        setattr(fn, DRAINS_ATTR, tuple(getattr(fn, DRAINS_ATTR, ()) + tuple(attrs)))
        return fn

    return deco


def absorbs_faults(reason: str):
    """Allowlist the decorated function's handlers for EXON003, with an
    attributed reason (refused when empty)."""
    if not reason or not reason.strip():
        raise ValueError("absorbs_faults requires a non-empty reason")

    def deco(fn):
        setattr(fn, ABSORBS_ATTR, reason)
        return fn

    return deco
