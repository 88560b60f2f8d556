"""Where the port's unported surfaces are queued.

Every option or method of a ported module that the port does not carry
yet raises the error made here, naming its item in ROADMAP.md's Queue A,
instead of falling back to something else quietly."""

from __future__ import annotations

# the items the errors name (ROADMAP.md, Queue A)
MESH = ("item 13b (the rest of the multi-GPU mesh: the skew rebalancer, the "
        "autoscaler, the device-loss degrade)")
CHAOS = "item 14 (remaining planes: chaos, the cluster and its security)"
CLUSTER = "item 14 (remaining planes: the cluster's TaskManager heartbeat and REST)"
ML = "item 14 (remaining touch points: ML_PREDICT, table/ml.py)"
API = "item 19 (the rest of the DataStream API)"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error an unported option or method raises."""
    return NotImplementedError(f"{what}: not ported yet: ROADMAP.md Queue A, {item}")
