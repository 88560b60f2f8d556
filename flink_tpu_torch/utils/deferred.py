"""Where the port's unported surfaces are queued.

Every option or method of a ported module that the port does not carry
yet raises the error made here, naming its item in ROADMAP.md's Queue A,
instead of falling back to something else quietly."""

from __future__ import annotations

# the items the errors name (ROADMAP.md, Queue A)
D4 = "deferred item D4 (compile tracker and phase counters)"
D6 = "deferred item D6 (the tiered-state row surface)"
STATE_PLANE = "item 11 (state and device planes)"
JOINS = "item 12 (joins)"
MESH = "item 13 (multi-GPU)"
CHAOS = "item 14 (remaining touch points: minicluster, chaos)"
ML = "item 14 (remaining touch points: ML_PREDICT, table/ml.py)"
METRICS = "item 15 (job metrics and emission latency)"
CHECKPOINTS = "item 16 (job checkpoints and savepoints)"
PARALLELISM = "item 17 (parallelism > 1 and key groups)"
API = "item 19 (the rest of the DataStream API)"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error an unported option or method raises."""
    return NotImplementedError(f"{what}: not ported yet: ROADMAP.md Queue A, {item}")
