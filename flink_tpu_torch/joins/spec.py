"""Plan-time surface of the device join subsystem.

A copy of `flink_tpu/joins/spec.py` (jax-free there; the port keeps its
own), read by the port's join runners and the SQL front door.

Two things live here, deliberately together so they can never drift:

  * the join fallback catalog — every reason a join shape refuses the
    device path (or refuses to execute at all), each a STRUCTURED code
    with prose, mirroring the SQL planner's FALLBACK_CATALOG discipline:
    a refusal is attributed, never a bare ValueError mid-construction;

  * the join geometry planner — the bucketed-ring decomposition one
    window/interval equi-join compiles onto: bucket granule = the
    window's slice granule (gcd of size and slide), a ring deep enough to
    hold every in-flight bucket, and a per-(key, bucket, side) record
    capacity from `execution.join.bucket-capacity`.

"On the Semantic Overlap of Operators" (arXiv 2303.00793) is the design
driver: window join, interval join, and windowed lookup-enrich collapse
onto one time-bucketed ring + segment cross-match core, so ONE geometry
plan (and one kernel pair, ops/join_ring.py) serves every variant — the
window join is the interval-mask-free special case.

Layering (ARCH001): joins may import core/ops/state/config (and the
parallel mesh library) — never runtime, api, table, or scheduler.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

#: why a join stays off the device path (or refuses outright). Codes are
#: stable: the joinFallbackReason gauge exports their index (0 = none)
#: and docs/joins.md renders this table.
JOIN_FALLBACK_CATALOG: Dict[str, str] = {
    "join-full-outer": "FULL OUTER joins need both sides' NULL paddings "
                       "retracted against each other's arrivals; neither "
                       "the host StreamingJoinRunner nor the device ring "
                       "implements that yet — the statement is refused "
                       "with this reason, never built",
    "join-unwindowed": "regular (unwindowed) joins keep unbounded "
                       "two-sided state with retraction output; they "
                       "execute on the host StreamingJoinRunner",
    "join-outer-windowed": "windowed LEFT/RIGHT OUTER joins need "
                           "per-window unmatched-row padding; the device "
                           "ring emits inner matches only",
    "join-cogroup": "coGroup applies a per-(key, window) list function "
                    "on the host; there is no device form for arbitrary "
                    "list UDFs",
    "join-session-window": "session windows are not sliceable; the "
                           "bucketed ring requires a fixed bucket "
                           "granule (gcd of size and slide)",
    "join-processing-time": "the device join is event-time only; "
                            "processing-time windows fire on the host",
    "join-ring-overflow": "a (key, bucket, side) exceeded "
                          "execution.join.bucket-capacity mid-stream; "
                          "the operator degraded to the host join with "
                          "state carried over (exactly-once preserved)",
    "join-key-capacity": "the stream's distinct keys exceeded "
                         "execution.state.key-capacity; the operator "
                         "degraded to the host join with state carried "
                         "over",
    "join-device-disabled": "execution.join.device-enabled is false; "
                            "window joins execute on the host operator",
}

#: stable small-int code per reason for the joinFallbackReason gauge
#: (0 = no fallback); insertion order IS the code assignment, so append
#: new reasons at the end of the catalog, never reorder
JOIN_FALLBACK_CODES: Dict[str, int] = {
    reason: i + 1 for i, reason in enumerate(JOIN_FALLBACK_CATALOG)
}


def fallback_code(reason: Optional[str]) -> int:
    return JOIN_FALLBACK_CODES.get(reason, 0) if reason else 0


class JoinUnsupported(Exception):
    """A join shape outside the device core — typed and attributed.

    Carries the catalogued reason code; callers route it the same way the
    planner routes `Unsupported`: the SQL front door attributes the
    fallback (or refuses the statement with the catalogued prose for
    shapes no path supports, e.g. full outer), and the runtime's device
    reroute falls back to the host operator."""

    def __init__(self, reason: str, detail: str = ""):
        assert reason in JOIN_FALLBACK_CATALOG, \
            f"uncatalogued join reason {reason!r}"
        self.reason = reason
        self.detail = detail or JOIN_FALLBACK_CATALOG[reason]
        super().__init__(f"{reason}: {self.detail}")


@dataclasses.dataclass(frozen=True)
class JoinGeometry:
    """The bucketed-ring decomposition of one windowed equi-join."""

    size_ms: int                 # window size
    slide_ms: int                # window slide (== size for tumbling)
    offset_ms: int               # window offset on the epoch grid
    bucket_ms: int               # ring granule = gcd(size, slide)
    buckets_per_window: int      # size / bucket
    slide_buckets: int           # slide / bucket
    ring_buckets: int            # NB: ring depth in bucket slots
    bucket_capacity: int         # C: record slots per (key, bucket, side)
    key_capacity: int            # K: dense key ids per shard set
    interval_lo_ms: Optional[int] = None   # interval join bound, else None
    interval_hi_ms: Optional[int] = None

    @property
    def is_interval(self) -> bool:
        return self.interval_lo_ms is not None

    def window_start(self, ts: int) -> int:
        """Start of the LAST window containing `ts` (the tumbling window
        for slide == size)."""
        return ((ts - self.offset_ms) // self.slide_ms) * self.slide_ms \
            + self.offset_ms

    def bucket_of(self, ts: int) -> int:
        return (ts - self.offset_ms) // self.bucket_ms


def plan_join_geometry(
    size_ms: int,
    slide_ms: int,
    offset_ms: int,
    *,
    key_capacity: int,
    bucket_capacity: int,
    ring_slack_buckets: int = 64,
    interval_lo_ms: Optional[int] = None,
    interval_hi_ms: Optional[int] = None,
) -> JoinGeometry:
    """Validate and plan the ring geometry for a windowed equi-join.

    The ring must hold every bucket between the purge horizon (oldest
    bucket a not-yet-fired window still covers) and the newest in-flight
    bucket; `ring_slack_buckets` bounds how far event time may run ahead
    of the watermark before the ring wraps onto a live bucket — which
    degrades to the host with `join-ring-overflow`, never corrupts."""
    if size_ms <= 0 or slide_ms <= 0:
        raise ValueError(
            f"join window needs size > 0 and slide > 0, got "
            f"size={size_ms} slide={slide_ms}")
    if key_capacity <= 0 or bucket_capacity <= 0:
        raise ValueError(
            f"join ring needs key_capacity > 0 and bucket_capacity > 0, "
            f"got K={key_capacity} C={bucket_capacity}")
    bucket_ms = math.gcd(int(size_ms), int(slide_ms))
    bpw = size_ms // bucket_ms
    nb = bpw + max(int(ring_slack_buckets), 1)
    return JoinGeometry(
        size_ms=int(size_ms),
        slide_ms=int(slide_ms),
        offset_ms=int(offset_ms),
        bucket_ms=bucket_ms,
        buckets_per_window=bpw,
        slide_buckets=slide_ms // bucket_ms,
        ring_buckets=nb,
        bucket_capacity=int(bucket_capacity),
        key_capacity=int(key_capacity),
        interval_lo_ms=interval_lo_ms,
        interval_hi_ms=interval_hi_ms,
    )
