"""Per-channel exchange I/O metrics registration.

The reference's TaskIOMetricGroup registers numBytesIn/numBytesOut counters
plus *PerSecond meters per task and per channel
(TaskIOMetricGroup.java:48, ResultPartitionMetrics). The dataplane
channels (runtime/dataplane.py) maintain the raw byte counters and rate
meters themselves — this helper binds them into a MetricGroup under the
conventional names, one call per channel end, used by both cluster
execution paths (staged graph tasks and the keyed shard loop).

Counterpart of `flink_tpu/metrics/exchange.py`, copied.
"""

from __future__ import annotations

from typing import Any, Optional

from flink_tpu_torch.metrics.registry import MetricGroup


def register_channel_metrics(
    group: MetricGroup,
    name: str,
    *,
    inbound: Optional[Any] = None,
    outbound: Optional[Any] = None,
) -> None:
    """Register numBytesIn/numBytesOut (+ *PerSecond) gauges for one
    exchange channel end. `inbound` is an InputChannel (bytes received off
    the wire, incl. frame overhead), `outbound` an OutputChannel (bytes
    written, incl. control frames on the channel's socket)."""
    if inbound is not None:
        group.gauge(f"numBytesIn.{name}", lambda ch=inbound: ch.bytes_in,
                    fold="sum", kind="counter")
        group.gauge(f"numBytesInPerSecond.{name}", inbound.in_rate,
                    fold="sum")
    if outbound is not None:
        group.gauge(f"numBytesOut.{name}", lambda ch=outbound: ch.bytes_out,
                    fold="sum", kind="counter")
        group.gauge(f"numBytesOutPerSecond.{name}", outbound.out_rate,
                    fold="sum")
