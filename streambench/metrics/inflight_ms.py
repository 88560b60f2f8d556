"""How long a record's dispatch stays in flight: the port's
`flink.fused.inflight_ns` (each dispatch's records times the time from
its launch returning to the end of its resolve, its rows emitted) over
`flink.fused.inflight_records`, over the window, in ms (program counter)."""

from streambench.core.sections import count_ratio


def read(rec):
    r = count_ratio(rec, "flink.fused.inflight_ns", "flink.fused.inflight_records")
    return None if r is None else r / 1e6
