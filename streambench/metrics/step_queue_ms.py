"""How long a record waits in the fused operator for its dispatch: the
port's `flink.fused.queue_wait_ns` (each step's records times the time
from the operator queueing the step to the dispatch that takes it) over
`flink.fused.queued_records`, over the window, in ms (program counter)."""

from streambench.core.sections import count_ratio


def read(rec):
    r = count_ratio(rec, "flink.fused.queue_wait_ns", "flink.fused.queued_records")
    return None if r is None else r / 1e6
