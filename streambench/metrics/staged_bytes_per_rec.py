"""Bytes the fused route stages for the card per record: the port's counts
`flink.fused.staged_bytes` (each dispatch's record staging buffers, pad
rows included) plus `flink.fused.plan_bytes` (its plan arrays) over the
window, per record handed over in the window (program counter)."""

from streambench.core.sections import window_totals


def read(rec):
    tot = window_totals(rec)
    if tot is None or "flink.fused.staged_bytes" not in tot or not rec["window_records"]:
        return None
    staged = tot["flink.fused.staged_bytes"][0] + tot.get("flink.fused.plan_bytes", (0, 0))[0]
    return staged / rec["window_records"]
