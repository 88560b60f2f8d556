"""Tiny-size versions of the cells for CPU runs of the harness."""

import copy

from streambench.core.spec import load_cell

#: per cell: event rate and traffic at a size a CPU run holds
TINY = {
    "ysb.max": (20_000, {"batch_size": 1 << 12, "pool_records": 1 << 15,
                         "warmup_batches": 8}),
}


def tiny_cell(workload: str, rate=None):
    """(cell, traffic) of `workload` cut to a CPU's size: its
    configuration with a lower event rate (`rate`, or the cell's tiny
    one), its traffic with small batches and pool."""
    cell = load_cell(workload)
    cell.config = copy.deepcopy(cell.config)
    tiny_rate, traffic = TINY[workload]
    cell.config["event_rate_per_s"] = tiny_rate if rate is None else rate
    return cell, dict(cell.traffic, **traffic)
