"""What the metric readers (`metrics/<name>.py`) share."""

from __future__ import annotations

from typing import Optional, Sequence

from streambench.core.spec import load_module
from streambench.core.trace import kernel_seconds


def roofline_pct(rec: dict, kernel: str, entries: Sequence[str]) -> Optional[float]:
    """The kernel's share of its memory roofline, in %, over the traced part
    of the window. Its bytes are the least the run's data needs
    (`roofline/<config>.py`), times the share of the run's dispatches
    (`entries` of the port's launch counters) that fell in the traced
    part; over the published HBM peak; over the device time of the
    kernels named `<kernel>_*` in the capture. None without a capture,
    without a dispatch in it, or when the capture lost kernels (fewer
    events than the port counted launched in it)."""
    trace, sub = rec["trace"], rec.get("trace_launches")
    if not trace or not sub:
        return None
    secs, events = kernel_seconds(trace, kernel + "_")
    n_sub = sum(sub.get(e, 0) for e in entries)
    n_run = sum(rec["launches_run"].get(e, 0) for e in entries)
    if secs <= 0 or n_sub <= 0 or n_run <= 0:
        return None
    cuda = rec.get("trace_cuda_launches") or {}
    if events < sum(cuda.get(e, sub.get(e, 0)) for e in entries):
        return None
    least = load_module("roofline", rec["config"]).least_bytes(kernel, rec["data"])
    if least is None:
        return None
    return 100.0 * least * n_sub / n_run / rec["peak"]["hbm_bytes_per_s"] / secs
