"""The port's hot-path section totals (`flink_tpu_torch.metrics.traces`)
over a run's window, for the metric readers: what they gained from the
window's first batch to the job closing its sink (the drain included), on
the perf_counter clock the window is timed by. A port without the totals
gives nothing; a log that no longer reaches back to the window's start
gives nothing and says so on standard error."""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple


def window_totals(rec: dict) -> Optional[Dict[str, Tuple[int, int]]]:
    """{name: (ns or sum, exits or adds)} over the window, or None."""
    from flink_tpu_torch.metrics import traces

    between = getattr(traces, "totals_between", None)
    if between is None:
        return None
    try:
        return between(round(rec["t_open"] * 1e9), round(rec["t_end"] * 1e9))
    except LookupError as e:
        print(f"sections: the window's totals are lost: {e}", file=sys.stderr, flush=True)
        return None


def section_ns_per_rec(rec: dict, name: str) -> Optional[float]:
    """The section's ns over the window, per record handed over in it; None
    when the window holds no exit from it."""
    tot = window_totals(rec)
    if tot is None or name not in tot or not rec["window_records"]:
        return None
    return tot[name][0] / rec["window_records"]


def count_ratio(rec: dict, num: str, den: str) -> Optional[float]:
    """Count `num` over count `den`, both over the window; None without `den`."""
    tot = window_totals(rec)
    if tot is None or not tot.get(den, (0, 0))[0]:
        return None
    return tot.get(num, (0, 0))[0] / tot[den][0]
