"""The traced part's idle device time split by the port's own spans.

The port's hot-path sections (`flink_tpu_torch.metrics.traces.section`)
are `record_function` ranges named `flink.*` while a capture runs, on the
capture's clock beside every CUDA event, so each idle gap of the card can
be put down to the span open on the job's thread at that instant, with no
shift between clocks. The job's thread is the one that ran the
benchmark's own `streambench.trace.open` span. The spans are flat, so at
most one is open at a time; idle time under none goes to `(none)`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from streambench.core.trace import TRACE_CLOSE, TRACE_OPEN, _is_device, _merge

PREFIX = "flink."
NONE = "(none)"


def idle_gaps(busy: np.ndarray, w0: float, w1: float) -> np.ndarray:
    """[w0, w1] less the merged busy intervals `busy` [n, 2]: [m, 2]."""
    busy = _merge(np.asarray(busy, np.float64).reshape(-1, 2))
    busy = np.clip(busy, w0, w1)
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]])
    gaps = edges.reshape(-1, 2)
    return gaps[gaps[:, 1] > gaps[:, 0]]


def split_idle(busy: np.ndarray, w0: float, w1: float,
               spans: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle seconds of [w0, w1] (the complement of `busy`) under each span
    of `spans` ((start, end, name), flat: none overlaps another), summed
    by name; the rest under `(none)`."""
    gaps = idle_gaps(busy, w0, w1)
    before = np.concatenate([[0.0], np.cumsum(gaps[:, 1] - gaps[:, 0])])

    def idle_upto(x: np.ndarray) -> np.ndarray:
        # idle seconds in [w0, x]
        i = np.searchsorted(gaps[:, 0], x, side="right") - 1
        j = np.maximum(i, 0)
        inside = np.clip(x - gaps[j, 0], 0.0, gaps[j, 1] - gaps[j, 0])
        return np.where(i >= 0, before[j] + inside, 0.0)

    out: Dict[str, float] = {}
    if len(gaps) and spans:
        t0 = np.asarray([s[0] for s in spans], np.float64)
        t1 = np.asarray([s[1] for s in spans], np.float64)
        idle = idle_upto(np.clip(t1, w0, w1)) - idle_upto(np.clip(t0, w0, w1))
        for (_a, _b, name), v in zip(spans, idle):
            out[name] = out.get(name, 0.0) + float(v)
    out[NONE] = float(before[-1]) - sum(out.values())
    return out


def idle_by_span(prof) -> Dict[str, object]:
    """Reduce the stopped capture `prof`: the traced part's idle seconds by
    `flink.*` span on the job's thread (`idle_by_span`), their sum
    (`idle_s`), `idle_unspanned_pct` (the `(none)` share, in %), the spans'
    count by name (`span_events`), and `flink_device_events`: the `flink.*`
    events on the CUDA device, which a span that enclosed a kernel launch,
    copy or fill would leave (and the device trace would count as work).
    Empty when the benchmark's spans are missing."""
    dev: List[Tuple[float, float]] = []
    marks: Dict[str, Tuple[float, int]] = {}
    cpu: List[Tuple[float, float, str, int]] = []
    on_device = 0
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        t0 = ev.start_ns() / 1e9
        t1 = t0 + ev.duration_ns() / 1e9
        if _is_device(ev):
            dev.append((t0, t1))
            on_device += name.startswith(PREFIX)
        elif name.startswith(PREFIX):
            cpu.append((t0, t1, name, ev.start_thread_id()))
        elif name in (TRACE_OPEN, TRACE_CLOSE) and name not in marks:
            marks[name] = (t0 if name == TRACE_OPEN else t1, ev.start_thread_id())
    if TRACE_OPEN not in marks or TRACE_CLOSE not in marks:
        return {}
    (w0, job), (w1, _tid) = marks[TRACE_OPEN], marks[TRACE_CLOSE]
    spans = [(a, b, n) for a, b, n, tid in cpu if tid == job and b > w0 and a < w1]
    split = split_idle(np.asarray(dev, np.float64).reshape(-1, 2), w0, w1, spans)
    idle_s = sum(split.values())
    counts: Dict[str, int] = {}
    for _a, _b, n in spans:
        counts[n] = counts.get(n, 0) + 1
    return {"idle_by_span": dict(sorted(split.items(), key=lambda kv: -kv[1])),
            "idle_s": idle_s,
            "idle_unspanned_pct": 100.0 * split[NONE] / idle_s if idle_s > 0 else None,
            "span_events": counts, "flink_device_events": on_device}
