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
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional


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
