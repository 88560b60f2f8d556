"""OTel-shape trace export (OTLP/JSON).

Counterpart of `flink_tpu/metrics/otel.py`, copied.

The reference ships spans to OpenTelemetry through
flink-metrics/flink-metrics-otel (OpenTelemetryTraceReporter.java); here the
same reporter SPI (`TraceReporter`) encodes spans into OTLP/JSON —
`resourceSpans -> scopeSpans -> spans` with nanosecond timestamps and typed
attribute values — so any OTLP/HTTP collector or file-based pipeline can
ingest them. No network dependency: the reporter buffers and can flush to a
file; the REST server serves the same payload at /jobs/<id>/traces.
"""

from __future__ import annotations

import json
import secrets
import threading
from typing import Any, Dict, List, Optional

from flink_tpu_torch.metrics.traces import Span, TraceReporter


def _attr_value(v: Any) -> Dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}   # OTLP/JSON encodes int64 as string
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def span_to_otlp(span: Span, trace_id: Optional[str] = None) -> Dict[str, Any]:
    """One Span -> OTLP/JSON span object (hex ids, unix-nano timestamps).
    Precedence for the trace id: explicit argument > the span's own
    correlation id (traces.job_trace_id propagation) > a fresh random id."""
    return {
        "traceId": trace_id or getattr(span, "trace_id", None) or secrets.token_hex(16),
        "spanId": secrets.token_hex(8),
        "name": f"{span.scope}.{span.name}",
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(int(span.start_ts_ms * 1e6)),
        "endTimeUnixNano": str(int(span.end_ts_ms * 1e6)),
        "attributes": [
            {"key": str(k), "value": _attr_value(v)}
            for k, v in span.attributes.items()
        ],
        "status": {},
    }


def spans_to_otlp(spans: List[Dict[str, Any]], service_name: str) -> Dict[str, Any]:
    """Wrap encoded spans in the OTLP resourceSpans envelope."""
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": [
                        {"key": "service.name",
                         "value": {"stringValue": service_name}},
                    ]
                },
                "scopeSpans": [
                    {
                        "scope": {"name": "flink_tpu_torch", "version": "1"},
                        "spans": spans,
                    }
                ],
            }
        ]
    }


class OtlpJsonTraceReporter(TraceReporter):
    """Buffers spans in OTLP/JSON form; optionally appends one OTLP export
    envelope per span batch to a file (`path`). `payload()` returns the full
    resourceSpans document for the REST endpoint / an OTLP-HTTP pusher."""

    def __init__(self, service_name: str = "flink-tpu",
                 path: Optional[str] = None, max_spans: int = 4096):
        self.service_name = service_name
        self.path = path
        self.max_spans = max_spans
        self._spans: List[Dict[str, Any]] = []
        self._fh = None
        self._lock = threading.Lock()

    def report_span(self, span: Span) -> None:
        enc = span_to_otlp(span)
        with self._lock:
            self._spans.append(enc)
            if len(self._spans) > self.max_spans:
                self._spans = self._spans[-self.max_spans:]
            if self.path:
                # buffer append + file write under ONE lock acquisition so
                # the flushed file order always matches payload(); the
                # handle is kept open across spans
                if self._fh is None:
                    self._fh = open(self.path, "a")
                self._fh.write(
                    json.dumps(spans_to_otlp([enc], self.service_name)) + "\n")
                self._fh.flush()

    def payload(self) -> Dict[str, Any]:
        with self._lock:
            return spans_to_otlp(list(self._spans), self.service_name)

    def clear(self) -> None:
        with self._lock:
            self._spans = []
