"""Metric types, hierarchical groups, registry, reporters.

Counterpart of `flink_tpu/metrics/registry.py`, copied (it is jax-free):
a port job's snapshot and Prometheus text are the JAX package's, byte for
byte, for the same metrics.

Capability parity with the reference metrics stack (flink-metrics-core
MetricGroup.java:37, runtime/metrics/MetricRegistryImpl.java:74, reporter
modules under flink-metrics/*): Counter/Gauge/Meter/Histogram registered in
scoped groups (job → task → operator), reported by pluggable reporters —
Prometheus text exposition, logging, and an in-memory reporter for tests.
The built-in runtime gauges (records in/out, busy/ingest time, watermark
lag; TaskIOMetricGroup.java:48 analogue) are registered by the executor.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional


# Shard-fold vocabulary (consumed by runtime.cluster.aggregate_shard_metrics
# and declared at registration, never inferred from the metric name):
#   "sum"            add across shards (totals, counts, rates-of-totals)
#   "min"            min across shards (progress frontiers: currentWatermark)
#   "max"            max across shards (high-water marks, versions, worst-case)
#   "mean"           arithmetic mean (ratios, utilization percentages)
#   "emission"       emission-latency snapshot dict -> exact bucket-wise merge
#   "per-device-max" {device: value} dict -> max over devices, max over shards
#   "hist"           histogram stats dict -> approximate envelope fold
#                    (count sums, min mins, max/mean/quantiles max — marked
#                    "approx": true in the folded payload)
FOLD_KINDS = ("sum", "min", "max", "mean", "emission", "per-device-max",
              "hist")

# Sampling-kind vocabulary (consumed by metrics.history.MetricHistory):
#   "counter"    monotone total — history records the windowed RATE per sec
#   "gauge"      point-in-time value — recorded as-is
#   "meter"      already a rate — recorded as-is
#   "histogram"  stats dict — history derives p50/p99 sub-series
METRIC_KINDS = ("counter", "gauge", "meter", "histogram")


class Counter:
    fold = "sum"
    kind = "counter"

    def __init__(self):
        self._value = 0

    def inc(self, n: int = 1) -> None:
        self._value += n

    @property
    def count(self) -> int:
        return self._value

    def value(self):
        return self._value


class Gauge:
    """`fold` declares how shards combine (see FOLD_KINDS); `kind` declares
    how the history plane samples it — a gauge wrapping a monotone total
    (evictions, numRecordsIn) registers kind="counter" so history records
    its windowed rate instead of an ever-growing line. None means
    undeclared: the shard fold falls back to the DEPRECATED name heuristic
    in runtime.cluster (which warns), and the registry audit test fails
    unless the family is allowlisted."""

    def __init__(self, fn: Callable[[], Any], fold: Optional[str] = None,
                 kind: Optional[str] = None):
        if fold is not None and fold not in FOLD_KINDS:
            raise ValueError(f"unknown fold kind {fold!r} (one of "
                             f"{FOLD_KINDS})")
        if kind is not None and kind not in METRIC_KINDS:
            raise ValueError(f"unknown metric kind {kind!r} (one of "
                             f"{METRIC_KINDS})")
        self._fn = fn
        self.fold = fold
        self.kind = kind or "gauge"

    def value(self):
        return self._fn()

    def freeze(self) -> None:
        """Hold the gauge at its current value and drop its closure (and
        whatever the closure keeps alive: an ended task's operator and its
        device rings). A gauge unreadable now stays unreadable, which
        `metrics_snapshot` skips."""
        try:
            value = self._fn()
        except Exception:  # noqa: BLE001 - read as absent, as a snapshot does
            def value_gone():
                raise LookupError("the gauge's source ended unreadable")

            self._fn = value_gone
            return
        self._fn = lambda: value


class Meter:
    """Rate over a sliding 60s window + lifetime count (MeterView analogue).

    Marks COALESCE into 100 ms buckets, so memory stays O(window) no matter
    the event rate (the reference MeterView keeps fixed per-second buckets
    for the same reason) — a dataplane channel marking per frame must not
    grow a tuple per frame. Lock-protected: senders mark() from their own
    threads while the heartbeat/snapshot thread reads rate()."""

    fold = "sum"
    kind = "meter"

    BUCKET_S = 0.1

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._events = deque()  # [bucket_start_t, n] buckets, oldest first
        self._count = 0
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        now = self._clock()
        with self._lock:
            self._count += n
            if self._events and now - self._events[-1][0] < self.BUCKET_S:
                self._events[-1][1] += n
            else:
                self._events.append([now, n])
            self._trim(now)

    def _trim(self, now: float) -> None:
        while self._events and now - self._events[0][0] > 60.0:
            self._events.popleft()

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def rate(self) -> float:
        now = self._clock()
        with self._lock:
            self._trim(now)
            if not self._events:
                return 0.0
            span = max(now - self._events[0][0], 1e-9)
            return sum(n for _, n in self._events) / span

    def value(self):
        return self.rate()


class Histogram:
    """Reservoir histogram with quantiles (DescriptiveStatisticsHistogram
    analogue; bounded ring reservoir)."""

    fold = "hist"
    kind = "histogram"

    def __init__(self, size: int = 1024):
        self._values = deque(maxlen=size)
        self._count = 0

    def update(self, value: float) -> None:
        self._values.append(float(value))
        self._count += 1

    @property
    def count(self) -> int:
        return self._count

    def quantile(self, q: float) -> float:
        if not self._values:
            return float("nan")
        vals = sorted(self._values)
        idx = min(int(q * len(vals)), len(vals) - 1)
        return vals[idx]

    def stats(self) -> Dict[str, float]:
        if not self._values:
            return {"count": 0}
        vals = sorted(self._values)
        return {
            "count": self._count,
            "min": vals[0],
            "max": vals[-1],
            "mean": sum(vals) / len(vals),
            "p50": vals[len(vals) // 2],
            "p95": vals[min(int(0.95 * len(vals)), len(vals) - 1)],
            "p99": vals[min(int(0.99 * len(vals)), len(vals) - 1)],
        }

    def value(self):
        return self.stats()


class MetricGroup:
    """Hierarchical scope (job.task.operator...) registering named metrics."""

    def __init__(self, registry: "MetricRegistry", scope: tuple):
        self._registry = registry
        self.scope = scope

    def add_group(self, name: str) -> "MetricGroup":
        return MetricGroup(self._registry, self.scope + (name,))

    def counter(self, name: str) -> Counter:
        return self._registry._register(self.scope, name, Counter())

    def gauge(self, name: str, fn: Callable[[], Any],
              fold: Optional[str] = None,
              kind: Optional[str] = None) -> Gauge:
        return self._registry._register(self.scope, name,
                                        Gauge(fn, fold=fold, kind=kind))

    def meter(self, name: str) -> Meter:
        return self._registry._register(self.scope, name, Meter())

    def histogram(self, name: str, size: int = 1024) -> Histogram:
        return self._registry._register(self.scope, name, Histogram(size))

    def metric_identifier(self, name: str) -> str:
        return ".".join(self.scope + (name,))


class MetricRegistry:
    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._reporters: List["Reporter"] = []

    def group(self, *scope: str) -> MetricGroup:
        return MetricGroup(self, tuple(scope))

    def _register(self, scope: tuple, name: str, metric):
        key = ".".join(scope + (name,))
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if type(existing) is not type(metric):
                    # collision: keep the FIRST registration (the reference
                    # registry logs and refuses the replacement —
                    # MetricRegistryImpl "Name collision" warning) and hand
                    # the caller its new metric UNREGISTERED: it is the
                    # right type for the caller's code (updates just go
                    # nowhere), whereas returning the existing wrong-typed
                    # metric would defer the failure to a crash at the
                    # first update call
                    import logging

                    logging.getLogger("flink_tpu_torch.metrics").warning(
                        "metric %r already registered as %s; the conflicting "
                        "%s registration is ignored (detached instance "
                        "returned)",
                        key, type(existing).__name__, type(metric).__name__,
                    )
                    return metric
                return existing
            self._metrics[key] = metric
        return metric

    def all_metrics(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._metrics)

    def unregister(self, keys) -> None:
        """Drop metrics by key (an extension of the port: a restarted
        job's attempt drops the gauges of the attempt it replaces, whose
        closures would otherwise keep that attempt's operators, and their
        device state, alive)."""
        with self._lock:
            for key in keys:
                self._metrics.pop(key, None)

    def add_reporter(self, reporter: "Reporter") -> None:
        self._reporters.append(reporter)

    def report(self) -> None:
        snapshot = self.all_metrics()
        for r in self._reporters:
            r.report(snapshot)


class Reporter:
    def report(self, metrics: Dict[str, Any]) -> None:
        raise NotImplementedError


class InMemoryReporter(Reporter):
    def __init__(self):
        self.last: Dict[str, Any] = {}

    def report(self, metrics: Dict[str, Any]) -> None:
        self.last = {k: m.value() for k, m in metrics.items()}


class LoggingReporter(Reporter):
    def __init__(self, logger=None):
        import logging

        self._log = logger or logging.getLogger("flink_tpu_torch.metrics")

    def report(self, metrics: Dict[str, Any]) -> None:
        for k, m in sorted(metrics.items()):
            self._log.info("%s = %s", k, m.value())


def _prom_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name grammar
    [a-zA-Z_:][a-zA-Z0-9_:]* — non-conforming characters become '_' and a
    leading digit gets an '_' prefix (a dotted scope like '0ff.x' must not
    produce an invalid exposition)."""
    s = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    if not s or s[0].isdigit():
        s = "_" + s
    return s


def _prom_label_value(value: Any) -> str:
    """Escape a label value per the text exposition format (backslash,
    double-quote, and newline must be escaped inside the quotes)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_labels(labels: Optional[Dict[str, Any]]) -> str:
    """'{k="v",...}' or '' — base labelset attached to every sample."""
    if not labels:
        return ""
    pairs = ",".join(
        f'{_prom_name(str(k))}="{_prom_label_value(v)}"'
        for k, v in sorted(labels.items()))
    return "{" + pairs + "}"


def _with_extra_label(lbl: str, extra: str) -> str:
    """Join a rendered base labelset with one more pair."""
    return lbl[:-1] + "," + extra + "}" if lbl else "{" + extra + "}"


def _render_summary(name: str, stats: Dict[str, Any], lbl: str) -> List[str]:
    """`# TYPE ... summary` + quantile series + _count for one histogram
    family — the ONE rendering both the live-metric and snapshot
    expositions use, so shard samples of a family can never drift to
    different quantile sets."""
    lines = [f"# TYPE {name} summary"]
    for q, stat in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"),
                    ("0.999", "p999")):
        v = stats.get(stat)
        if isinstance(v, (int, float)) and not (
                isinstance(v, float) and math.isnan(v)):
            extra = f'quantile="{q}"'
            lines.append(f"{name}{_with_extra_label(lbl, extra)} {v}")
    lines.append(f'{name}_count{lbl} {stats.get("count", 0)}')
    return lines


def prometheus_text(metrics: Dict[str, Any],
                    labels: Optional[Dict[str, Any]] = None) -> str:
    """Prometheus text exposition format (flink-metrics-prometheus
    PrometheusReporter analogue — here as an encoding; the REST server
    exposes it at /metrics). Emits `# TYPE` metadata per family: Counter ->
    counter, Gauge/Meter -> gauge, Histogram -> summary (quantile series +
    _count, the reference reporter's HistogramSummaryProxy shape).
    `labels` (e.g. {'job': id}) attach to every sample — required whenever
    several registries share family names in one exposition, or the merged
    document would carry duplicate samples."""

    lbl = _render_labels(labels)
    lines = []
    for key, metric in sorted(metrics.items()):
        name = _prom_name(key)
        val = metric.value()
        if isinstance(metric, Histogram):
            lines.extend(_render_summary(name, val, lbl))
        elif isinstance(val, dict) and "count" in val:
            # histogram-stats-shaped dict behind a NON-Histogram metric —
            # e.g. the emission-latency plane's log-bucket snapshot gauge.
            # Render it as the same summary family instead of silently
            # dropping it: every registered histogram exports uniformly,
            # whatever metric class carries it.
            lines.extend(_render_summary(name, val, lbl))
        elif isinstance(val, (int, float)) and not isinstance(val, bool):
            kind = "counter" if isinstance(metric, Counter) else "gauge"
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name}{lbl} {val}")
    return "\n".join(lines) + "\n"


def prometheus_text_from_snapshot(snapshot: Dict[str, Any],
                                  labels: Optional[Dict[str, Any]] = None) -> str:
    """Exposition for a PLAIN-DATA metric snapshot (metrics_snapshot form —
    what TaskExecutors ship to the JobManager over RPC): numeric values
    become untyped gauges, histogram-stat dicts become quantile series.
    `labels` (e.g. {'shard': 3}) are attached to every sample."""
    lbl = _render_labels(labels)
    lines = []
    for key, val in sorted(snapshot.items()):
        if key.startswith("__"):      # reserved metadata (__folds__ etc.)
            continue
        name = _prom_name(key)
        if isinstance(val, dict):
            lines.extend(_render_summary(name, val, lbl))
        elif isinstance(val, (int, float)) and not isinstance(val, bool):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{lbl} {val}")
    return "\n".join(lines) + "\n"


def merge_prometheus_text(texts: "List[str]") -> str:
    """Merge several expositions into one valid document: the text format
    allows at most ONE `# TYPE` line per metric family with all of the
    family's samples grouped under it, so naive concatenation of per-job /
    per-shard expositions (repeated TYPE lines, interleaved families) is
    rejected by strict parsers. Keeps the first declared type per family
    and groups samples; a summary's `_count`/`_sum` series stay with their
    parent family."""
    types: Dict[str, str] = {}
    samples: Dict[str, List[str]] = {}
    order: List[str] = []
    summaries = set()

    def family_of(sample_line: str) -> str:
        name = sample_line.split("{", 1)[0].split(" ", 1)[0]
        for suffix in ("_count", "_sum"):
            if name.endswith(suffix) and name[: -len(suffix)] in summaries:
                return name[: -len(suffix)]
        return name

    for text in texts:
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("# TYPE "):
                _, _, name, kind = line.split(" ", 3)
                if name not in types:
                    types[name] = kind
                    order.append(name)
                    if kind == "summary":
                        summaries.add(name)
                continue
            if line.startswith("#"):
                continue
            fam = family_of(line)
            if fam not in samples and fam not in types:
                order.append(fam)
            samples.setdefault(fam, []).append(line)
    out = []
    for fam in order:
        kind = types.get(fam)
        if kind:
            out.append(f"# TYPE {fam} {kind}")
        out.extend(samples.get(fam, ()))
    return "\n".join(out) + "\n"


def metrics_snapshot(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Plain-data view of a metric table — int/float scalars and histogram
    stat dicts only — safe to JSON-encode or ship over the restricted RPC
    wire (TM -> JM metric shipping).

    Two reserved metadata keys ride along under dunder names (so every
    existing consumer's numeric/suffix filters skip them naturally):
    ``__folds__`` maps metric key -> declared shard-fold kind (only keys
    that DECLARED one — aggregate_shard_metrics reads these instead of the
    deprecated name heuristic) and ``__kinds__`` maps metric key ->
    sampling kind (counter/gauge/meter/histogram — the history plane reads
    these to record counters as windowed rates)."""
    out: Dict[str, Any] = {}
    folds: Dict[str, str] = {}
    kinds: Dict[str, str] = {}
    for key, metric in metrics.items():
        try:
            val = metric.value()
        except Exception:  # a gauge closure over torn-down state must not
            continue       # poison the whole snapshot
        if hasattr(val, "item"):   # numpy scalar
            val = val.item()
        if isinstance(val, bool):
            continue
        if isinstance(val, dict):
            out[key] = {
                str(k): (v.item() if hasattr(v, "item") else v)
                for k, v in val.items()
                if isinstance(v, (int, float)) or hasattr(v, "item")
            }
        elif isinstance(val, (int, float)):
            out[key] = val
        else:
            continue
        fold = getattr(metric, "fold", None)
        if fold is not None:
            folds[key] = fold
        kind = getattr(metric, "kind", None)
        if kind is not None:
            kinds[key] = kind
    if folds:
        out["__folds__"] = folds
    if kinds:
        out["__kinds__"] = kinds
    return out


class PrometheusReporter(Reporter):
    """Holds the latest exposition text; served by the REST endpoint."""

    def __init__(self):
        self.text = ""

    def report(self, metrics: Dict[str, Any]) -> None:
        self.text = prometheus_text(metrics)
