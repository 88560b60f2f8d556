"""Device-plane observability: compile/recompile tracking and per-program
cost/roofline attribution.

Counterpart of `flink_tpu/metrics/device_stats.py`, copied with its own
imports. What differs is what a compile and a cost are on the port:

- **A compile** is the first dispatch in this process of a dispatch
  program's geometry: the one that pays the kernels' nvcc build or library
  load (`ops/cuda_superscan.py`) and the caching allocator's first blocks.
  The port has no jit; its program callables
  (`runtime/fused_window_pipeline.py::DispatchProgram`) consult a
  process-wide table of (program, cache key), keyed as the JAX package
  keys its compiled executables, and expose a ``_cache_size()`` that grows
  on a key's first dispatch. So the tracker's detection below is the JAX
  one, unchanged: the call that grew ``_cache_size`` is the call that
  compiled, with the per-signature fallback for callables without it.
- **Cost and memory analysis** are the program callable's own counts
  (``fn.cost_analysis(*args)``: bytes read and written once and scalar
  operations, from `ops/cuda_superscan.py::k1_cost`/`k2_cost`;
  ``fn.memory_analysis(*args)``: the wrapper's own scratch, fire-row and
  ring bytes), where the JAX tracker asks XLA (``fn.lower(*args)``). They
  are the port's numbers, not XLA's.

The rest is the JAX module's: per-program compile count and wall time, the
triggering shape signature, a bounded recompile-event ring with cause
attribution (ring doubling / batch-geometry churn / dtype change), the
``recompileStorm`` gauge on an injected clock, the roofline gauges over
the DeviceTimer's host-clock time, and the ``device.XlaCompile`` span
(named as in the JAX package, for parity).

Layering: metrics sits below the runtime — this module never imports it
(nor torch: the program callables are handed in). All tracker state is
lock-protected: dispatch happens on task threads while other threads read
gauges and payloads.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

#: roofline denominators by platform when the
#: observability.device.hbm-gbps / .peak-tflops options are left at 0
#: (auto): the JAX package's table. Deliberately conservative
#: datasheet-order numbers — utilization gauges are for RELATIVE
#: attribution across operators and PRs; set the options to the card's
#: figures for absolute numbers.
PLATFORM_PEAKS: Dict[str, "tuple[float, float]"] = {
    # platform: (HBM GB/s, peak TFLOP/s)
    "tpu": (1200.0, 275.0),
    "gpu": (2000.0, 300.0),
    "cpu": (50.0, 0.2),
}


def platform_peaks(hbm_gbps: float = 0.0, peak_tflops: float = 0.0,
                   device_type: str = "cpu") -> "tuple[float, float]":
    """Resolve the roofline denominators: configured values win, 0 falls
    back to the PLATFORM_PEAKS entry of the operator's device: `cuda` (a
    torch device's type) reads the gpu row, anything else the cpu row."""
    if hbm_gbps > 0 and peak_tflops > 0:
        return hbm_gbps, peak_tflops
    platform = "gpu" if device_type == "cuda" else "cpu"
    dflt = PLATFORM_PEAKS[platform]
    return (hbm_gbps if hbm_gbps > 0 else dflt[0],
            peak_tflops if peak_tflops > 0 else dflt[1])


def _signature_str(signature: Dict[str, Any]) -> str:
    return ",".join(f"{k}={signature[k]}" for k in sorted(signature))


def attribute_cause(prev: Optional[Dict[str, Any]],
                    new: Dict[str, Any]) -> str:
    """Why did this signature recompile, given the program's previous one?

    Precedence mirrors how disruptive each churn source is: a dtype change
    is a program-semantics change (usually a bug), key-capacity growth is
    the ring-doubling cost model working as designed (amortized, but worth
    seeing), and T/B churn is batch-geometry instability (ragged tails,
    unstable source batching) — the classic silent-recompile thrash."""
    if prev is None:
        return "initial"
    changed = {k for k in set(prev) | set(new) if prev.get(k) != new.get(k)}
    if not changed:
        # same signature compiled again: the executable cache was evicted
        # or a sibling program shares the name — still worth flagging
        return "cache-eviction"
    if any("dtype" in k.lower() for k in changed):
        return "dtype-change"
    if "K" in changed:
        return "ring-doubling"
    if changed & {"T", "B"}:
        return "batch-geometry"
    return "other:" + "+".join(sorted(changed))


class _ProgramStats:
    __slots__ = ("compiles", "compile_ms", "dispatches", "last_signature",
                 "seen_signatures", "bytes_total", "flops_total",
                 "cost_by_signature")

    def __init__(self):
        self.compiles = 0
        self.compile_ms = 0.0
        self.dispatches = 0
        self.last_signature: Optional[Dict[str, Any]] = None
        self.seen_signatures: set = set()
        self.bytes_total = 0.0
        self.flops_total = 0.0
        # sig_str -> {"flops", "bytes_accessed", "temp_bytes"?, ...}
        self.cost_by_signature: Dict[str, Dict[str, float]] = {}


class CompileTracker:
    """Compile/recompile + cost accounting for one job's device programs.

    One tracker per operator (runner) keeps attribution local; job-level
    exposure merges the per-runner payloads (merge_compile_payloads)."""

    def __init__(self, *, history_size: int = 32, storm_threshold: int = 4,
                 storm_window_ms: int = 60_000, cost_analysis: bool = True,
                 memory_analysis: bool = False,
                 on_event: Optional[Callable[[Dict[str, Any]], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time):
        self.history_size = max(int(history_size), 1)
        self.storm_threshold = max(int(storm_threshold), 1)
        self.storm_window_ms = max(int(storm_window_ms), 1)
        self.cost_analysis = cost_analysis
        self.memory_analysis = memory_analysis
        self.on_event = on_event
        self._clock = clock
        self._wall = wall_clock
        self._lock = threading.Lock()
        self._programs: Dict[str, _ProgramStats] = {}
        self._events: deque = deque(maxlen=self.history_size)
        self._recompile_times: deque = deque(maxlen=256)  # monotonic stamps
        self.num_compiles = 0
        self.num_recompiles = 0
        self.compile_ms_total = 0.0

    # -- dispatch wrapper --------------------------------------------------
    def call(self, program: str, fn, args: tuple,
             signature: Dict[str, Any]):
        """Invoke ``fn(*args)``, recording a compile event if this call
        compiled. Non-compiling dispatches cost one cache-size probe and a
        dict increment — O(1) host work on the hot path."""
        probe = getattr(fn, "_cache_size", None)
        pre = None
        if probe is not None:
            try:
                pre = probe()
            except Exception:  # noqa: BLE001 — observability never fails
                probe = None   # the dispatch
        t0 = self._clock()
        out = fn(*args)
        elapsed_ms = (self._clock() - t0) * 1000.0
        sig_str = _signature_str(signature)
        compiled = False
        if probe is not None and pre is not None:
            try:
                compiled = probe() > pre
            except Exception:  # noqa: BLE001
                compiled = False
        needs_cost = False
        with self._lock:
            stats = self._programs.get(program)
            if stats is None:
                stats = self._programs[program] = _ProgramStats()
            new_signature = sig_str not in stats.seen_signatures
            if probe is None or pre is None:
                # no program-table introspection: first sighting of a
                # signature is the compile (an upper bound — the process
                # may already have dispatched it, but the signature is new to
                # THIS program's stream of dispatches)
                compiled = new_signature
            stats.seen_signatures.add(sig_str)
            stats.dispatches += 1
            if compiled:
                cause = attribute_cause(stats.last_signature, signature)
                recompile = stats.compiles > 0
                stats.compiles += 1
                stats.compile_ms += elapsed_ms
                self.num_compiles += 1
                self.compile_ms_total += elapsed_ms
                if recompile:
                    self.num_recompiles += 1
                    self._recompile_times.append(self._clock())
                event = {
                    "program": program,
                    "signature": sig_str,
                    "cause": cause,
                    "recompile": recompile,
                    "compile_count": stats.compiles,
                    # wall time of the compiling call: the kernels' build or
                    # load, the allocator's first blocks and the first
                    # launch (a dispatch returns before the card finishes)
                    "duration_ms": round(elapsed_ms, 3),
                    "wall_ts_ms": self._wall() * 1000.0,
                }
                self._events.append(event)
            else:
                event = None
                cost = stats.cost_by_signature.get(sig_str)
                if cost is not None:
                    stats.bytes_total += cost.get("bytes_accessed", 0.0)
                    stats.flops_total += cost.get("flops", 0.0)
                elif new_signature:
                    # the process-wide program table already held this shape
                    # (a sibling pipeline or a previous job dispatched it):
                    # no compile EVENT for this job, but the roofline
                    # still needs the per-dispatch cost — a warm-cache
                    # job must not read 0% utilization forever
                    needs_cost = True
            stats.last_signature = dict(signature)
        if event is not None or needs_cost:
            # analysis OUTSIDE the lock, as in the JAX package (there it
            # re-traces; here it is arithmetic on shapes)
            cost = self._analyze(fn, args)
            if cost is not None:
                with self._lock:
                    stats.cost_by_signature[sig_str] = cost
                    stats.bytes_total += cost.get("bytes_accessed", 0.0)
                    stats.flops_total += cost.get("flops", 0.0)
                    if event is not None:
                        event["cost"] = dict(cost)
        if event is not None and self.on_event is not None:
            try:
                self.on_event(event)
            except Exception:  # noqa: BLE001 — a broken span sink
                pass           # must not fail the dispatch
        return out

    def _analyze(self, fn, args) -> Optional[Dict[str, float]]:
        """Best-effort cost/memory analysis of the program that just
        compiled: the callable's own ``cost_analysis(*args)`` ({"flops",
        "bytes_accessed"}) and, gated separately, ``memory_analysis(*args)``
        ({"temp_bytes", "output_bytes", "argument_bytes"}). Both are
        arithmetic on the dispatch's shapes: no device work, no sync."""
        if not self.cost_analysis:
            return None
        cost = getattr(fn, "cost_analysis", None)
        if cost is None:
            return None
        out: Dict[str, float] = {}
        try:
            ca = cost(*args)
            for key in ("flops", "bytes_accessed"):
                if isinstance(ca.get(key), (int, float)):
                    out[key] = float(ca[key])
        except Exception:  # noqa: BLE001 — observability never fails a dispatch
            return None
        memory = getattr(fn, "memory_analysis", None)
        if self.memory_analysis and memory is not None:
            try:
                for key, v in memory(*args).items():
                    if isinstance(v, (int, float)):
                        out[key] = float(v)
            except Exception:  # noqa: BLE001
                pass
        return out or None

    # -- gauges ------------------------------------------------------------
    def recompile_storm(self) -> int:
        """1 when >= storm_threshold recompiles landed within the sliding
        storm window (a job paying compile latency on the hot path)."""
        with self._lock:
            return self.recompile_storm_unlocked()

    def bytes_accessed_total(self) -> float:
        with self._lock:
            return sum(s.bytes_total for s in self._programs.values())

    def flops_total(self) -> float:
        with self._lock:
            return sum(s.flops_total for s in self._programs.values())

    def dispatches_total(self) -> int:
        with self._lock:
            return sum(s.dispatches for s in self._programs.values())

    def register(self, group) -> None:
        """Register the compile-observability gauges on a metric group."""
        group.gauge("numCompiles", lambda: self.num_compiles,
                    fold="sum", kind="counter")
        group.gauge("numRecompiles", lambda: self.num_recompiles,
                    fold="sum", kind="counter")
        group.gauge("compileTimeMsTotal",
                    lambda: round(self.compile_ms_total, 3),
                    fold="sum", kind="counter")
        group.gauge("recompileStorm", self.recompile_storm, fold="max")

    # -- exposure ----------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def payload(self) -> Dict[str, Any]:
        """Plain-data compile block (REST /jobs/:id/device shape)."""
        with self._lock:
            return {
                "numCompiles": self.num_compiles,
                "numRecompiles": self.num_recompiles,
                "compileTimeMsTotal": round(self.compile_ms_total, 3),
                "recompileStorm": self.recompile_storm_unlocked(),
                "programs": {
                    name: {
                        "compiles": s.compiles,
                        "dispatches": s.dispatches,
                        "compileTimeMsTotal": round(s.compile_ms, 3),
                        "lastSignature": (_signature_str(s.last_signature)
                                          if s.last_signature else None),
                    }
                    for name, s in self._programs.items()
                },
                "events": [dict(e) for e in self._events],
            }

    def recompile_storm_unlocked(self) -> int:
        horizon = self._clock() - self.storm_window_ms / 1000.0
        recent = sum(1 for t in self._recompile_times if t >= horizon)
        return 1 if recent >= self.storm_threshold else 0


def roofline_pct(bytes_accessed: float, flops: float, device_time_s: float,
                 hbm_gbps: float, peak_tflops: float) -> Dict[str, float]:
    """Utilization of the memory/compute rooflines over a measured device
    wall-time window: achieved GB/s (or FLOP/s) as a percentage of the
    part's peak. The denominator is the DeviceTimer's host-clock wall time
    around the dispatch/readback sections (on the port a dispatch returns
    before the card finishes, so that time is mostly host work), so the
    figure UNDER-reports on a host-bound path — right for cross-operator
    and cross-PR comparison, not as the card's own utilization."""
    if device_time_s <= 0:
        return {"hbmUtilizationPct": 0.0, "flopsUtilizationPct": 0.0}
    hbm = bytes_accessed / (device_time_s * max(hbm_gbps, 1e-9) * 1e9)
    fl = flops / (device_time_s * max(peak_tflops, 1e-9) * 1e12)
    return {
        "hbmUtilizationPct": round(min(hbm, 10.0) * 100.0, 3),
        "flopsUtilizationPct": round(min(fl, 10.0) * 100.0, 3),
    }


def compile_event_span(event: Dict[str, Any]):
    """One compile event as a trace span (scope 'device', name
    'XlaCompile') for the TraceRegistry / TM->JM span shipping. Attribute
    values are OTLP-scalar-safe (str/int/float/bool)."""
    from flink_tpu_torch.metrics.traces import Span

    end = float(event.get("wall_ts_ms", 0.0))
    dur = float(event.get("duration_ms", 0.0))
    attrs: Dict[str, Any] = {
        "program": event.get("program"),
        "signature": event.get("signature"),
        "cause": event.get("cause"),
        "recompile": bool(event.get("recompile", False)),
        "compileCount": int(event.get("compile_count", 1)),
    }
    cost = event.get("cost") or {}
    if "flops" in cost:
        attrs["costFlops"] = float(cost["flops"])
    if "bytes_accessed" in cost:
        attrs["costBytesAccessed"] = float(cost["bytes_accessed"])
    return Span("device", "XlaCompile", end - dur, end, attrs)


def merge_compile_payloads(payloads: List[Dict[str, Any]],
                           history_size: int = 64) -> Dict[str, Any]:
    """Fold per-operator compile payloads into one job-level block: counts
    sum, storm ORs, program tables merge (names are per-program already),
    events interleave by wall timestamp, newest kept within the bound."""
    out: Dict[str, Any] = {
        "numCompiles": 0, "numRecompiles": 0, "compileTimeMsTotal": 0.0,
        "recompileStorm": 0, "programs": {}, "events": [],
    }
    events: List[Dict[str, Any]] = []
    for p in payloads:
        out["numCompiles"] += int(p.get("numCompiles", 0))
        out["numRecompiles"] += int(p.get("numRecompiles", 0))
        out["compileTimeMsTotal"] = round(
            out["compileTimeMsTotal"]
            + float(p.get("compileTimeMsTotal", 0.0)), 3)
        out["recompileStorm"] = max(out["recompileStorm"],
                                    int(p.get("recompileStorm", 0)))
        for name, s in (p.get("programs") or {}).items():
            cur = out["programs"].setdefault(
                name, {"compiles": 0, "dispatches": 0,
                       "compileTimeMsTotal": 0.0, "lastSignature": None})
            cur["compiles"] += int(s.get("compiles", 0))
            cur["dispatches"] += int(s.get("dispatches", 0))
            cur["compileTimeMsTotal"] = round(
                cur["compileTimeMsTotal"]
                + float(s.get("compileTimeMsTotal", 0.0)), 3)
            cur["lastSignature"] = s.get("lastSignature") or cur["lastSignature"]
        events.extend(p.get("events") or ())
    events.sort(key=lambda e: e.get("wall_ts_ms", 0.0))
    out["events"] = events[-history_size:]
    return out


def empty_device_payload() -> Dict[str, Any]:
    """REST /jobs/:id/device body for a job with no device plane (gates
    off, no device operators, or no attempt yet)."""
    return {
        "enabled": False,
        "compile": merge_compile_payloads([]),
        "operators": {},
        "profiler": {"enabled": False, "captures": 0,
                     "last_capture_dir": None},
    }
