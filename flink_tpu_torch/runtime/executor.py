"""Local pipeline executor: the host-driven stepped dataflow loop.

Counterpart of `flink_tpu/runtime/executor.py` but for its cluster
stages. The sources' readers yield columnar batches in turn;
each batch flows through push-based StepRunners (a stateless chain, a
keyed window step or another stateful operator, then sinks), and the
sources' watermarks advance between steps.

Runner selection follows the JAX package. A window step whose chain is
traceable (graph/fusion.py) gets a `DeviceChainRunner`: the chain runs as
a torch prologue on the device inside each fused dispatch. Correlated
sibling windows over one keyed stream (graph/window_sharing.py) share one
`SharedWindowRunner` instead, its members' edges fed through
`SharedWindowSiblingRunner`s. Otherwise a
`ChainRunner` applies the chain on the host and a `WindowStepRunner`
keys the records through the host dictionary into its operator:
- GlobalWindows with a CountTrigger or PurgingTrigger(CountTrigger): the
  device global-window operator (`runtime/tpu_global_window_operator.py`);
- event-time session windows whose sources' out-of-orderness stays below
  the gap: the session operator (`runtime/tpu_session_operator.py`,
  kernels K3 and K4);
- grid windows: the fused operator (kernel K1), or, with allowed lateness,
  a late side output or `execution.window.fused` off, the per-batch
  operator (`runtime/tpu_window_operator.py`), whose late side output
  reaches the consumers of `get_side_output(LATE_DATA_TAG)`;
- every other window step (Python aggregates, window functions, other
  triggers, evictors, processing time, GlobalWindows without a count
  trigger, the session steps the device session operator refuses): the
  per-record oracle operator (`runtime/oracle_window_operator.py`), host
  code, as in the JAX package.
A two-input window join (`DataStream.join`) gets a `DeviceJoinRunner`
(`runtime/device_join_operator.py`: the bucket ring on the device) when
it is eligible, else, with its catalogued `JoinUnsupported` reason, the
host `WindowJoinRunner`, which also runs coGroup; a regular SQL join gets
a `StreamingJoinRunner` (`runtime/stream_join_operator.py`). Two-input
runners min-combine their gates' watermarks and end after both gates.
A fused window step takes the `execution.latency.*` options
(`_latency_kwargs`), and, on the host-keyed path, the `state.tier.*` and
`state.changelog.*` options (`_tier_for_config`): its key capacity is then
fixed at the hot capacity, and the per-batch operator takes the grow-only
hot/cold id split instead. A `group_agg` step
(`KeyedStream.continuous_aggregate`) gets a `GroupAggRunner`
(`runtime/group_agg_operator.py`).

Checkpoints: every stateful runner snapshots in the JAX runner's form
(`snapshot`/`restore`), `JobRuntime.capture` gathers them with the source
positions at a step boundary, and `JobRuntime.run` takes the checkpoint
coordinator, cancellation and savepoint hooks that runtime/minicluster.py
hands it. `LocalPipelineExecutor` runs one attempt with no recovery, as in
the JAX package.

The mesh (`parallel.mesh.*`, `_mesh_for_config`): a fused window step
and a device join run over a mesh of shards placed on
`parallel/mesh.py::visible_devices`, clamped as the JAX package clamps
it; under 2 usable devices the job stays on one device. At a step
boundary `run` takes the client's live mesh-rescale request and the skew
rebalancer's new key-group assignment (parallel.mesh.skew-rebalance, the
routing table of `ShardedFusedPipeline`): either raises
`MeshRescaleRequested` with a step-aligned capture (and, for a rebalance,
the assignment), and the MiniCluster rebuilds the runtime over the new
size or table and restores it, exactly-once. `set_mesh_routing` applies
an assignment to every routed operator; `mesh_group_loads` reads the
rebalancer's input back from the device.
`pipeline.parallelism` is read by no runner, as in the JAX package.

Observability (`observability.*`, the JAX package's defaults): every
runner registers its operator metrics on the job's registry
(`register_runner_metrics`: numRecordsIn, the latencyMs histogram of the
latency markers, and each family's gauges), device runners time their
dispatch and readback sections on the host clock (`DeviceTimer`, no
synchronize of its own), windowed runners stamp each fire's emission
latency where its rows become host-visible (`make_emission_tracker`), and
`JobRuntime` registers the job group and stamps a latency marker at each
source batch. Unlike the JAX runners, whose window, chain and sink
runners register numRecordsIn and never count it (ROADMAP.md Queue C),
every runner counts the records handed to it.

The device plane (`observability.device.*`, on by default as in JAX):
a device window runner attaches a CompileTracker to an operator that takes
one (the fused operator: compile counts and events, the roofline gauges,
K1's phase counters) and a throttled KeyStatsCollector over an operator's
per-key loads (keySkew, hot keys, the key-group histogram; per shard on
the mesh); `JobRuntime` registers the `job.device.*` group and
`job.keySkew`, reports each compile as a `device.XlaCompile` span, serves
the JAX package's `/jobs/:id/device` payload from `device_snapshot()`
(served over REST by runtime/rest.py) and, with `observability.profiler.*`,
captures a torch.profiler trace of each attempt.

The rest of the DataStream API's runners are the JAX package's, on the
host: `map_batch` in the chain, `KeyedReduceRunner`, `KeyedProcessRunner`
(event-time and processing-time timers; a processing-time timer's output
is stamped MIN_TIMESTAMP; side outputs by tag), `CepRunner`,
`UnionRunner` (the valve min-combines its inputs' watermarks; a window
after it still gets the fused runner), `CoMapRunner`,
`KeyedCoProcessRunner`, `BroadcastProcessRunner`, the async I/O runner
(runtime/async_io.py) and the iteration's `IterationHeadRunner` and
`IterationTailRunner`: the run loop drains the feedback to quiescence at
every step boundary and at the end, each head bounded by its max_rounds.
An operator function that declares create_coordinator() gets a job-scope
coordinator (runtime/coordination.py) whose state rides `capture` and
`restore`.

The chaos plane's device seam is the JAX package's: `WindowStepRunner` and
`DeviceChainRunner` call `HOOK("device", uid)` at the top of each batch,
before anything of it is staged or launched, so an injected error leaves
the device untouched and rides the normal restart path.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import types
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from flink_tpu_torch.api.functions import AggregateFunction, ProcessFunction
from flink_tpu_torch.api.windowing.assigners import EventTimeSessionWindows, GlobalWindows
from flink_tpu_torch.chaos import plan as _chaos
from flink_tpu_torch.config import (
    Configuration,
    ExecutionOptions,
    LatencyOptions,
    ObservabilityOptions,
    ParallelOptions,
    PipelineOptions,
    StateTierOptions,
)
from flink_tpu_torch.core.keygroups import KeyGroupRange
from flink_tpu_torch.core.time import MAX_WATERMARK, MIN_TIMESTAMP, MIN_WATERMARK
from flink_tpu_torch.core.watermarks import BoundedOutOfOrdernessWatermarks, WatermarkStrategy
from flink_tpu_torch.graph.transformation import Step, StepGraph, Transformation
from flink_tpu_torch.metrics.emission_latency import (
    EmissionLatencyTracker,
    merge_snapshots as _merge_emission_snapshots,
    watermark_lag_ms,
)
from flink_tpu_torch.metrics.registry import Gauge, MetricRegistry
from flink_tpu_torch.metrics.task_io import DeviceTimer, TaskIOMetrics
from flink_tpu_torch.ops.aggregators import ONE, resolve
from flink_tpu_torch.parallel import mesh as mesh_lib
from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator
from flink_tpu_torch.runtime.fused_window_pipeline import TracedPrologue
from flink_tpu_torch.runtime.oracle_window_operator import OracleWindowOperator
from flink_tpu_torch.runtime.timers import InternalTimerService
from flink_tpu_torch.runtime.tpu_global_window_operator import (
    TpuGlobalWindowOperator,
    supported_trigger,
)
from flink_tpu_torch.runtime.tpu_session_operator import TpuSessionWindowOperator
from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator
from flink_tpu_torch.scheduler.latency_controller import LatencySpec
from flink_tpu_torch.state.heap import HeapKeyedStateBackend, value_state
from flink_tpu_torch.state.tier_manager import TierConfig
from flink_tpu_torch.utils.arrays import as_device_column, canonical_column, obj_array
from flink_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class JobExecutionResult:
    job_name: str
    runtime_ms: float
    records_in: int
    metrics: Dict[str, Any]


# ---------------------------------------------------------------------------
# step runners (push-based; each pushes into `downstream`)
# ---------------------------------------------------------------------------

class _FanOut:
    """Downstream edge set of one runner: routes to every consumer's input
    gate (ordinal), counting the records into each consumer's
    numRecordsIn."""

    __slots__ = ("edges",)

    def __init__(self):
        self.edges: List = []   # (runner, input_ordinal)

    def __bool__(self) -> bool:
        return bool(self.edges)

    def add(self, runner: "StepRunner", ordinal: int) -> None:
        self.edges.append((runner, ordinal))

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        _deliver(self.edges, values, timestamps)

    def on_watermark(self, watermark: int) -> None:
        for r, o in self.edges:
            r.on_watermark_n(o, watermark)

    def on_marker(self, wall_ms: float) -> None:
        for r, _o in self.edges:
            r.on_marker(wall_ms)

    def on_end(self) -> None:
        for r, o in self.edges:
            r.on_end_n(o)


def _deliver(edges, values, timestamps) -> None:
    """Hand one batch to every (runner, gate) edge, counting it into each
    runner's numRecordsIn once its metrics are registered."""
    n = len(timestamps)
    for r, o in edges:
        counter = r.records_in_counter
        if counter is not None:
            counter.inc(n)
        r.on_batch_n(o, values, timestamps)


class StepRunner:
    downstream: Optional[_FanOut] = None
    sides: Optional[Dict[str, _FanOut]] = None   # side-output channels by tag
    num_inputs: int = 1
    records_in_counter = None   # numRecordsIn, once register_metrics ran
    _marker_hist = None         # latencyMs, once register_metrics ran

    def side_channel(self, tag_id: str) -> _FanOut:
        if self.sides is None:
            self.sides = {}
        return self.sides.setdefault(tag_id, _FanOut())

    def emit_side(self, tag_id: str, values, timestamps) -> None:
        if self.sides and tag_id in self.sides:
            self.sides[tag_id].on_batch(values, timestamps)

    def register_metrics(self, group) -> None:
        # operator-scope IO metrics: the records handed to this runner, and
        # the source-to-here transit of each latency marker as it passes
        self.records_in_counter = group.counter("numRecordsIn")
        self._marker_hist = group.histogram("latencyMs")

    # -- input-gate protocol (the multi-input valve) ------------------------
    def on_batch_n(self, ordinal: int, values: np.ndarray, timestamps: np.ndarray) -> None:
        self.on_batch(values, timestamps)

    def on_watermark_n(self, ordinal: int, watermark: int) -> None:
        """Per-gate watermark: min-combine across gates before processing
        (StatusWatermarkValve.java semantics). The gates' watermarks are
        not part of any snapshot, as in the JAX package (ROADMAP Queue C)."""
        if self.num_inputs <= 1:
            self.on_watermark(watermark)
            return
        wms = self.__dict__.setdefault("_gate_wms", {})
        wms[ordinal] = max(wms.get(ordinal, MIN_WATERMARK), watermark)
        if len(wms) < self.num_inputs:
            return
        combined = min(wms.values())
        if combined > self.__dict__.get("_combined_wm", MIN_WATERMARK):
            self.__dict__["_combined_wm"] = combined
            self.on_watermark(combined)

    def on_end_n(self, ordinal: int) -> None:
        """End of one gate: a multi-input runner ends after every gate has."""
        if self.num_inputs <= 1:
            self.on_end()
            return
        ended = self.__dict__.setdefault("_ended_gates", set())
        ended.add(ordinal)
        if len(ended) >= self.num_inputs:
            self.on_end()

    # -- processing -------------------------------------------------------
    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        raise NotImplementedError

    def on_watermark(self, watermark: int) -> None:
        if self.downstream:
            self.downstream.on_watermark(watermark)
        for f in (self.sides or {}).values():
            f.on_watermark(watermark)

    def on_marker(self, wall_ms: float) -> None:
        """Latency marker: a wall-clock stamp from the source that flows
        straight through every runner (windows forward it at once), each
        recording (now - stamp) into its latencyMs histogram before
        forwarding."""
        h = self._marker_hist
        if h is not None:
            h.update(time.time() * 1000.0 - wall_ms)
        if self.downstream:
            self.downstream.on_marker(wall_ms)
        for f in (self.sides or {}).values():
            f.on_marker(wall_ms)

    def on_processing_time(self, now_ms: int) -> None:
        """Wall-clock tick of the run loop; runners with processing-time
        timers fire them here."""

    def on_end(self) -> None:
        if self.downstream:
            self.downstream.on_end()
        for f in (self.sides or {}).values():
            f.on_end()

    # -- checkpointing (the JAX runners' forms) -----------------------------
    def snapshot(self) -> dict:
        return {}

    def restore(self, snap: dict) -> None:
        pass


def make_emission_tracker(uid: str, config: Configuration):
    """Per-operator emission-latency tracker, or None when the plane is off
    (observability.emission-latency.enabled). One policy for every windowed
    runner family (fused, per-batch, session, global, join), so a job's
    latency report sees one key shape."""
    if not config.get(ObservabilityOptions.EMISSION_LATENCY_ENABLED):
        return None
    return EmissionLatencyTracker(
        uid,
        outlier_pct=config.get(ObservabilityOptions.EMISSION_LATENCY_OUTLIER_PCT),
        outlier_floor_ms=config.get(ObservabilityOptions.EMISSION_LATENCY_OUTLIER_FLOOR_MS),
        ring_size=config.get(ObservabilityOptions.EMISSION_LATENCY_OUTLIER_RING),
        min_samples=config.get(ObservabilityOptions.EMISSION_LATENCY_OUTLIER_MIN_SAMPLES))


def _fused_chunk(batch_size: int) -> int:
    """Superscan ingest chunk for a configured batch size: the next power
    of two, clamped to [256, 4096] — one policy for both fused routes."""
    return min(4096, max(256, 1 << (max(batch_size, 1) - 1).bit_length()))


def _columnarize_records(vals, where: str):
    """Record-mode (object column) → numeric column, for UDFs declared
    traceable=True: the host routes feed them the representation the fused
    device path stages (CHAIN_FUSION is a perf switch, never a semantics
    switch). Raises if the records do not columnarize."""
    arr = np.asarray(vals.tolist() if isinstance(vals, np.ndarray) else list(vals))
    if arr.dtype == object:
        raise TypeError(
            f"{where} is declared traceable=True and requires numeric "
            "record columns; these records do not columnarize — drop "
            "traceable=True to run per-record instead"
        )
    return arr


def _call_traceable(fn, *cols):
    """A traceable UDF (a function of torch tensor columns) called on the
    host: CPU tensor views of the numpy columns in, numpy out."""
    args = [torch.from_numpy(c if c.flags.writeable else c.copy()) for c in cols]
    out = fn(*args)
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


class ChainRunner(StepRunner):
    """Fused stateless chain: map/map_ts/filter/flat_map applied per batch
    on the host. Traceable transforms take the canonical numeric column as
    a CPU tensor (the form the device prologue gives them); vectorized ones
    take the numpy column; plain ones run per record."""

    def __init__(self, transforms: List[Transformation]):
        self.transforms = transforms

    @staticmethod
    def _to_column(vals, columnar: bool = True) -> np.ndarray:
        """Normalize a transform's output. A vectorized transform's is a
        whole column by contract, of any rank (`columnar`); a map_batch's
        list becomes a numeric column only when it is one-dimensional,
        else a column of its records."""
        if isinstance(vals, np.ndarray):
            return vals
        arr = np.asarray(vals)
        if arr.dtype.kind in "OUSifub" and (arr.ndim == 1 or columnar):
            return arr
        return obj_array(list(vals))

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        vals = values
        ts = np.asarray(timestamps, dtype=np.int64)
        for t in self.transforms:
            if len(ts) == 0:
                return
            fn = t.config["fn"]
            vec = t.config.get("vectorized", False)
            traced = t.config.get("traceable", False)
            if traced:
                if getattr(vals, "dtype", None) == object:
                    vals = _columnarize_records(vals, f"{t.kind} '{t.name}'")
                # the fused path computes on canonical columns, so this
                # route does too (same checked cast)
                vals = canonical_column(vals, f"{t.kind} '{t.name}'")
            if t.kind == "map":
                if traced:
                    vals = _call_traceable(fn, vals)
                elif vec:
                    vals = self._to_column(fn(vals))
                else:
                    vals = obj_array([fn(v) for v in vals])
            elif t.kind == "map_ts":
                if traced:
                    # timestamps in the canonical int32 the fused path stages
                    vals = _call_traceable(fn, vals, canonical_column(
                        ts, f"map_with_timestamp '{t.name}' timestamps"))
                elif vec:
                    vals = self._to_column(fn(vals, ts))
                else:
                    vals = obj_array([fn(v, int(x)) for v, x in zip(vals, ts)])
            elif t.kind == "filter":
                if traced:
                    mask = _call_traceable(fn, vals).astype(bool)
                elif vec:
                    mask = np.asarray(fn(vals), dtype=bool)
                else:
                    mask = np.fromiter((bool(fn(v)) for v in vals), dtype=bool,
                                       count=len(vals))
                vals = vals[mask]
                ts = ts[mask]
            elif t.kind == "map_batch":
                # one call over the whole batch's records
                vals = self._to_column(fn(vals if vec else list(vals)), columnar=vec)
                if len(vals) != len(ts):
                    raise ValueError(
                        f"map_batch '{t.name}' returned {len(vals)} values "
                        f"for {len(ts)} input records; map_batch must be "
                        "1:1 (use flat_map for 1:N transforms)")
            elif t.kind == "flat_map":
                if vec:
                    out, src_idx = fn(vals)
                    vals = self._to_column(out)
                    ts = ts[np.asarray(src_idx, dtype=np.int64)]
                else:
                    new_vals, new_ts = [], []
                    for v, x in zip(vals, ts):
                        for out in fn(v):
                            new_vals.append(out)
                            new_ts.append(int(x))
                    vals = obj_array(new_vals)
                    ts = np.asarray(new_ts, dtype=np.int64)
            else:
                raise NotImplementedError(t.kind)
        if len(ts) and self.downstream:
            self.downstream.on_batch(vals, ts)


def _max_source_out_of_orderness(step: Step) -> Optional[int]:
    """Largest bounded-out-of-orderness delay (ms) among the source
    watermark strategies feeding `step`, walking the step DAG back to its
    source transformations. Returns None when any reachable source uses a
    generator whose bound is not statically knowable (punctuated/custom)."""
    bound = 0
    seen = set()
    stack = [step]
    while stack:
        s = stack.pop()
        if id(s) in seen:
            continue
        seen.add(id(s))
        for edge in s.inputs:
            producer = edge[0]
            if isinstance(producer, Step):
                stack.append(producer)
                continue
            strategy = producer.config.get("watermark_strategy")
            if strategy is None:
                continue     # no watermarks: never advances event time
            gen = strategy.create_generator()
            if not isinstance(gen, BoundedOutOfOrdernessWatermarks):
                return None
            bound = max(bound, gen._delay)
    return bound


def _latency_kwargs(config: Configuration) -> dict:
    """The latency-mode option bundle for FusedWindowOperator: empty (not
    latency=None) when execution.latency.target-ms is off, so the default
    configuration constructs the operator as before the mode existed. Both
    fused construction sites (WindowStepRunner, DeviceChainRunner) take it."""
    target = config.get(LatencyOptions.TARGET_MS)
    if target is None or int(target) <= 0:
        return {}
    return {"latency": LatencySpec(
        target_ms=int(target),
        max_inflight=config.get(LatencyOptions.MAX_INFLIGHT),
        floor_steps=config.get(LatencyOptions.FLOOR_STEPS),
        readback_steps=config.get(LatencyOptions.READBACK_STEPS),
        min_dwell_ms=config.get(LatencyOptions.MIN_DWELL_MS),
        hysteresis_pct=config.get(LatencyOptions.HYSTERESIS_PCT),
    )}


def _mesh_for_config(config: Configuration, key_capacity: int, device):
    """The job's mesh when parallel.mesh.enabled applies, else None.

    The requested shard count (0 = every visible device) is clamped to the
    devices `parallel/mesh.py::visible_devices` gives for the job's device,
    then rounded DOWN to the largest divisor of the operator's key capacity
    so the contiguous key ranges divide evenly. Under 2 usable devices the
    job stays on one device, as the JAX package's does."""
    if not config.get(ParallelOptions.MESH_ENABLED):
        return None
    devices = mesh_lib.visible_devices(device)
    n = mesh_lib.usable_mesh_size(config.get(ParallelOptions.MESH_DEVICES), len(devices),
                                  key_capacity)
    if n <= 1:
        return None
    return mesh_lib.build_mesh(n, devices)


def _mesh_exchange_kwargs(config: Configuration) -> dict:
    """The exchange options threaded to FusedWindowOperator (ignored off
    the mesh): the map-side combiner and the key-group routing table
    (parallel.mesh.skew-rebalance, parallel.mesh.key-groups). Single-sourced
    so both fused construction sites take the same."""
    return {"mesh_local_combine": config.get(ParallelOptions.MESH_LOCAL_COMBINE),
            "mesh_skew_routing": config.get(ParallelOptions.MESH_SKEW_REBALANCE),
            "mesh_key_groups": config.get(ParallelOptions.MESH_KEY_GROUPS)}


class MeshRescaleRequested(BaseException):
    """Control-flow signal, not a failure: the run loop reached a step
    boundary with a pending mesh-rescale request. Carries the target
    shard count and the step-aligned state capture the rebuilt runtime
    restores from (the snapshot is canonical [K, S], so any mesh size
    re-shards it). With `routing` set this is a skew REBALANCE, not a
    resize: the target is the current size and `routing` the new [G]
    key-group assignment the rebuilt runtime applies after its restore.
    BaseException so ordinary `except Exception` operator guards can
    never swallow it."""

    def __init__(self, target: int, snapshot: dict, routing=None):
        super().__init__(f"mesh rescale to {target} devices" if routing is None
                         else f"mesh key-group rebalance over {target} devices")
        self.target = int(target)
        self.snapshot = snapshot
        self.routing = routing


def _tier_for_config(config: Configuration) -> Optional[TierConfig]:
    """The fused window path's TierConfig when the million-key state plane
    applies (state.tier.enabled), else None. Tiering needs the host key
    dictionary, so the traced-chain runner (dense device keying) never
    receives one."""
    if not config.get(StateTierOptions.TIER_ENABLED):
        return None
    return TierConfig(
        hot_key_capacity=config.get(StateTierOptions.HOT_KEY_CAPACITY),
        eviction_policy=config.get(StateTierOptions.EVICTION_POLICY),
        admission_min_count=config.get(StateTierOptions.ADMISSION_MIN_COUNT),
        cold_dir=config.get(StateTierOptions.COLD_DIR) or None,
        changelog_enabled=config.get(StateTierOptions.CHANGELOG_ENABLED),
        changelog_dir=config.get(StateTierOptions.CHANGELOG_DIR) or None,
        materialize_interval=config.get(StateTierOptions.CHANGELOG_MATERIALIZE_INTERVAL),
        retained_bases=config.get(StateTierOptions.CHANGELOG_RETAINED_BASES),
    )


def _session_disorder_within_gap(step: Step, assigner) -> bool:
    """Device-session routing gate: the session operator's late contract
    (drop records whose standalone session is already expired) matches the
    merging oracle only while watermark out-of-orderness stays BELOW the
    session gap — with bound >= gap a record can arrive late enough that
    the oracle would still merge it into an open session the device path
    already expired, i.e. silent data loss. Such pipelines take the oracle,
    with the JAX package's warning. Fail-open on an unknowable bound
    (custom/punctuated generators), as in the JAX package."""
    bound = _max_source_out_of_orderness(step)
    if bound is None or bound < assigner.gap:
        return True
    warnings.warn(
        f"session windows: watermark out-of-orderness bound ({bound} ms) >= "
        f"session gap ({assigner.gap} ms) — using the per-record oracle "
        "operator instead of the device session operator, whose late "
        "contract would silently drop records the oracle merges. Shrink the "
        "out-of-orderness bound below the gap to re-enable the device path, "
        "or set execution.window.device-sessions false to silence this.",
        RuntimeWarning,
    )
    return False


def _push_rows(fan: Optional[_FanOut], out: list, window_fn=None) -> None:
    """Hand an operator's drained (key, window, result, ts) rows to `fan`:
    row mode as (key, value); columnar mode (key None) as the packed
    (window, key ids, values) triple; a window function's output as it is."""
    if out and fan:
        vals = obj_array([r if (window_fn is not None or k is None) else (k, r)
                          for (k, _w, r, _t) in out])
        fan.on_batch(vals, np.asarray([t for (_k, _w, _r, t) in out], dtype=np.int64))


class WindowStepRunner(StepRunner):
    """Keyed window aggregation step over the operator the JAX runner
    selects, under its conditions: global count windows, device sessions,
    the fused operator, the per-batch operator, else the per-record oracle
    operator (host code; `self.device` False)."""

    window_fn = None          # a ProcessWindowFunction (the oracle's)
    device = True             # False: the per-record oracle operator runs the step
    processing_time = False   # the step's windows are over processing time
    # the fused operator's drain is its readback section
    _drain_resolves_device = False

    def __init__(self, step: Step, config: Configuration, device: torch.device):
        t = step.terminal
        cfg = t.config
        assigner = cfg["assigner"]
        aggregate = cfg["aggregate"]
        self.key_selector = cfg["key_selector"]
        self.key_vectorized = cfg.get("key_vectorized", False)
        self.key_traceable = cfg.get("key_traceable", False)
        self.value_fn = cfg.get("value_fn") or (lambda v: v)
        self.value_vectorized = cfg.get("value_vectorized", False) and cfg.get("value_fn")
        self.value_traceable = cfg.get("value_traceable", False) and cfg.get("value_fn")
        self.window_fn = cfg.get("window_fn")
        device_agg = resolve(aggregate)
        self.uid = t.uid
        # SQL-originated window steps (planner lowering, interpreted
        # translation) are marked so a job can tell which path SQL selected
        self.sql_origin = bool(cfg.get("sql_origin"))
        self._needs_value = device_agg is None or any(
            f.source != ONE for f in device_agg.fields)
        self.processing_time = not assigner.is_event_time
        use_device = (
            device_agg is not None
            and assigner.slice_ms is not None
            and assigner.is_event_time
            and cfg.get("trigger") is None
            and cfg.get("evictor") is None
            and self.window_fn is None
        )
        use_fused = (
            use_device
            and cfg.get("allowed_lateness", 0) == 0
            and not cfg.get("side_output_late")
            and config.get(ExecutionOptions.FUSED_WINDOWS)
            and all(f.scatter in ("add", "min", "max") for f in device_agg.fields)
        )
        count_spec = supported_trigger(cfg.get("trigger"))
        if (isinstance(assigner, GlobalWindows) and device_agg is not None
                and count_spec is not None and cfg.get("evictor") is None
                and self.window_fn is None):
            n, purging = count_spec
            self.op = TpuGlobalWindowOperator(
                device_agg, count_n=n, purging=purging,
                key_capacity=config.get(ExecutionOptions.KEY_CAPACITY), device=device)
        elif (isinstance(assigner, EventTimeSessionWindows)
              and device_agg is not None
              and assigner.is_event_time
              and config.get(ExecutionOptions.DEVICE_SESSIONS)
              and cfg.get("trigger") is None
              and cfg.get("evictor") is None
              and self.window_fn is None
              and cfg.get("allowed_lateness", 0) == 0
              and not cfg.get("side_output_late")
              and _session_disorder_within_gap(step, assigner)):
            # per-slice fragments + gap-merge scan (runtime/
            # tpu_session_operator.py); capacity grows with the dictionary
            self.op = TpuSessionWindowOperator(
                assigner, device_agg,
                key_capacity=min(1 << 10, config.get(ExecutionOptions.KEY_CAPACITY)),
                device=device)
        elif use_fused:
            # the fused operator's drain is its readback section (deferred
            # superbatch resolution); elsewhere drain is a host list swap
            self._drain_resolves_device = True
            # start small and grow by doubling with the key dictionary: the
            # superscan's cost scales with the key capacity. With the state
            # tier (state.tier.*) the capacity is FIXED at the hot capacity
            # instead: the vocabulary evicts, the capacity never grows
            tier = _tier_for_config(config)
            if tier is not None:
                capacity = tier.hot_key_capacity
            else:
                capacity = min(1 << 10, config.get(ExecutionOptions.KEY_CAPACITY))
            self.op = FusedWindowOperator(
                assigner, device_agg, key_capacity=capacity,
                superbatch_steps=config.get(ExecutionOptions.SUPERBATCH_STEPS),
                chunk=_fused_chunk(config.get(ExecutionOptions.BATCH_SIZE)),
                columnar_output=config.get(ExecutionOptions.COLUMNAR_OUTPUT),
                # the mesh (parallel.mesh.*): the same operator over its
                # shards; None keeps the one-device path
                mesh=_mesh_for_config(config, capacity, device),
                tier=tier, device=device, **_mesh_exchange_kwargs(config),
                **_latency_kwargs(config))
        elif use_device:
            # allowed lateness, a late side output or the fused path off:
            # one ingest and the due fires per batch. The state tier takes
            # the grow-only hot/cold id split here (ids past the hot
            # capacity aggregate in the cold tier), without lateness only
            tier = _tier_for_config(config)
            tier_kwargs = {}
            if tier is not None and cfg.get("allowed_lateness", 0) == 0:
                tier_kwargs = dict(hot_key_capacity=tier.hot_key_capacity,
                                   cold_tier_dir=tier.cold_dir)
            self.op = TpuWindowOperator(
                assigner, device_agg,
                allowed_lateness=cfg.get("allowed_lateness", 0),
                key_capacity=config.get(ExecutionOptions.KEY_CAPACITY),
                emit_late_to_side_output=bool(cfg.get("side_output_late")),
                columnar_output=config.get(ExecutionOptions.COLUMNAR_OUTPUT),
                device=device, **tier_kwargs)
        else:
            # the per-record oracle: the JAX runner's choice for these steps
            # (parity, not a fallback); host code, the device takes no part
            agg_fn = aggregate
            if device_agg is not None and not isinstance(aggregate, AggregateFunction):
                agg_fn = device_agg.python_equivalent()
            self.op = OracleWindowOperator(
                assigner, agg_fn,
                trigger=cfg.get("trigger"),
                allowed_lateness=cfg.get("allowed_lateness", 0),
                max_parallelism=config.get(PipelineOptions.MAX_PARALLELISM),
                window_function=self.window_fn,
                evictor=cfg.get("evictor"),
                emit_late_to_side_output=bool(cfg.get("side_output_late")),
            )
            self.device = False
        self._init_planes(config, device)

    def _init_planes(self, config: Configuration, device=None) -> None:
        """Device timing (observability.device-timing.enabled): the host
        clock around the dispatch and readback sections, never a
        synchronize of its own. Emission latency
        (observability.emission-latency.*): device operators stamp at their
        own resolve sites (where a fired window's rows become
        host-visible); the per-record oracle has no tracker surface, so the
        runner stamps its drained rows instead: drain is the oracle's
        visibility point."""
        self.device_timer = (
            DeviceTimer()
            if self.device and config.get(ObservabilityOptions.DEVICE_TIMING_ENABLED)
            else None)
        self.emission_tracker = make_emission_tracker(self.uid, config)
        self._emission_lateness = getattr(self.op, "allowed_lateness", 0)
        self._emission_at_drain = False
        if self.emission_tracker is not None:
            if hasattr(type(self.op), "emission_tracker"):
                self.op.emission_tracker = self.emission_tracker
            else:
                self._emission_at_drain = True
        self._init_device_stats(config, device)

    def _init_device_stats(self, config: Configuration, device=None) -> None:
        """The device plane (metrics/device_stats.py, metrics/key_stats.py):
        a CompileTracker attached to an operator with the attach surface
        (the fused operator; the others skip it) and a throttled key-stats
        collector over an operator's device-resident per-key loads. Gated
        like the JAX runner's; per-batch host cost is one clock compare."""
        self.device_stats = None
        self.key_stats = None
        self._roofline_peaks = None
        if not (self.device and config.get(ObservabilityOptions.DEVICE_STATS_ENABLED)):
            return
        from flink_tpu_torch.metrics.device_stats import CompileTracker, platform_peaks
        from flink_tpu_torch.metrics.key_stats import KeyStatsCollector

        attach = getattr(self.op, "attach_device_stats", None)
        if attach is not None:
            tracker = CompileTracker(
                history_size=config.get(ObservabilityOptions.DEVICE_RECOMPILE_HISTORY_SIZE),
                storm_threshold=config.get(
                    ObservabilityOptions.DEVICE_RECOMPILE_STORM_THRESHOLD),
                storm_window_ms=config.get(
                    ObservabilityOptions.DEVICE_RECOMPILE_STORM_WINDOW_MS),
                cost_analysis=config.get(ObservabilityOptions.DEVICE_COST_ANALYSIS_ENABLED),
                memory_analysis=config.get(
                    ObservabilityOptions.DEVICE_MEMORY_ANALYSIS_ENABLED))
            attach(tracker)
            self.device_stats = tracker
            self._roofline_peaks = platform_peaks(
                config.get(ObservabilityOptions.DEVICE_HBM_GBPS),
                config.get(ObservabilityOptions.DEVICE_PEAK_TFLOPS),
                resolve_device(device).type)
        loads_fn = getattr(self.op, "key_loads", None)
        if loads_fn is not None:
            self.key_stats = KeyStatsCollector(
                loads_fn,
                num_key_groups=config.get(PipelineOptions.MAX_PARALLELISM),
                top_k=config.get(ObservabilityOptions.DEVICE_KEY_STATS_TOP_K),
                row_bytes_fn=getattr(self.op, "state_row_bytes", None),
                ready_fn=getattr(self.op, "key_stats_ready", None),
                interval_ms=config.get(ObservabilityOptions.DEVICE_KEY_STATS_INTERVAL_MS),
                # mesh operators also fold per-shard loads, so the skew
                # gauges see the worst shard too
                mesh_loads_fn=(getattr(self.op, "per_device_key_loads", None)
                               if getattr(self.op, "mesh_devices", lambda: 1)() > 1
                               else None))

    def _device_stats_tick(self) -> None:
        """A due key-stats fold (one clock compare otherwise). Called
        outside every DeviceTimer section: the fold's one copy waits for
        the dispatch in flight."""
        if self.key_stats is not None:
            self.key_stats.maybe_collect()

    def device_roofline(self) -> Dict[str, float]:
        """hbmUtilizationPct / flopsUtilizationPct: the tracker's bytes and
        operations over the DeviceTimer's time (host clock; 0.0 when either
        side is off)."""
        from flink_tpu_torch.metrics.device_stats import roofline_pct

        tracker, timer = self.device_stats, self.device_timer
        if tracker is None or timer is None or self._roofline_peaks is None:
            return {"hbmUtilizationPct": 0.0, "flopsUtilizationPct": 0.0}
        hbm, tflops = self._roofline_peaks
        return roofline_pct(tracker.bytes_accessed_total(), tracker.flops_total(),
                            timer.total_s, hbm, tflops)

    def _section(self, fn, *args):
        """fn(*args), inside a device-timer section when timing is on."""
        if self.device_timer is None:
            return fn(*args)
        with self.device_timer.section():
            return fn(*args)

    def _keys_of(self, values) -> np.ndarray:
        if self.key_traceable:
            return _call_traceable(self.key_selector, values)
        if self.key_vectorized:
            return np.asarray(self.key_selector(values))
        raw_keys = [self.key_selector(v) for v in values]
        keys = np.asarray(raw_keys)
        if keys.ndim != 1 or keys.dtype.kind not in "iuUS":
            keys = obj_array(raw_keys)
        return keys

    def _values_of(self, values) -> np.ndarray:
        if not self._needs_value:     # pure-count aggregates ignore values
            return np.zeros(len(values), dtype=np.float32)
        if self.value_traceable:
            if getattr(values, "dtype", None) == object:
                values = _columnarize_records(values, "value_fn")
            values = canonical_column(values, "value_fn input")
            return _call_traceable(self.value_fn, values).astype(np.float32)
        if self.value_vectorized:
            return np.asarray(self.value_fn(values), dtype=np.float32)
        return np.asarray([self.value_fn(v) for v in values], dtype=np.float32)

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        # chaos seam (device dispatch boundary): one is-None check per
        # batch when chaos is off
        hook = _chaos.HOOK
        if hook is not None:
            hook("device", self.uid)
        if self.key_traceable and len(timestamps):
            # host route of a traceable program: columnarize record-mode
            # input and cast to the canonical dtype as the fused ingest does
            if getattr(values, "dtype", None) == object:
                values = _columnarize_records(values, "key_by selector")
            values = canonical_column(values, "key_by selector input")
        if not self.device:
            self._process_records(values, timestamps)
            return
        keys = self._keys_of(values)
        if keys.ndim != 1 or keys.dtype.kind not in "iuUSO":
            keys = obj_array(list(keys))
        self._section(self.op.process_batch, keys, self._values_of(values), timestamps)
        self._device_stats_tick()

    def _process_records(self, values, timestamps) -> None:
        """The oracle's per-record feed (the JAX runner's): processing-time
        windows stamp every record with the wall clock and advance the
        operator's processing time after the batch."""
        if self.processing_time:
            now = int(time.time() * 1000)
            timestamps = np.full(len(values), now, dtype=np.int64)
        # column selectors see a one-row column per record here
        if self.key_traceable:
            key_of = lambda v: _call_traceable(self.key_selector, np.asarray(v)[None, ...])[0]  # noqa: E731
        elif self.key_vectorized:
            key_of = lambda v: np.asarray(self.key_selector(np.asarray(v)[None, ...]))[0]  # noqa: E731
        else:
            key_of = self.key_selector
        if self.value_traceable:
            val_of = lambda v: _call_traceable(self.value_fn, canonical_column(  # noqa: E731
                np.asarray(v)[None, ...], "value_fn input"))[0]
        elif self.value_vectorized:
            val_of = lambda v: np.asarray(self.value_fn(np.asarray(v)[None, ...]))[0]  # noqa: E731
        else:
            val_of = self.value_fn
        for v, ts in zip(values, timestamps):
            self.op.process_record(key_of(v), val_of(v), int(ts))
        if self.processing_time:
            self.op.advance_processing_time(int(time.time() * 1000))
            self._drain()

    def on_processing_time(self, now_ms: int) -> None:
        # processing-time windows fire from the run loop's wall-clock tick,
        # not only when their own source produces a batch
        self._device_stats_tick()
        if self.processing_time:
            self.op.advance_processing_time(now_ms)
            self._drain()

    def on_watermark(self, watermark: int) -> None:
        if self.device and self.key_stats is not None:
            # fold BEFORE the watermark's purge, so a due collection sees
            # the state the advance is about to retire
            self._device_stats_tick()
        self._section(self.op.process_watermark, watermark)
        self._drain()
        # fused operators emit at superbatch granularity: forward only the
        # watermark their resolved output already covers (the session
        # operator has resolved everything its drain returned)
        safe = getattr(self.op, "emitted_watermark", None)
        if safe is not None:
            watermark = min(watermark, safe)
        if watermark > MIN_WATERMARK:
            self._forward_watermark(watermark)

    def _forward_watermark(self, watermark: int) -> None:
        StepRunner.on_watermark(self, watermark)

    def on_end(self) -> None:
        self._drain()
        super().on_end()

    def _drain(self) -> None:
        # side outputs (late data) to the tagged consumers; rows without a
        # consumer are dropped, not accumulated
        op_sides = getattr(self.op, "side_output", None)
        for tag_id, rows in list((op_sides or {}).items()):
            if rows:
                self.emit_side(tag_id, obj_array([(k, v) for (k, v, _t) in rows]),
                               np.asarray([t for (_k, _v, t) in rows], dtype=np.int64))
            op_sides[tag_id] = []
        if self._drain_resolves_device:
            # the fused operator's readback section, as the JAX runner times it
            out = self._section(self.op.drain_output)
        else:
            out = self.op.drain_output()
        if out and self._emission_at_drain:
            tr, lateness = self.emission_tracker, self._emission_lateness
            for _k, w, _r, t in out:
                tr.record_fire(getattr(w, "end", int(t) + 1), lateness_ms=lateness)
        _push_rows(self.downstream, out, self.window_fn)

    def register_metrics(self, group) -> None:
        super().register_metrics(group)
        group.gauge("numLateRecordsDropped", lambda: self.op.num_late_records_dropped,
                    fold="sum", kind="counter")

        def _wm():
            return getattr(self.op, "current_watermark",
                           getattr(getattr(self.op, "timer_service", None),
                                   "current_watermark", 0))

        # the job's combined watermark is what every subtask reached: MIN
        group.gauge("currentWatermark", _wm, fold="min")
        if self.emission_tracker is not None:
            # the flat log-bucket snapshot (folds bucket-wise across shards)
            # and the wall-clock lag behind the watermark (worst shard)
            group.gauge("emissionLatencyMs", self.emission_tracker.snapshot,
                        fold="emission", kind="histogram")
            group.gauge("watermarkLagMs", lambda: watermark_lag_ms(_wm()), fold="max")
        if self.device_timer is not None:
            self.device_timer._hist = group.histogram("deviceDispatchMs")
            self.device_timer.register(group)
        state_bytes = getattr(self.op, "state_bytes", None)
        if state_bytes is not None:
            group.gauge("stateBytes", state_bytes, fold="sum")
        key_count = getattr(self.op, "state_key_count", None)
        if key_count is not None:
            group.gauge("stateKeyCount", key_count, fold="sum")
        # the device plane: compile counters, roofline, phase counters and
        # key statistics, on the operator scope
        if self.device_stats is not None:
            self.device_stats.register(group)
            # each shard's own card's view: MEAN across shards
            group.gauge("hbmUtilizationPct",
                        lambda: self.device_roofline()["hbmUtilizationPct"], fold="mean")
            group.gauge("flopsUtilizationPct",
                        lambda: self.device_roofline()["flopsUtilizationPct"], fold="mean")
            phases = getattr(self.op, "phase_totals", None)
            if callable(phases):
                for name, key in (("phaseIngestRecords", "ingestRecords"),
                                  ("phaseFireSteps", "fireSteps"),
                                  ("phasePurgeSteps", "purgeSteps")):
                    group.gauge(name, lambda k=key: phases()[k], fold="sum", kind="counter")
        if self.key_stats is not None:
            self.key_stats.register(group)
        # the state tier's gauges: counts and sizes SUM across shards, the
        # hot fill ratio MEANs; eviction and promotion totals are monotone
        tier_gauges = getattr(self.op, "tier_gauges", None)
        if callable(tier_gauges) and tier_gauges() is not None:
            for key, kind in (("vocabSize", None), ("residentKeys", None),
                              ("evictions", "counter"), ("promotions", "counter"),
                              ("spilledBytes", "counter"), ("changelogBytes", "counter")):
                group.gauge(key, lambda k=key: self.op.tier_gauges().get(k),
                            fold="sum", kind=kind)
            group.gauge("tierHotFillRatio",
                        lambda: self.op.tier_gauges().get("tierHotFillRatio"), fold="mean")
        # latency mode's controller gauges, only when the mode is on (MAX
        # across shards: the deepest rung is the job's latency view)
        latency_gauges = getattr(self.op, "latency_gauges", None)
        if callable(latency_gauges) and latency_gauges() is not None:
            for key in ("latencyModeActive", "currentBatchRung", "inflightDepth",
                        "ladderRecompiles"):
                group.gauge(key, lambda k=key: self.op.latency_gauges().get(k), fold="max")

    def snapshot(self) -> dict:
        return {"operator": self.op.snapshot()}

    def restore(self, snap: dict) -> None:
        self.op.restore(snap["operator"])


class DeviceChainRunner(WindowStepRunner):
    """Whole-graph fusion runner (graph/fusion.py): the traceable
    map/filter/map_ts chain, key/value extraction and the window aggregate
    run as one fused dispatch per superbatch — the chain as a torch
    prologue over the raw staged columns on the device, then kernel K1.
    Only raw source columns cross from the host. Inherits the watermark
    and drain surfaces of WindowStepRunner."""

    def __init__(self, step: Step, plan, config: Configuration, device: torch.device):
        self._init_fused(plan.terminal, plan.transforms, config, device)

    def _init_fused(self, t, transforms, config: Configuration, device: torch.device,
                    assigners=None) -> None:
        """The construction of the fused device surface, shared with
        SharedWindowRunner (which passes the group's `assigners`), so an
        option threaded to FusedWindowOperator lands on both paths."""
        cfg = t.config
        prologue = TracedPrologue(
            transforms=tuple((tr.kind, tr.config["fn"]) for tr in transforms),
            key_fn=cfg["key_selector"],
            value_fn=cfg.get("value_fn"),
        )
        # dense device keying cannot grow mid-dispatch: capacity is the
        # configured bound, and an out-of-range key raises at resolve
        capacity = config.get(ExecutionOptions.KEY_CAPACITY)
        self.op = FusedWindowOperator(
            None if assigners is not None else cfg["assigner"], cfg["aggregate"],
            key_capacity=capacity,
            superbatch_steps=config.get(ExecutionOptions.SUPERBATCH_STEPS),
            chunk=_fused_chunk(config.get(ExecutionOptions.BATCH_SIZE)),
            columnar_output=config.get(ExecutionOptions.COLUMNAR_OUTPUT),
            # the mesh (parallel.mesh.*): each shard runs the prologue on
            # its slice of the raw columns, then the keyBy exchange and K1
            mesh=_mesh_for_config(config, capacity, device),
            prologue=prologue, device=device, **_mesh_exchange_kwargs(config),
            **_latency_kwargs(config),
            **({} if assigners is None else {"assigners": list(assigners)}))
        self.uid = t.uid
        self.sql_origin = bool(cfg.get("sql_origin"))
        # the drain resolves deferred dispatches' rows: the readback section
        self._drain_resolves_device = True
        self._init_planes(config, device)

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        hook = _chaos.HOOK   # chaos seam: fused-chain dispatch boundary
        if hook is not None:
            hook("device", self.uid)
        if len(timestamps) == 0:
            return   # nothing to stage
        if getattr(values, "dtype", None) == object or not isinstance(values, np.ndarray):
            # record-mode source: one columnarization pass per batch
            values = _columnarize_records(values, "fused device chain")
        else:
            values = as_device_column(values)
        self._section(self.op.process_raw_batch, values, timestamps)
        self._device_stats_tick()


class SharedWindowSiblingRunner(StepRunner):
    """Placeholder runner of a non-leader member of a shared-partial window
    group (graph/window_sharing.py): it owns the member's downstream edges,
    into which the group's leader pushes this member's rows, watermarks
    and end of input. Its own input edges are never wired (the leader
    consumes the stream once; wiring them would ingest it twice)."""

    def __init__(self, step: Step, spec: int):
        self.uid = step.terminal.uid
        self.spec = spec
        self.sql_origin = bool(step.terminal.config.get("sql_origin"))

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        raise AssertionError("shared-window sibling received a direct batch; its input "
                             "edges must not be wired")


class SharedWindowRunner(DeviceChainRunner):
    """Shared-partials runner (graph/window_sharing.py): one fused device
    program serves N correlated window() siblings. K1 ingests gcd-granule
    partials once, every member window folds its own slice run from the
    shared ring (Factor Windows), and each member's rows go to its own
    downstream edges through its sibling runner. Construction is
    DeviceChainRunner's; only emission routing and the watermark and
    end-of-input fan-out differ; latency markers fan out to every member,
    as watermarks do."""

    def __init__(self, step: Step, shared_plan, config: Configuration, device: torch.device):
        self.shared_plan = shared_plan
        self._init_fused(shared_plan.terminals[0], shared_plan.transforms, config, device,
                         assigners=shared_plan.assigners)
        # spec index -> the runner owning that member's downstream edges
        # (spec 0: this leader); build_runners registers the siblings
        self.member_runners: List[StepRunner] = [self]

    def _drain(self) -> None:
        # each member's lane to its own edges, in the record shape of an
        # unshared runner: sharing never changes what downstream receives
        drained = self._section(lambda: [self.op.drain_spec_output(spec)
                                         for spec in range(len(self.member_runners))])
        for r, out in zip(self.member_runners, drained):
            _push_rows(r.downstream, out)

    def _forward_watermark(self, watermark: int) -> None:
        for r in self.member_runners:
            StepRunner.on_watermark(r, watermark)

    def on_marker(self, wall_ms: float) -> None:
        # every member's downstream sees the marker: sharing must not blind
        # the sibling sinks' latency histograms
        h = self._marker_hist
        if h is not None:
            h.update(time.time() * 1000.0 - wall_ms)
        for r in self.member_runners:
            if r.downstream:
                r.downstream.on_marker(wall_ms)
            for f in (r.sides or {}).values():
                f.on_marker(wall_ms)

    def on_end(self) -> None:
        self._drain()
        for r in self.member_runners:
            StepRunner.on_end(r)


class KeyedReduceRunner(StepRunner):
    """Rolling keyed reduce (KeyedStream.reduce): emits each key's running
    reduce per input record (StreamGroupedReduceOperator), on the host."""

    def __init__(self, step: Step, config: Configuration):
        t = step.terminal
        self.key_selector = t.config["key_selector"]
        self.reduce_fn = t.config["reduce_fn"]
        max_par = config.get(PipelineOptions.MAX_PARALLELISM)
        self.state = HeapKeyedStateBackend(KeyGroupRange(0, max_par - 1), max_par)
        self.state.register(value_state("rolling"))
        self.uid = t.uid

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        out = []
        for v in values:
            self.state.set_current_key(self.key_selector(v))
            cur = self.state.get("rolling")
            nxt = v if cur is None else self.reduce_fn(cur, v)
            self.state.put("rolling", nxt)
            out.append(nxt)
        if out and self.downstream:
            self.downstream.on_batch(obj_array(out), timestamps)

    def snapshot(self) -> dict:
        return {"state": self.state.snapshot()}

    def restore(self, snap: dict) -> None:
        self.state.restore(snap["state"])


class KeyedProcessRunner(StepRunner):
    """A KeyedProcessFunction on the host: per-key state (registered as the
    function asks for it), event-time and processing-time timers, and side
    outputs (`ctx.output(tag, v)`) buffered per tag and emitted with the
    main output after each batch, watermark or processing-time tick."""

    def __init__(self, step: Step, config: Configuration):
        t = step.terminal
        self.key_selector = t.config["key_selector"]
        self._init_keyed(t, config)

    def _init_keyed(self, t: Transformation, config: Configuration) -> None:
        self.fn: ProcessFunction = t.config["process_fn"]
        max_par = config.get(PipelineOptions.MAX_PARALLELISM)
        self.state = HeapKeyedStateBackend(KeyGroupRange(0, max_par - 1), max_par,
                                           auto_register=True)
        self.timers = InternalTimerService(self._on_event_timer, self._on_proc_timer)
        self._out: List = []
        self._out_ts: List[int] = []
        self._side_buf: Dict[str, tuple] = {}
        self.uid = t.uid

    class _TimerService:
        def __init__(self, runner, key):
            self._r = runner
            self._key = key

        def register_event_time_timer(self, time: int) -> None:
            self._r.timers.register_event_time_timer(self._key, None, time)

        def register_processing_time_timer(self, time: int) -> None:
            self._r.timers.register_processing_time_timer(self._key, None, time)

        def current_watermark(self) -> int:
            return self._r.timers.current_watermark

        def state(self):
            return self._r.state

    def _ctx(self, key, timestamp):
        def side(tag, value):
            buf = self._side_buf.setdefault(getattr(tag, "tag_id", tag), ([], []))
            buf[0].append(value)
            buf[1].append(timestamp)

        return ProcessFunction.Context(timestamp, self._TimerService(self, key), side)

    def _fire_timer(self, time, key, out_ts) -> None:
        self.state.set_current_key(key)
        on_timer = getattr(self.fn, "on_timer", None)
        if on_timer is None:
            return
        for out in on_timer(time, self._ctx(key, time)):
            self._out.append(out)
            self._out_ts.append(out_ts)

    def _on_event_timer(self, time, key, _ns) -> None:
        self._fire_timer(time, key, time)

    def _on_proc_timer(self, time, key, _ns) -> None:
        # a processing-time timer's output carries no event timestamp
        # (MIN_TIMESTAMP), so no wall-clock epoch enters event time
        self._fire_timer(time, key, MIN_TIMESTAMP)

    def on_processing_time(self, now_ms: int) -> None:
        self.timers.advance_processing_time(now_ms)
        self._flush()

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        for v, ts in zip(values, timestamps):
            key = self.key_selector(v)
            self.state.set_current_key(key)
            for out in self.fn.process_element(v, self._ctx(key, int(ts))):
                self._out.append(out)
                self._out_ts.append(int(ts))
        self._flush()

    def on_watermark(self, watermark: int) -> None:
        self.timers.advance_watermark(watermark)
        self._flush()
        super().on_watermark(watermark)

    def _flush(self) -> None:
        if self._out:
            if self.downstream:
                self.downstream.on_batch(obj_array(self._out),
                                         np.asarray(self._out_ts, dtype=np.int64))
            # cleared without a consumer too: a step read only through its
            # side output must not pile its main output up
            self._out, self._out_ts = [], []
        if self._side_buf:
            for tag_id, (vals, tss) in self._side_buf.items():
                if vals:
                    self.emit_side(tag_id, obj_array(vals), np.asarray(tss, dtype=np.int64))
            self._side_buf = {}

    def snapshot(self) -> dict:
        return {"state": self.state.snapshot(), "timers": self.timers.snapshot()}

    def restore(self, snap: dict) -> None:
        self.state.restore(snap["state"])
        self.timers.restore(snap["timers"])


class CepRunner(StepRunner):
    """Keyed CEP pattern matching (CepOperator.java:83): records buffer per
    key, matches come out at the watermark."""

    def __init__(self, step: Step, config: Configuration):
        from flink_tpu_torch.cep.operator import CepOperator

        t = step.terminal
        self.key_selector = t.config["key_selector"]
        self.op = CepOperator(t.config["pattern"], t.config.get("select_fn"))
        self.uid = t.uid

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        for v, ts in zip(values, timestamps):
            self.op.process_record(self.key_selector(v), v, int(ts))

    def on_watermark(self, watermark: int) -> None:
        self.op.process_watermark(watermark)
        out = self.op.drain_output()
        if out and self.downstream:
            self.downstream.on_batch(obj_array([r for (_k, _w, r, _t) in out]),
                                     np.asarray([t for (_k, _w, _r, t) in out], dtype=np.int64))
        super().on_watermark(watermark)

    def snapshot(self) -> dict:
        return {"operator": self.op.snapshot()}

    def restore(self, snap: dict) -> None:
        self.op.restore(snap["operator"])


class UnionRunner(StepRunner):
    """N-way stream union: batches pass through, and the base class's valve
    min-combines the inputs' watermarks (DataStream.union)."""

    def __init__(self, step: Step):
        self.num_inputs = len(step.inputs)
        self.uid = step.terminal.uid

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        if self.downstream:
            self.downstream.on_batch(values, timestamps)


class CoMapRunner(StepRunner):
    """Non-keyed connected streams: fn1 on input 0, fn2 on input 1
    (ConnectedStreams.map/flatMap)."""

    num_inputs = 2

    def __init__(self, step: Step):
        t = step.terminal
        self.fns = (t.config["fn1"], t.config["fn2"])
        self.flat = t.kind == "co_flat_map"
        self.uid = t.uid

    def on_batch_n(self, ordinal: int, values, timestamps) -> None:
        fn = self.fns[ordinal]
        ts = np.asarray(timestamps, dtype=np.int64)
        if self.flat:
            out, out_ts = [], []
            for v, tt in zip(values, ts):
                for o in fn(v):
                    out.append(o)
                    out_ts.append(int(tt))
            if out and self.downstream:
                self.downstream.on_batch(obj_array(out), np.asarray(out_ts, dtype=np.int64))
        elif len(ts) and self.downstream:
            self.downstream.on_batch(obj_array([fn(v) for v in values]), ts)

    def on_batch(self, values, timestamps) -> None:  # pragma: no cover
        raise AssertionError("CoMapRunner consumes via input gates")


class KeyedCoProcessRunner(KeyedProcessRunner):
    """A keyed two-input process function: both inputs key into the same
    state backend and timers (KeyedCoProcessFunction), which is the point
    of connect() over union(). Only the two-gate dispatch differs from the
    one-input runner."""

    num_inputs = 2

    def __init__(self, step: Step, config: Configuration):
        t = step.terminal
        self.key_selectors = (t.config["key_selector1"], t.config["key_selector2"])
        self._init_keyed(t, config)

    def on_batch_n(self, ordinal: int, values, timestamps) -> None:
        ks = self.key_selectors[ordinal]
        process = self.fn.process_element1 if ordinal == 0 else self.fn.process_element2
        for v, ts in zip(values, np.asarray(timestamps, dtype=np.int64)):
            key = ks(v)
            self.state.set_current_key(key)
            for out in process(v, self._ctx(key, int(ts))):
                self._out.append(out)
                self._out_ts.append(int(ts))
        self._flush()

    def on_batch(self, values, timestamps) -> None:  # pragma: no cover
        raise AssertionError("KeyedCoProcessRunner consumes via input gates")


class BroadcastProcessRunner(StepRunner):
    """The broadcast state pattern (BroadcastConnectedStream.process): gate 1
    carries the broadcast stream, whose elements update operator-wide
    state; gate 0's elements read it through a read-only view."""

    num_inputs = 2

    def __init__(self, step: Step, config: Configuration):
        t = step.terminal
        self.fn = t.config["process_fn"]
        self.state: Dict[Any, Any] = {}
        self._view = types.MappingProxyType(self.state)  # a live read-only view
        self._out: List = []
        self._out_ts: List[int] = []
        self.uid = t.uid

    def on_batch_n(self, ordinal: int, values, timestamps) -> None:
        ts = np.asarray(timestamps, dtype=np.int64)
        if ordinal == 1:
            for v in values:
                self.fn.process_broadcast_element(v, self.state)
            return
        for v, tt in zip(values, ts):
            for out in self.fn.process_element(v, self._view):
                self._out.append(out)
                self._out_ts.append(int(tt))
        if self._out:
            if self.downstream:
                self.downstream.on_batch(obj_array(self._out),
                                         np.asarray(self._out_ts, dtype=np.int64))
            self._out, self._out_ts = [], []

    def on_batch(self, values, timestamps) -> None:  # pragma: no cover
        raise AssertionError("BroadcastProcessRunner consumes via input gates")

    def snapshot(self) -> dict:
        return {"broadcast": dict(self.state)}

    def restore(self, snap: dict) -> None:
        self.state = dict(snap["broadcast"])
        self._view = types.MappingProxyType(self.state)


class WindowJoinRunner(StepRunner):
    """Keyed event-time window join / coGroup, on the host: the oracle of
    the device join (`runtime/device_join_operator.py`).

    The reference implements join as coGroup over tagged inputs flowing into
    one WindowOperator (JoinedStreams.java:101 'Join is implemented on top
    of CoGroup', CoGroupedStreams.java WithWindow.apply): elements of both
    sides buffer per (key, window); when the watermark passes the window
    end, join emits one result per left x right pair, coGroup emits one
    result per window from both element lists. Late elements (window already
    fired) are dropped, matching WindowOperator.isWindowLate."""

    num_inputs = 2

    def __init__(self, step: Step, config: Configuration):
        t = step.terminal
        self.key_selectors = (t.config["key_selector1"], t.config["key_selector2"])
        self.assigner = t.config["assigner"]
        if not self.assigner.is_event_time:
            raise ValueError("window joins support event-time assigners")
        self.join_fn = t.config.get("join_fn")
        self.cogroup = t.kind == "co_group"
        # (key, window_start, window_end) -> ([left...], [right...])
        self._buf: Dict[tuple, tuple] = {}
        self._wm = MIN_WATERMARK
        self.num_late_dropped = 0
        self.uid = t.uid

    def on_batch_n(self, ordinal: int, values, timestamps) -> None:
        ks = self.key_selectors[ordinal]
        for v, ts in zip(values, np.asarray(timestamps, dtype=np.int64)):
            key = ks(v)
            for w in self.assigner.assign_windows(v, int(ts)):
                if w.end - 1 <= self._wm:
                    self.num_late_dropped += 1
                    continue
                sides = self._buf.get((key, w.start, w.end))
                if sides is None:
                    sides = ([], [])
                    self._buf[(key, w.start, w.end)] = sides
                sides[ordinal].append(v)

    def on_batch(self, values, timestamps) -> None:  # pragma: no cover
        raise AssertionError("WindowJoinRunner consumes via input gates")

    def on_watermark(self, watermark: int) -> None:
        self._wm = max(self._wm, watermark)
        out, out_ts = [], []
        # fire in (window end, key-insertion) order, mirroring the oracle's
        # timer ordering
        ripe = [k for k in self._buf if k[2] - 1 <= self._wm]
        ripe.sort(key=lambda k: k[2])
        for k in ripe:
            left, right = self._buf.pop(k)
            max_ts = k[2] - 1
            if self.cogroup:
                out.append(self.join_fn(left, right))
                out_ts.append(max_ts)
            else:
                for lv in left:
                    for rv in right:
                        out.append(self.join_fn(lv, rv))
                        out_ts.append(max_ts)
        if out and self.downstream:
            self.downstream.on_batch(obj_array(out), np.asarray(out_ts, dtype=np.int64))
        super().on_watermark(watermark)

    def snapshot(self) -> dict:
        return {
            "buf": {k: (list(l), list(r)) for k, (l, r) in self._buf.items()},
            "wm": self._wm,
            "late": self.num_late_dropped,
        }

    def restore(self, snap: dict) -> None:
        self._buf = {k: (list(l), list(r)) for k, (l, r) in snap["buf"].items()}
        self._wm = snap["wm"]
        self.num_late_dropped = snap["late"]


class SinkRunner(StepRunner):
    _latency_hist = None

    def __init__(self, step: Step):
        sink = step.terminal.config["sink"]
        self.writer = sink.create_writer()
        self.committer = sink.create_committer()
        self.uid = step.terminal.uid

    def register_metrics(self, group) -> None:
        super().register_metrics(group)
        # per-marker pipeline latency at the sink: source wall clock to
        # sink arrival (the reference's LatencyMarker histogram)
        self._latency_hist = group.histogram("pipelineLatencyMs")

    def on_marker(self, wall_ms: float) -> None:
        if self._latency_hist is not None:
            self._latency_hist.update(time.time() * 1000.0 - wall_ms)
        super().on_marker(wall_ms)

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        self.writer.write_batch(values, timestamps)

    def commit_epoch(self, epoch_id: str = "final") -> None:
        if self.committer is not None:
            self.committer.commit(self.writer.prepare_commit(epoch_id))

    def on_end(self) -> None:
        self.commit_epoch("final")
        self.writer.close()

    def snapshot(self) -> dict:
        # collect-style sinks are stateful: emissions before the cut belong
        # to the checkpoint (a failed attempt's emissions after it are
        # discarded and re-fired on replay)
        store = getattr(self.writer, "store", None)
        return {"collected": list(store)} if store is not None else {}

    def restore(self, snap: dict) -> None:
        store = getattr(self.writer, "store", None)
        if store is not None and "collected" in snap:
            store[:] = snap["collected"]


class IterationHeadRunner(StepRunner):
    """An iteration's head (StreamIterationHead): forwards the initial
    stream and re-injects the feedback batches its tail queues. Watermarks
    cross only the initial edge, and the sources' final watermark and end
    are held until the run loop has drained the feedback to quiescence:
    bounded inputs end exactly when the loop body stops feeding records
    back."""

    def __init__(self, step: Step):
        t = step.terminal
        self.uid = t.uid
        self.max_rounds = int(t.config.get("max_rounds", 10000))
        self._feedback: deque = deque()     # (values, timestamps) batches
        self._end_held = False
        self._held_wm: Optional[int] = None
        self._closed = False

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        if self.downstream:
            self.downstream.on_batch(values, timestamps)

    def on_watermark(self, watermark: int) -> None:
        if watermark >= MAX_WATERMARK - 1 and not self._closed:
            # the final flush must not fire downstream windows while
            # feedback can still inject records into them
            self._held_wm = max(self._held_wm or MIN_WATERMARK, watermark)
            return
        super().on_watermark(watermark)

    def on_end(self) -> None:
        self._end_held = True   # released by finish_iteration()

    # -- the feedback edge (the tail and the run loop call these) ----------
    def enqueue_feedback(self, values, timestamps) -> None:
        if len(timestamps):
            self._feedback.append((values, np.asarray(timestamps, dtype=np.int64)))

    def has_feedback(self) -> bool:
        return bool(self._feedback)

    def drain_round(self) -> int:
        """Re-inject the batches queued at the round's start (the batches
        their processing queues belong to the next round); returns the
        records sent."""
        sent = 0
        for _ in range(len(self._feedback)):
            values, ts = self._feedback.popleft()
            sent += len(ts)
            if self.downstream:
                self.downstream.on_batch(values, ts)
        return sent

    def finish_iteration(self) -> None:
        """Quiescence: release the held final watermark and end."""
        self._closed = True
        if self._held_wm is not None:
            StepRunner.on_watermark(self, self._held_wm)
            self._held_wm = None
        if self._end_held:
            StepRunner.on_end(self)

    def snapshot(self) -> dict:
        if not self._feedback:
            return {}
        return {"feedback": [(obj_array(list(v)), ts.copy()) for v, ts in self._feedback]}

    def restore(self, snap: dict) -> None:
        self._feedback = deque((v, np.asarray(ts, dtype=np.int64))
                               for v, ts in snap.get("feedback", ()))


class IterationTailRunner(StepRunner):
    """An iteration's tail (StreamIterationTail): every batch it receives is
    queued on its head's feedback edge; watermarks and the end stop here."""

    def __init__(self, step: Step):
        t = step.terminal
        self.uid = t.uid
        self.head_transform_id = t.config["head"].id
        self.head: Optional[IterationHeadRunner] = None  # wired in build_runners

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        self.head.enqueue_feedback(values, timestamps)

    def on_watermark(self, watermark: int) -> None:
        pass

    def on_end(self) -> None:
        pass


def _make_runner(step: Step, config: Configuration, device: torch.device) -> StepRunner:
    if step.terminal is None:
        return ChainRunner(step.chain)
    kind = step.terminal.kind
    if kind == "window_aggregate":
        return WindowStepRunner(step, config, device)
    if kind == "reduce":
        return KeyedReduceRunner(step, config)
    if kind == "process_keyed":
        return KeyedProcessRunner(step, config)
    if kind == "async_map":
        from flink_tpu_torch.runtime.async_io import AsyncMapRunner

        return AsyncMapRunner(step.terminal, config)
    if kind == "cep":
        return CepRunner(step, config)
    if kind == "sink":
        return SinkRunner(step)
    if kind == "union":
        return UnionRunner(step)
    if kind in ("co_map", "co_flat_map"):
        return CoMapRunner(step)
    if kind == "co_process":
        return KeyedCoProcessRunner(step, config)
    if kind == "broadcast_process":
        return BroadcastProcessRunner(step, config)
    if kind == "group_agg":
        from flink_tpu_torch.runtime.group_agg_operator import GroupAggRunner

        return GroupAggRunner(step, config, device)
    if kind in ("window_join", "co_group"):
        # device reroute: eligible event-time window equi-joins run on the
        # bucketed-ring pipeline; every refusal is a catalogued
        # JoinUnsupported reason, and the host runner stays the oracle
        if kind == "window_join":
            from flink_tpu_torch.joins.spec import JoinUnsupported
            from flink_tpu_torch.runtime.device_join_operator import DeviceJoinRunner

            try:
                return DeviceJoinRunner(step, config, device)
            except JoinUnsupported:
                pass
        return WindowJoinRunner(step, config)
    if kind == "regular_join":
        from flink_tpu_torch.runtime.stream_join_operator import StreamingJoinRunner

        return StreamingJoinRunner(step, config)
    if kind == "iteration_head":
        return IterationHeadRunner(step)
    if kind == "iteration_tail":
        return IterationTailRunner(step)
    if kind == "stage_output":
        from flink_tpu_torch.runtime.stages import StageOutputRunner

        return StageOutputRunner(step)
    raise NotImplementedError(kind)


def build_runners(graph: StepGraph, config: Configuration, device=None):
    """Build the runner DAG: one runner per step, fan-out edges wired by
    input ordinal. Returns (runners in topo order, source feed map
    {source_transformation_id: [(entry_runner, ordinal)]}).

    Whole-graph fusion happens here: eligible window steps get a
    DeviceChainRunner that absorbs the traceable chain step feeding them.
    With execution.window.shared-partials (the default), correlated window
    siblings (graph/window_sharing.py) collapse into one
    SharedWindowRunner; the other members get SharedWindowSiblingRunners
    whose input edges are not wired, so the stream is ingested once.
    `device=None` runs on CUDA or raises."""
    from flink_tpu_torch.graph.fusion import plan_device_chains
    from flink_tpu_torch.graph.window_sharing import plan_shared_windows

    device = resolve_device(device)
    plans, absorbed = {}, set()
    if config.get(ExecutionOptions.CHAIN_FUSION) and config.get(ExecutionOptions.FUSED_WINDOWS):
        plans, absorbed = plan_device_chains(graph)

    shared_of: Dict[int, tuple] = {}    # id(step) -> (plan, spec)
    edge_silent: set = set()            # member steps with unwired inputs
    if plans and config.get(ExecutionOptions.SHARED_PARTIALS):
        for sw in plan_shared_windows(graph, plans):
            for spec, member in enumerate(sw.members):
                shared_of[id(member)] = (sw, spec)
                plans.pop(id(member), None)
                if spec > 0:
                    edge_silent.add(id(member))
            if sw.absorbed is not None:
                absorbed.add(id(sw.absorbed))

    runner_of: Dict[int, StepRunner] = {}
    runners: List[StepRunner] = []
    for step in graph.steps:
        if id(step) in absorbed:
            continue
        if id(step) in shared_of:
            sw, spec = shared_of[id(step)]
            r = (SharedWindowRunner(step, sw, config, device) if spec == 0
                 else SharedWindowSiblingRunner(step, spec))
        elif id(step) in plans:
            r = DeviceChainRunner(step, plans[id(step)], config, device)
        else:
            r = _make_runner(step, config, device)
        if len(step.inputs) > 1:
            r.num_inputs = len(step.inputs)
        runner_of[id(step)] = r
        runners.append(r)
    # leaders learn their members' runners (spec order) for the fan-out
    for step in graph.steps:
        ent = shared_of.get(id(step))
        if ent is not None and ent[1] == 0:
            runner_of[id(step)].member_runners = [runner_of[id(m)] for m in ent[0].members]

    feeds: Dict[int, List] = {}
    for step in graph.steps:
        if id(step) in absorbed or id(step) in edge_silent:
            continue
        r = runner_of[id(step)]
        if id(step) in shared_of:
            step_inputs = shared_of[id(step)][0].inputs
        elif id(step) in plans:
            step_inputs = plans[id(step)].inputs
        else:
            step_inputs = step.inputs
        for entity, ordinal, tag in step_inputs:
            if isinstance(entity, Transformation):       # a source feeds this
                if tag is not None:
                    raise ValueError("sources have no side-output channels")
                feeds.setdefault(entity.id, []).append((r, ordinal))
            elif tag is not None:
                runner_of[id(entity)].side_channel(tag).add(r, ordinal)
            else:
                up = runner_of[id(entity)]
                if up.downstream is None:
                    up.downstream = _FanOut()
                up.downstream.add(r, ordinal)
    for r in runners:
        if r.downstream is None:
            r.downstream = _FanOut()
    # feedback edges, tail -> head, matched by the head transformation the
    # tail's close_with recorded (the cycle exists only at run time)
    heads = {step.terminal.id: runner_of[id(step)] for step in graph.steps
             if step.terminal is not None and step.terminal.kind == "iteration_head"}
    for r in runners:
        if isinstance(r, IterationTailRunner):
            if r.head_transform_id not in heads:
                raise ValueError("iteration tail closed with a head that is not part of "
                                 "this pipeline")
            r.head = heads[r.head_transform_id]
    return runners, feeds


def register_runner_metrics(runners: List[StepRunner], registry: MetricRegistry) -> None:
    for i, r in enumerate(runners):
        r.register_metrics(registry.group("job", "operator", getattr(r, "uid", f"chain-{i}")))


class JobCancelledException(Exception):
    pass


class JobRuntime:
    """One running attempt of a job: sources, watermarks,
    runners and the end-of-input flush, plus the checkpoint capture and
    restore surface (capture happens between steps, so alignment is
    free)."""

    class _SourceDriver:
        """One source's read state: enumerator/reader/watermark generator
        plus the entry gates it feeds."""

        def __init__(self, transform: Transformation, feeds: List):
            cfg = transform.config
            self.uid = transform.uid
            self.source = cfg["source"]
            strategy: Optional[WatermarkStrategy] = cfg.get("watermark_strategy")
            self.generator = strategy.create_generator() if strategy else None
            self.assigner = strategy.timestamp_assigner if strategy else None
            self.enumerator = self.source.create_enumerator()
            self.reader = self.source.create_reader()
            self.current_split = None
            self.done = False
            self.finished_signalled = False
            self.feeds = feeds              # [(runner, ordinal)]
            self.last_marker_wall = 0.0     # marker-interval throttle state

        def emit_batch(self, values, ts) -> None:
            _deliver(self.feeds, values, ts)

        def emit_watermark(self, wm: int) -> None:
            for r, o in self.feeds:
                r.on_watermark_n(o, wm)

        def emit_marker(self, wall_ms: float) -> None:
            for r, _o in self.feeds:
                r.on_marker(wall_ms)

        def finish(self) -> None:
            """End of this source: flush its watermark and close its gates
            (idempotent)."""
            if self.finished_signalled:
                return
            self.finished_signalled = True
            self.emit_watermark(MAX_WATERMARK - 1)
            for r, o in self.feeds:
                r.on_end_n(o)

        def snapshot(self) -> dict:
            return {
                "pending_splits": self.enumerator.snapshot(),
                "current_split": self.current_split,
                "reader_position": self.reader.snapshot_position(),
                "done": self.done,
                "generator": self.generator.snapshot() if self.generator else None,
            }

        def restore(self, snap: dict) -> None:
            self.enumerator.restore(snap["pending_splits"])
            self.current_split = snap["current_split"]
            self.done = snap["done"]
            if self.current_split is not None:
                self.reader.add_split(self.current_split)
                self.reader.restore_position(snap["reader_position"])
            if self.generator is not None and snap.get("generator") is not None:
                self.generator.restore(snap["generator"])

    def __init__(self, graph: StepGraph, config: Configuration, device=None,
                 registry: Optional[MetricRegistry] = None, traces=None):
        # pipeline.parallelism is read by no runner, as in the JAX package:
        # the job runs as one attempt whatever it is set to, and keyed
        # state spreads over devices through parallel.mesh.* instead
        self.graph = graph
        self.config = config
        self.traces = traces    # optional TraceRegistry (emission-stall spans)
        self.device = resolve_device(device)
        self.runners, feeds = build_runners(graph, config, self.device)
        self.sources = [JobRuntime._SourceDriver(t, feeds.get(t.id, []))
                        for t in graph.sources]
        # operator coordinators (runtime/coordination.py): an operator
        # function declaring create_coordinator() gets a job-scope
        # coordinator and its event bus. Candidates are the terminal
        # runners' fn, both sides of a co-transform and the chain
        # transforms' fns, under keys that stay the same across rebuilds,
        # so a coordinator's state survives a restore
        from flink_tpu_torch.runtime.coordination import wire as _wire_coordinator

        self.coordinators = {}
        for idx, r in enumerate(self.runners):
            uid = getattr(r, "uid", f"coordinator@{idx}")
            candidates = []
            if getattr(r, "fn", None) is not None:
                candidates.append((uid, r.fn))
            for j, f in enumerate(getattr(r, "fns", ()) or ()):
                candidates.append((f"{uid}#{j}", f))
            for t in getattr(r, "transforms", ()) or ():
                f = t.config.get("fn")
                if f is not None:
                    candidates.append((t.uid, f))
            for key, f in candidates:
                coord = _wire_coordinator(f)
                if coord is not None:
                    self.coordinators[key] = coord
        self.iteration_heads = [r for r in self.runners if isinstance(r, IterationHeadRunner)]
        self.records_in = 0
        # observability: job-scope throughput, busy/idle/backpressure
        # ratios, step latency and device time
        self.registry = registry or MetricRegistry()
        registered_before = set(self.registry.all_metrics())
        register_runner_metrics(self.runners, self.registry)
        job_group = self.registry.group("job")
        self.records_meter = job_group.meter("numRecordsInPerSecond")
        self.step_latency = job_group.histogram("stepLatencyMs")
        self.io = TaskIOMetrics()   # no exchange senders: nothing backpressures
        self.io.register(job_group)
        job_group.gauge("numRecordsIn", lambda: self.records_in, fold="sum", kind="counter")
        # the shards this attempt's keyed state spans (1: one device); MAX,
        # since each shard reports its own mesh's size
        job_group.gauge("meshDevices", self.mesh_devices, fold="max")
        # SQL jobs only: 1 when every SQL window step selected the fused
        # runner (a device join counts), 0 when any fell back
        sql_runners = tuple(r for r in self.runners if getattr(r, "sql_origin", False))
        if sql_runners:
            from flink_tpu_torch.runtime.device_join_operator import DeviceJoinRunner

            job_group.gauge("sqlFusedSelected", lambda rs=sql_runners: int(all(
                isinstance(r, (DeviceChainRunner, DeviceJoinRunner)) for r in rs)),
                fold="min")
        job_group.gauge("deviceTimeMsTotal", lambda: sum(
            r.device_timer.total_s * 1000.0 for r in self.runners
            if getattr(r, "device_timer", None) is not None),
            fold="sum", kind="counter")
        # the device plane: the job-level compile, roofline and skew gauges
        # (job.device.*, job.keySkew); compile events also ride the trace
        # registry as 'device'-scope spans when one is bound
        tracked = [r for r in self.runners if getattr(r, "device_stats", None) is not None]
        trackers = [r.device_stats for r in tracked]
        collectors = [r.key_stats for r in self.runners
                      if getattr(r, "key_stats", None) is not None]
        if trackers:
            dg = job_group.add_group("device")
            dg.gauge("numCompiles", lambda: sum(t.num_compiles for t in trackers),
                     fold="sum", kind="counter")
            dg.gauge("numRecompiles", lambda: sum(t.num_recompiles for t in trackers),
                     fold="sum", kind="counter")
            dg.gauge("compileTimeMsTotal",
                     lambda: round(sum(t.compile_ms_total for t in trackers), 3),
                     fold="sum", kind="counter")
            dg.gauge("recompileStorm", lambda: max(t.recompile_storm() for t in trackers),
                     fold="max")
            for key in ("hbmUtilizationPct", "flopsUtilizationPct"):
                dg.gauge(key, lambda k=key: max(
                    (r.device_roofline()[k] for r in tracked), default=0.0), fold="mean")
        if collectors:
            def _job_skew(cs=tuple(collectors)):
                skews = [v for v in (c.skew() for c in cs) if v is not None]
                return max(skews) if skews else None

            job_group.gauge("keySkew", _job_skew, fold="max")
        if traces is not None and trackers:
            from flink_tpu_torch.metrics.device_stats import compile_event_span

            for t in trackers:
                if t.on_event is None:
                    t.on_event = (lambda ev, _tr=traces: _tr.report(compile_event_span(ev)))
        # emission latency: the job's p99 over every operator (MAX across
        # shards), and the outlier EmissionStall spans into the trace plane
        em_trackers = tuple(r.emission_tracker for r in self.runners
                            if getattr(r, "emission_tracker", None) is not None)
        if em_trackers:
            job_group.gauge("p99EmissionLatencyMs", lambda ts=em_trackers: (
                _merge_emission_snapshots([t.snapshot() for t in ts]).get("p99", 0.0)),
                fold="max")
            if traces is not None:
                from flink_tpu_torch.metrics.traces import Span

                for t in em_trackers:
                    if t.span_sink is None:
                        t.span_sink = (lambda scope, name, s0, s1, a, _tr=traces:
                                       _tr.report(Span(scope, name, s0, s1, a)))
        # the profiler capture surface (observability.profiler.*): where
        # each attempt's trace landed, for device_snapshot()
        self.profiler_captures = 0
        self.last_profiler_capture_dir: Optional[str] = None
        self._marker_interval = config.get(ObservabilityOptions.MARKER_INTERVAL_MS)
        self._sampling_interval = config.get(ObservabilityOptions.SAMPLING_INTERVAL_MS)
        # the gauges this attempt registered: their closures hold its
        # runners, so a registry that outlives the attempt (the
        # MiniCluster's, across restarts) drops them when the attempt ends
        # (counters, meters and histograms hold no runner and carry on)
        self.gauge_keys = [k for k, m in self.registry.all_metrics().items()
                           if k not in registered_before and isinstance(m, Gauge)]

    # -- checkpoint surface ------------------------------------------------
    def capture(self) -> dict:
        """The job's state at this step boundary, in the JAX package's
        form: numpy arrays and plain data (operators pull device state to
        the host), so either package restores it."""
        runner_snaps = {}
        for r in self.runners:
            snap = r.snapshot()
            if snap:
                runner_snaps[getattr(r, "uid", f"runner-{id(r)}")] = snap
        return {
            "sources": {d.uid: d.snapshot() for d in self.sources},
            "runners": runner_snaps,
            "coordinators": {uid: c.checkpoint() for uid, c in self.coordinators.items()},
            "records_in": self.records_in,
        }

    def restore(self, snap: dict) -> None:
        if "sources" in snap:
            for d in self.sources:
                if d.uid in snap["sources"]:
                    d.restore(snap["sources"][d.uid])
        else:
            # single-source snapshot of the JAX package's pre-DAG layout
            legacy = dict(snap["source"])
            legacy["generator"] = snap.get("generator")
            self.sources[0].restore(legacy)
        for r in self.runners:
            uid = getattr(r, "uid", None)
            if uid is not None and uid in snap["runners"]:
                r.restore(snap["runners"][uid])
        for uid, c in self.coordinators.items():
            if uid in snap.get("coordinators", {}):
                c.restore(snap["coordinators"][uid])
        self.records_in = snap["records_in"]

    def commit_sinks(self, checkpoint_id: int) -> None:
        for r in self.runners:
            if isinstance(r, SinkRunner):
                r.commit_epoch(str(checkpoint_id))

    def operator_state_bytes(self) -> Dict[str, int]:
        """Per-operator state footprint from the operators' own
        state_bytes(): the per-operator breakdown of a completed checkpoint
        record."""
        out: Dict[str, int] = {}
        for idx, r in enumerate(self.runners):
            fn = getattr(getattr(r, "op", None), "state_bytes", None)
            if fn is None:
                continue
            try:
                out[getattr(r, "uid", f"runner-{idx}")] = int(fn())
            except Exception:   # a torn-down operator must not fail a
                continue        # checkpoint's bookkeeping
        return out

    # -- the loop ----------------------------------------------------------
    def mesh_devices(self) -> int:
        """Shards this attempt's keyed state is spread over (the widest
        operator; 1 = one device)."""
        return max((int(fn()) for fn in (
            getattr(getattr(r, "op", None), "mesh_devices", None)
            for r in self.runners) if fn is not None), default=1)

    def mesh_capacity(self) -> Optional[int]:
        """The smallest construction-time key capacity of the operators
        that can run on a mesh (None: no such operator); a rescale target
        is clamped against it, as the rebuilt operators will clamp."""
        caps = [op.mesh_capacity() for op in (getattr(r, "op", None) for r in self.runners)
                if op is not None and hasattr(op, "mesh_capacity")]
        return min(caps) if caps else None

    # -- the key-group routing table (parallel.mesh.skew-rebalance) -------
    def _routed_ops(self):
        for r in self.runners:
            op = getattr(r, "op", None)
            fn = getattr(op, "routing_version", None)
            if callable(fn) and fn() is not None:
                yield op

    def mesh_routing_version(self) -> Optional[int]:
        """Highest routing-table version across the mesh operators (None
        when no operator carries a table)."""
        versions = [op.routing_version() for op in self._routed_ops()]
        return max(versions) if versions else None

    def mesh_group_loads(self):
        """(group_loads [G], current assignment [G], mesh size) of the first
        routed operator that holds data: the skew rebalancer's decision
        input (a device readback); None when no operator carries a table
        or no record has landed in its rings yet."""
        for op in self._routed_ops():
            loads = op.mesh_group_loads()
            if loads is not None and loads.sum() > 0:
                return loads, op.pipe.routing.assign, op.mesh_devices()
        return None

    def set_mesh_routing(self, assign) -> None:
        """Apply a key-group assignment to every routed operator (the
        rebuilt attempt of a rebalance, AFTER its restore: the restore may
        adopt a grown snapshot K and rebuild the table for the new
        capacity). An assignment sized for a DIFFERENT group count is
        skipped, not an error: the geometry changed between decision and
        application, and the rebalancer re-decides from live skew under the
        new table."""
        assign = np.asarray(assign)
        for op in self._routed_ops():
            if assign.shape[0] != op.pipe.routing.G:
                continue
            op.set_routing_assignment(assign)

    def run(
        self,
        coordinator=None,
        cancel_check: Optional[Callable[[], bool]] = None,
        savepoint_request: Optional[Callable[[], Optional[str]]] = None,
        rescale_request: Optional[Callable[[], Optional[int]]] = None,
        rebalance_request: Optional[Callable[[], Optional[Any]]] = None,
    ) -> None:
        """Run to the end of input. At every step boundary: `cancel_check`
        (True raises JobCancelledException), the coordinator's due
        checkpoint, `savepoint_request` (a path writes a savepoint there),
        `rescale_request` (a shard count other than this attempt's raises
        MeshRescaleRequested with a step-aligned capture) and
        `rebalance_request` (a new [G] key-group assignment raises it at
        this attempt's size, carrying the assignment). The coordinator
        commits this attempt's sinks on each completed checkpoint while the
        attempt runs."""
        if coordinator is not None:
            coordinator.register_on_complete(self.commit_sinks)
        profiler = self._start_profiler()
        try:
            self._run_loop(coordinator, cancel_check, savepoint_request, rescale_request,
                           rebalance_request)
        finally:
            if coordinator is not None:
                coordinator.unregister_on_complete(self.commit_sinks)
            if profiler is not None:
                self._stop_profiler(profiler)

    # -- the device plane's payload and the profiler ---------------------
    def _start_profiler(self):
        """A running torch.profiler capture of this attempt
        (observability.profiler.enabled): CUDA activity (with the host's
        beside it: CUDA-only sessions have come back short on the H100) on
        the card, CPU activity otherwise; None when off or when the profiler
        does not start (warned, never failing the job, as the JAX
        runtime's)."""
        if not self.config.get(ObservabilityOptions.PROFILER_ENABLED):
            return None
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities)
            prof.__enter__()
        except Exception as e:  # noqa: BLE001 — observability never fails the job
            warnings.warn(f"torch.profiler trace capture unavailable: {e!r}", RuntimeWarning)
            return None
        return prof

    def _stop_profiler(self, prof) -> None:
        """Stop the capture, export its Chrome trace into
        observability.profiler.dir and count it."""
        import os

        profile_dir = self.config.get(ObservabilityOptions.PROFILER_DIR)
        try:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                profile_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
            # the capture is not write-only: count it and remember where it
            # landed, for device_snapshot()
            self.profiler_captures += 1
            self.last_profiler_capture_dir = profile_dir
        except Exception as e:  # noqa: BLE001 — observability never fails the job
            logging.getLogger(__name__).debug("torch.profiler export failed: %r", e)

    def device_snapshot(self) -> Dict[str, Any]:
        """The device-plane payload (the JAX package's /jobs/:id/device
        body, served by runtime/rest.py): the merged compile block,
        per-operator cost/roofline/phase/key telemetry, and the profiler
        capture surface. Plain data, JSON-safe."""
        from flink_tpu_torch.metrics.device_stats import (
            empty_device_payload,
            merge_compile_payloads,
        )

        payload = empty_device_payload()
        ops: Dict[str, Any] = {}
        compile_payloads = []
        for idx, r in enumerate(self.runners):
            op = getattr(r, "op", None)
            tracker = getattr(r, "device_stats", None)
            ks = getattr(r, "key_stats", None)
            timer = getattr(r, "device_timer", None)
            tier_fn = getattr(op, "tier_payload", None)
            tier = tier_fn() if callable(tier_fn) else None
            routing_fn = getattr(op, "routing_payload", None)
            routing = routing_fn() if callable(routing_fn) else None
            if tracker is None and ks is None and tier is None and routing is None:
                continue
            entry: Dict[str, Any] = {}
            if timer is not None:
                entry["deviceTimeMsTotal"] = round(timer.total_s * 1000.0, 3)
                entry["deviceDispatches"] = timer.dispatches
            if tracker is not None:
                cp = tracker.payload()
                compile_payloads.append(cp)
                entry["compile"] = cp
                entry.update(r.device_roofline())
            phases = getattr(op, "phase_totals", None)
            if callable(phases):
                entry["phases"] = phases()
            if ks is not None:
                entry["keys"] = ks.payload()
            if tier is not None:
                entry["tier"] = tier
            if routing is not None:
                entry["routing"] = routing
            ops[getattr(r, "uid", f"runner-{idx}")] = entry
        payload["operators"] = ops
        payload["compile"] = merge_compile_payloads(
            compile_payloads,
            history_size=self.config.get(ObservabilityOptions.DEVICE_RECOMPILE_HISTORY_SIZE))
        payload["enabled"] = bool(ops)
        payload["profiler"] = {
            "enabled": self.config.get(ObservabilityOptions.PROFILER_ENABLED),
            "captures": self.profiler_captures,
            "last_capture_dir": self.last_profiler_capture_dir,
        }
        return payload

    def _run_loop(self, coordinator, cancel_check, savepoint_request,
                  rescale_request=None, rebalance_request=None) -> None:
        batch_size = self.config.get(ExecutionOptions.BATCH_SIZE)
        for d in self.sources:
            if d.current_split is None and not d.done:
                d.current_split = d.enumerator.next_split()
                if d.current_split is not None:
                    d.reader.add_split(d.current_split)
                else:
                    d.done = True
            if d.done:
                # zero-split or restored-as-done sources still flush their
                # watermark and end contribution
                d.finish()
        last_tick = 0.0     # the first step boundary ticks, as the JAX loop's does
        # round-robin over sources, one batch per turn; checkpoints align at
        # batch boundaries whichever source produced the batch
        while any(not d.done for d in self.sources):
            for d in self.sources:
                if d.done:
                    continue
                loop_t0 = time.perf_counter()
                if cancel_check is not None and cancel_check():
                    raise JobCancelledException()
                batch = d.reader.poll_batch(batch_size)
                if batch is None:
                    d.current_split = d.enumerator.next_split()
                    busy_dt = 0.0
                    if d.current_split is None:
                        d.done = True
                        busy_t0 = time.perf_counter()
                        d.finish()
                        busy_dt = time.perf_counter() - busy_t0
                    else:
                        d.reader.add_split(d.current_split)
                    self.io.record_step(busy_dt, time.perf_counter() - loop_t0)
                    continue
                values, ts = batch.values, batch.timestamps
                if d.assigner is not None:
                    ts = np.asarray([d.assigner(v, int(x)) for v, x in zip(values, ts)],
                                    dtype=np.int64)
                self.records_in += len(batch)
                self.records_meter.mark(len(batch))
                busy_t0 = time.perf_counter()
                # the latency marker is stamped before the synchronous push,
                # so a sink's (now - stamp) is this batch's real transit;
                # observability.latency-markers.interval-ms spaces them (0:
                # one a batch, -1: none)
                t_mark = None
                if self._marker_interval >= 0:
                    now_wall = time.time() * 1000.0
                    if now_wall - d.last_marker_wall >= self._marker_interval:
                        d.last_marker_wall = t_mark = now_wall
                d.emit_batch(values, ts)
                if t_mark is not None:
                    d.emit_marker(t_mark)
                if d.generator is not None:
                    wm = (d.generator.on_batch_np(ts)
                          if hasattr(d.generator, "on_batch_np") else None)
                    if wm is None:
                        for v, x in zip(values, ts):
                            d.generator.on_event(v, int(x))
                        wm = d.generator.on_periodic_emit()
                    if wm is not None and wm > MIN_WATERMARK:
                        d.emit_watermark(wm)
                if self.iteration_heads:
                    # feedback runs to quiescence at the step boundary, so a
                    # checkpoint captures (almost) no feedback in flight
                    self._drain_iterations()
                step_dt = time.perf_counter() - busy_t0
                self.step_latency.update(step_dt * 1000)
                # step boundary: checkpoints and savepoints align here
                if coordinator is not None:
                    coordinator.maybe_trigger(self.capture)
                if savepoint_request is not None:
                    path = savepoint_request()
                    if path is not None:
                        self._write_savepoint(path)
                if rescale_request is not None:
                    target = rescale_request()
                    if target is not None and target != self.mesh_devices():
                        # a live mesh rescale: the job master rebuilds this
                        # runtime over the new shard count and restores this
                        # capture (the checkpoint path's), exactly-once
                        raise MeshRescaleRequested(target, self.capture())
                if rebalance_request is not None:
                    assign = rebalance_request()
                    if assign is not None:
                        # a skew rebalance: the rescale's capture and
                        # restore at this attempt's size, with the new
                        # key-group table applied to the rebuilt runtime
                        # (placement never changes a result)
                        raise MeshRescaleRequested(self.mesh_devices(), self.capture(),
                                                   routing=assign)
                now_ms = time.time() * 1000.0
                if now_ms - last_tick >= 50.0:
                    # the processing-time service's tick (the JAX run loop's
                    # 50 ms period): drive wall-clock timers
                    last_tick = now_ms
                    for r in self.runners:
                        r.on_processing_time(int(now_ms))
                    # and the busy/idle sampling window
                    self.io.maybe_sample(self._sampling_interval)
                self.io.record_step(step_dt, time.perf_counter() - loop_t0)
        # end of input: every source's final watermark + end signal fires
        # all remaining windows downstream
        for d in self.sources:
            d.finish()
        if self.iteration_heads:
            # the heads held the final watermark and end: drain the feedback
            # left to quiescence, then release them
            self._drain_iterations()
            for h in self.iteration_heads:
                h.finish_iteration()

    def _drain_iterations(self) -> None:
        """Feedback rounds, round-robin over the iteration heads, until every
        feedback queue is empty (the loop bodies stopped feeding records
        back). Each head's max_rounds bounds the rounds in which it still
        had feedback, so a loop that does not converge trips its own bound."""
        rounds = {id(h): 0 for h in self.iteration_heads}
        while any(h.has_feedback() for h in self.iteration_heads):
            for h in self.iteration_heads:
                if not h.has_feedback():
                    continue
                rounds[id(h)] += 1
                if rounds[id(h)] > h.max_rounds:
                    raise RuntimeError(
                        f"iteration '{h.uid}' did not reach quiescence "
                        f"within max_rounds={h.max_rounds}; the loop body "
                        "must eventually stop emitting feedback records "
                        "(or raise iterate(max_rounds=...))")
                h.drain_round()

    def _write_savepoint(self, path: str) -> None:
        from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage

        data = self.capture()
        data["savepoint"] = True
        FsCheckpointStorage(path).save(0, data)


class LocalPipelineExecutor:
    """Single-host execution: one synchronous attempt, no recovery."""

    def __init__(self, config: Optional[Configuration] = None, device=None):
        self.config = config or Configuration()
        self.device = device

    def execute(self, graph: StepGraph, job_name: str = "job") -> JobExecutionResult:
        runtime = JobRuntime(graph, self.config, self.device)
        t0 = time.perf_counter()
        runtime.run()
        runtime_ms = (time.perf_counter() - t0) * 1000
        return JobExecutionResult(job_name=job_name, runtime_ms=runtime_ms,
                                  records_in=runtime.records_in,
                                  metrics={"records_in": runtime.records_in})
