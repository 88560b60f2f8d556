"""Local pipeline executor: the host-driven stepped dataflow loop.

Counterpart of the subset of `flink_tpu/runtime/executor.py` that a keyed
event-time window job or a continuous aggregate runs. The source reader
yields a columnar batch; the batch flows through push-based StepRunners (a
stateless chain, a keyed window step or a continuous aggregate, then
sinks), and the source's watermark advances between steps.

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
A fused window step takes the `execution.latency.*` options
(`_latency_kwargs`). A `group_agg` step
(`KeyedStream.continuous_aggregate`) gets a `GroupAggRunner`
(`runtime/group_agg_operator.py`).

Left out, raising where a job asks for them (ROADMAP.md Queue A): job
metrics and emission latency (item 15), checkpoints and savepoints of a
running job (item 16), parallelism > 1 (item 17), the chaos hook (item
14), and the rest of the DataStream API's runners (item 19).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from flink_tpu_torch.api.functions import AggregateFunction
from flink_tpu_torch.api.windowing.assigners import EventTimeSessionWindows, GlobalWindows
from flink_tpu_torch.config import (
    Configuration,
    ExecutionOptions,
    LatencyOptions,
    PipelineOptions,
)
from flink_tpu_torch.core.time import MAX_WATERMARK, MIN_WATERMARK
from flink_tpu_torch.core.watermarks import BoundedOutOfOrdernessWatermarks, WatermarkStrategy
from flink_tpu_torch.graph.transformation import Step, StepGraph, Transformation
from flink_tpu_torch.ops.aggregators import ONE, resolve
from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator
from flink_tpu_torch.runtime.fused_window_pipeline import TracedPrologue
from flink_tpu_torch.runtime.oracle_window_operator import OracleWindowOperator
from flink_tpu_torch.runtime.tpu_global_window_operator import (
    TpuGlobalWindowOperator,
    supported_trigger,
)
from flink_tpu_torch.runtime.tpu_session_operator import TpuSessionWindowOperator
from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator
from flink_tpu_torch.scheduler.latency_controller import LatencySpec
from flink_tpu_torch.utils import deferred
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
    gate (ordinal)."""

    __slots__ = ("edges",)

    def __init__(self):
        self.edges: List = []   # (runner, input_ordinal)

    def __bool__(self) -> bool:
        return bool(self.edges)

    def add(self, runner: "StepRunner", ordinal: int) -> None:
        self.edges.append((runner, ordinal))

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        for r, o in self.edges:
            r.on_batch_n(o, values, timestamps)

    def on_watermark(self, watermark: int) -> None:
        for r, o in self.edges:
            r.on_watermark_n(o, watermark)

    def on_end(self) -> None:
        for r, o in self.edges:
            r.on_end_n(o)


class StepRunner:
    downstream: Optional[_FanOut] = None
    sides: Optional[Dict[str, _FanOut]] = None   # side-output channels by tag

    def side_channel(self, tag_id: str) -> _FanOut:
        if self.sides is None:
            self.sides = {}
        return self.sides.setdefault(tag_id, _FanOut())

    def emit_side(self, tag_id: str, values, timestamps) -> None:
        if self.sides and tag_id in self.sides:
            self.sides[tag_id].on_batch(values, timestamps)

    # -- input-gate protocol (single-input steps on the port) --------------
    def on_batch_n(self, ordinal: int, values: np.ndarray, timestamps: np.ndarray) -> None:
        self.on_batch(values, timestamps)

    def on_watermark_n(self, ordinal: int, watermark: int) -> None:
        self.on_watermark(watermark)

    def on_end_n(self, ordinal: int) -> None:
        self.on_end()

    # -- processing -------------------------------------------------------
    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        raise NotImplementedError

    def on_watermark(self, watermark: int) -> None:
        if self.downstream:
            self.downstream.on_watermark(watermark)
        for f in (self.sides or {}).values():
            f.on_watermark(watermark)

    def on_processing_time(self, now_ms: int) -> None:
        """Wall-clock tick of the run loop; runners with processing-time
        timers fire them here."""

    def on_end(self) -> None:
        if self.downstream:
            self.downstream.on_end()
        for f in (self.sides or {}).values():
            f.on_end()


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
    def _to_column(vals) -> np.ndarray:
        """Normalize a vectorized transform's output (a whole column by
        contract, of any rank)."""
        if isinstance(vals, np.ndarray):
            return vals
        arr = np.asarray(vals)
        if arr.dtype.kind in "OUSifub":
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
                raise deferred.not_ported(f"chain transform {t.kind!r}", deferred.API)
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
            # start small and grow by doubling with the key dictionary: the
            # superscan's cost scales with the key capacity
            capacity = min(1 << 10, config.get(ExecutionOptions.KEY_CAPACITY))
            self.op = FusedWindowOperator(
                assigner, device_agg, key_capacity=capacity,
                superbatch_steps=config.get(ExecutionOptions.SUPERBATCH_STEPS),
                chunk=_fused_chunk(config.get(ExecutionOptions.BATCH_SIZE)),
                columnar_output=config.get(ExecutionOptions.COLUMNAR_OUTPUT),
                device=device, **_latency_kwargs(config))
        elif use_device:
            # allowed lateness, a late side output or the fused path off:
            # one ingest and the due fires per batch
            self.op = TpuWindowOperator(
                assigner, device_agg,
                allowed_lateness=cfg.get("allowed_lateness", 0),
                key_capacity=config.get(ExecutionOptions.KEY_CAPACITY),
                emit_late_to_side_output=bool(cfg.get("side_output_late")),
                columnar_output=config.get(ExecutionOptions.COLUMNAR_OUTPUT),
                device=device)
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
        self.op.process_batch(keys, self._values_of(values), timestamps)

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
        if self.processing_time:
            self.op.advance_processing_time(now_ms)
            self._drain()

    def on_watermark(self, watermark: int) -> None:
        self.op.process_watermark(watermark)
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
        _push_rows(self.downstream, self.op.drain_output(), self.window_fn)


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
        self.op = FusedWindowOperator(
            None if assigners is not None else cfg["assigner"], cfg["aggregate"],
            key_capacity=config.get(ExecutionOptions.KEY_CAPACITY),
            superbatch_steps=config.get(ExecutionOptions.SUPERBATCH_STEPS),
            chunk=_fused_chunk(config.get(ExecutionOptions.BATCH_SIZE)),
            columnar_output=config.get(ExecutionOptions.COLUMNAR_OUTPUT),
            prologue=prologue, device=device, **_latency_kwargs(config),
            **({} if assigners is None else {"assigners": list(assigners)}))
        self.uid = t.uid
        self.sql_origin = bool(cfg.get("sql_origin"))

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        if len(timestamps) == 0:
            return   # nothing to stage
        if getattr(values, "dtype", None) == object or not isinstance(values, np.ndarray):
            # record-mode source: one columnarization pass per batch
            values = _columnarize_records(values, "fused device chain")
        else:
            values = as_device_column(values)
        self.op.process_raw_batch(values, timestamps)


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
    end-of-input fan-out differ.

    The JAX runner also fans latency markers out to every member; the port
    has no latency markers until ROADMAP item 15, so there is no on_marker
    here yet."""

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
        for spec, r in enumerate(self.member_runners):
            _push_rows(r.downstream, self.op.drain_spec_output(spec))

    def _forward_watermark(self, watermark: int) -> None:
        for r in self.member_runners:
            StepRunner.on_watermark(r, watermark)

    def on_end(self) -> None:
        self._drain()
        for r in self.member_runners:
            StepRunner.on_end(r)


class SinkRunner(StepRunner):
    def __init__(self, step: Step):
        sink = step.terminal.config["sink"]
        self.writer = sink.create_writer()
        self.committer = sink.create_committer()
        self.uid = step.terminal.uid

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        self.writer.write_batch(values, timestamps)

    def commit_epoch(self, epoch_id: str = "final") -> None:
        if self.committer is not None:
            self.committer.commit(self.writer.prepare_commit(epoch_id))

    def on_end(self) -> None:
        self.commit_epoch("final")
        self.writer.close()


def _make_runner(step: Step, config: Configuration, device: torch.device) -> StepRunner:
    if step.terminal is None:
        return ChainRunner(step.chain)
    kind = step.terminal.kind
    if kind == "window_aggregate":
        return WindowStepRunner(step, config, device)
    if kind == "sink":
        return SinkRunner(step)
    if kind == "group_agg":
        from flink_tpu_torch.runtime.group_agg_operator import GroupAggRunner

        return GroupAggRunner(step, config, device)
    raise deferred.not_ported(f"runner for {kind!r}", deferred.API)


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
    return runners, feeds


class JobRuntime:
    """One running attempt of a job at parallelism 1: sources, watermarks,
    runners and the end-of-input flush."""

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

        def emit_batch(self, values, ts) -> None:
            for r, o in self.feeds:
                r.on_batch_n(o, values, ts)

        def emit_watermark(self, wm: int) -> None:
            for r, o in self.feeds:
                r.on_watermark_n(o, wm)

        def finish(self) -> None:
            """End of this source: flush its watermark and close its gates
            (idempotent)."""
            if self.finished_signalled:
                return
            self.finished_signalled = True
            self.emit_watermark(MAX_WATERMARK - 1)
            for r, o in self.feeds:
                r.on_end_n(o)

    def __init__(self, graph: StepGraph, config: Configuration, device=None):
        parallelism = config.get(PipelineOptions.PARALLELISM)
        if parallelism != 1:
            raise deferred.not_ported(f"pipeline.parallelism={parallelism}",
                                      deferred.PARALLELISM)
        self.graph = graph
        self.config = config
        self.runners, feeds = build_runners(graph, config, device)
        self.sources = [JobRuntime._SourceDriver(t, feeds.get(t.id, []))
                        for t in graph.sources]
        self.records_in = 0

    def capture(self) -> dict:
        raise deferred.not_ported("JobRuntime.capture", deferred.CHECKPOINTS)

    def restore(self, snap: dict) -> None:
        raise deferred.not_ported("JobRuntime.restore", deferred.CHECKPOINTS)

    def run(self) -> None:
        batch_size = self.config.get(ExecutionOptions.BATCH_SIZE)
        for d in self.sources:
            d.current_split = d.enumerator.next_split()
            if d.current_split is not None:
                d.reader.add_split(d.current_split)
            else:
                d.done = True
                d.finish()
        last_tick = time.time() * 1000.0
        # round-robin over sources, one batch per turn
        while any(not d.done for d in self.sources):
            for d in self.sources:
                if d.done:
                    continue
                batch = d.reader.poll_batch(batch_size)
                if batch is None:
                    d.current_split = d.enumerator.next_split()
                    if d.current_split is None:
                        d.done = True
                        d.finish()
                    else:
                        d.reader.add_split(d.current_split)
                    continue
                values, ts = batch.values, batch.timestamps
                if d.assigner is not None:
                    ts = np.asarray([d.assigner(v, int(x)) for v, x in zip(values, ts)],
                                    dtype=np.int64)
                self.records_in += len(batch)
                d.emit_batch(values, ts)
                if d.generator is not None:
                    wm = (d.generator.on_batch_np(ts)
                          if hasattr(d.generator, "on_batch_np") else None)
                    if wm is None:
                        for v, x in zip(values, ts):
                            d.generator.on_event(v, int(x))
                        wm = d.generator.on_periodic_emit()
                    if wm is not None and wm > MIN_WATERMARK:
                        d.emit_watermark(wm)
                now_ms = time.time() * 1000.0
                if now_ms - last_tick >= 50.0:
                    # the processing-time service's tick: drive wall-clock
                    # timers (the JAX run loop's 50 ms period)
                    last_tick = now_ms
                    for r in self.runners:
                        r.on_processing_time(int(now_ms))
        # end of input: every source's final watermark + end signal fires
        # all remaining windows downstream
        for d in self.sources:
            d.finish()


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
