"""Local pipeline executor: the host-driven stepped dataflow loop.

Counterpart of the subset of `flink_tpu/runtime/executor.py` that a keyed
event-time window job or a continuous aggregate runs. The source reader
yields a columnar batch; the batch flows through push-based StepRunners (a
stateless chain, a keyed window step or a continuous aggregate, then
sinks), and the source's watermark advances between steps.

Runner selection follows the JAX package. A window step whose chain is
traceable (graph/fusion.py) gets a `DeviceChainRunner`: the chain runs as
a torch prologue on the device inside each fused dispatch. Otherwise a
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
  reaches the consumers of `get_side_output(LATE_DATA_TAG)`.
A `group_agg` step (`KeyedStream.continuous_aggregate`) gets a
`GroupAggRunner` (`runtime/group_agg_operator.py`).

Left out, raising where a job asks for them (ROADMAP.md Queue A): the
per-record oracle window operator (item 18: Python aggregates, other
triggers, evictors, window functions, processing time, and the session
steps the JAX package hands to it), job metrics and emission latency
(item 15), checkpoints and savepoints of a running job (item 16),
parallelism > 1 (item 17), the chaos hook (item 14), and the rest of the
DataStream API's runners (item 19).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from flink_tpu_torch.api.windowing.assigners import EventTimeSessionWindows, GlobalWindows
from flink_tpu_torch.config import Configuration, ExecutionOptions, PipelineOptions
from flink_tpu_torch.core.time import MAX_WATERMARK, MIN_WATERMARK
from flink_tpu_torch.core.watermarks import BoundedOutOfOrdernessWatermarks, WatermarkStrategy
from flink_tpu_torch.graph.transformation import Step, StepGraph, Transformation
from flink_tpu_torch.ops.aggregators import ONE, resolve
from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator
from flink_tpu_torch.runtime.fused_window_pipeline import TracedPrologue
from flink_tpu_torch.runtime.tpu_global_window_operator import (
    TpuGlobalWindowOperator,
    supported_trigger,
)
from flink_tpu_torch.runtime.tpu_session_operator import TpuSessionWindowOperator
from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator
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
    """Fused stateless chain: map/map_ts/filter applied per batch on the
    host. Traceable transforms take the canonical numeric column as a CPU
    tensor (the form the device prologue gives them); vectorized ones take
    the numpy column; plain ones run per record."""

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


def _session_disorder_within_gap(step: Step, assigner) -> Optional[str]:
    """Device-session routing gate: the session operator's late contract
    (drop records whose standalone session is already expired) matches the
    merging oracle only while watermark out-of-orderness stays BELOW the
    session gap — with bound >= gap a record can arrive late enough that
    the oracle would still merge it into an open session the device path
    already expired, i.e. silent data loss. Returns None when the device
    operator may run, else the reason (the JAX package's warning) it may
    not. Fail-open on an unknowable bound (custom/punctuated generators),
    as in the JAX package."""
    bound = _max_source_out_of_orderness(step)
    if bound is None or bound < assigner.gap:
        return None
    return (f"session windows: watermark out-of-orderness bound ({bound} ms) >= "
            f"session gap ({assigner.gap} ms) — the JAX package uses its "
            "per-record oracle operator instead of the device session "
            "operator, whose late contract would silently drop records the "
            "oracle merges. Shrink the out-of-orderness bound below the gap "
            "to select the device path")


def _session_refusal(step: Step, cfg: dict, assigner, device_agg,
                     config: Configuration) -> Optional[str]:
    """Why a session window step cannot take the device session operator
    (the JAX runner's conditions; it would pick its oracle), or None."""
    if device_agg is None:
        return "a Python aggregate"
    if not assigner.is_event_time:
        return "processing-time sessions"
    if not config.get(ExecutionOptions.DEVICE_SESSIONS):
        return "execution.window.device-sessions is false"
    if (cfg.get("trigger") is not None or cfg.get("evictor") is not None
            or cfg.get("window_fn") is not None):
        return "a custom trigger, evictor or window function"
    if cfg.get("allowed_lateness", 0) != 0 or cfg.get("side_output_late"):
        return "allowed lateness or a late side output"
    return _session_disorder_within_gap(step, assigner)


class WindowStepRunner(StepRunner):
    """Keyed window aggregation step over the device operator the JAX
    runner selects: global count windows, sessions, the fused operator or
    the per-batch operator (its oracle branch is not ported)."""

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
        device_agg = resolve(aggregate)
        self.uid = t.uid
        self._needs_value = device_agg is not None and any(
            f.source != ONE for f in device_agg.fields)
        count_spec = supported_trigger(cfg.get("trigger"))
        if (isinstance(assigner, GlobalWindows) and device_agg is not None
                and count_spec is not None and cfg.get("evictor") is None
                and cfg.get("window_fn") is None):
            n, purging = count_spec
            self.op = TpuGlobalWindowOperator(
                device_agg, count_n=n, purging=purging,
                key_capacity=config.get(ExecutionOptions.KEY_CAPACITY), device=device)
            return
        if isinstance(assigner, EventTimeSessionWindows):
            reason = _session_refusal(step, cfg, assigner, device_agg, config)
            if reason is not None:
                raise deferred.not_ported(
                    f"window step '{t.name}' (it needs the per-record oracle "
                    f"operator: {reason})", deferred.ORACLE)
            # per-slice fragments + gap-merge scan (runtime/
            # tpu_session_operator.py); capacity grows with the dictionary
            self.op = TpuSessionWindowOperator(
                assigner, device_agg,
                key_capacity=min(1 << 10, config.get(ExecutionOptions.KEY_CAPACITY)),
                device=device)
            return
        use_device = (
            device_agg is not None
            and assigner.slice_ms is not None
            and assigner.is_event_time
            and cfg.get("trigger") is None
            and cfg.get("evictor") is None
            and cfg.get("window_fn") is None
        )
        if not use_device:
            raise deferred.not_ported(
                f"window step '{t.name}' (it needs the per-record oracle operator: "
                "a Python aggregate, window function, trigger or evictor)",
                deferred.ORACLE)
        use_fused = (
            cfg.get("allowed_lateness", 0) == 0
            and not cfg.get("side_output_late")
            and config.get(ExecutionOptions.FUSED_WINDOWS)
            and all(f.scatter in ("add", "min", "max") for f in device_agg.fields)
        )
        if not use_fused:
            # allowed lateness, a late side output or the fused path off:
            # one ingest and the due fires per batch
            self.op = TpuWindowOperator(
                assigner, device_agg,
                allowed_lateness=cfg.get("allowed_lateness", 0),
                key_capacity=config.get(ExecutionOptions.KEY_CAPACITY),
                emit_late_to_side_output=bool(cfg.get("side_output_late")),
                columnar_output=config.get(ExecutionOptions.COLUMNAR_OUTPUT),
                device=device)
            return
        # start small and grow by doubling with the key dictionary: the
        # superscan's cost scales with the key capacity
        capacity = min(1 << 10, config.get(ExecutionOptions.KEY_CAPACITY))
        self.op = FusedWindowOperator(
            assigner, device_agg, key_capacity=capacity,
            superbatch_steps=config.get(ExecutionOptions.SUPERBATCH_STEPS),
            chunk=_fused_chunk(config.get(ExecutionOptions.BATCH_SIZE)),
            columnar_output=config.get(ExecutionOptions.COLUMNAR_OUTPUT),
            device=device)

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
        keys = self._keys_of(values)
        if keys.ndim != 1 or keys.dtype.kind not in "iuUSO":
            keys = obj_array(list(keys))
        self.op.process_batch(keys, self._values_of(values), timestamps)

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
            super().on_watermark(watermark)

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
        out = self.op.drain_output()
        if out and self.downstream:
            # row mode: (key, value); columnar mode (k is None): the packed
            # (window, key ids, values) triple
            vals = obj_array([r if k is None else (k, r) for (k, _w, r, _t) in out])
            ts = np.asarray([t for (_k, _w, _r, t) in out], dtype=np.int64)
            self.downstream.on_batch(vals, ts)


class DeviceChainRunner(WindowStepRunner):
    """Whole-graph fusion runner (graph/fusion.py): the traceable
    map/filter/map_ts chain, key/value extraction and the window aggregate
    run as one fused dispatch per superbatch — the chain as a torch
    prologue over the raw staged columns on the device, then kernel K1.
    Only raw source columns cross from the host. Inherits the watermark
    and drain surfaces of WindowStepRunner."""

    def __init__(self, step: Step, plan, config: Configuration, device: torch.device):
        t = plan.terminal
        cfg = t.config
        prologue = TracedPrologue(
            transforms=tuple((tr.kind, tr.config["fn"]) for tr in plan.transforms),
            key_fn=cfg["key_selector"],
            value_fn=cfg.get("value_fn"),
        )
        # dense device keying cannot grow mid-dispatch: capacity is the
        # configured bound, and an out-of-range key raises at resolve
        self.op = FusedWindowOperator(
            cfg["assigner"], cfg["aggregate"],
            key_capacity=config.get(ExecutionOptions.KEY_CAPACITY),
            superbatch_steps=config.get(ExecutionOptions.SUPERBATCH_STEPS),
            chunk=_fused_chunk(config.get(ExecutionOptions.BATCH_SIZE)),
            columnar_output=config.get(ExecutionOptions.COLUMNAR_OUTPUT),
            prologue=prologue, device=device)
        self.uid = t.uid

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        if len(timestamps) == 0:
            return   # nothing to stage
        if getattr(values, "dtype", None) == object or not isinstance(values, np.ndarray):
            # record-mode source: one columnarization pass per batch
            values = _columnarize_records(values, "fused device chain")
        else:
            values = as_device_column(values)
        self.op.process_raw_batch(values, timestamps)


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
    The port forms no shared-partial group (ROADMAP D3; setting
    execution.window.shared-partials raises): sibling windows each get
    their own fused runner. `device=None` runs on CUDA or raises."""
    from flink_tpu_torch.graph.fusion import plan_device_chains

    device = resolve_device(device)
    plans, absorbed = {}, set()
    if config.get(ExecutionOptions.CHAIN_FUSION) and config.get(ExecutionOptions.FUSED_WINDOWS):
        plans, absorbed = plan_device_chains(graph)

    runner_of: Dict[int, StepRunner] = {}
    runners: List[StepRunner] = []
    for step in graph.steps:
        if id(step) in absorbed:
            continue
        if id(step) in plans:
            r = DeviceChainRunner(step, plans[id(step)], config, device)
        else:
            r = _make_runner(step, config, device)
        runner_of[id(step)] = r
        runners.append(r)

    feeds: Dict[int, List] = {}
    for step in graph.steps:
        if id(step) in absorbed:
            continue
        r = runner_of[id(step)]
        step_inputs = plans[id(step)].inputs if id(step) in plans else step.inputs
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
