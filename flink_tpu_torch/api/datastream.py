"""DataStream-style fluent API.

Counterpart of `flink_tpu/api/datastream.py` for the keyed event-time
window path: `env.from_source(...).filter(...).key_by(...).window(...)
.aggregate(...)` records a Transformation DAG, and `env.execute()` plans
and runs it on the port's executor, where a traceable chain runs as a
torch prologue on the device inside each fused dispatch (kernel K1).

UDF forms: `traceable=True` declares a pure function of torch tensor
columns (e.g. `lambda col: col[:, 0].to(torch.int32)`), which runs on the
device under chain fusion and on a CPU tensor view on the host route;
`vectorized=True` a function of numpy columns, run on the host; neither, a
function of one record.

Windows take allowed lateness and a late side output
(`side_output_late_data()`, read with `get_side_output(LATE_DATA_TAG)`),
and GlobalWindows a count trigger (the per-batch and global device
operators); any trigger, an evictor, `reduce`, `process`, a Python
AggregateFunction and processing-time windows run on the per-record
oracle operator, as in the JAX package; `KeyedStream.continuous_aggregate`
emits a retract changelog. `join`/`co_group` build two-input window joins:
eligible event-time joins on the device join ring, coGroup and the rest on
the host join runner. `env.execute_async()` runs the job on the
MiniCluster with checkpoints, restarts and savepoints (fault tolerance).

The rest of the JAX API runs on the host, as in the JAX package, and
feeds the window runners like any chain: `map_batch`, `async_map`
(runtime/async_io.py), `union` (a window after a union still fuses its
traceable chain onto the device), `connect` with `map`/`flat_map`, a keyed
`process` sharing per-key state, and the broadcast state pattern, the
partitioner hints, `slot_sharing_group` (a no-op locally), `iterate` with
`close_with`, keyed `reduce` and `process` (timers, side outputs through
`ctx.output(tag, v)` and `get_side_output(tag)`), CEP
(`cep.pattern_stream`) and API V2 (`api/v2.py`).

`StreamExecutionEnvironment(device=None)` runs on CUDA and raises at
execute() without a GPU; pass device="cpu" for the plain PyTorch path. The
device is threaded into every operator the job builds. Surfaces the port
does not carry yet raise NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Union

from flink_tpu_torch.api.functions import (
    AggregateFunction,
    OutputTag,
    ReduceAggregate,
    as_key_selector,
)
from flink_tpu_torch.api.windowing.assigners import WindowAssigner
from flink_tpu_torch.config import Configuration, PipelineOptions
from flink_tpu_torch.connectors.sink import CollectSink, Sink
from flink_tpu_torch.connectors.source import CollectionSource, Source
from flink_tpu_torch.core.watermarks import WatermarkStrategy
from flink_tpu_torch.graph.transformation import Transformation, plan


class StreamExecutionEnvironment:
    """Entry point: holds the configuration, the device and the sinks;
    execute() plans and runs."""

    def __init__(self, config: Optional[Configuration] = None, device=None):
        self.config = config or Configuration()
        self.device = device
        self._sinks: List[Transformation] = []
        # non-sink plan roots (iteration tails): reachable only through
        # close_with, so they are planned explicitly
        self._roots: List[Transformation] = []

    @staticmethod
    def get_execution_environment(config: Optional[Configuration] = None,
                                  device=None) -> "StreamExecutionEnvironment":
        return StreamExecutionEnvironment(config, device)

    # -- config -----------------------------------------------------------
    def set_parallelism(self, parallelism: int) -> "StreamExecutionEnvironment":
        self.config.set(PipelineOptions.PARALLELISM, parallelism)
        return self

    def set_max_parallelism(self, max_parallelism: int) -> "StreamExecutionEnvironment":
        self.config.set(PipelineOptions.MAX_PARALLELISM, max_parallelism)
        return self

    @property
    def parallelism(self) -> int:
        return self.config.get(PipelineOptions.PARALLELISM)

    @property
    def max_parallelism(self) -> int:
        return self.config.get(PipelineOptions.MAX_PARALLELISM)

    # -- sources ----------------------------------------------------------
    def from_source(self, source: Source,
                    watermark_strategy: Optional[WatermarkStrategy] = None,
                    name: str = "source") -> "DataStream":
        t = Transformation("source", name, [],
                           {"source": source, "watermark_strategy": watermark_strategy})
        return DataStream(self, t)

    def from_collection(self, items: Sequence, timestamp_fn: Optional[Callable] = None,
                        watermark_strategy: Optional[WatermarkStrategy] = None) -> "DataStream":
        return self.from_source(CollectionSource(items, timestamp_fn), watermark_strategy,
                                name="collection")

    # -- execution --------------------------------------------------------
    def execute(self, job_name: Optional[str] = None):
        from flink_tpu_torch.runtime.executor import LocalPipelineExecutor

        if not self._sinks:
            raise RuntimeError("No sinks defined; nothing to execute")
        executor = LocalPipelineExecutor(self.config, self.device)
        return executor.execute(plan(self._sinks + self._roots),
                                job_name or self.config.get(PipelineOptions.NAME))

    def execute_async(self, job_name: Optional[str] = None):
        """Submit to the in-process MiniCluster (runtime/minicluster.py) on
        the environment's device, as execute() runs: returns a JobClient.
        The job runs on its own thread with the configured checkpoints
        (execution.checkpointing.*) and restart strategy
        (restart-strategy.*)."""
        from flink_tpu_torch.runtime.minicluster import MiniCluster

        if len(self._sinks) != 1:
            raise RuntimeError("exactly one sink required")
        return MiniCluster.get_shared().submit(
            plan([self._sinks[0]] + self._roots), self.config, job_name, device=self.device)


class DataStream:
    def __init__(self, env: StreamExecutionEnvironment, transform: Transformation):
        self.env = env
        self.transform = transform

    def _derive(self, kind: str, name: str, config: dict) -> "DataStream":
        return DataStream(self.env, Transformation(kind, name, [self.transform], config))

    # -- record-local ops --------------------------------------------------
    def map(self, fn: Callable, name: str = "map", vectorized: bool = False,
            traceable: bool = False) -> "DataStream":
        """Per-record transform. vectorized=True: fn maps the whole numpy
        value column. traceable=True: fn is a pure function of a torch
        tensor column (row-local), eligible for the fused device chain."""
        fn = fn.map if hasattr(fn, "map") else fn
        return self._derive("map", name, {"fn": fn, "vectorized": vectorized or traceable,
                                          "traceable": traceable})

    def map_batch(self, fn: Callable, name: str = "map_batch") -> "DataStream":
        """1:1 transform over the whole step batch at once (a list of the
        batch's records in, a list of equal length out), on the host: the
        point to amortize a lookup or a model over a batch."""
        return self._derive("map_batch", name, {"fn": fn})

    def map_with_timestamp(self, fn: Callable, name: str = "map_ts",
                           vectorized: bool = False, traceable: bool = False) -> "DataStream":
        """map over (value, event_timestamp_ms). Column form:
        fn(values_column, timestamps_column) -> values_column; traceable
        fns get torch tensors, timestamps as int32."""
        return self._derive("map_ts", name, {"fn": fn, "vectorized": vectorized or traceable,
                                             "traceable": traceable})

    def flat_map(self, fn: Callable, name: str = "flat_map",
                 vectorized: bool = False) -> "DataStream":
        """1:N transform, run on the host. Per-record form: fn(record)
        returns an iterable of records, each with its input's timestamp.
        Vectorized form: fn(values_column) returns (out_values,
        source_index), where source_index[i] is the input row out_values[i]
        came from (its timestamp follows)."""
        fn = fn.flat_map if hasattr(fn, "flat_map") else fn
        return self._derive("flat_map", name, {"fn": fn, "vectorized": vectorized})

    def filter(self, fn: Callable, name: str = "filter", vectorized: bool = False,
               traceable: bool = False) -> "DataStream":
        """Predicate filter. Column form: fn(values_column) returns a
        boolean mask over the column."""
        fn = fn.filter if hasattr(fn, "filter") else fn
        return self._derive("filter", name, {"fn": fn, "vectorized": vectorized or traceable,
                                             "traceable": traceable})

    def async_map(self, fn: Callable, *, capacity: int = 100,
                  timeout_ms: Optional[float] = None, ordered: bool = True,
                  retry=None, name: str = "async_map") -> "DataStream":
        """Async I/O with bounded concurrency (AsyncDataStream.orderedWait /
        unorderedWait): `fn` (or an AsyncFunction) runs on a pool of
        `capacity` threads; results come in input order when `ordered`,
        else in completion order; `timeout_ms` takes the function's
        timeout_value, `retry` a RetryStrategy (runtime/async_io.py)."""
        from flink_tpu_torch.runtime.async_io import NO_RETRY

        return self._derive("async_map", name, {
            "fn": fn, "capacity": capacity, "timeout_ms": timeout_ms,
            "ordered": ordered, "retry": retry or NO_RETRY})

    def key_by(self, key_selector: Callable, name: str = "key_by",
               vectorized: bool = False, traceable: bool = False) -> "KeyedStream":
        """Partition by key. Column form: key_selector(values_column)
        returns the key column. traceable=True declares a torch column
        function returning NON-NEGATIVE INTEGER keys below
        `execution.state.key-capacity`: a downstream eligible window then
        fuses with the chain into one device dispatch."""
        vectorized = vectorized or traceable
        sel = as_key_selector(key_selector) if not vectorized else key_selector
        t = Transformation("key_by", name, [self.transform],
                           {"key_selector": sel, "vectorized": vectorized,
                            "traceable": traceable})
        return KeyedStream(self.env, t)

    # -- partitioning ------------------------------------------------------
    def _partition_hint(self, kind: str) -> "DataStream":
        """An explicit repartitioning: locally a pass-through view (one
        parallel instance), kept in the plan; key_by stays the only
        partitioner that moves records (by key group)."""
        return self._derive(kind, kind, {})

    def rebalance(self) -> "DataStream":
        """Round-robin redistribution (RebalancePartitioner)."""
        return self._partition_hint("rebalance")

    def rescale(self) -> "DataStream":
        """Local-group round-robin (RescalePartitioner)."""
        return self._partition_hint("rescale")

    def shuffle(self) -> "DataStream":
        """Uniform-random redistribution (ShufflePartitioner)."""
        return self._partition_hint("shuffle")

    def broadcast(self) -> "DataStream":
        """Every downstream instance sees every record (BroadcastPartitioner);
        the second stream of the broadcast state pattern."""
        return self._partition_hint("broadcast")

    def forward(self) -> "DataStream":
        """Pin to the local downstream instance (ForwardPartitioner); the
        chain fuses through it."""
        return self._partition_hint("forward")

    def global_(self) -> "DataStream":
        """Route everything to instance 0 (GlobalPartitioner), kept so a plan
        states where a global step (SQL's per-window top-N) must run."""
        return self._partition_hint("global")

    def slot_sharing_group(self, name: str) -> "DataStream":
        """Put the operator that produced this stream into slot-sharing
        group `name` (downstream operators inherit it unless they declare
        their own). A change of group breaks the chain; locally groups run
        in one process, as the JAX package's local environment runs them."""
        self.transform.config["slot_sharing_group"] = name
        return self

    def iterate(self, max_rounds: int = 10000) -> "IterativeStream":
        """Open an iteration (IterativeStream.java): the returned stream
        carries this stream's records plus every record fed back through
        close_with(). Watermarks do not cross the feedback edge; with
        bounded inputs the job ends when the loop body stops feeding records
        back, and `max_rounds` bounds a loop that does not.

            it = stream.iterate()
            body = it.map(step_fn)
            it.close_with(body.filter(still_going))   # feedback edge
            body.filter(done).sink_to(...)            # loop exit
        """
        t = Transformation("iteration_head", "iterate", [self.transform],
                           {"max_rounds": max_rounds})
        return IterativeStream(self.env, t)

    # -- sinks -------------------------------------------------------------
    def sink_to(self, sink: Sink, name: str = "sink") -> "DataStreamSink":
        t = Transformation("sink", name, [self.transform], {"sink": sink})
        self.env._sinks.append(t)
        return DataStreamSink(self.env, t)

    def print(self) -> "DataStreamSink":
        """Print each record to standard output (PrintSink)."""
        from flink_tpu_torch.connectors.sink import PrintSink

        return self.sink_to(PrintSink(), name="print")

    def collect(self) -> CollectSink:
        """Attach a CollectSink and return it (results after execute())."""
        sink = CollectSink()
        self.sink_to(sink, name="collect")
        return sink

    # -- multi-input topologies --------------------------------------------
    def union(self, *others: "DataStream") -> "DataStream":
        """Merge streams of the same type; watermarks min-combine across the
        inputs (DataStream.union / UnionTransformation)."""
        if not others:
            return self
        return DataStream(self.env, Transformation(
            "union", "union", [self.transform] + [o.transform for o in others], {}))

    def connect(self, other: "DataStream") -> "ConnectedStreams":
        """Pair two streams for co-processing (DataStream.connect): a keyed
        process shares per-key state across the two inputs."""
        return ConnectedStreams(self.env, self, other)

    def join(self, other: "DataStream") -> "JoinBuilder":
        """Keyed windowed join (JoinedStreams.java:101):
        a.join(b).where(ks_a).equal_to(ks_b).window(assigner).apply(fn).
        Eligible event-time joins run on the device join ring
        (`runtime/device_join_operator.py`), others on the host runner."""
        return JoinBuilder(self.env, self, other, cogroup=False)

    def co_group(self, other: "DataStream") -> "JoinBuilder":
        """Keyed windowed coGroup (CoGroupedStreams.java): apply(fn) receives
        (left_elements, right_elements) once per key x window, on the host."""
        return JoinBuilder(self.env, self, other, cogroup=True)

    def get_side_output(self, tag) -> "DataStream":
        """The stream of this operator's side output for `tag`
        (SingleOutputStreamOperator.getSideOutput): what a process()
        operator emits with ctx.output(tag, v), or a window aggregate's late
        data with side_output_late_data() and LATE_DATA_TAG."""
        if not isinstance(tag, OutputTag):
            tag = OutputTag(str(tag))
        return self._derive("side_output", f"side:{tag.tag_id}", {"tag": tag})


class IterativeStream(DataStream):
    """The head of an iteration; close_with wires the feedback edge back to
    it."""

    def close_with(self, feedback: DataStream) -> DataStream:
        """Feed `feedback`'s records back into this head
        (IterativeStream.closeWith). Returns the feedback stream."""
        tail = Transformation("iteration_tail", "iteration_tail", [feedback.transform],
                              {"head": self.transform})
        self.env._roots.append(tail)
        return feedback


class ConnectedStreams:
    """Two paired streams (ConnectedStreams.java): co-transforms see both
    inputs; the keyed process shares per-key state across them."""

    def __init__(self, env: StreamExecutionEnvironment, first: DataStream, second: DataStream):
        self.env = env
        self.first = first
        self.second = second

    def _two_input(self, kind: str, name: str, config: dict) -> DataStream:
        return DataStream(self.env, Transformation(
            kind, name, [self.first.transform, self.second.transform], config))

    def map(self, fn1: Callable, fn2: Callable, name: str = "co_map") -> DataStream:
        return self._two_input("co_map", name, {"fn1": fn1, "fn2": fn2})

    def flat_map(self, fn1: Callable, fn2: Callable, name: str = "co_flat_map") -> DataStream:
        return self._two_input("co_flat_map", name, {"fn1": fn1, "fn2": fn2})

    def key_by(self, key_selector1: Callable, key_selector2: Callable) -> "ConnectedStreams":
        """Key both inputs; a later process() shares keyed state and timers
        across them (the point of connect over union)."""
        cs = ConnectedStreams(self.env, self.first, self.second)
        cs._ks = (as_key_selector(key_selector1), as_key_selector(key_selector2))
        return cs

    def process(self, co_process_fn, name: str = "co_process") -> DataStream:
        """Keyed (after key_by(ks1, ks2)): a KeyedCoProcessFunction
        (process_element1/process_element2, optional on_timer) with shared
        per-key state. Broadcast (the second stream .broadcast()): a
        BroadcastProcessFunction (process_element(value, read-only state) /
        process_broadcast_element(value, state)) over operator-wide
        broadcast state. Anything else is refused."""
        ks = getattr(self, "_ks", None)
        if ks is not None:
            return self._two_input("co_process", name, {
                "process_fn": co_process_fn, "key_selector1": ks[0], "key_selector2": ks[1]})
        if self.second.transform.kind == "broadcast":
            return self._two_input("broadcast_process", name, {"process_fn": co_process_fn})
        raise ValueError(
            "connect(...).process requires key_by(ks1, ks2), or a "
            ".broadcast() second stream for the broadcast state pattern"
        )


class JoinBuilder:
    """where/equalTo/window/apply builder for joins and coGroups
    (JoinedStreams.java:101, CoGroupedStreams.java)."""

    def __init__(self, env, first: DataStream, second: DataStream, cogroup: bool):
        self.env = env
        self.first = first
        self.second = second
        self.cogroup = cogroup
        self._ks1: Optional[Callable] = None
        self._ks2: Optional[Callable] = None
        self._assigner: Optional[WindowAssigner] = None

    def where(self, key_selector: Callable) -> "JoinBuilder":
        self._ks1 = as_key_selector(key_selector)
        return self

    def equal_to(self, key_selector: Callable) -> "JoinBuilder":
        self._ks2 = as_key_selector(key_selector)
        return self

    def window(self, assigner: WindowAssigner) -> "JoinBuilder":
        self._assigner = assigner
        return self

    def apply(self, fn: Callable, name: Optional[str] = None) -> DataStream:
        """Join: fn(left, right) per matching pair. CoGroup: fn(lefts,
        rights) once per key x window."""
        if self._ks1 is None or self._ks2 is None:
            raise ValueError("join requires where(...) and equal_to(...)")
        if self._assigner is None:
            raise ValueError("join requires a window(...) assigner")
        kind = "co_group" if self.cogroup else "window_join"
        t = Transformation(
            kind, name or kind,
            [self.first.transform, self.second.transform],
            {"key_selector1": self._ks1, "key_selector2": self._ks2,
             "assigner": self._assigner, "join_fn": fn},
        )
        return DataStream(self.env, t)


class DataStreamSink:
    def __init__(self, env, transform):
        self.env = env
        self.transform = transform

    def uid(self, uid: str) -> "DataStreamSink":
        self.transform.uid = uid
        return self


class KeyedStream(DataStream):
    """Keyed partitioned stream."""

    @property
    def key_selector(self) -> Callable:
        return self.transform.config["key_selector"]

    def window(self, assigner: WindowAssigner) -> "WindowedStream":
        return WindowedStream(self, assigner)

    def _scalar_key_selector(self) -> Callable:
        """Per-record view of the key selector (a vectorized selector is
        called on a one-record column)."""
        sel = self.key_selector
        if self.transform.config.get("vectorized"):
            import numpy as np

            return lambda v: sel(np.asarray(v)[None, ...])[0]
        return sel

    def continuous_aggregate(self, specs, key_fields, out_names,
                             mini_batch: Optional[bool] = None,
                             generate_update_before: bool = True,
                             device: Optional[bool] = None,
                             name: str = "group_agg") -> DataStream:
        """Continuous (non-windowed) group aggregation emitting a retract
        changelog (GroupAggFunction.java:33). `specs` is a list of (func,
        col) with func in COUNT/SUM/AVG/MIN/MAX (col None for COUNT(*));
        `key_fields` name the key parts and `out_names` the aggregate
        outputs of the emitted rows. Input rows may carry changelog kinds
        (table/changelog.py). `mini_batch=True` emits one transition per
        distinct key per batch, False the exact per-record sequence;
        `device=True` keeps the linear accumulators on the device with one
        scatter-add step per batch. None takes the configuration's
        execution.group-agg.* options."""
        t = Transformation("group_agg", name, [self.transform], {
            "key_selector": self._scalar_key_selector(),
            "specs": list(specs),
            "key_fields": list(key_fields),
            "out_names": list(out_names),
            "mini_batch": mini_batch,
            "generate_update_before": generate_update_before,
            "device": device,
        })
        return DataStream(self.env, t)

    def reduce(self, fn: Callable, name: str = "keyed_reduce") -> DataStream:
        """Rolling keyed reduce: emits each key's running reduce per input
        record (StreamGroupedReduceOperator), on the host."""
        return self._derive("reduce", name, {
            "reduce_fn": fn, "key_selector": self._scalar_key_selector()})

    def process(self, process_fn, name: str = "keyed_process") -> DataStream:
        """A KeyedProcessFunction with per-key state, event-time and
        processing-time timers and side outputs (ctx.output(tag, v)), on
        the host."""
        return self._derive("process_keyed", name, {
            "process_fn": process_fn, "key_selector": self._scalar_key_selector()})


class WindowedStream:
    """Builder for windowed aggregations."""

    def __init__(self, keyed: KeyedStream, assigner: WindowAssigner):
        self._keyed = keyed
        self._assigner = assigner
        self._trigger = None
        self._evictor = None
        self._allowed_lateness = 0
        self._side_output_late = False

    def trigger(self, trigger) -> "WindowedStream":
        """A CountTrigger or PurgingTrigger(CountTrigger) on GlobalWindows
        runs on the device global-window operator; every other trigger on
        the per-record oracle operator."""
        self._trigger = trigger
        return self

    def evictor(self, evictor) -> "WindowedStream":
        """An evictor buffers each window's elements (no pre-aggregation):
        the per-record oracle operator runs the window."""
        self._evictor = evictor
        return self

    def allowed_lateness(self, lateness_ms: int) -> "WindowedStream":
        self._allowed_lateness = lateness_ms
        return self

    def side_output_late_data(self) -> "WindowedStream":
        """Too-late records go to the LATE_DATA_TAG side output instead of
        being dropped."""
        self._side_output_late = True
        return self

    def _agg_transform(self, aggregate, value_fn, window_fn, name,
                       value_vectorized: bool = False,
                       value_traceable: bool = False) -> DataStream:
        keyed_cfg = self._keyed.transform.config
        t = Transformation("window_aggregate", name, [self._keyed.transform], {
            "assigner": self._assigner,
            "aggregate": aggregate,
            "value_fn": value_fn,
            "value_vectorized": value_vectorized or value_traceable,
            "value_traceable": value_traceable,
            "window_fn": window_fn,
            "trigger": self._trigger,
            "evictor": self._evictor,
            "allowed_lateness": self._allowed_lateness,
            "side_output_late": self._side_output_late,
            "key_selector": self._keyed.key_selector,
            "key_vectorized": keyed_cfg.get("vectorized", False),
            "key_traceable": keyed_cfg.get("traceable", False),
        })
        return DataStream(self._keyed.env, t)

    def aggregate(self, aggregate: Union[str, AggregateFunction, Any],
                  value_fn: Optional[Callable] = None, window_fn=None,
                  name: str = "window_aggregate", value_vectorized: bool = False,
                  value_traceable: bool = False) -> DataStream:
        """`aggregate` is a builtin name ('sum'/'count'/'min'/'max'/'mean'),
        a DeviceAggregator (device operators), or an AggregateFunction (the
        per-record oracle operator, as is any `window_fn`, a
        ProcessWindowFunction over the aggregate's result). `value_fn`
        extracts the numeric column; with value_vectorized=True it maps the
        whole numpy column, and value_traceable=True declares it a torch
        column function that runs in the fused device prologue."""
        return self._agg_transform(aggregate, value_fn, window_fn, name,
                                   value_vectorized=value_vectorized,
                                   value_traceable=value_traceable)

    def reduce(self, fn: Callable, name: str = "window_reduce") -> DataStream:
        """A ReduceFunction (or a two-argument callable) as the window's
        pre-aggregator, on the per-record oracle operator."""
        return self._agg_transform(ReduceAggregate(fn), None, None, name)

    def process(self, window_fn, name: str = "window_process") -> DataStream:
        """A buffered window with a ProcessWindowFunction (no
        pre-aggregation), on the per-record oracle operator."""
        return self._agg_transform(None, None, window_fn, name)

    def sum(self, value_fn: Optional[Callable] = None) -> DataStream:
        return self.aggregate("sum", value_fn, name="window_sum")

    def count(self) -> DataStream:
        return self.aggregate("count", name="window_count")

    def max(self, value_fn: Optional[Callable] = None) -> DataStream:
        return self.aggregate("max", value_fn, name="window_max")

    def min(self, value_fn: Optional[Callable] = None) -> DataStream:
        return self.aggregate("min", value_fn, name="window_min")

