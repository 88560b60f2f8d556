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
emits a retract changelog.

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
from flink_tpu_torch.utils import deferred


def _not_ported(owner: str, name: str, item: str):
    """A method of the JAX API that the port does not carry yet."""
    def method(self, *args, **kwargs):
        raise deferred.not_ported(f"{owner}.{name}", item)
    method.__name__ = name
    return method


class StreamExecutionEnvironment:
    """Entry point: holds the configuration, the device and the sinks;
    execute() plans and runs."""

    def __init__(self, config: Optional[Configuration] = None, device=None):
        self.config = config or Configuration()
        self.device = device
        self._sinks: List[Transformation] = []

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
        return executor.execute(plan(self._sinks),
                                job_name or self.config.get(PipelineOptions.NAME))

    execute_async = _not_ported("StreamExecutionEnvironment", "execute_async", deferred.CHAOS)


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

    def global_(self) -> "DataStream":
        """Route everything to instance 0 (GlobalPartitioner): at the port's
        parallelism of 1 a pass-through hint, kept so a plan states where a
        global step (SQL's per-window top-N) must run."""
        return self._derive("global", "global", {})

    # -- sinks -------------------------------------------------------------
    def sink_to(self, sink: Sink, name: str = "sink") -> "DataStreamSink":
        t = Transformation("sink", name, [self.transform], {"sink": sink})
        self.env._sinks.append(t)
        return DataStreamSink(self.env, t)

    def collect(self) -> CollectSink:
        """Attach a CollectSink and return it (results after execute())."""
        sink = CollectSink()
        self.sink_to(sink, name="collect")
        return sink

    def get_side_output(self, tag) -> "DataStream":
        """The stream of this operator's side output for `tag`
        (SingleOutputStreamOperator.getSideOutput): a window aggregate's
        late data with side_output_late_data() and LATE_DATA_TAG. Side
        outputs of process() operators are not ported (ROADMAP item 19)."""
        if self.transform.kind != "window_aggregate":
            raise deferred.not_ported(
                f"DataStream.get_side_output of a {self.transform.kind!r} stream", deferred.API)
        if not isinstance(tag, OutputTag):
            tag = OutputTag(str(tag))
        return self._derive("side_output", f"side:{tag.tag_id}", {"tag": tag})

    # -- not ported yet ----------------------------------------------------
    map_batch = _not_ported("DataStream", "map_batch", deferred.API)
    async_map = _not_ported("DataStream", "async_map", deferred.API)
    union = _not_ported("DataStream", "union", deferred.API)
    connect = _not_ported("DataStream", "connect", deferred.API)
    join = _not_ported("DataStream", "join", deferred.JOINS)
    co_group = _not_ported("DataStream", "co_group", deferred.JOINS)
    rebalance = _not_ported("DataStream", "rebalance", deferred.API)
    rescale = _not_ported("DataStream", "rescale", deferred.API)
    shuffle = _not_ported("DataStream", "shuffle", deferred.API)
    broadcast = _not_ported("DataStream", "broadcast", deferred.API)
    forward = _not_ported("DataStream", "forward", deferred.API)
    slot_sharing_group = _not_ported("DataStream", "slot_sharing_group", deferred.API)
    iterate = _not_ported("DataStream", "iterate", deferred.API)


class DataStreamSink:
    def __init__(self, env, transform):
        self.env = env
        self.transform = transform


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

    reduce = _not_ported("KeyedStream", "reduce", deferred.API)
    process = _not_ported("KeyedStream", "process", deferred.API)


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

