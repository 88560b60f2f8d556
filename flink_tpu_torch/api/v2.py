"""DataStream API V2: ProcessFunction-centric streams (C9).

The reference's next-gen API (flink-datastream-api:
datastream/api/ExecutionEnvironment.java, stream/KeyedPartitionStream.java,
function/OneInputStreamProcessFunction.java) reduces the operator zoo to a
single `process()` primitive over explicit partitionings; its impl module
(flink-datastream) translates onto the V1 runtime. Same structure here: V2
streams wrap the V1 DataStream plan, so both APIs share the executor,
state, windowing and device paths.

Counterpart of `flink_tpu/api/v2.py`, copied.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

from flink_tpu_torch.api.datastream import DataStream, StreamExecutionEnvironment


class Collector:
    """Receives the elements a ProcessFunction emits."""

    def __init__(self):
        self._out: List[Any] = []

    def collect(self, value: Any) -> None:
        self._out.append(value)


class RuntimeContext:
    """Visible execution context of one invocation."""

    def __init__(self, timestamp: Optional[int] = None, key: Any = None):
        self.timestamp = timestamp
        self.key = key


class OneInputStreamProcessFunction:
    """V2's single user primitive (OneInputStreamProcessFunction.java):
    override process_record; open/close bracket the lifetime."""

    def open(self) -> None:
        pass

    def process_record(self, record: Any, output: Collector, ctx: RuntimeContext) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _as_process_fn(fn) -> OneInputStreamProcessFunction:
    if isinstance(fn, OneInputStreamProcessFunction):
        return fn

    class _Wrapped(OneInputStreamProcessFunction):
        def process_record(self, record, output, ctx):
            for v in fn(record):
                output.collect(v)

    return _Wrapped()


class NonKeyedPartitionStream:
    """V2 stream over the V1 plan."""

    def __init__(self, inner: DataStream):
        self._inner = inner

    def process(self, fn, name: str = "process") -> "NonKeyedPartitionStream":
        pf = _as_process_fn(fn)
        pf.open()

        def flat(record):
            out = Collector()
            pf.process_record(record, out, RuntimeContext())
            return out._out

        return NonKeyedPartitionStream(self._inner.flat_map(flat, name=name))

    def key_by(self, key_selector: Callable) -> "KeyedPartitionStream":
        return KeyedPartitionStream(self._inner.key_by(key_selector), key_selector)

    def to_sink(self, sink) -> None:
        self._inner.sink_to(sink)

    def collect_to_list(self):
        return self._inner.collect()


class KeyedPartitionStream:
    def __init__(self, inner, key_selector: Callable):
        self._inner = inner
        self._key_selector = key_selector

    def process(self, fn, name: str = "keyed_process") -> NonKeyedPartitionStream:
        from flink_tpu_torch.api.functions import ProcessFunction

        pf = _as_process_fn(fn)
        pf.open()
        selector = self._key_selector

        class _Adapter(ProcessFunction):
            def process_element(self, value, ctx):
                out = Collector()
                pf.process_record(
                    value, out,
                    RuntimeContext(timestamp=ctx.timestamp, key=selector(value)),
                )
                return iter(out._out)

        return NonKeyedPartitionStream(self._inner.process(_Adapter(), name=name))

    def window(self, assigner):
        return self._inner.window(assigner)


class ExecutionEnvironment:
    """V2 entry point (ExecutionEnvironment.java). A new V1 environment
    runs on `device` (None: CUDA, raising at execute() without a GPU)."""

    def __init__(self, v1_env: Optional[StreamExecutionEnvironment] = None, device=None):
        self.v1 = v1_env or StreamExecutionEnvironment.get_execution_environment(device=device)

    @staticmethod
    def get_instance(device=None) -> "ExecutionEnvironment":
        return ExecutionEnvironment(device=device)

    def from_source(self, source, watermark_strategy=None,
                    name: str = "v2-source") -> NonKeyedPartitionStream:
        return NonKeyedPartitionStream(self.v1.from_source(source, watermark_strategy, name))

    def from_collection(self, items: Iterable, timestamp_fn=None,
                        watermark_strategy=None) -> NonKeyedPartitionStream:
        return NonKeyedPartitionStream(
            self.v1.from_collection(list(items), timestamp_fn=timestamp_fn,
                                    watermark_strategy=watermark_strategy)
        )

    def execute(self, job_name: str = "v2-job"):
        return self.v1.execute(job_name)
