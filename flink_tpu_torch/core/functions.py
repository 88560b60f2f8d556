"""User function interfaces (reference: flink-core .../api/common/functions/
MapFunction, FlatMapFunction, FilterFunction, ReduceFunction,
AggregateFunction; window functions in .../streaming/api/functions/windowing/).

Counterpart of `flink_tpu/core/functions.py`, copied. A `traceable=True`
UDF on the port is a function of a torch tensor column; a
`vectorized=True` one takes a numpy column; a plain one takes one record.
"""

from __future__ import annotations

from typing import Any, Callable, Generic, Iterable, Iterator, List, Optional, TypeVar

IN = TypeVar("IN")
OUT = TypeVar("OUT")
ACC = TypeVar("ACC")
KEY = TypeVar("KEY")


class MapFunction(Generic[IN, OUT]):
    def map(self, value: IN) -> OUT:
        raise NotImplementedError


class FlatMapFunction(Generic[IN, OUT]):
    def flat_map(self, value: IN) -> Iterator[OUT]:
        raise NotImplementedError


class FilterFunction(Generic[IN]):
    def filter(self, value: IN) -> bool:
        raise NotImplementedError


class ReduceFunction(Generic[IN]):
    """reduce(a, b) must be associative; used as the window pre-aggregator
    (WindowedStream.reduce:181)."""

    def reduce(self, a: IN, b: IN) -> IN:
        raise NotImplementedError


class AggregateFunction(Generic[IN, ACC, OUT]):
    """create/add/get_result/merge contract (AggregateFunction.java).
    `merge` is required for session windows and distributed combines."""

    def create_accumulator(self) -> ACC:
        raise NotImplementedError

    def add(self, value: IN, accumulator: ACC) -> ACC:
        raise NotImplementedError

    def get_result(self, accumulator: ACC) -> OUT:
        raise NotImplementedError

    def merge(self, a: ACC, b: ACC) -> ACC:
        raise NotImplementedError


class _LambdaReduce(ReduceFunction):
    def __init__(self, fn: Callable[[Any, Any], Any]):
        self._fn = fn

    def reduce(self, a, b):
        return self._fn(a, b)


def as_reduce_function(fn) -> ReduceFunction:
    return fn if isinstance(fn, ReduceFunction) else _LambdaReduce(fn)


class ReduceAggregate(AggregateFunction):
    """Adapts a ReduceFunction to the AggregateFunction contract the way
    WindowedStream.reduce wraps into ReducingStateDescriptor."""

    _EMPTY = object()

    def __init__(self, reduce_fn: ReduceFunction):
        self.reduce_fn = as_reduce_function(reduce_fn)

    def create_accumulator(self):
        return ReduceAggregate._EMPTY

    def add(self, value, acc):
        if acc is ReduceAggregate._EMPTY:
            return value
        return self.reduce_fn.reduce(acc, value)

    def get_result(self, acc):
        return None if acc is ReduceAggregate._EMPTY else acc

    def merge(self, a, b):
        if a is ReduceAggregate._EMPTY:
            return b
        if b is ReduceAggregate._EMPTY:
            return a
        return self.reduce_fn.reduce(a, b)


class ProcessWindowFunction(Generic[IN, OUT, KEY]):
    """Receives the (pre-aggregated or buffered) window contents at fire time
    (ProcessWindowFunction.java). `context.window` is the firing window."""

    class Context:
        def __init__(self, window, current_watermark: int):
            self.window = window
            self.current_watermark = current_watermark

    def process(self, key: KEY, context: "ProcessWindowFunction.Context",
                elements: Iterable[IN]) -> Iterator[OUT]:
        raise NotImplementedError


class PassThroughWindowFunction(ProcessWindowFunction):
    def process(self, key, context, elements):
        for e in elements:
            yield e


class ProcessFunction(Generic[IN, OUT]):
    """Low-level per-record function with timers and side outputs
    (KeyedProcessFunction.java). `KeyedStream.process` is not ported yet
    (ROADMAP item 19)."""

    class Context:
        def __init__(self, timestamp, timer_service, side_collector):
            self.timestamp = timestamp
            self.timer_service = timer_service
            self._side = side_collector

        def output(self, tag: str, value) -> None:
            self._side(tag, value)

    def process_element(self, value: IN, ctx: "ProcessFunction.Context") -> Iterator[OUT]:
        raise NotImplementedError

    def on_timer(self, timestamp: int, ctx: "ProcessFunction.Context") -> Iterator[OUT]:
        return iter(())


class KeySelector(Generic[IN, KEY]):
    def get_key(self, value: IN) -> KEY:
        raise NotImplementedError


def as_key_selector(fn) -> Callable[[Any], Any]:
    if isinstance(fn, KeySelector):
        return fn.get_key
    return fn


class OutputTag:
    """Side-output tag (OutputTag.java). Late data uses LATE_DATA_TAG."""

    def __init__(self, tag_id: str):
        self.tag_id = tag_id

    def __hash__(self):
        return hash(self.tag_id)

    def __eq__(self, other):
        return isinstance(other, OutputTag) and other.tag_id == self.tag_id

    def __repr__(self):
        return f"OutputTag({self.tag_id!r})"


LATE_DATA_TAG = OutputTag("late-data")
