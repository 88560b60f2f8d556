"""User function interfaces.

Counterpart of `flink_tpu/api/functions.py` (whose definitions live in
`flink_tpu/core/functions.py`): the interfaces a DataStream job on the
port's path takes, and the side-output tags. A `traceable=True` UDF on the port is a function of a
torch tensor column; a `vectorized=True` one takes a numpy column; a plain
one takes one record.
"""

from __future__ import annotations

from typing import Any, Callable, Generic, TypeVar

IN = TypeVar("IN")
OUT = TypeVar("OUT")
ACC = TypeVar("ACC")
KEY = TypeVar("KEY")


class MapFunction(Generic[IN, OUT]):
    def map(self, value: IN) -> OUT:
        raise NotImplementedError


class FilterFunction(Generic[IN]):
    def filter(self, value: IN) -> bool:
        raise NotImplementedError


class AggregateFunction(Generic[IN, ACC, OUT]):
    """create/add/get_result/merge contract (AggregateFunction.java). An
    aggregate of this kind runs on the per-record oracle operator, which
    the port does not carry yet (ROADMAP item 18)."""

    def create_accumulator(self) -> ACC:
        raise NotImplementedError

    def add(self, value: IN, accumulator: ACC) -> ACC:
        raise NotImplementedError

    def get_result(self, accumulator: ACC) -> OUT:
        raise NotImplementedError

    def merge(self, a: ACC, b: ACC) -> ACC:
        raise NotImplementedError


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
