"""User function interfaces, re-exported from `core/functions.py`.

Counterpart of `flink_tpu/api/functions.py`: the definitions live in core
(as the reference places them in flink-core), and this module keeps the
API-namespace import path.
"""

from flink_tpu_torch.core.functions import (  # noqa: F401
    ACC,
    IN,
    KEY,
    LATE_DATA_TAG,
    OUT,
    AggregateFunction,
    FilterFunction,
    FlatMapFunction,
    KeySelector,
    MapFunction,
    OutputTag,
    PassThroughWindowFunction,
    ProcessFunction,
    ProcessWindowFunction,
    ReduceAggregate,
    ReduceFunction,
    as_key_selector,
    as_reduce_function,
)
