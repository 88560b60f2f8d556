"""CEP: complex event processing on keyed streams (reference:
flink-libraries/flink-cep — CepOperator.java:83, nfa/NFA.java, Pattern API).

Counterpart of `flink_tpu/cep/__init__.py`, copied.
"""

from flink_tpu_torch.cep.pattern import Pattern
from flink_tpu_torch.cep.nfa import NFA
from flink_tpu_torch.cep.operator import CepOperator


def pattern_stream(keyed_stream, pattern: Pattern, select_fn=None, name: str = "cep"):
    """CEP.pattern(stream, pattern).select(fn) analogue: returns a DataStream
    of select_fn(match) records."""
    from flink_tpu_torch.api.datastream import DataStream
    from flink_tpu_torch.graph.transformation import Transformation

    t = Transformation(
        "cep",
        name,
        [keyed_stream.transform],
        {
            "pattern": pattern,
            "select_fn": select_fn,
            "key_selector": keyed_stream.key_selector,
        },
    )
    return DataStream(keyed_stream.env, t)
