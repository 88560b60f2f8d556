"""Aggregator specs of the fused window path.

Counterpart of `flink_tpu/ops/aggregators.py`. The accumulator of a
(key, window) is *columnar*: each field is one ring of cells in device
memory, updated by a scatter-combine at ingest and folded across a window's
slices at fire time. Fields combine by add, min or max — enough for
sum/count/min/max/mean.

A field may be declared with a 64-bit dtype (`sum_agg(np.float64)`); it
computes in the 32-bit form all the same (`device_dtype`), as the JAX
package's arrays do with x64 off, so both packages give the same rows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.core.functions import AggregateFunction
from flink_tpu_torch.utils.arrays import canonical_dtype

# scatter sources
VALUE = "value"   # scatter the record's value column
ONE = "one"       # scatter constant 1 (count)


@dataclasses.dataclass(frozen=True)
class AccField:
    """One columnar accumulator field."""

    name: str
    dtype: Any            # numpy dtype of the field
    identity: float       # padding / empty-slice value
    scatter: str          # 'add' | 'min' | 'max'
    source: str = VALUE   # which input column feeds the scatter
    # declared value domain: non-negative ints < 2**domain_bits (the bounded
    # max the JAX package runs as nibble histograms); None = unbounded
    domain_bits: Any = None

    @property
    def device_dtype(self) -> np.dtype:
        """The numpy dtype the field's ring holds (32-bit)."""
        return device_dtype(self.dtype)

    @property
    def device_identity(self):
        """The identity as the field's ring holds it."""
        return device_value(self.identity, self.dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceAggregator:
    """Columnar aggregator: fields + an extract over the combined fields.

    `extract` maps {field_name: array} -> result array and uses only
    operations that work on numpy arrays and torch tensors alike.
    eq=False ⇒ identity hashing; the built-in factories memoize and return
    one instance per argument set.
    """

    name: str
    fields: Tuple[AccField, ...]
    extract: Callable[[Dict[str, Any]], Any]
    result_dtype: Any = np.float32
    combinable: bool = True

    def field(self, name: str) -> AccField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def python_equivalent(self) -> AggregateFunction:
        """Scalar AggregateFunction with identical math, for the per-record
        oracle operator (JAX `DeviceAggregator.python_equivalent`)."""
        return _ColumnarAsPython(self)


_SCATTER_NP = {
    "add": lambda a, b: a + b,
    "min": np.minimum,
    "max": np.maximum,
}


class _ColumnarAsPython(AggregateFunction):
    """Scalar-dict interpretation of a DeviceAggregator (oracle parity):
    count, sum, min, max and mean as `AggregateFunction`s."""

    def __init__(self, spec: DeviceAggregator):
        self.spec = spec

    def create_accumulator(self):
        return {f.name: f.identity for f in self.spec.fields}

    def add(self, value, acc):
        out = dict(acc)
        for f in self.spec.fields:
            v = 1 if f.source == ONE else value
            out[f.name] = _SCATTER_NP[f.scatter](acc[f.name], v)
        return out

    def get_result(self, acc):
        res = self.spec.extract({k: np.asarray(v) for k, v in acc.items()})
        arr = np.asarray(res)
        return arr.item() if arr.ndim == 0 else arr

    def merge(self, a, b):
        return {
            f.name: _SCATTER_NP[f.scatter](a[f.name], b[f.name])
            for f in self.spec.fields
        }


def combine_binary(op: str):
    """Elementwise torch combine for a scatter kind."""
    table = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}
    if op not in table:
        raise ValueError(op)
    return table[op]


def combine_reduce(op: str):
    """Axis reduction for a scatter kind (numpy arrays and torch tensors):
    the fire-time fold over a window's slice cells."""
    if op == "add":
        return lambda a, axis: a.sum(axis)
    if op == "min":
        return lambda a, axis: a.min(axis)[0] if isinstance(a, torch.Tensor) else a.min(axis)
    if op == "max":
        return lambda a, axis: a.max(axis)[0] if isinstance(a, torch.Tensor) else a.max(axis)
    raise ValueError(op)


def scan_identity(dtype, scatter: str):
    """The neutral element of a scatter kind at a dtype, as a ring of that
    dtype holds it — what purged ring cells and empty fold lanes hold so
    combining them is a no-op."""
    if scatter == "add":
        return 0
    if scatter == "min":
        return device_value(_max_of(dtype), dtype)
    if scatter == "max":
        return device_value(_min_of(dtype), dtype)
    raise ValueError(scatter)


def device_dtype(dtype) -> np.dtype:
    """The dtype a field of `dtype` computes in: 64-bit numeric dtypes
    narrow to 32 bits (int64→int32, float64→float32), the dtypes of the
    JAX package's device arrays with x64 off."""
    return canonical_dtype(dtype)


def device_value(value, dtype):
    """A fill value of a field declared `dtype` as its 32-bit ring holds it,
    cast as numpy (and jnp with x64 off) casts: a float64 extreme becomes
    ±inf, an int64 one wraps."""
    with np.errstate(over="ignore"):
        return np.asarray(value, np.dtype(dtype)).astype(device_dtype(dtype)).item()


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype a field declared `dtype` computes in (32-bit)."""
    return torch.from_numpy(np.zeros(0, device_dtype(dtype))).dtype


# ---------------------------------------------------------------------------
# Built-ins
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def sum_agg(dtype=np.float32) -> DeviceAggregator:
    return DeviceAggregator(
        "sum",
        (AccField("sum", dtype, 0, "add"),),
        lambda f: f["sum"],
        result_dtype=dtype,
    )


@functools.lru_cache(maxsize=None)
def count_agg() -> DeviceAggregator:
    return DeviceAggregator(
        "count",
        (AccField("count", np.int32, 0, "add", source=ONE),),
        lambda f: f["count"],
        result_dtype=np.int32,
    )


@functools.lru_cache(maxsize=None)
def min_agg(dtype=np.float32) -> DeviceAggregator:
    ident = _max_of(dtype)
    return DeviceAggregator(
        "min", (AccField("min", dtype, ident, "min"),), lambda f: f["min"], result_dtype=dtype
    )


@functools.lru_cache(maxsize=None)
def max_agg(dtype=np.float32, domain_bits=None) -> DeviceAggregator:
    """Windowed max. With `domain_bits` set, values are declared to be
    non-negative ints < 2**domain_bits: the accumulator becomes int32 with
    identity -1 ("absent") and ingest clips each value to [0, 255]."""
    if domain_bits is not None:
        if domain_bits > 8:
            raise ValueError("bounded max supports domain_bits <= 8")
        return DeviceAggregator(
            "max8",
            (AccField("max", np.int32, -1, "max", domain_bits=domain_bits),),
            lambda f: f["max"],
            result_dtype=np.int32,
        )
    ident = _min_of(dtype)
    return DeviceAggregator(
        "max", (AccField("max", dtype, ident, "max"),), lambda f: f["max"], result_dtype=dtype
    )


@functools.lru_cache(maxsize=None)
def mean_agg(dtype=np.float32) -> DeviceAggregator:
    return DeviceAggregator(
        "mean",
        (
            AccField("sum", dtype, 0, "add"),
            AccField("count", np.int32, 0, "add", source=ONE),
        ),
        lambda f: f["sum"] / _maximum(f["count"], 1),
        result_dtype=dtype,
    )


def _maximum(a, b):
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, min=b)
    return np.maximum(a, b)


def _max_of(dtype) -> float:
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return float(np.finfo(dt).max)
    return int(np.iinfo(dt).max)


def _min_of(dtype) -> float:
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return float(np.finfo(dt).min)
    return int(np.iinfo(dt).min)


BUILTINS = {
    "sum": sum_agg,
    "count": count_agg,
    "min": min_agg,
    "max": max_agg,
    "mean": mean_agg,
}


def resolve(agg) -> Optional[DeviceAggregator]:
    """Resolve a user-provided aggregate spec to a DeviceAggregator; None
    means it has no device form."""
    if isinstance(agg, DeviceAggregator):
        return agg
    if isinstance(agg, str) and agg in BUILTINS:
        return BUILTINS[agg]()
    return None
