"""Typed configuration: the options the port's DataStream path reads.

Counterpart of `flink_tpu/config.py`. Keys and defaults are the JAX
package's, so a job configured for one package configures the other the
same way. Only the options the port implements are defined here; setting
any other key raises, naming the ROADMAP.md item that will carry it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Generic, Optional, TypeVar

from flink_tpu_torch.utils import deferred

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class ConfigOption(Generic[T]):
    """A typed configuration key with a default value."""

    key: str
    default: T = None  # type: ignore[assignment]
    type: type = object
    description: str = ""

    def with_description(self, description: str) -> "ConfigOption[T]":
        return dataclasses.replace(self, description=description)

    def __hash__(self) -> int:
        return hash(self.key)


class ConfigOptions:
    """Builder entry point: ConfigOptions.key(...).int_type().default_value(...)."""

    @staticmethod
    def key(key: str) -> "_OptionBuilder":
        return _OptionBuilder(key)


class _OptionBuilder:
    def __init__(self, key: str):
        self._key = key

    def int_type(self) -> "_TypedBuilder[int]":
        return _TypedBuilder(self._key, int)

    def bool_type(self) -> "_TypedBuilder[bool]":
        return _TypedBuilder(self._key, bool)

    def string_type(self) -> "_TypedBuilder[str]":
        return _TypedBuilder(self._key, str)


class _TypedBuilder(Generic[T]):
    def __init__(self, key: str, typ: type):
        self._key = key
        self._type = typ

    def default_value(self, value: T) -> ConfigOption[T]:
        option = ConfigOption(key=self._key, default=value, type=self._type)
        _OPTIONS[option.key] = option
        return option


#: every option the port implements, by key
_OPTIONS: Dict[str, ConfigOption] = {}

#: key prefixes of the JAX package's options the port does not carry yet
_UNPORTED_PREFIXES = (
    ("parallel.", deferred.MESH),
    ("state.tier.", deferred.STATE_PLANE),
    ("execution.latency.", deferred.D2),
    # a perf switch in the JAX package; the port forms no sharing group,
    # so sibling windows each run their own fused program
    ("execution.window.shared-partials", deferred.D3),
    ("observability.", deferred.METRICS),
    ("execution.checkpointing.", deferred.CHECKPOINTS),
    ("state.checkpoints.", deferred.CHECKPOINTS),
    ("state.savepoints.", deferred.CHECKPOINTS),
    ("restart-strategy", deferred.CHECKPOINTS),
    ("execution.join.", deferred.JOINS),
)


def _coerce(value: Any, typ: type) -> Any:
    if typ is object or value is None or isinstance(value, typ):
        return value
    if typ is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes", "on")
        return bool(value)
    return typ(value)


def _check_key(key: str) -> None:
    if key in _OPTIONS:
        return
    item = next((it for prefix, it in _UNPORTED_PREFIXES if key.startswith(prefix)),
                "the module that reads it")
    raise deferred.not_ported(f"configuration option {key!r}", item)


class Configuration:
    """Key/value store resolved against typed ConfigOptions. Only keys of
    the port's options may be set."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data: Dict[str, Any] = {}
        for k, v in (data or {}).items():
            self.set_string(k, v)

    def get(self, option: ConfigOption[T]) -> T:
        if option.key in self._data:
            return _coerce(self._data[option.key], option.type)
        return option.default

    def set(self, option: ConfigOption[T], value: T) -> "Configuration":
        return self.set_string(option.key, value)

    def set_string(self, key: str, value: Any) -> "Configuration":
        _check_key(key)
        self._data[key] = value
        return self

    def __repr__(self) -> str:
        return f"Configuration({self._data!r})"


class PipelineOptions:
    NAME = ConfigOptions.key("pipeline.name").string_type().default_value("flink-tpu-job")
    MAX_PARALLELISM = ConfigOptions.key("pipeline.max-parallelism").int_type().default_value(128)
    PARALLELISM = (
        ConfigOptions.key("pipeline.parallelism").int_type().default_value(1)
    ).with_description("Subtasks per operator; the port runs 1 (more raises).")


class ExecutionOptions:
    BATCH_SIZE = (
        ConfigOptions.key("execution.step.batch-size").int_type().default_value(65536)
    ).with_description("Records per source poll and per superscan step.")
    KEY_CAPACITY = (
        ConfigOptions.key("execution.state.key-capacity").int_type().default_value(1 << 16)
    ).with_description(
        "Key capacity of device state: the bound of the fused device chain's "
        "dense keys, and the cap the host-keyed fused window grows to.")
    FUSED_WINDOWS = (
        ConfigOptions.key("execution.window.fused").bool_type().default_value(True)
    ).with_description(
        "Run eligible event-time window aggregates on the fused superscan "
        "operator (one dispatch per superbatch). Off, they run on the per-batch "
        "device operator (TpuWindowOperator), as do windows with allowed "
        "lateness or a late side output.")
    CHAIN_FUSION = (
        ConfigOptions.key("execution.chain.device-fusion").bool_type().default_value(True)
    ).with_description(
        "Run a traceable map/filter/map_ts chain plus traceable key/value "
        "extraction as a prologue on the device, inside the fused window "
        "dispatch. Off, or for an ineligible chain, the host chain runs it "
        "with identical results.")
    SUPERBATCH_STEPS = (
        ConfigOptions.key("execution.window.superbatch-steps").int_type().default_value(32)
    ).with_description("Steps buffered per fused-window dispatch.")
    DEVICE_SESSIONS = (
        ConfigOptions.key("execution.window.device-sessions").bool_type().default_value(True)
    ).with_description(
        "Select the device session-window operator (per-slice fragments + "
        "gap-merge scan, kernels K3/K4) for eligible event-time session "
        "aggregates. Its late contract drops records whose standalone session "
        "is already expired, which matches the merging oracle only while "
        "watermark out-of-orderness stays below the session gap. Off (or "
        "disorder >= gap), the JAX package runs the per-record oracle, which "
        "the port does not carry: the job raises (ROADMAP item 18).")
    COLUMNAR_OUTPUT = (
        ConfigOptions.key("execution.window.columnar-output").bool_type().default_value(False)
    ).with_description(
        "Emit window fires as packed (window, key-ids, values) rows instead of "
        "one (key, value) row per key.")
    MINI_BATCH_GROUP_AGG = (
        ConfigOptions.key("execution.group-agg.mini-batch").bool_type().default_value(True)
    ).with_description(
        "Continuous (non-windowed) aggregates emit one changelog transition "
        "per distinct key per step batch (the reference's "
        "table.exec.mini-batch optimization) instead of per input record. "
        "Set to false for the exact per-record emission sequence.")
    DEVICE_GROUP_AGG = (
        ConfigOptions.key("execution.group-agg.device").bool_type().default_value(False)
    ).with_description(
        "Keep continuous-aggregation accumulators in device memory with one "
        "scatter-add step per batch (COUNT/SUM/AVG only; MIN/MAX need the "
        "host retractable multiset). COUNT columns are int32 on the device "
        "and wrap past 2**31 - 1 where the host path's integers would not; "
        "SUM/AVG accumulate in float32 where the host path uses float64.")
