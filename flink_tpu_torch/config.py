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

    def duration_ms_type(self) -> "_TypedBuilder[int]":
        """Durations are plain ints in milliseconds."""
        return _TypedBuilder(self._key, int)


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
        "disorder >= gap), the per-record oracle operator runs them, as in the "
        "JAX package.")
    SHARED_PARTIALS = (
        ConfigOptions.key("execution.window.shared-partials").bool_type().default_value(True)
    ).with_description(
        "Run correlated window aggregates (sibling window() steps over the "
        "same keyed stream with the same aggregate, e.g. 1m/5m/1h dashboards) "
        "as ONE shared-partial device program: slices are ingested once at "
        "the gcd granule and every member window folds its result from the "
        "shared ring at fire time (graph/window_sharing.py). Needs "
        "execution.chain.device-fusion and execution.window.fused. A perf "
        "switch, never a semantics switch: off, each member runs its own "
        "fused program with the same rows.")
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


class LatencyOptions:
    """Latency-mode execution (execution.latency.*): the fused window path
    trades superbatch amortization for emission latency under an explicit
    target. Off by default; a perf switch, never a semantics switch."""

    TARGET_MS = (
        ConfigOptions.key("execution.latency.target-ms").int_type().default_value(0)
    ).with_description(
        "Emission-latency target for the fused window path; 0 (default) keeps "
        "throughput mode and its dispatches unchanged. When set, a controller "
        "(scheduler/latency_controller.py) adapts the superbatch depth between "
        "execution.latency.floor-steps and execution.window.superbatch-steps "
        "from windowed arrival-rate estimates, on a pow2 rung ladder.")
    MAX_INFLIGHT = (
        ConfigOptions.key("execution.latency.max-inflight-dispatches")
        .int_type().default_value(1)
    ).with_description(
        "Bound of the fused operator's in-flight dispatch ring: how many "
        "enqueued dispatches may await resolution at once. Barriers "
        "(flush_all, snapshot) drain the whole ring in dispatch order.")
    FLOOR_STEPS = (
        ConfigOptions.key("execution.latency.floor-steps").int_type().default_value(2)
    ).with_description(
        "Smallest superbatch depth the latency controller may select: the "
        "bottom rung of the pow2 ladder.")
    READBACK_STEPS = (
        ConfigOptions.key("execution.latency.readback-steps").int_type().default_value(8)
    ).with_description(
        "Streamed fire readback: a dispatch runs as groups of this many steps "
        "(one K1 launch each), and each group's fired rows start their "
        "device-to-host copy as soon as the group is launched. Rows and their "
        "order are those of the whole-span dispatch. 0 keeps span-granular "
        "readback; a depth it does not divide runs whole.")
    MIN_DWELL_MS = (
        ConfigOptions.key("execution.latency.min-dwell-ms")
        .duration_ms_type().default_value(500)
    ).with_description(
        "Minimum time the controller holds a rung before a non-escalation "
        "move; a rate spike that demands the full span escalates at once.")
    HYSTERESIS_PCT = (
        ConfigOptions.key("execution.latency.hysteresis-pct").int_type().default_value(25)
    ).with_description(
        "Dead band around each rung boundary, in percent of the boundary "
        "rate, so a rate oscillating across a boundary never flaps rungs.")


class TableOptions:
    """The Table/SQL front door (`table/`, `planner/`)."""

    DEVICE_FUSION = (
        ConfigOptions.key("table.device-fusion").bool_type().default_value(True)
    ).with_description(
        "Route SQL statements through the planner (`planner/`): a windowed "
        "GROUP BY aggregate over a table with declared field_types (the GROUP "
        "BY key a declared int) lowers onto the same fused step graph a "
        "hand-built DataStream job takes (DeviceChainRunner, kernel K1). Other "
        "statements take the interpreted table path with a catalogued reason "
        "in `last_plan_report`. False interprets every statement. A perf "
        "switch, never a semantics switch: both paths give the same rows.")
