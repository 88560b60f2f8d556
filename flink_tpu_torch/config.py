"""Typed configuration: the options the port's DataStream path reads.

Counterpart of `flink_tpu/config.py`. Keys and defaults are the JAX
package's, so a job configured for one package configures the other the
same way. The options the port implements are defined here, and so are
the JAX package's options that no module of either package reads
(`pipeline.object-reuse`, `execution.runtime-mode`, `DeviceOptions`,
`MetricOptions`): a job may set them and nothing changes. Setting any
other key raises, naming the ROADMAP.md item that will carry it.

The layered surface is the JAX package's: options with fallback keys, and
a `Configuration` built from defaults < file (`load`) < dynamic
properties (`from_env`) < per-job overrides (`add_all`, `set`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Generic, Iterable, Optional, TypeVar

from flink_tpu_torch.utils import deferred

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class ConfigOption(Generic[T]):
    """A typed configuration key with a default value."""

    key: str
    default: T = None  # type: ignore[assignment]
    type: type = object
    description: str = ""
    fallback_keys: tuple = ()

    def with_description(self, description: str) -> "ConfigOption[T]":
        return dataclasses.replace(self, description=description)

    def with_fallback_keys(self, *keys: str) -> "ConfigOption[T]":
        option = dataclasses.replace(self, fallback_keys=tuple(keys))
        for k in keys:
            _OPTIONS[k] = option
        return option

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

    def float_type(self) -> "_TypedBuilder[float]":
        return _TypedBuilder(self._key, float)

    def bool_type(self) -> "_TypedBuilder[bool]":
        return _TypedBuilder(self._key, bool)

    def string_type(self) -> "_TypedBuilder[str]":
        return _TypedBuilder(self._key, str)

    def duration_ms_type(self) -> "_TypedBuilder[int]":
        """Durations are plain ints in milliseconds."""
        return _TypedBuilder(self._key, int)

    def list_type(self) -> "_TypedBuilder[list]":
        return _TypedBuilder(self._key, list)


class _TypedBuilder(Generic[T]):
    def __init__(self, key: str, typ: type):
        self._key = key
        self._type = typ

    def default_value(self, value: T) -> ConfigOption[T]:
        option = ConfigOption(key=self._key, default=value, type=self._type)
        _OPTIONS[option.key] = option
        return option

    def no_default_value(self) -> ConfigOption[Optional[T]]:
        return self.default_value(None)


#: every option the port implements, by key
_OPTIONS: Dict[str, ConfigOption] = {}

def _coerce(value: Any, typ: type) -> Any:
    if typ is object or value is None or isinstance(value, typ):
        return value
    if typ is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes", "on")
        return bool(value)
    if typ is list and isinstance(value, str):
        return [v.strip() for v in value.split(";") if v.strip()]
    return typ(value)


def _check_key(key: str) -> None:
    if key not in _OPTIONS:
        raise deferred.not_ported(f"configuration option {key!r}", "the module that reads it")


class Configuration:
    """Layered key/value store resolved against typed ConfigOptions: get and
    set by option, fallback-key resolution, cloning and merge (`add_all`).
    Only keys (or fallback keys) of the port's options may be set."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data: Dict[str, Any] = {}
        for k, v in (data or {}).items():
            self.set_string(k, v)

    # -- typed access -----------------------------------------------------
    def get(self, option: ConfigOption[T], override_default: Optional[T] = None) -> T:
        if option.key in self._data:
            return _coerce(self._data[option.key], option.type)
        for fk in option.fallback_keys:
            if fk in self._data:
                return _coerce(self._data[fk], option.type)
        return override_default if override_default is not None else option.default

    def set(self, option: ConfigOption[T], value: T) -> "Configuration":
        return self.set_string(option.key, value)

    def contains(self, option: ConfigOption) -> bool:
        return option.key in self._data or any(fk in self._data for fk in option.fallback_keys)

    def remove(self, option: ConfigOption) -> bool:
        return self._data.pop(option.key, _SENTINEL) is not _SENTINEL

    # -- raw access -------------------------------------------------------
    def set_string(self, key: str, value: Any) -> "Configuration":
        _check_key(key)
        self._data[key] = value
        return self

    def get_string(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def key_set(self) -> Iterable[str]:
        return self._data.keys()

    # -- layering ---------------------------------------------------------
    def add_all(self, other: "Configuration") -> "Configuration":
        self._data.update(other._data)
        return self

    def clone(self) -> "Configuration":
        return Configuration(dict(self._data))

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "Configuration":
        return Configuration(dict(data))

    @staticmethod
    def from_env(prefix: str = "FLINK_TPU_") -> "Configuration":
        """Dynamic-property layer from environment variables:
        FLINK_TPU_FOO_BAR=1 -> key "foo.bar" (reference: dynamic -D props)."""
        data = {}
        for k, v in os.environ.items():
            if k.startswith(prefix):
                data[k[len(prefix):].lower().replace("_", ".")] = v
        return Configuration(data)

    @staticmethod
    def load(path: str) -> "Configuration":
        """File layer. JSON or simple `key: value` YAML subset (no deps)."""
        with open(path) as f:
            text = f.read()
        try:
            return Configuration(json.loads(text))
        except json.JSONDecodeError:
            data: Dict[str, Any] = {}
            for line in text.splitlines():
                line = line.strip()
                if not line or line.startswith("#") or ":" not in line:
                    continue
                key, _, val = line.partition(":")
                data[key.strip()] = val.strip()
            return Configuration(data)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Configuration) and self._data == other._data

    def __repr__(self) -> str:
        return f"Configuration({self._data!r})"


_SENTINEL = object()


class PipelineOptions:
    NAME = ConfigOptions.key("pipeline.name").string_type().default_value("flink-tpu-job")
    MAX_PARALLELISM = ConfigOptions.key("pipeline.max-parallelism").int_type().default_value(128)
    PARALLELISM = (
        ConfigOptions.key("pipeline.parallelism").int_type().default_value(1)
    ).with_description(
        "Subtasks per operator. Read by no runner, as in the JAX package: a "
        "job runs as one attempt, and keyed state spreads over devices "
        "through parallel.mesh.* instead.")
    # read by no module of either package
    AUTO_WATERMARK_INTERVAL = (
        ConfigOptions.key("pipeline.auto-watermark-interval").duration_ms_type().default_value(200)
    )
    OBJECT_REUSE = ConfigOptions.key("pipeline.object-reuse").bool_type().default_value(True)


class ExecutionOptions:
    # read by no module of either package
    BATCH_TIMEOUT_MS = (
        ConfigOptions.key("execution.step.batch-timeout-ms").duration_ms_type().default_value(10)
    ).with_description("Max time to wait filling a step batch (BufferDebloater analogue).")
    RUNTIME_MODE = ConfigOptions.key("execution.runtime-mode").string_type().default_value("STREAMING")
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
    DEVICE_JOINS = (
        ConfigOptions.key("execution.join.device-enabled").bool_type().default_value(True)
    ).with_description(
        "Select the device join operator (per-key time-bucketed rings in "
        "HBM + segment-wise cross-match, docs/joins.md) for eligible "
        "event-time window equi-joins. Ineligible shapes — processing "
        "time, session windows, coGroup, outer joins — keep the host "
        "operator with an attributed reason (joinFallbackReason); off "
        "forces the host operator for every join. A perf switch, never a "
        "semantics switch.")
    JOIN_BUCKET_CAPACITY = (
        ConfigOptions.key("execution.join.bucket-capacity").int_type().default_value(128)
    ).with_description(
        "Record slots per (key, time bucket, side) in the device join "
        "ring. A (key, bucket) side that exceeds it mid-stream degrades "
        "that operator to the host join — state carried over, "
        "exactly-once preserved, reason recorded — for the rest of the "
        "job. Size it to the worst per-key burst inside one bucket "
        "granule (gcd of window size and slide).")
    JOIN_RING_SLACK = (
        ConfigOptions.key("execution.join.ring-slack-buckets").int_type().default_value(64)
    ).with_description(
        "Extra ring depth beyond one window's buckets: how many bucket "
        "granules event time may run ahead of the purge horizon before "
        "the ring would wrap onto a live bucket (which degrades to the "
        "host join, never corrupts). Raise for very disordered streams.")


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


class DeviceOptions:
    """Read by no module of either package."""

    MESH_AXIS_NAME = ConfigOptions.key("device.mesh.axis-name").string_type().default_value("shards")
    NUM_SHARDS = (
        ConfigOptions.key("device.mesh.num-shards").int_type().default_value(0)
    ).with_description("0 = use all visible devices.")
    DONATE_STATE = ConfigOptions.key("device.donate-state").bool_type().default_value(True)


class MetricOptions:
    """Read by no module of either package (the port's metrics are the
    observability.* options)."""

    LATENCY_INTERVAL_MS = (
        ConfigOptions.key("metrics.latency.interval").duration_ms_type().default_value(0))
    REPORTERS = ConfigOptions.key("metrics.reporters").list_type().default_value([])


class ParallelOptions:
    """Execution over a mesh of shards in this process (flink_tpu_torch/
    parallel/): eligible fused keyed window jobs shard their window-state
    rings by key range over the mesh and run the keyBy exchange between
    the shards' devices inside each dispatch — the mesh is a slot resource
    of the process, not a cluster of tasks. The descriptions follow the
    JAX package's; on the port a device is a GPU (or the CPU), the
    exchange is block copies between the shards' devices, and the mesh's
    devices come from parallel/mesh.py::visible_devices. The mesh's
    control loops run in the MiniCluster's attempt loop: the skew
    rebalancer (scheduler/rebalancer.py), the autoscaler's mesh rescale
    (scheduler/autoscaler.py) and the device-loss degrade."""

    MESH_ENABLED = (
        ConfigOptions.key("parallel.mesh.enabled").bool_type().default_value(False)
    ).with_description(
        "Run eligible fused keyed window jobs over a mesh of shards, one "
        "torch device each (a device may repeat): window-state columns "
        "shard by contiguous key range, each shard transforms and keys its "
        "slice of the ingest batch, and ONE exchange per dispatch of T "
        "steps routes records to their key-range owners, as per-pair block "
        "copies on the device (no host dataplane hop). Results are "
        "byte-identical to the single-device fused path; snapshots stay "
        "canonical [K, S], so checkpoints restore across any mesh size. "
        "Under 2 usable devices (parallel/mesh.py::visible_devices) the job "
        "stays on one device."
    )
    MESH_DEVICES = (
        ConfigOptions.key("parallel.mesh.devices").int_type().default_value(0)
    ).with_description(
        "Devices in the job's mesh. 0 (default) uses every visible device. "
        "Clamped to the visible device count, then rounded down to the "
        "largest divisor of the key capacity so contiguous key ranges "
        "divide evenly across shards."
    )
    MESH_DEGRADE_ON_DEVICE_LOSS = (
        ConfigOptions.key("parallel.mesh.degrade-on-device-loss")
        .bool_type().default_value(True)
    ).with_description(
        "When a mesh job fails with a device-plane error (a CUDA error "
        "raised by torch or by a kernel launch; chaos drills inject the "
        "same shape with a device-scoped marker), the restart rebuilds the "
        "job at a REDUCED mesh size instead of retrying the dead geometry "
        "forever: the latest checkpoint's canonical [K, S] snapshot "
        "re-shards over the surviving devices (halving per restart, floor "
        "1 = one device). Off restarts at the configured size every time."
    )
    MESH_AUTOSCALE = (
        ConfigOptions.key("parallel.mesh.autoscale").bool_type().default_value(True)
    ).with_description(
        "Let the autoscaler (autoscaler.enabled) treat MESH SIZE as the "
        "parallelism axis it rescales on the in-process path: scaling "
        "decisions execute as a live checkpoint-rewind + key-group re-shard "
        "onto a different device count at a step boundary, exactly-once. "
        "Off keeps the autoscaler observe-only for mesh jobs."
    )
    MESH_LOCAL_COMBINE = (
        ConfigOptions.key("parallel.mesh.local-combine")
        .bool_type().default_value(False)
    ).with_description(
        "Map-side combiner for the mesh keyBy exchange: each shard "
        "segment-reduces its slice of every step by (key, rel-slice) "
        "BEFORE the exchange, so what crosses the interconnect is at "
        "most one partial per (source shard, key, slice) instead of the "
        "key's full tuple mass — under zipf-skewed traffic a hot key "
        "costs n_shards partials per slice, not its record count. "
        "Applies to decomposable builtin aggregates (count/sum/min/max, "
        "mean as its two add-scatter fields); non-decomposable aggregates "
        "transparently keep the route-raw exchange. A performance switch, "
        "never a semantics switch: partial pre-reduction uses the same "
        "scatter combiners the ring ingest applies — counts and integer/"
        "min/max fields are bit-exact; float-ADD fields are reassociated "
        "(partials per source shard, then a cross-shard fold), which like "
        "any parallel pre-aggregation is bit-exact for integer-valued "
        "payloads and may differ in final ulps otherwise."
    )
    MESH_SKEW_REBALANCE = (
        ConfigOptions.key("parallel.mesh.skew-rebalance")
        .bool_type().default_value(False)
    ).with_description(
        "Skew-aware key-group routing on the in-process mesh path: the "
        "static owner function (key-group -> contiguous device range) "
        "becomes a routing table on each shard's device, and a rebalancer "
        "in the scheduler watches the per-key-group loads and remaps the "
        "hottest key-groups across devices at a step-aligned boundary "
        "through the mesh-rescale capture/restore machinery — exactly-once, "
        "with checkpoints staying canonical [K, S] (routing is placement, "
        "never semantics). Off keeps the static contiguous owner function."
    )
    MESH_KEY_GROUPS = (
        ConfigOptions.key("parallel.mesh.key-groups").int_type()
        .default_value(0)
    ).with_description(
        "Key-group count of the skew-rebalance routing table (0 = auto: "
        "up to 128, rounded to a multiple of the mesh size that divides "
        "the key capacity). More groups = finer-grained rebalancing at "
        "a slightly larger replicated routing table."
    )
    MESH_REBALANCE_SKEW_THRESHOLD = (
        ConfigOptions.key("parallel.mesh.rebalance.skew-threshold")
        .float_type().default_value(1.25)
    ).with_description(
        "meshLoadSkew (max/mean per-device resident records) above which "
        "the skew rebalancer considers remapping key-groups. A rebalance "
        "only triggers when the replanned assignment also improves the "
        "predicted skew by at least ~10% — a single unsplittable hot "
        "group never causes rebuild churn."
    )
    MESH_REBALANCE_INTERVAL_MS = (
        ConfigOptions.key("parallel.mesh.rebalance.interval-ms")
        .int_type().default_value(1000)
    ).with_description(
        "Minimum milliseconds between skew-rebalancer decisions (and "
        "between a completed rebalance and the next check). 0 decides on "
        "every step boundary — test/bench cadence, not production: each "
        "decision reads the per-key loads back from the device."
    )


class StateTierOptions:
    """The million-key state plane (state/vocab.py, state/tier_manager.py):
    a dynamic key vocabulary bounds the RESIDENT key set to a fixed number of
    device ring rows, demotes cold keys' rows through the host/disk cold
    tier, promotes them on re-admission, and (optionally) journals every
    interval's delta so checkpoints are incremental."""

    TIER_ENABLED = (
        ConfigOptions.key("state.tier.enabled").bool_type().default_value(False)
    ).with_description(
        "Decouple key cardinality from the device key capacity on the "
        "host-keyed fused window path: at most state.tier.hot-key-capacity "
        "keys stay RESIDENT as device ring rows (admission and eviction per "
        "state.tier.eviction-policy); every other key's state lives in the "
        "cold tier (host memtable + spilled runs) and aggregates there; window "
        "fires merge both tiers exactly. Results are the untiered path's: "
        "tiering is placement, never semantics. Applies to FusedWindowOperator "
        "jobs with host key dictionaries (traced dense-keyed chains keep their "
        "device keying) and forces row-mode emission (dense ids are recycled, "
        "so packed columnar output would alias keys). With the fused path off, "
        "TpuWindowOperator takes a grow-only hot/cold id split instead.")
    HOT_KEY_CAPACITY = (
        ConfigOptions.key("state.tier.hot-key-capacity").int_type().default_value(1 << 13)
    ).with_description(
        "Resident dense-id capacity of the hot tier (device ring rows) when "
        "state.tier.enabled. Unlike execution.state.key-capacity this never "
        "grows: the vocabulary evicts instead.")
    EVICTION_POLICY = (
        ConfigOptions.key("state.tier.eviction-policy").string_type().default_value("lru")
    ).with_description(
        "Victim selection when the hot tier is full: 'lru' (least recently "
        "used, frequency tiebreak) or 'lfu' (least frequently used, recency "
        "tiebreak). Keys touched by the batch being routed are pinned either "
        "way.")
    ADMISSION_MIN_COUNT = (
        ConfigOptions.key("state.tier.admission-min-count").int_type().default_value(1)
    ).with_description(
        "Doorkeeper: while the hot tier is full, a key must be sighted this "
        "many times before it may evict a resident (tiny-LFU admission; 1 = "
        "always admit). Raise under heavy-tailed traffic so one-touch keys "
        "aggregate cold instead of churning hot rows.")
    COLD_DIR = (
        ConfigOptions.key("state.tier.cold-dir").string_type().default_value("")
    ).with_description(
        "Directory for the cold tier's spilled runs. Empty = a fresh temp "
        "directory per operator instance; set it to survive in-place restarts.")
    CHANGELOG_ENABLED = (
        ConfigOptions.key("state.changelog.enabled").bool_type().default_value(False)
    ).with_description(
        "Incremental checkpoints for tiered operators: cold-tier mutations and "
        "vocabulary ops journal into an append-only segment log as they "
        "happen, and each checkpoint appends ONE entry with the "
        "interval-touched device cells, so a checkpoint handle is "
        "(materialized base, log offset) and its bytes scale with the "
        "per-interval delta. Restore replays the log over the base host-side "
        "into the canonical full snapshot. Requires state.tier.enabled.")
    CHANGELOG_DIR = (
        ConfigOptions.key("state.changelog.dir").string_type().default_value("")
    ).with_description(
        "Directory for changelog segments and materialized bases. Empty = a "
        "fresh temp directory per operator instance.")
    CHANGELOG_MATERIALIZE_INTERVAL = (
        ConfigOptions.key("state.changelog.materialize-interval").int_type()
        .default_value(8)
    ).with_description(
        "Checkpoints between full materializations: every Nth checkpoint "
        "folds the log into a fresh base file and truncates segments below the "
        "oldest retained base.")
    CHANGELOG_RETAINED_BASES = (
        ConfigOptions.key("state.changelog.retained-bases").int_type().default_value(4)
    ).with_description(
        "Materialized base files kept on disk; must cover the checkpoint "
        "retention window (a restorable handle must find its base).")


class ExchangeOptions:
    """The cross-host dataplane exchange (runtime/dataplane.py — the DCN
    counterpart of the reference's Netty shuffle and its
    taskmanager.network.* options). Wire format and credit cadence are
    negotiated per connection, so mixed-version clusters interoperate:
    a peer that does not speak the binary wire downgrades that channel to
    the legacy pickled frames transparently."""

    WIRE_FORMAT = (
        ConfigOptions.key("exchange.wire-format").string_type().default_value("binary")
    ).with_description(
        "Encoding for record batches on cross-host exchange channels. "
        "'binary' (default) is the zero-copy columnar wire "
        "(flink_tpu_torch/security/wire.py): little-endian header + raw array "
        "buffers sent with scatter-gather I/O and incrementally MACed — no "
        "serialization copy for contiguous numeric columns. 'pickle' forces "
        "the legacy restricted-pickle frames everywhere (debugging / "
        "downgrade). Control frames always stay on the pickle codec."
    )
    CREDIT_BATCH = (
        ConfigOptions.key("exchange.credit-batch").int_type().default_value(0)
    ).with_description(
        "Coalescing grain for credit grants: the receiver banks freed ring "
        "slots and sends one credit frame per this many slots instead of "
        "one per consumed batch. 0 (default) derives capacity/4 from the "
        "ring capacity; 1 restores per-batch grants. Backpressure blocking "
        "semantics are unchanged — only the control-frame rate drops."
    )
    DEBLOAT_ENABLED = (
        ConfigOptions.key("exchange.debloat.enabled").bool_type().default_value(True)
    ).with_description(
        "Adaptive batch sizing on stage-boundary senders (BufferDebloater "
        "analogue): each sender EMAs its observed send throughput and "
        "splits outgoing batches larger than throughput x target latency, "
        "so a backpressured channel carries smaller batches (lower queueing "
        "latency) while a fast channel passes batches through whole."
    )
    DEBLOAT_TARGET_LATENCY_MS = (
        ConfigOptions.key("exchange.debloat.target-latency-ms")
        .duration_ms_type().default_value(200)
    ).with_description(
        "Target per-batch transit latency the debloater sizes toward "
        "(taskmanager.network.memory.buffer-debloat.target analogue)."
    )
    RECONNECT_WINDOW_MS = (
        ConfigOptions.key("exchange.reconnect.window-ms")
        .duration_ms_type().default_value(5000)
    ).with_description(
        "Bounded window a keyed-exchange sender spends re-dialing a peer "
        "after a transient dataplane failure (connection reset, injected "
        "blip) before escalating to the normal task-failure/restart path. "
        "The reconnect re-runs the open/credit negotiation and resumes "
        "only when the receiver's next expected sequence number matches "
        "the sender's (no frame was lost); a real loss, or a peer whose "
        "TaskManager stopped heartbeating, fails over immediately. 0 "
        "disables reconnection (every dataplane error restarts the job, "
        "the pre-chaos behavior)."
    )


class CheckpointingOptions:
    """Job checkpoints (checkpoint/coordinator.py), for jobs started with
    `env.execute_async` on the MiniCluster (runtime/minicluster.py)."""

    INTERVAL_MS = (
        ConfigOptions.key("execution.checkpointing.interval").duration_ms_type()
        .default_value(0)
    ).with_description(
        "Interval between job checkpoints, taken at a step boundary; 0 (default) "
        "takes none. A fused window operator dispatches the steps it holds at "
        "each checkpoint.")
    DIRECTORY = ConfigOptions.key("execution.checkpointing.dir").string_type().no_default_value()
    MODE = (ConfigOptions.key("execution.checkpointing.mode").string_type()
            .default_value("EXACTLY_ONCE"))
    MAX_RETAINED = (ConfigOptions.key("execution.checkpointing.max-retained").int_type()
                    .default_value(3))
    TOLERABLE_FAILED_CHECKPOINTS = (
        ConfigOptions.key("execution.checkpointing.tolerable-failed-checkpoints")
        .int_type().default_value(0)
    ).with_description(
        "Consecutive checkpoint failures (capture or persist) the job "
        "tolerates before the failure restarts it. Each tolerated failure "
        "still lands a FAILED record in the checkpoint stats; a completed "
        "checkpoint resets the count. 0 (default) restarts on the first "
        "failure.")


class ObservabilityOptions:
    """The streaming observability plane (reference: LatencyMarker emission,
    TaskIOMetricGroup busy/idle/backPressured sampling, profiler capture).
    Keys and defaults are the JAX package's, and so are the descriptions
    but where the port differs (the device plane's compiles and costs, the
    torch profiler). observability.shipping.interval-ms is read by the
    cluster's TaskExecutor (`main --conf`)."""

    MARKER_INTERVAL_MS = (
        ConfigOptions.key("observability.latency-markers.interval-ms")
        .duration_ms_type().default_value(0)
    ).with_description(
        "Minimum wall-clock spacing between latency markers stamped at each "
        "source (LatencyMarker analogue). 0 stamps one marker per source "
        "batch; -1 disables marker emission entirely. Markers forwarded "
        "from an upstream stage over the dataplane always pass through "
        "regardless of this interval."
    )
    SAMPLING_INTERVAL_MS = (
        ConfigOptions.key("observability.sampling.interval-ms")
        .duration_ms_type().default_value(100)
    ).with_description(
        "Window over which busy/idle/backPressured time deltas are sampled "
        "into the *MsPerSecond gauges (the reference's backpressure "
        "sampling period). Lifetime ratios are maintained continuously and "
        "are unaffected."
    )
    DEVICE_TIMING_ENABLED = (
        ConfigOptions.key("observability.device-timing.enabled")
        .bool_type().default_value(True)
    ).with_description(
        "Time the host-side device sections of each window step (kernel "
        "dispatch + any blocking readback) into per-operator "
        "deviceDispatchMs histograms and deviceTimeMsTotal gauges. Timing "
        "is host-clock around already-synchronous sections — it never "
        "inserts extra block_until_ready syncs into deferred pipelines."
    )
    CHECKPOINT_HISTORY_SIZE = (
        ConfigOptions.key("observability.checkpoint-history.size")
        .int_type().default_value(10)
    ).with_description(
        "Per-checkpoint stat records retained in the CheckpointStatsTracker "
        "ring per job (trigger timestamp, capture/persist durations, "
        "per-task ack latency, state sizes, status and failure cause), "
        "served at /jobs/:id/checkpoints. Lifetime counters and the "
        "last-checkpoint gauges are unaffected by the ring size."
    )
    EXCEPTION_HISTORY_SIZE = (
        ConfigOptions.key("observability.exception-history.size")
        .int_type().default_value(16)
    ).with_description(
        "Exception-history entries and recovery-timeline records retained "
        "per job (timestamp, task/TaskManager attribution, root-cause "
        "chain, restart number; restore duration, rewound checkpoint id, "
        "replay depth, downtime), served at /jobs/:id/exceptions."
    )
    PROFILER_ENABLED = (
        ConfigOptions.key("observability.profiler.enabled")
        .bool_type().default_value(False)
    ).with_description(
        "Capture a torch.profiler trace (CUDA activity on the card, CPU "
        "activity otherwise) for the duration of each job attempt, exported "
        "as a Chrome trace under observability.profiler.dir. Heavyweight: "
        "for offline analysis only, never in production."
    )
    PROFILER_DIR = (
        ConfigOptions.key("observability.profiler.dir")
        .string_type().default_value("/tmp/flink-tpu-profile")
    ).with_description(
        "Output directory for observability.profiler.enabled trace dumps "
        "(Chrome trace JSON, one file per captured attempt)."
    )
    SHIPPING_INTERVAL_MS = (
        ConfigOptions.key("observability.shipping.interval-ms")
        .duration_ms_type().default_value(500)
    ).with_description(
        "How often a TaskExecutor ships metric snapshots and trace spans to "
        "the JobManager over the authenticated RPC plane (piggybacked on "
        "the heartbeat; the JM aggregates and serves them via REST and "
        "Prometheus)."
    )
    DEVICE_STATS_ENABLED = (
        ConfigOptions.key("observability.device.enabled")
        .bool_type().default_value(True)
    ).with_description(
        "Device-plane observability for device window operators: compile/"
        "recompile tracking with shape-signature cause attribution (ring "
        "doubling, batch-geometry churn, dtype change; a compile is a "
        "program geometry's first dispatch in the process), per-program "
        "cost/roofline gauges (hbmUtilizationPct, flopsUtilizationPct: the "
        "program's bytes and operations over the DeviceTimer's host-clock "
        "time), per-phase ingest/fire/purge counters counted inside the "
        "K1/K2 launches, and per-key-group load telemetry (keySkew, hot "
        "keys). Served by JobRuntime.device_snapshot(). Per-batch host cost "
        "is O(1); the key-stats fold runs on the device on its own sampling "
        "interval."
    )
    DEVICE_RECOMPILE_HISTORY_SIZE = (
        ConfigOptions.key("observability.device.recompile-history.size")
        .int_type().default_value(32)
    ).with_description(
        "Compile events retained in the per-job recompile-event ring "
        "(program, shape signature, cause, compile wall time). The "
        "lifetime compile/recompile counters are unaffected by the ring "
        "size."
    )
    DEVICE_RECOMPILE_STORM_THRESHOLD = (
        ConfigOptions.key("observability.device.recompile-storm.threshold")
        .int_type().default_value(4)
    ).with_description(
        "Recompiles within observability.device.recompile-storm.window-ms "
        "that flip the recompileStorm warning gauge to 1 — a job changing "
        "program geometry at this rate is paying first-dispatch latency on "
        "the hot path (growing key dictionary, churning batch geometry)."
    )
    DEVICE_RECOMPILE_STORM_WINDOW_MS = (
        ConfigOptions.key("observability.device.recompile-storm.window-ms")
        .duration_ms_type().default_value(60_000)
    ).with_description(
        "Sliding window over which recompiles are counted for the "
        "recompileStorm warning gauge."
    )
    DEVICE_COST_ANALYSIS_ENABLED = (
        ConfigOptions.key("observability.device.cost-analysis.enabled")
        .bool_type().default_value(True)
    ).with_description(
        "Capture each dispatch program's cost (bytes read and written once, "
        "scalar operations; ops/cuda_superscan.py k1_cost/k2_cost) at its "
        "first dispatch — the numerator of the roofline gauges. Arithmetic "
        "on shapes; utilization gauges read 0 when disabled."
    )
    DEVICE_MEMORY_ANALYSIS_ENABLED = (
        ConfigOptions.key("observability.device.memory-analysis.enabled")
        .bool_type().default_value(False)
    ).with_description(
        "Additionally capture each program's own allocations per signature: "
        "temp_bytes (K1's step partials scratch), output_bytes (the fire "
        "rows) and argument_bytes (the rings and lanes)."
    )
    DEVICE_KEY_STATS_INTERVAL_MS = (
        ConfigOptions.key("observability.device.key-stats.interval-ms")
        .duration_ms_type().default_value(1000)
    ).with_description(
        "How often the per-key-group load fold runs (one device "
        "segment-sum over the resident window state + one small host "
        "copy). Gauges (keySkew, activeKeys, keyGroupLoad histogram, "
        "top-K hot keys) hold the latest fold between runs."
    )
    DEVICE_KEY_STATS_TOP_K = (
        ConfigOptions.key("observability.device.key-stats.top-k")
        .int_type().default_value(8)
    ).with_description(
        "Hot keys reported per operator by the key-stats fold (dense key "
        "id + resident record count, hottest first)."
    )
    DEVICE_HBM_GBPS = (
        ConfigOptions.key("observability.device.hbm-gbps")
        .float_type().default_value(0.0)
    ).with_description(
        "Device-memory bandwidth (GB/s) used as the denominator of the "
        "hbmUtilizationPct roofline gauge. 0 picks a per-platform default "
        "(gpu/cpu); set it to the card's figure for calibrated utilization."
    )
    DEVICE_PEAK_TFLOPS = (
        ConfigOptions.key("observability.device.peak-tflops")
        .float_type().default_value(0.0)
    ).with_description(
        "Peak compute (TFLOP/s) used as the denominator of the "
        "flopsUtilizationPct roofline gauge. 0 picks a per-platform "
        "default."
    )
    EMISSION_LATENCY_ENABLED = (
        ConfigOptions.key("observability.emission-latency.enabled")
        .bool_type().default_value(True)
    ).with_description(
        "Record per-operator emission latency — host_resolve_wall_ms minus "
        "(window_end_event_ms + allowed lateness) — into a log-bucketed "
        "emissionLatencyMs histogram at the instant deferred emissions "
        "resolve, plus a watermarkLagMs gauge per windowed operator. "
        "Stamping happens on already-host-side resolve paths (it never "
        "forces a device sync); the fold across mesh shards merges "
        "histogram buckets and takes MAX lag. Serves /jobs/:id/latency, "
        "Prometheus summaries and the bench latency_frontier block."
    )
    EMISSION_LATENCY_OUTLIER_PCT = (
        ConfigOptions.key("observability.emission-latency.outlier-percentile")
        .float_type().default_value(99.0)
    ).with_description(
        "Fires whose emission latency lands at or above this percentile of "
        "the operator's own histogram (once 16+ samples exist) are captured "
        "as outliers: kept in a bounded ring and reported as latency-scope "
        "EmissionStall spans for tail attribution against concurrent "
        "control-plane spans (checkpoint, restart, rescale, rebalance, "
        "recompile)."
    )
    EMISSION_LATENCY_OUTLIER_FLOOR_MS = (
        ConfigOptions.key("observability.emission-latency.outlier-floor-ms")
        .float_type().default_value(5.0)
    ).with_description(
        "Absolute floor under which a fire is never treated as an outlier "
        "regardless of percentile rank — keeps a uniformly-fast operator "
        "(sub-millisecond tail) from spamming EmissionStall spans over "
        "noise."
    )
    EMISSION_LATENCY_OUTLIER_RING = (
        ConfigOptions.key("observability.emission-latency.outlier-ring-size")
        .int_type().default_value(64)
    ).with_description(
        "Outlier records retained per operator (resolve wall time + "
        "latency) for the /jobs/:id/latency stall-attribution report. The "
        "histogram and lifetime counters are unaffected by the ring size."
    )
    EMISSION_LATENCY_OUTLIER_MIN_SAMPLES = (
        ConfigOptions.key(
            "observability.emission-latency.outlier-min-samples")
        .int_type().default_value(16)
    ).with_description(
        "Recorded fires an operator needs before any fire can be captured "
        "as an outlier — the percentile threshold is meaningless over a "
        "near-empty histogram. Chaos/validation runs set 1 so the first "
        "post-restore fire is capture-eligible and its stall interval "
        "pins the recovery span."
    )
    HISTORY_INTERVAL_MS = (
        ConfigOptions.key("observability.history.interval-ms")
        .duration_ms_type().default_value(1000)
    ).with_description(
        "Sampling interval of the metric history plane: every registered "
        "job/operator metric is sampled into a bounded time-series ring "
        "on the existing processing-time tick (MiniCluster step boundary "
        "/ JobManager schedule tick) — counters recorded as windowed "
        "rates, gauges as values, histograms as per-sample p50/p99 "
        "sub-series. Served at /jobs/:id/history on both execution paths."
    )
    HISTORY_RETENTION_POINTS = (
        ConfigOptions.key("observability.history.retention-points")
        .int_type().default_value(256)
    ).with_description(
        "Points retained per metric series (a bounded ring — the oldest "
        "point falls off when the ring is full). Together with the "
        "sampling interval this bounds the lookback window: 256 points "
        "at 1000 ms is ~4.3 minutes of trajectory per metric."
    )
    DOCTOR_ENABLED = (
        ConfigOptions.key("observability.doctor.enabled")
        .bool_type().default_value(True)
    ).with_description(
        "Run the job doctor and its health watchdog: /jobs/:id/doctor "
        "serves a ranked, evidence-attributed bottleneck diagnosis joined "
        "over the history rings and the span stream, and the watchdog "
        "turns threshold breaches (throughput collapse vs the job's own "
        "recent baseline, watermark stall, backpressure saturation, "
        "emission-p99 breach) into rate-limited health.* spans."
    )
    DOCTOR_WINDOW_MS = (
        ConfigOptions.key("observability.doctor.window-ms")
        .duration_ms_type().default_value(60000)
    ).with_description(
        "Lookback window of one doctor diagnosis: history points and "
        "spans older than this are ignored when scoring bottleneck "
        "families."
    )
    DOCTOR_WATCHDOG_MIN_GAP_MS = (
        ConfigOptions.key("observability.doctor.watchdog-min-gap-ms")
        .duration_ms_type().default_value(5000)
    ).with_description(
        "Rate limit per health.* span family: a sustained breach emits at "
        "most one span per gap, so a wedged job cannot flood the bounded "
        "span ring with identical watchdog spans."
    )
    DOCTOR_P99_BREACH_MS = (
        ConfigOptions.key("observability.doctor.p99-breach-ms")
        .float_type().default_value(0.0)
    ).with_description(
        "Emission-latency p99 threshold for the health.P99Breach watchdog "
        "span (0 disables the check — there is no universal latency SLO; "
        "jobs with one declare it here)."
    )


class AutoscalerOptions:
    """The elastic autoscaler (flink_tpu_torch/scheduler/): a reactive
    controller that watches the observability-plane gauges (busy and
    backpressure ratios, pool usage, watermark skew, checkpoint
    durations), decides scale-up/down per the configured policy, and on a
    MiniCluster mesh job (parallel.mesh.autoscale) rescales the mesh live
    by a step-aligned capture and a key-group re-shard. Off by default —
    rescaling costs a checkpoint rewind. On the distributed JobManager the
    controller runs its loop over the TM-shipped snapshots and executes
    rescales (runtime/cluster.py); runtime/rest.py serves its log."""

    ENABLED = (
        ConfigOptions.key("autoscaler.enabled").bool_type().default_value(False)
    ).with_description(
        "Enable reactive autoscaling. On a MiniCluster mesh job "
        "(parallel.mesh.enabled and parallel.mesh.autoscale) decisions "
        "execute as live mesh rescales; without a mesh the controller runs "
        "observe-only: decisions appear in its decision log but are never "
        "executed."
    )
    MIN_PARALLELISM = (
        ConfigOptions.key("autoscaler.min-parallelism").int_type().default_value(1)
    ).with_description(
        "Lower bound the autoscaler may scale a job down to."
    )
    MAX_PARALLELISM = (
        ConfigOptions.key("autoscaler.max-parallelism").int_type().default_value(0)
    ).with_description(
        "Upper bound the autoscaler may scale a job up to; 0 (default) "
        "bounds only by available slots and the job's own max-parallelism "
        "(key-group count)."
    )
    STABILIZATION_INTERVAL_MS = (
        ConfigOptions.key("autoscaler.stabilization-interval-ms")
        .duration_ms_type().default_value(30_000)
    ).with_description(
        "Quiet period after a job starts or a rescale completes before the "
        "next decision may execute: signals from a warming attempt (replay, "
        "cold caches, fresh counters) must not immediately trigger another "
        "rescale."
    )
    POLICY = (
        ConfigOptions.key("autoscaler.policy").string_type().default_value("threshold")
    ).with_description(
        "Decision engine: 'threshold' doubles/halves parallelism on the "
        "utilization thresholds; 'learning' wraps the threshold rule with a "
        "bounded history of past rescale outcomes and damps decisions that "
        "previously failed to improve throughput (the Adaptive Parallelism "
        "Tuning blueprint, PAPERS.md)."
    )
    INTERVAL_MS = (
        ConfigOptions.key("autoscaler.interval-ms")
        .duration_ms_type().default_value(1000)
    ).with_description(
        "How often the controller samples the job's aggregated gauges into "
        "the signal window and evaluates the policy."
    )
    SIGNAL_WINDOW = (
        ConfigOptions.key("autoscaler.signal-window").int_type().default_value(6)
    ).with_description(
        "Samples per vertex the signal aggregator averages over before the "
        "policy sees them — one noisy tick must not rescale a job. The "
        "3-sample decision warm-up and outcome-settling bars clamp to this "
        "window when it is smaller."
    )
    SCALE_UP_THRESHOLD = (
        ConfigOptions.key("autoscaler.utilization.scale-up-threshold")
        .float_type().default_value(0.85)
    ).with_description(
        "Windowed utilization (busy + backpressured fraction) at or above "
        "which the threshold policy scales up."
    )
    SCALE_DOWN_THRESHOLD = (
        ConfigOptions.key("autoscaler.utilization.scale-down-threshold")
        .float_type().default_value(0.3)
    ).with_description(
        "Windowed utilization at or below which the threshold policy "
        "scales down."
    )
    DECISION_HISTORY_SIZE = (
        ConfigOptions.key("autoscaler.decision-history.size")
        .int_type().default_value(32)
    ).with_description(
        "Decision-log entries retained per job (signals seen, action, "
        "target, outcome, rescale duration)."
    )
    LEARNING_MIN_GAIN = (
        ConfigOptions.key("autoscaler.learning.min-gain")
        .float_type().default_value(1.1)
    ).with_description(
        "Throughput gain a past scale-up must have achieved (scale-down: "
        "1/min-gain retention) for the learning policy to repeat the same "
        "transition without damping."
    )
    LEARNING_PATIENCE = (
        ConfigOptions.key("autoscaler.learning.patience")
        .int_type().default_value(4)
    ).with_description(
        "Number of triggers the learning policy suppresses a previously "
        "unhelpful transition for before retrying it (load may have "
        "changed shape since the bad outcome)."
    )


class WatchdogOptions:
    """Stuck-task detection (distributed JobManager). A task wedged inside
    a live TaskManager — blocked UDF, dead device dispatch, a lost RPC
    reply — is invisible to heartbeat failure detection: the TM keeps
    beating while the task makes no progress forever."""

    STUCK_TASK_TIMEOUT_MS = (
        ConfigOptions.key("execution.watchdog.stuck-task-timeout-ms")
        .duration_ms_type().default_value(0)
    ).with_description(
        "Fail a RUNNING job's task through the normal attributed "
        "restart path when its heartbeat-reported step counter has not "
        "advanced for this long while its TaskManager stays alive (and "
        "the task has not finished). 0 (default) disables the watchdog. "
        "Tune WELL above the longest legitimate pause a step can take — "
        "device compiles, cold restores and backpressure stalls all "
        "freeze the step counter; start at 10x the heartbeat timeout."
    )


class SecurityOptions:
    """Transport security (reference: SecurityOptions + security.ssl.internal.*).

    One per-cluster shared secret authenticates every internal plane (RPC,
    dataplane exchange, blob) via a connection handshake + per-frame HMACs,
    and derives the REST bearer token. Resolution order for the secret:
    `security.transport.secret` > `security.transport.secret-file` (e.g. a
    mounted K8s Secret) > `FLINK_TPU_SECURITY_TRANSPORT_SECRET[_FILE]` env
    > an auto-generated per-user secret file (0600) shared by all local
    processes. See flink_tpu_torch/security/transport.py."""

    TRANSPORT_ENABLED = (
        ConfigOptions.key("security.transport.enabled").bool_type().default_value(True)
    ).with_description(
        "Authenticate and MAC-sign every internal network frame (RPC, "
        "dataplane, blob) and deserialize through the restricted allowlist. "
        "Set to false to restore the legacy plaintext protocol for local "
        "debugging — never on a network you do not fully trust."
    )
    TRANSPORT_SECRET = (
        ConfigOptions.key("security.transport.secret").string_type().no_default_value()
    ).with_description(
        "Per-cluster shared secret. Prefer security.transport.secret-file "
        "(or the env vars) so the secret stays out of config files."
    )
    TRANSPORT_SECRET_FILE = (
        ConfigOptions.key("security.transport.secret-file").string_type().no_default_value()
    ).with_fallback_keys(
        # Configuration.from_env maps FLINK_TPU_SECURITY_TRANSPORT_SECRET_FILE
        # to the all-dots form; accept both spellings
        "security.transport.secret.file",
    ).with_description(
        "Path to a file holding the cluster secret (e.g. a mounted "
        "Kubernetes Secret)."
    )
    TRANSPORT_CLUSTER_ID = (
        ConfigOptions.key("security.transport.cluster-id").string_type().default_value("flink-tpu")
    ).with_fallback_keys("security.transport.cluster.id").with_description(
        "Cluster identity exchanged in the connection handshake; peers from "
        "a different cluster are rejected even when they share a secret."
    )
    SSL_INTERNAL_ENABLED = (
        ConfigOptions.key("security.ssl.internal.enabled").bool_type().default_value(False)
    ).with_description(
        "Layer TLS (stdlib ssl) under the HMAC framing on internal "
        "connections, mirroring the reference's security.ssl.internal.*."
    )
    SSL_INTERNAL_CERT = (
        ConfigOptions.key("security.ssl.internal.cert").string_type().no_default_value()
    ).with_description("PEM certificate chain presented by this process.")
    SSL_INTERNAL_KEY = (
        ConfigOptions.key("security.ssl.internal.key").string_type().no_default_value()
    ).with_description("PEM private key for security.ssl.internal.cert.")
    SSL_INTERNAL_CA = (
        ConfigOptions.key("security.ssl.internal.ca").string_type().no_default_value()
    ).with_description(
        "PEM CA bundle peers must chain to; when set on the server side, "
        "client certificates are required (mutual TLS)."
    )
    REST_AUTH_ENABLED = (
        ConfigOptions.key("security.rest.auth.enabled").bool_type().default_value(False)
    ).with_description(
        "Require `Authorization: Bearer <token>` on the REST API, with the "
        "token derived from the cluster secret "
        "(flink_tpu_torch.security.rest_bearer_token)."
    )


class ChaosOptions:
    """Deterministic fault injection (flink_tpu_torch/chaos). Default OFF;
    when off the runtime pays one module-level `is None` check per seam
    call and nothing else. A MiniCluster job whose config enables it
    installs the plan for that job and uninstalls it when the job ends;
    drills and tests install plans programmatically
    (`testing.harness.fault_injection`)."""

    ENABLED = (
        ConfigOptions.key("chaos.enabled").bool_type().default_value(False)
    ).with_description(
        "Install the configured FaultPlan process-wide for the job. Every "
        "fault it injects is labeled and attributed `injected: true` in "
        "the job's exception history. Never enable in production except "
        "as a deliberate, supervised drill."
    )
    SEED = (
        ConfigOptions.key("chaos.seed").int_type().default_value(0)
    ).with_description(
        "Seed for the FaultPlan's RNG (probability triggers): the same "
        "seed over a deterministic workload replays the same fault "
        "sequence."
    )
    RULES = (
        ConfigOptions.key("chaos.rules").string_type().default_value("")
    ).with_description(
        "JSON list of FaultRule field dicts, e.g. "
        '[{"scope": "device", "fault": "error", "nth": 6}]. '
        "Scopes: transport|rpc|dataplane|storage|device|heartbeat; "
        "faults: error|crash|delay|"
        "drop|torn|partition; triggers: nth-call, probability, window_s "
        "since install, max_fires."
    )


class RestartOptions:
    """Restart strategy of a MiniCluster job (checkpoint/restart.py)."""

    STRATEGY = (ConfigOptions.key("restart-strategy.type").string_type()
                .default_value("exponential-delay"))
    MAX_ATTEMPTS = ConfigOptions.key("restart-strategy.max-attempts").int_type().default_value(10)
    INITIAL_BACKOFF_MS = (ConfigOptions.key("restart-strategy.initial-backoff")
                          .duration_ms_type().default_value(100))
    MAX_BACKOFF_MS = (ConfigOptions.key("restart-strategy.max-backoff")
                      .duration_ms_type().default_value(10_000))
    BACKOFF_MULTIPLIER = (ConfigOptions.key("restart-strategy.backoff-multiplier")
                          .float_type().default_value(2.0))
