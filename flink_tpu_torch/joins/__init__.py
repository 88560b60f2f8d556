"""Device-side streaming joins: the two-input keyed join subsystem.

Counterpart of `flink_tpu/joins/`. Layering: `joins` sits beside
`ops`/`state` — it may import core, ops, state and config, and never
runtime, api, table or scheduler. The runtime's `DeviceJoinRunner` drives
these pipelines from behind the StepRunner boundary; the SQL planner
lowers window equi-joins onto them. `ShardedJoinPipeline`
(`joins/sharded.py`) splits both sides' rings over a mesh's shards by key.
"""

from flink_tpu_torch.joins.pipeline import FusedJoinPipeline, expand_pairs
from flink_tpu_torch.joins.ring import BucketRing
from flink_tpu_torch.joins.spec import (
    JOIN_FALLBACK_CATALOG,
    JOIN_FALLBACK_CODES,
    JoinGeometry,
    JoinUnsupported,
    fallback_code,
    plan_join_geometry,
)

__all__ = [
    "BucketRing",
    "FusedJoinPipeline",
    "JoinGeometry",
    "JoinUnsupported",
    "JOIN_FALLBACK_CATALOG",
    "JOIN_FALLBACK_CODES",
    "fallback_code",
    "plan_join_geometry",
    "expand_pairs",
]
