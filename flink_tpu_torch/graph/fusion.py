"""Whole-graph fusion planner: which window steps take the fused device chain.

Counterpart of `flink_tpu/graph/fusion.py`, with its eligibility rules
unchanged. An eligible chain — traceable map/filter/map_ts transforms
feeding a device-eligible keyed window aggregate with a traceable key
selector (and value_fn) — runs as ONE fused device dispatch per superbatch:
the transforms and the key/value extraction run as a prologue over the raw
columns on the device, and kernel K1 ingests, fires and purges. The host
never materializes the post-transform, key or value columns.

The planner only decides; the executor builds a `DeviceChainRunner` for
each plan (runtime/executor.py). Everything ineligible keeps the
ChainRunner + WindowStepRunner path with the same results.

Eligibility:
- the window terminal resolves to a DeviceAggregator whose fields all
  scatter-combine (add/min/max), on a sliceable event-time assigner, with
  no custom trigger/evictor/window function, zero allowed lateness and no
  late-data side output;
- the key selector (and value_fn, if any) is declared `traceable=True`: a
  function of a torch tensor column returning non-negative int keys below
  the configured key capacity;
- every transform of the upstream chain step (if one feeds the window
  step) is a map/filter/map_ts declared `traceable=True`;
- that chain step feeds only this window step and shares its slot group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from flink_tpu_torch.graph.transformation import Step, StepGraph, Transformation
from flink_tpu_torch.ops.aggregators import resolve

#: chain kinds with a traced device form
TRACEABLE_CHAIN_KINDS = {"map", "filter", "map_ts"}


@dataclasses.dataclass
class DeviceChainPlan:
    """One fused device chain: the prologue transformations (in order,
    possibly empty), the window terminal, and the input edges the fused
    runner consumes (the absorbed chain step's inputs, or the window
    step's own when nothing was absorbed)."""

    transforms: List[Transformation]
    terminal: Transformation
    inputs: List
    absorbed: Optional[Step] = None


def window_is_device_fusable(t: Transformation) -> bool:
    """Does this window_aggregate terminal qualify for the traced path?"""
    if t.kind != "window_aggregate":
        return False
    cfg = t.config
    if not cfg.get("key_traceable"):
        return False
    agg = resolve(cfg.get("aggregate"))
    if agg is None or any(f.scatter not in ("add", "min", "max") for f in agg.fields):
        return False
    assigner = cfg.get("assigner")
    if assigner is None or assigner.slice_ms is None or not assigner.is_event_time:
        return False
    if cfg.get("trigger") is not None or cfg.get("evictor") is not None:
        return False
    if cfg.get("window_fn") is not None:
        return False
    if cfg.get("allowed_lateness", 0) != 0 or cfg.get("side_output_late"):
        return False
    if cfg.get("value_fn") is not None and not cfg.get("value_traceable"):
        return False
    return True


def chain_is_traceable(chain: List[Transformation]) -> bool:
    """Every transform of a pure chain step has a traced device form."""
    return all(t.kind in TRACEABLE_CHAIN_KINDS and t.config.get("traceable")
               for t in chain)


def _step_consumers(graph: StepGraph) -> Dict[int, int]:
    """id(step) -> number of consuming edges across the graph."""
    counts: Dict[int, int] = {}
    for s in graph.steps:
        for edge in s.inputs:
            if isinstance(edge[0], Step):
                counts[id(edge[0])] = counts.get(id(edge[0]), 0) + 1
    return counts


def plan_device_chains(graph: StepGraph) -> Tuple[Dict[int, DeviceChainPlan], Set[int]]:
    """Walk the StepGraph; return ({id(window_step): plan}, absorbed_ids).

    Steps in `absorbed_ids` (pure chain steps folded into a fused program)
    get no runner of their own; the window step's runner consumes the
    absorbed step's input edges instead."""
    plans: Dict[int, DeviceChainPlan] = {}
    absorbed: Set[int] = set()
    consumers = _step_consumers(graph)
    for step in graph.steps:
        t = step.terminal
        if t is None or not window_is_device_fusable(t):
            continue
        if step.partitioning != "key_group" or len(step.inputs) != 1:
            continue
        producer, _ordinal, tag = step.inputs[0]
        if tag is not None:
            continue
        if (
            isinstance(producer, Step)
            and producer.terminal is None
            and chain_is_traceable(producer.chain)
            and consumers.get(id(producer), 0) == 1
            and producer.slot_group == step.slot_group
            and len(producer.inputs) == 1
        ):
            plans[id(step)] = DeviceChainPlan(transforms=list(producer.chain), terminal=t,
                                              inputs=list(producer.inputs),
                                              absorbed=producer)
            absorbed.add(id(producer))
        else:
            # no absorbable chain: fuse key/value extraction + window alone
            plans[id(step)] = DeviceChainPlan(transforms=[], terminal=t,
                                              inputs=list(step.inputs))
    return plans, absorbed
