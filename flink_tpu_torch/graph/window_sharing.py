"""Sharing optimizer for correlated window aggregates (Factor Windows).

Counterpart of `flink_tpu/graph/window_sharing.py`, with its grouping and
refusal rules unchanged. A job that computes several windows over the same
keyed stream (the 1m/5m/1h dashboard shape) would scan the stream once per
window, although every member window can be folded from the partials of a
common finer "factor" window (Factor Windows, PAPERS.md, arXiv
2008.12379). The slice decomposition of the fused path is that factor
window: slices at the gcd granule of the group.

`plan_shared_windows` walks the fusion planner's per-step
`DeviceChainPlan`s (graph/fusion.py) and groups device-fusable
`window_aggregate` siblings that consume the same keyed stream (same
producer edge, same traceable key selector and value extractor, same
resolved aggregate, same slot-sharing group, one common window offset)
into `SharedWindowPlan`s. The executor builds one shared-partial runner
per group: K1 ingests gcd-granule partials once, each member window folds
its own slice run from the shared ring (runtime/fused_window_pipeline.py
`SharedWindowPipeline`, per-slot `spws` in K1), and each member's rows go
to its own downstream.

When the common producer is a pure traceable chain consumed only by the
group, the chain is absorbed into the shared program too.

Exactness: member decompositions onto the shared granule go through
`WindowAssigner.slices_on`, which decomposes exactly or raises; a group
that does not decompose exactly is refused and each member keeps its own
fused program. Sharing is a perf switch, never a semantics switch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from flink_tpu_torch.graph.fusion import DeviceChainPlan, chain_is_traceable
from flink_tpu_torch.graph.transformation import Step, StepGraph, Transformation
from flink_tpu_torch.ops.aggregators import resolve

#: refuse groups whose shared ring would explode: a member needing more
#: slices per window than this on the shared granule (a 1-second window
#: grouped with a 1 ms one) costs more in fire-time folds than sharing
#: saves in ingest
MAX_SHARED_SPW = 4096


@dataclasses.dataclass
class SharedWindowPlan:
    """One shared-partial group: member window steps (spec order), their
    terminals and assigners, the shared traced chain (possibly empty), the
    input edges the shared runner consumes, and the cost-model estimate."""

    members: List[Step]                   # window steps; members[0] = leader
    terminals: List[Transformation]
    assigners: List
    transforms: List[Transformation]      # shared absorbed chain, in order
    inputs: List                          # executor wiring edges
    granule_ms: int
    member_spws: List[int]                # slices per window on the granule
    estimated_sharing_factor: float
    absorbed: Optional[Step] = None       # chain step folded into the program

    @property
    def name(self) -> str:
        parts = [t.name for t in self.transforms]
        parts.append(" | ".join(t.name for t in self.terminals))
        return " => ".join(parts)


def _group_signature(step: Step, plan: DeviceChainPlan):
    """Correlation key: two window steps share a scan iff they consume the
    same producer edge, key with the same traceable selector, extract the
    same value column, fold with the same resolved aggregate, and share a
    slot group."""
    cfg = plan.terminal.config
    producer, ordinal = step.inputs[0][0], step.inputs[0][1]
    return (
        id(producer), ordinal,
        id(cfg["key_selector"]),
        id(cfg.get("value_fn")) if cfg.get("value_fn") is not None else None,
        id(resolve(cfg.get("aggregate"))),
        step.slot_group,
    )


def _shared_granule(assigners) -> Optional[Tuple[int, List[int], List[int]]]:
    """(granule_ms, member_spws, member_sls), or None when the group has no
    exact, bounded shared decomposition (mixed offsets, a member whose
    decomposition is inexact, or a pathological granule ratio)."""
    if len({a.offset_ms for a in assigners}) != 1:
        return None
    g = 0
    for a in assigners:
        if a.slice_ms is None or not a.is_event_time:
            return None
        g = math.gcd(g, a.slice_ms)
    spws, sls = [], []
    for a in assigners:
        try:
            spw, sl = a.slices_on(g)
        except ValueError:
            return None
        if spw > MAX_SHARED_SPW:
            return None
        spws.append(spw)
        sls.append(sl)
    return g, spws, sls


def _sharing_factor(n: int, spws: List[int], sls: List[int]) -> float:
    """Factor-Windows cost estimate: independent plans pay one ingest scan
    per member (the per-record cost); the shared plan pays one scan plus
    the fire-time folds every member pays anyway. The estimate is the
    scan-count ratio damped by the fire density of the finer granule."""
    # a member folds spw slices a fire and fires every sl slices
    fire_density = sum(spw / max(sl, 1) for spw, sl in zip(spws, sls))
    return n / (1.0 + 0.01 * fire_density)


def plan_shared_windows(
    graph: StepGraph,
    chain_plans: Dict[int, DeviceChainPlan],
) -> List[SharedWindowPlan]:
    """Group correlated device-fusable window siblings into shared plans.

    `chain_plans` is plan_device_chains' output: only steps it classified
    device-fusable take part. Members that absorbed a private chain are not
    grouped (their streams differ); a common pure traceable chain feeding
    only the group is lifted into the shared program instead."""
    groups: Dict[tuple, List[Step]] = {}
    for step in graph.steps:
        plan = chain_plans.get(id(step))
        if plan is None or plan.absorbed is not None:
            continue
        if len(step.inputs) != 1:
            continue
        if step.inputs[0][2] is not None:
            continue
        groups.setdefault(_group_signature(step, plan), []).append(step)

    consumers: Dict[int, int] = {}
    for s in graph.steps:
        for edge in s.inputs:
            if isinstance(edge[0], Step):
                consumers[id(edge[0])] = consumers.get(id(edge[0]), 0) + 1

    out: List[SharedWindowPlan] = []
    for members in groups.values():
        if len(members) < 2:
            continue
        terminals = [s.terminal for s in members]
        assigners = [t.config["assigner"] for t in terminals]
        dec = _shared_granule(assigners)
        if dec is None:
            continue
        g, spws, sls = dec
        producer = members[0].inputs[0][0]
        transforms: List[Transformation] = []
        inputs = [members[0].inputs[0]]
        absorbed = None
        if (
            isinstance(producer, Step)
            and producer.terminal is None
            and chain_is_traceable(producer.chain)
            and consumers.get(id(producer), 0) == len(members)
            and producer.slot_group == members[0].slot_group
            and len(producer.inputs) == 1
        ):
            # the group is the chain's only consumer set: lift the chain
            # into the shared program (per-member absorption was blocked
            # because the siblings shared it)
            transforms = list(producer.chain)
            inputs = list(producer.inputs)
            absorbed = producer
        out.append(SharedWindowPlan(
            members=list(members),
            terminals=terminals,
            assigners=assigners,
            transforms=transforms,
            inputs=inputs,
            granule_ms=g,
            member_spws=spws,
            estimated_sharing_factor=_sharing_factor(len(members), spws, sls),
            absorbed=absorbed,
        ))
    return out


def describe(plans: List[SharedWindowPlan]) -> str:
    """Human-readable summary (mirrors the JAX package's)."""
    return "\n".join(
        f"shared-windows[{i}] g={p.granule_ms}ms "
        f"x{len(p.members)} (est {p.estimated_sharing_factor:.2f}x): "
        f"{p.name}"
        for i, p in enumerate(plans)
    )
