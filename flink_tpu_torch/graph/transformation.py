"""Transformation DAG and its plan into chained steps.

Counterpart of `flink_tpu/graph/transformation.py`: API calls record
`Transformation` nodes; `plan` groups chainable record-local
transformations into steps (the analogue of operator chains) and cuts
chains at keyBy. The port plans the kinds its API records — source,
map/map_ts/filter/flat_map, key_by, global (a pass-through partition
hint), window_aggregate, group_agg, sink and side_output (a tagged view of
the producing step's side channel) — with the JAX planner's rules; any
other kind raises.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional

from flink_tpu_torch.utils import deferred

_ids = itertools.count(1)

# record-local kinds fusable into one chain step
CHAINABLE = {"map", "map_ts", "filter", "flat_map"}

# single-input stateful/boundary terminals
TERMINALS = {"window_aggregate", "group_agg", "sink"}


@dataclasses.dataclass
class Transformation:
    """One logical node: op kind + config + inputs."""

    kind: str
    name: str
    inputs: List["Transformation"]
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    uid: Optional[str] = None

    def __post_init__(self):
        self.id = next(_ids)
        if self.uid is None:
            self.uid = f"{self.kind}-{self.id}"

    def __hash__(self):
        return self.id

    def __repr__(self):
        return f"Transformation#{self.id}({self.kind}:{self.name})"


@dataclasses.dataclass
class Step:
    """A fused pipeline stage (operator chain): `chain` is the list of
    record-local transformations applied in one pass, `terminal` the
    stage's stateful/boundary op if any, `partitioning` how records enter
    ('forward' or 'key_group'), `inputs` the (producer, ordinal, tag)
    edges, a producer being an upstream Step or a source Transformation."""

    chain: List[Transformation]
    terminal: Optional[Transformation]
    partitioning: str
    key_selector: Optional[Callable] = None
    inputs: List = dataclasses.field(default_factory=list)
    slot_group: str = "default"

    @property
    def name(self) -> str:
        parts = [t.name for t in self.chain]
        if self.terminal is not None:
            parts.append(self.terminal.name)
        return " -> ".join(parts) or "empty-step"

    @property
    def uid(self) -> str:
        if self.terminal is not None:
            return self.terminal.uid
        return self.chain[-1].uid if self.chain else "step"


@dataclasses.dataclass
class StepGraph:
    """Physical plan: `sources` feed the entry steps; `steps` is in
    topological order."""

    sources: List[Transformation]
    steps: List[Step]


def plan(sink_transforms) -> StepGraph:
    """Translate the transformation DAG rooted at the sink(s) into a
    StepGraph: a topological walk fusing chainable runs and cutting at
    keyBy and at every multi-consumer boundary."""
    sinks = ([sink_transforms] if isinstance(sink_transforms, Transformation)
             else list(sink_transforms))

    consumers: Dict[int, int] = {}
    nodes: Dict[int, Transformation] = {}
    stack = list(sinks)
    while stack:
        n = stack.pop()
        if n.id in nodes:
            continue
        nodes[n.id] = n
        for i in n.inputs:
            consumers[i.id] = consumers.get(i.id, 0) + 1
            stack.append(i)

    # topological order (sources first), deterministic by node id
    order: List[Transformation] = []
    state: Dict[int, int] = {}
    for s in sorted(sinks, key=lambda t: t.id):
        work = [(s, False)]
        while work:
            n, expanded = work.pop()
            if expanded:
                state[n.id] = 2
                order.append(n)
                continue
            if state.get(n.id) == 2:
                continue
            if state.get(n.id) == 1:
                raise ValueError("transformation graph has a cycle")
            state[n.id] = 1
            work.append((n, True))
            for i in reversed(n.inputs):
                if state.get(i.id) != 2:
                    work.append((i, False))

    # auto-generated uids stabilized by topological position, so
    # identically built jobs name their operators alike
    for pos, t in enumerate(order):
        if t.uid == f"{t.kind}-{t.id}":
            t.uid = f"{t.kind}@{pos}"

    sources: List[Transformation] = []
    steps: List[Step] = []
    # producer[node.id]: the source or step whose output carries the node's
    # records; keyed[node.id]: the key_by config of keyed views;
    # side_tag[node.id]: the producing step's side-output channel
    producer: Dict[int, Any] = {}
    keyed: Dict[int, Dict[str, Any]] = {}
    side_tag: Dict[int, str] = {}

    def new_step(**kw) -> Step:
        s = Step(**kw)
        steps.append(s)
        return s

    def input_of(inp: Transformation):
        """(producer, tag, partitioning, key_selector) of one edge."""
        tag = side_tag.get(inp.id)
        if inp.id in keyed:
            return producer[inp.id], tag, "key_group", keyed[inp.id]["key_selector"]
        return producer[inp.id], tag, "forward", None

    for t in order:
        if t.kind == "source":
            sources.append(t)
            producer[t.id] = t
        elif t.kind == "key_by":
            producer[t.id] = producer[t.inputs[0].id]
            if t.inputs[0].id in side_tag:
                side_tag[t.id] = side_tag[t.inputs[0].id]
            keyed[t.id] = t.config  # re-keying: the newest selector wins
        elif t.kind == "global":
            # a partition hint: locally a pass-through view that keeps the
            # upstream's channel; it ends the open chain, as in the JAX planner
            producer[t.id] = producer[t.inputs[0].id]
            if t.inputs[0].id in side_tag:
                side_tag[t.id] = side_tag[t.inputs[0].id]
        elif t.kind == "side_output":
            # a tagged view of the producing step's side channel
            producer[t.id] = producer[t.inputs[0].id]
            side_tag[t.id] = t.config["tag"].tag_id
        elif t.kind in CHAINABLE:
            inp = t.inputs[0]
            ent = producer[inp.id]
            if (
                isinstance(ent, Step)
                and ent.terminal is None
                and consumers.get(inp.id, 0) == 1
                and inp.id not in keyed
                and inp.id not in side_tag
                and ent.chain
                and ent.chain[-1].id == inp.id
            ):
                ent.chain.append(t)          # fuse into the open chain
                producer[t.id] = ent
            else:
                ent2, tag, part, ks = input_of(inp)
                producer[t.id] = new_step(chain=[t], terminal=None, partitioning=part,
                                          key_selector=ks, inputs=[(ent2, 0, tag)])
        elif t.kind in TERMINALS:
            ent, tag, part, ks = input_of(t.inputs[0])
            producer[t.id] = new_step(chain=[], terminal=t, partitioning=part,
                                      key_selector=ks, inputs=[(ent, 0, tag)])
        else:
            raise deferred.not_ported(f"transformation kind {t.kind!r}", deferred.API)

    if not sources:
        raise ValueError("pipeline must start at a source")
    return StepGraph(sources=sources, steps=steps)
