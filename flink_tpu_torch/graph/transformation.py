"""Transformation DAG and its plan into chained steps.

Counterpart of `flink_tpu/graph/transformation.py`: API calls record
`Transformation` nodes; `plan` groups chainable record-local
transformations into steps (the analogue of operator chains) and cuts
chains at keyBy, at every multi-input or multi-consumer boundary, and
where the slot-sharing group changes. The partitioners are pass-through
views locally; `forward`, the one that keeps chaining, is seen through by
fusion. An iteration's tail names its head in its config, so the DAG stays
acyclic and the feedback cycle exists only at run time; the tail joins its
head's slot-sharing group.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional

_ids = itertools.count(1)

# chain-breaking kinds: a keyBy repartition and the partitioner hints
REDISTRIBUTING = {"key_by", "rebalance", "broadcast", "rescale", "global", "shuffle", "forward"}

# record-local kinds fusable into one chain step
CHAINABLE = {"map", "map_ts", "map_batch", "flat_map", "filter", "process"}

# single-input stateful/boundary terminals; the iteration's head and tail
# are its feedback edge's two ends
TERMINALS = {
    "window_aggregate", "reduce", "sink", "process_keyed", "async_map", "cep",
    "group_agg", "iteration_head", "iteration_tail",
}

# multi-input terminals (DataStream.java:111 union/connect/join surface)
MULTI_TERMINALS = {"union", "co_map", "co_flat_map", "co_process", "window_join", "co_group",
                   "broadcast_process", "regular_join"}


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
    edges, a producer being an upstream Step or a source Transformation;
    the ordinal selects the input gate of a two-input operator."""

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
    alias_of: Dict[int, int] = {}   # forward views -> the node they show
    # slot-sharing group per node: declared, else the first input's
    group_of: Dict[int, str] = {}

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
        g = t.config.get("slot_sharing_group")
        if g is None and t.inputs:
            g = group_of[t.inputs[0].id]
        group_of[t.id] = g or "default"
        if t.kind == "source":
            sources.append(t)
            producer[t.id] = t
        elif t.kind == "key_by":
            producer[t.id] = producer[t.inputs[0].id]
            if t.inputs[0].id in side_tag:
                side_tag[t.id] = side_tag[t.inputs[0].id]
            keyed[t.id] = t.config  # re-keying: the newest selector wins
        elif t.kind == "side_output":
            # a tagged view of the producing step's side channel
            producer[t.id] = producer[t.inputs[0].id]
            side_tag[t.id] = t.config["tag"].tag_id
        elif t.kind in CHAINABLE:
            inp = t.inputs[0]
            ent = producer[inp.id]
            eff_id = alias_of.get(inp.id, inp.id)
            if (
                isinstance(ent, Step)
                and ent.terminal is None
                and consumers.get(inp.id, 0) == 1
                # seeing through a forward view must not hide the viewed
                # node's other consumers
                and (eff_id == inp.id or consumers.get(eff_id, 0) == 1)
                and inp.id not in keyed
                and inp.id not in side_tag
                and ent.chain
                and ent.chain[-1].id == eff_id
                and group_of[t.id] == ent.slot_group
            ):
                ent.chain.append(t)          # fuse into the open chain
                producer[t.id] = ent
            else:
                ent2, tag, part, ks = input_of(inp)
                producer[t.id] = new_step(chain=[t], terminal=None, partitioning=part,
                                          key_selector=ks, inputs=[(ent2, 0, tag)],
                                          slot_group=group_of[t.id])
        elif t.kind in TERMINALS:
            ent, tag, part, ks = input_of(t.inputs[0])
            producer[t.id] = new_step(chain=[], terminal=t, partitioning=part,
                                      key_selector=ks, inputs=[(ent, 0, tag)],
                                      slot_group=group_of[t.id])
        elif t.kind in MULTI_TERMINALS:
            ins = []
            part, ks = "forward", None
            for o, inp in enumerate(t.inputs):
                ent, tag, p, k = input_of(inp)
                ins.append((ent, o, tag))
                if p == "key_group":
                    part, ks = p, (ks or k)
            producer[t.id] = new_step(chain=[], terminal=t, partitioning=part,
                                      key_selector=ks, inputs=ins, slot_group=group_of[t.id])
        elif t.kind in REDISTRIBUTING:
            # a partitioner hint: locally a pass-through view that keeps the
            # upstream's channel; `forward`, the one partitioner that keeps
            # chaining, also keeps the keyed view and is seen through by
            # fusion
            inp = t.inputs[0]
            producer[t.id] = producer[inp.id]
            if inp.id in side_tag:
                side_tag[t.id] = side_tag[inp.id]
            if t.kind == "forward":
                if inp.id in keyed:
                    keyed[t.id] = keyed[inp.id]
                alias_of[t.id] = alias_of.get(inp.id, inp.id)
        else:
            raise NotImplementedError(f"transformation kind {t.kind}")

    if not sources:
        raise ValueError("pipeline must start at a source")
    # an iteration's tail joins its head's slot-sharing group: the feedback
    # cycle is local
    head_group = {s.terminal.id: s.slot_group for s in steps
                  if s.terminal is not None and s.terminal.kind == "iteration_head"}
    for s in steps:
        if s.terminal is not None and s.terminal.kind == "iteration_tail":
            hid = s.terminal.config["head"].id
            if hid in head_group:
                s.slot_group = head_group[hid]
    return StepGraph(sources=sources, steps=steps)
