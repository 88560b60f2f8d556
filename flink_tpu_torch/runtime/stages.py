"""Slot-sharing groups → pipeline stages.

Reference capability: `SlotSharingGroup` / `CoLocationGroup`
(flink-runtime .../runtime/jobmanager/scheduler/SlotSharingGroup.java,
`DataStream.slotSharingGroup`). In the reference, subtasks of all vertices
share one slot by default, and naming a group ISOLATES heavyweight
operators into their own slots — which also makes the cut stages run
concurrently as a pipeline (PIPELINED result partitions).

The stepped-executor analogue: a planned StepGraph is split at
slot-sharing-group boundaries into *stages*. Each stage is deployed as its
own task in its own slot (one process/thread running a JobRuntime over the
stage's sub-graph) and the cross-stage edges become credit-controlled
dataplane exchanges (runtime/dataplane.py — the PIPELINED partition
analogue, backpressure via credits). The default (everything in one group)
keeps today's behavior: the whole pipeline slice in one slot, which is
exactly the reference's default slot sharing.

Co-location: an iteration's feedback cycle (head → body → tail) must stay
within one stage — the CoLocationGroup constraint the reference applies to
iteration head/tail pairs — validated here.

Protocol on a cross-stage channel (FIFO, credit-controlled):
  ("b", values, timestamps)  — a record batch
  ("w", watermark_ms)        — a watermark advance
  ("m", wall_ms)             — a latency marker (source wall-clock stamp)
  ("barrier", cp_id)         — an aligned checkpoint barrier
  end-of-stream via the channel's eos frame (OutputChannel.end()).
Latency markers cross stages: the producer forwards its marker stamp as an
("m", wall_ms) frame (throttled to one per ~100 ms per channel — markers
are samples, and an unthrottled forward would cost one credit per batch)
and the consuming stage's input reader hands it to the run loop
(take_marker), so a sink's (now - stamp) measures END-TO-END transit
across every stage and exchange hop rather than resetting at each
boundary.

Checkpoints across stages use the reference's aligned-barrier algorithm
(CheckpointCoordinator → CheckpointBarrier → CheckpointBarrierHandler
alignment): the JM triggers the SOURCE stages; a source stage snapshots at
its next step boundary and emits a barrier into every out-channel; a
downstream stage pauses each input gate as its barrier arrives (alignment
backpressure — paused gates stop consuming, so post-barrier records never
enter pre-barrier state), and when every gate plus the local source
contribution has arrived it snapshots, forwards the barrier, and acks.
FIFO channels make the cut consistent with NO channel state in the
snapshot: everything pre-barrier is reflected in some stage's state,
everything post-barrier is regenerated from the rewound sources on
restore.

Counterpart of `flink_tpu/runtime/stages.py`, copied but for the device
edge: a stage's output batch may hold the port's CUDA tensors (a traced
chain's columns), which `StageOutputRunner` copies to numpy columns once
before they are sent.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from flink_tpu_torch.connectors.source import Batch, Source, SourceSplit, SplitEnumerator, SourceReader
from flink_tpu_torch.core.time import MIN_WATERMARK
from flink_tpu_torch.graph.transformation import Step, StepGraph, Transformation
from flink_tpu_torch.utils.arrays import as_device_column, obj_array
from flink_tpu_torch.utils.device import HostCopy


# ---------------------------------------------------------------------------
# stage assignment / validation
# ---------------------------------------------------------------------------

def stage_names(graph: StepGraph) -> List[str]:
    """Distinct slot-sharing groups in first-appearance (topological)
    order; the deployment order of the stages."""
    names: List[str] = []
    for s in graph.steps:
        if s.slot_group not in names:
            names.append(s.slot_group)
    return names


def num_stages(graph: StepGraph) -> int:
    return len(stage_names(graph))


def _stage_index(graph: StepGraph) -> Dict[int, int]:
    names = stage_names(graph)
    return {id(s): names.index(s.slot_group) for s in graph.steps}


def validate_stages(graph: StepGraph) -> None:
    """Slot-sharing groups must cut the graph into a forward pipeline:

    - every cross-group edge flows from an earlier stage to a later one
      (groups may not interleave along a path);
    - all steps fed directly by one source belong to one stage (a physical
      reader cannot be split across processes);
    - an iteration's feedback cycle stays within one stage (CoLocationGroup
      analogue — the runtime cycle is process-local)."""
    idx = _stage_index(graph)
    # co-location first: a split iteration loop is the clearer diagnosis
    # (its backward feedback edge would otherwise read as "interleaved")
    tails = [s for s in graph.steps
             if s.terminal is not None and s.terminal.kind == "iteration_tail"]
    heads = {s.terminal.id: s for s in graph.steps
             if s.terminal is not None and s.terminal.kind == "iteration_head"}
    for tail in tails:
        head = heads.get(tail.terminal.config["head"].id)
        if head is None:
            continue  # caught by build_runners
        loop_steps = _between(graph, head, tail)
        bad = [s for s in loop_steps if idx[id(s)] != idx[id(head)]]
        if bad:
            raise ValueError(
                "iteration loop must stay within one slot sharing group "
                f"(co-location): step '{bad[0].name}' is in group "
                f"{bad[0].slot_group!r} but the iteration head is in "
                f"{head.slot_group!r}"
            )
    for s in graph.steps:
        for edge in s.inputs:
            ent = edge[0]
            if isinstance(ent, Step) and idx[id(ent)] > idx[id(s)]:
                raise ValueError(
                    f"slot sharing groups interleave: step '{s.name}' "
                    f"(group {s.slot_group!r}) consumes step '{ent.name}' "
                    f"(group {ent.slot_group!r}) which is scheduled later; "
                    "groups must form a forward pipeline"
                )
    src_stage: Dict[int, int] = {}
    for s in graph.steps:
        for edge in s.inputs:
            ent = edge[0]
            if isinstance(ent, Transformation):
                prev = src_stage.setdefault(ent.id, idx[id(s)])
                if prev != idx[id(s)]:
                    raise ValueError(
                        f"source '{ent.name}' feeds steps in different slot "
                        "sharing groups; keep its direct consumers in one "
                        "group"
                    )


def _between(graph: StepGraph, head: Step, tail: Step) -> List[Step]:
    """Steps on any path head → … → tail (inclusive), following step edges."""
    consumers: Dict[int, List[Step]] = {}
    for s in graph.steps:
        for edge in s.inputs:
            if isinstance(edge[0], Step):
                consumers.setdefault(id(edge[0]), []).append(s)
    reach_from_head = set()
    work = [head]
    while work:
        s = work.pop()
        if id(s) in reach_from_head:
            continue
        reach_from_head.add(id(s))
        work.extend(consumers.get(id(s), ()))
    reaches_tail = set()
    work = [tail]
    while work:
        s = work.pop()
        if id(s) in reaches_tail:
            continue
        reaches_tail.add(id(s))
        for edge in s.inputs:
            if isinstance(edge[0], Step):
                work.append(edge[0])
    both = reach_from_head & reaches_tail
    return [s for s in graph.steps if id(s) in both]


# ---------------------------------------------------------------------------
# cross-stage edges
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CrossEdge:
    edge_id: str
    producer_step: int        # index into graph.steps
    consumer_step: int
    ordinal: int              # input gate at the consumer
    tag: Optional[str]        # producer side-output channel, if any
    src_stage: int
    dst_stage: int


def cross_edges(graph: StepGraph) -> List[CrossEdge]:
    """Deterministic enumeration of edges crossing stage boundaries —
    identical on every task, so channel ids agree across processes."""
    idx = _stage_index(graph)
    pos = {id(s): i for i, s in enumerate(graph.steps)}
    edges: List[CrossEdge] = []
    for s in graph.steps:
        for edge in s.inputs:
            ent, ordinal = edge[0], edge[1]
            tag = edge[2] if len(edge) > 2 else None
            if isinstance(ent, Step) and idx[id(ent)] != idx[id(s)]:
                edges.append(CrossEdge(
                    edge_id=f"x{len(edges)}",
                    producer_step=pos[id(ent)],
                    consumer_step=pos[id(s)],
                    ordinal=ordinal,
                    tag=tag,
                    src_stage=idx[id(ent)],
                    dst_stage=idx[id(s)],
                ))
    return edges


# ---------------------------------------------------------------------------
# runtime pieces: channel-fed source, channel-writing sink
# ---------------------------------------------------------------------------

class _WmBox:
    """Shared watermark cell between a stage-input reader (writer) and its
    watermark 'generator' (reader)."""

    __slots__ = ("wm",)

    def __init__(self):
        self.wm = MIN_WATERMARK


class _ChannelWatermarkGenerator:
    def __init__(self, box: _WmBox):
        self._box = box
        self._emitted = MIN_WATERMARK

    def on_batch_np(self, ts) -> int:
        # always an int (None would trigger the per-event fallback in the
        # source driver); non-advancing values are dropped by the valves
        if self._box.wm > self._emitted:
            self._emitted = self._box.wm
        return self._emitted

    def snapshot(self):
        return self._emitted

    def restore(self, snap) -> None:
        self._emitted = snap


class _ChannelWatermarks:
    """WatermarkStrategy duck-type forwarding upstream-stage watermarks."""

    timestamp_assigner = None

    def __init__(self, box: _WmBox):
        self._box = box

    def create_generator(self) -> _ChannelWatermarkGenerator:
        return _ChannelWatermarkGenerator(self._box)


def _graph_disorder_bound(graph) -> "int | None":
    """Largest bounded-out-of-orderness delay (ms) across the FULL job's
    original sources, or None if any bound is not statically knowable.
    Stage-in sources carry this as `out_of_orderness_hint` so operator
    selection inside a carved stage (executor._max_source_out_of_orderness)
    still sees the job's real disorder bound — a _ChannelWatermarks
    generator alone would make the device-session routing gate fail open
    across every stage boundary. Conservative: the max is over all sources,
    not only those reaching a given window step."""
    from flink_tpu_torch.core.watermarks import BoundedOutOfOrdernessWatermarks

    bound = 0
    for src in graph.sources:
        strategy = src.config.get("watermark_strategy")
        if strategy is None:
            continue
        gen = strategy.create_generator()
        if not isinstance(gen, BoundedOutOfOrdernessWatermarks):
            return None
        bound = max(bound, gen._delay)
    return bound


class BarrierAligner:
    """Aligned-barrier tracker for one stage task (the
    CheckpointBarrierHandler analogue). Gates are the stage's cross-input
    edge ids plus the virtual '__source__' gate when the stage also hosts
    original sources (its barrier is the JM trigger consumed at a step
    boundary). A gate that delivered the in-flight barrier is PAUSED —
    its reader yields empty batches without consuming — until every gate
    arrives; then `on_complete(cp_id)` runs on the run-loop thread
    (snapshot + forward + ack) and all gates resume. FIFO channels make
    one-at-a-time alignment sufficient: a later barrier simply waits in
    its paused gate's ring."""

    SOURCE_GATE = "__source__"

    def __init__(self, gates, has_local_sources: bool, on_complete):
        self.expected = set(gates)
        if has_local_sources:
            self.expected.add(self.SOURCE_GATE)
        self.on_complete = on_complete
        self.cp: Optional[int] = None
        self.arrived: set = set()
        self._queued: List[tuple] = []   # barriers for LATER checkpoints

    def on_barrier(self, gate: str, cp_id: int) -> None:
        if self.cp is not None and gate in self.arrived:
            # a later checkpoint's barrier on an already-aligned gate
            # (only the virtual source gate can do this — channel gates
            # pause): queue it for after the in-flight alignment, or it
            # would be silently merged into the wrong cut
            self._queued.append((gate, cp_id))
            return
        if self.cp is None:
            self.cp = cp_id
        self.arrived.add(gate)
        self._maybe_complete()

    def on_eos(self, gate: str) -> None:
        """End-of-stream on a gate (EndOfPartition analogue —
        SingleCheckpointBarrierHandler.processEndOfPartition): an ended
        channel can never deliver a barrier, so stop expecting it; an ended
        channel also has no pre-barrier data left, so for alignment purposes
        it counts as aligned. Without this, a stage whose upstreams end at
        different lengths stalls forever: the shorter upstream never emits
        the in-flight barrier, the already-paused gates never resume, and
        the paused upstream blocks on credits."""
        self.expected.discard(gate)
        self.arrived.discard(gate)
        self._maybe_complete()

    def _maybe_complete(self) -> None:
        if self.cp is not None and self.arrived >= self.expected:
            cp, self.cp, self.arrived = self.cp, None, set()
            self.on_complete(cp)
            queued, self._queued = self._queued, []
            for g, c in queued:
                self.on_barrier(g, c)

    def paused(self, gate: str) -> bool:
        return self.cp is not None and gate in self.arrived


class _StageReader(SourceReader):
    """Reads ('b', values, ts) / ('w', wm) / ('barrier', cp) messages off
    one exchange channel. Returns an EMPTY batch on poll timeout (keeps
    the round-robin source loop live for the job's other inputs) and None
    only at end-of-stream. While this gate's barrier is aligning, the
    reader yields empty batches WITHOUT consuming (alignment
    backpressure)."""

    def __init__(self, channel, cancelled: threading.Event, box: _WmBox,
                 gate: str = "", aligner: Optional[BarrierAligner] = None):
        self._chan = channel
        self._cancelled = cancelled
        self._box = box
        self._gate = gate
        self._aligner = aligner
        self._pending_marker: Optional[float] = None

    def add_split(self, split: SourceSplit) -> None:
        pass

    def take_marker(self) -> Optional[float]:
        """Latest upstream latency-marker stamp received on this channel
        (cleared on read). The run loop attaches it to the next batch it
        pushes, preserving cross-stage transit measurement; markers are
        samples, so keeping only the latest between batches is lossless for
        percentile purposes."""
        m, self._pending_marker = self._pending_marker, None
        return m

    def poll_batch(self, max_records: int) -> Optional[Batch]:
        while not self._cancelled.is_set():
            if self._aligner is not None and self._aligner.paused(self._gate):
                return _EMPTY_BATCH               # aligning: do not consume
            try:
                msg = self._chan.poll(timeout=0.05)
            except TimeoutError:
                return _EMPTY_BATCH
            if msg is None:
                if self._aligner is not None:     # ended gates align freely
                    self._aligner.on_eos(self._gate)
                return None                       # upstream stage ended
            if msg[0] == "w":
                self._box.wm = max(self._box.wm, int(msg[1]))
                return _EMPTY_BATCH               # watermark piggybacks next
            if msg[0] == "m":
                self._pending_marker = float(msg[1])
                return _EMPTY_BATCH               # marker rides the next batch
            if msg[0] == "barrier":
                if self._aligner is not None:
                    # may complete the alignment: the snapshot callback runs
                    # HERE, on the run-loop thread between batches
                    self._aligner.on_barrier(self._gate, int(msg[1]))
                return _EMPTY_BATCH
            # numeric columns forward device-ready: the binary wire decodes
            # straight into contiguous np.frombuffer views, which pass
            # through untouched and the fused runner stages them as it
            # stages any source's columns; only a non-contiguous view pays
            # one compaction here
            return Batch(values=as_device_column(msg[1]),
                         timestamps=np.asarray(msg[2], dtype=np.int64))
        return None


def _host_columns(values, timestamps):
    """`values` and `timestamps` as host columns: a torch tensor (the port's
    device columns) is copied to a numpy array once, through one
    `HostCopy`; anything else passes through. A tensor never reaches the
    frame codec."""
    tensors = [x if isinstance(x, torch.Tensor) else None for x in (values, timestamps)]
    if tensors == [None, None]:
        return values, timestamps
    host = HostCopy(tensors).wait()
    return tuple(x if h is None else h.numpy() for x, h in zip((values, timestamps), host))


_EMPTY_BATCH = Batch(values=obj_array([]),
                     timestamps=np.asarray([], dtype=np.int64))


class StageInputSource(Source):
    """Source wrapping one cross-stage input channel."""

    boundedness = "CONTINUOUS_UNBOUNDED"

    def __init__(self, channel, cancelled: threading.Event, box: _WmBox,
                 gate: str = "", aligner: Optional[BarrierAligner] = None):
        self._channel = channel
        self._cancelled = cancelled
        self._box = box
        self._gate = gate
        self._aligner = aligner

    def create_enumerator(self) -> SplitEnumerator:
        return SplitEnumerator([SourceSplit("stage-input")])

    def create_reader(self) -> _StageReader:
        return _StageReader(self._channel, self._cancelled, self._box,
                            self._gate, self._aligner)


class StageOutputRunner:
    """Terminal step writing this stage's boundary output to the exchange
    (instantiated via executor._make_runner on kind 'stage_output';
    duck-typed StepRunner — import cycle keeps it out of executor.py).
    Backpressure: send blocks on credits, surfacing the downstream stage's
    backlog to this stage's run loop (reference: writer blocking on
    LocalBufferPool)."""

    downstream = None
    sides = None
    num_inputs = 1
    records_in_counter = None   # the port's runners count numRecordsIn
    #                             on delivery; this one counts numRecordsOut

    MARKER_FORWARD_SPACING_MS = 100.0

    def __init__(self, step: Step):
        t = step.terminal
        self.uid = t.uid
        self.sender = t.config["sender"]
        self.cancelled: threading.Event = t.config["cancelled"]
        # BufferDebloater analogue at batch granularity: observes this
        # sender's achieved throughput and splits oversized batches toward
        # throughput x target latency, so a backpressured exchange carries
        # smaller batches (None = exchange.debloat.enabled: false)
        self.debloater = t.config.get("debloater")
        self._ended = False
        self._last_marker_fwd = 0.0
        self.records_out = None

    def register_metrics(self, group) -> None:
        self.records_out = group.counter("numRecordsOut")
        # exchange-side observability: credits left (outPoolUsage inverse —
        # 0 while the downstream stage lags) and cumulative time this task
        # spent blocked on them (the task's backPressured contribution)
        group.gauge("availableCredits", self.sender.available_credits,
                    fold="sum")
        group.gauge("backPressuredTimeMsTotal",
                    lambda: self.backpressure_seconds() * 1000.0,
                    fold="sum", kind="counter")
        if self.debloater is not None:
            group.gauge("debloatedBatchSize", self.debloater.batch_size,
                        fold="sum")

    def backpressure_seconds(self) -> float:
        """Cumulative seconds blocked waiting for downstream credits; the
        task's TaskIOMetrics subtracts this from busy time."""
        return getattr(self.sender, "backpressured_s", 0.0)

    def _send(self, msg) -> None:
        while True:
            try:
                self.sender.send(msg, timeout=1.0)
                return
            except TimeoutError:
                if self.cancelled.is_set():
                    from flink_tpu_torch.runtime.executor import JobCancelledException

                    raise JobCancelledException()

    # StepRunner protocol (single gate)
    def on_batch_n(self, ordinal, values, timestamps) -> None:
        self.on_batch(values, timestamps)

    def on_watermark_n(self, ordinal, watermark) -> None:
        self.on_watermark(watermark)

    def on_end_n(self, ordinal) -> None:
        self.on_end()

    def on_batch(self, values, timestamps) -> None:
        n = len(timestamps)
        if not n:
            return
        # device edge: a traced chain's columns may be CUDA tensors; they
        # leave for the wire as numpy columns, copied to the host once
        values, timestamps = _host_columns(values, timestamps)
        if self.records_out is not None:
            self.records_out.inc(n)
        d = self.debloater
        if d is None:
            self._send(("b", values, timestamps))
            return
        # split-only debloating: an oversized batch is sent in target-sized
        # slices (views, no copies). Splitting is stateless, so it composes
        # with aligned checkpoints — nothing is ever buffered across a
        # barrier. Until the first observation the batch passes through
        # whole (min_size would shred it for no reason).
        target = max(d.batch_size(), 1) if d.observed else n
        t0 = time.perf_counter()
        if n > target:
            for lo in range(0, n, target):
                self._send(("b", values[lo:lo + target],
                            timestamps[lo:lo + target]))
        else:
            self._send(("b", values, timestamps))
        # send time includes any credit wait — exactly the signal that
        # should shrink batches under backpressure
        d.observe(n, time.perf_counter() - t0)

    def on_watermark(self, watermark: int) -> None:
        self._send(("w", int(watermark)))

    def on_marker(self, wall_ms: float) -> None:
        # forward the stamp across the exchange so downstream stages (and
        # ultimately the sinks) measure end-to-end transit; the send shares
        # the data channel's credit discipline, which is exactly right — a
        # marker delayed by backpressure reports latency that backpressure
        # really added. Forwarding is throttled (markers are samples): with
        # per-batch markers at the source, an unthrottled forward would add
        # one exchange frame — one credit — per batch on the hot path.
        if self._ended:
            return
        now = time.monotonic() * 1000.0
        if now - self._last_marker_fwd >= self.MARKER_FORWARD_SPACING_MS:
            self._last_marker_fwd = now
            self._send(("m", float(wall_ms)))

    def on_processing_time(self, now_ms: int) -> None:
        pass

    def on_end(self) -> None:
        if not self._ended:
            self._ended = True
            self.sender.end()

    def snapshot(self) -> dict:
        return {}

    def restore(self, snap: dict) -> None:
        pass


# ---------------------------------------------------------------------------
# per-stage sub-graph
# ---------------------------------------------------------------------------

def stage_has_original_sources(graph: StepGraph, stage_idx: int) -> bool:
    idx = _stage_index(graph)
    return any(
        isinstance(edge[0], Transformation)
        for s in graph.steps if idx[id(s)] == stage_idx
        for edge in s.inputs
    )


def source_stage_indices(graph: StepGraph) -> List[int]:
    """Stages hosting original sources — the ones the JM's checkpoint
    trigger targets (barriers cascade to the rest)."""
    return [i for i in range(num_stages(graph))
            if stage_has_original_sources(graph, i)]


def build_stage_graph(
    graph: StepGraph,
    stage_idx: int,
    in_channels: Dict[str, Any],
    out_senders: Dict[str, Any],
    cancelled: threading.Event,
    aligner: Optional[BarrierAligner] = None,
    debloaters: Optional[Dict[str, Any]] = None,
) -> StepGraph:
    """Carve stage `stage_idx` out of `graph` (the task's OWN unpickled
    copy — mutated in place): cross-stage inputs become StageInputSource
    transformations reading `in_channels[edge_id]`; boundary outputs grow a
    'stage_output' terminal step writing `out_senders[edge_id]`."""
    idx = _stage_index(graph)
    edges = cross_edges(graph)
    mine = [s for s in graph.steps if idx[id(s)] == stage_idx]
    disorder_hint = _graph_disorder_bound(graph)   # before sources mutate

    for e in edges:
        if e.dst_stage == stage_idx:
            consumer = graph.steps[e.consumer_step]
            box = _WmBox()
            src_t = Transformation(
                "source", f"stage-in:{e.edge_id}", [],
                {
                    "source": StageInputSource(
                        in_channels[e.edge_id], cancelled, box,
                        gate=e.edge_id, aligner=aligner),
                    "watermark_strategy": _ChannelWatermarks(box),
                    "out_of_orderness_hint": disorder_hint,
                },
            )
            src_t.uid = f"stage-in-{e.edge_id}"
            # string id: the unpickled graph carries CLIENT-counter ids, and
            # this process's fresh counter would collide with them (feeds in
            # build_runners key by id — a collision merges two sources'
            # feed lists and misroutes records)
            src_t.id = f"stage-in-{e.edge_id}"
            for j, edge in enumerate(consumer.inputs):
                ent, ordinal = edge[0], edge[1]
                tag = edge[2] if len(edge) > 2 else None
                if (isinstance(ent, Step)
                        and graph.steps[e.producer_step] is ent
                        and ordinal == e.ordinal and tag == e.tag):
                    # tag consumed producer-side; this gate sees a plain feed
                    consumer.inputs[j] = (src_t, ordinal, None)
                    break
        if e.src_stage == stage_idx:
            producer = graph.steps[e.producer_step]
            out_t = Transformation(
                "stage_output", f"stage-out:{e.edge_id}", [],
                {"sender": out_senders[e.edge_id], "cancelled": cancelled,
                 "debloater": (debloaters or {}).get(e.edge_id)},
            )
            out_t.uid = f"stage-out-{e.edge_id}"
            out_t.id = f"stage-out-{e.edge_id}"   # collision-proof (see above)
            mine.append(Step(
                chain=[], terminal=out_t, partitioning="forward",
                inputs=[(producer, 0, e.tag)],
            ))

    sources: List[Transformation] = []
    for s in mine:
        for edge in s.inputs:
            ent = edge[0]
            if isinstance(ent, Transformation) and ent.kind == "source" \
                    and ent not in sources:
                sources.append(ent)
    if not sources:
        raise ValueError(f"stage {stage_idx} has no inputs")
    return StepGraph(sources=sources, steps=mine)
