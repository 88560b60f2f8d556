"""FusedWindowOperator: the operator the executor drives for fused windows.

Counterpart of `flink_tpu/runtime/fused_window_operator.py`. It presents
the operator surface — process_batch / process_raw_batch /
process_watermark / drain_output / snapshot / restore — while buffering
steps and dispatching one T-step superscan per superbatch on
`FusedWindowPipeline` (kernel K1 for CUDA state).

Two host-side layers keep the pipeline's planner from raising:

- StepNormalizer splits raw (batch, watermark) steps into planner-safe
  steps: slice-span splitting, intermediate watermarks so no step fires
  more than fires_per_step windows, and ring-overflow hold-back of records
  too far in the future.
- The dispatch grouper packs normalized steps into fixed-T superbatches
  (padding with empty steps) and cuts a dispatch early before planned
  fires exceed out_rows.

Emissions materialize when a superbatch resolves; `emitted_watermark` is
the watermark downstream may safely observe. One dispatch stays in flight:
dispatch i+1 is staged and enqueued before dispatch i resolves.

Latency mode (`latency=LatencySpec(target_ms > 0, ...)`, the
`execution.latency.*` options): a `SuperbatchController` picks the depth
each dispatch cuts at from a pow2 rung ladder, the in-flight ring holds up
to `max_inflight` dispatches, and the pipeline runs each dispatch as
readback groups of `readback_steps` steps. The rows and their order are
throughput mode's.

Shared partials (`assigners=`, graph/window_sharing.py): one
SharedWindowPipeline serves several correlated windows over one stream,
SharedStepNormalizer budgets each member's fire slots, and each member's
rows go to its own lane (`drain_spec_output`).

Not ported (each raises, naming its ROADMAP.md item): the mesh (item 13),
the state tier (item 11), device stats (D4) and queryable state (item 11).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.api.windowing.assigners import WindowAssigner
from flink_tpu_torch.core.time import MAX_WATERMARK, MIN_WATERMARK, TimeWindow
from flink_tpu_torch.lint.contracts import inflight_ring
from flink_tpu_torch.ops.aggregators import ONE, VALUE, resolve
from flink_tpu_torch.runtime.fused_window_pipeline import (
    FusedWindowPipeline,
    SharedWindowPipeline,
)
from flink_tpu_torch.scheduler.latency_controller import LatencySpec, SuperbatchController
from flink_tpu_torch.state.columnar import KeyDictionary
from flink_tpu_torch.utils import deferred


@dataclasses.dataclass
class _Step:
    """One planner-safe step: a (possibly empty) batch plus the watermark in
    effect after it, annotated with how many windows its advance fires."""

    kid: np.ndarray
    vals: Optional[np.ndarray]
    ts: np.ndarray
    wm: int
    n_fires: int
    # slice ids of ts, when the normalizer already computed them
    s_abs: Optional[np.ndarray] = None


class StepNormalizer:
    """Host-side simulation of the fused planner's frontier state, used to
    pre-split raw steps so `stage_superbatch` never raises. Uses the
    pipeline's geometry formulas (one source of truth)."""

    def __init__(self, pipe: FusedWindowPipeline, raw_payload: bool = False):
        self.p = pipe
        # payload column: dense int32 key ids, or the raw record columns of
        # a traced chain — the normalizer only row-indexes it
        self._cast = ((lambda a: np.asarray(a)) if raw_payload
                      else (lambda a: np.asarray(a, np.int32)))
        self.wm = MIN_WATERMARK
        self.fire_cursor: Optional[int] = None
        self.max_seen: Optional[int] = None
        self.min_used: Optional[int] = None
        self.purged_to: Optional[int] = None
        # far-future records held until the ring can take them
        self._future: List[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]] = []
        self.num_future_held = 0

    def _j_fired_upto(self, wm: int) -> int:
        return self.p._j_fired_upto(wm)

    def _min_live_slice(self, wm: int) -> int:
        return self.p._min_live_slice(wm)

    def _slice_of(self, ts: np.ndarray) -> np.ndarray:
        return self.p._slice_of(np.asarray(ts, dtype=np.int64))

    def _fire_wm(self, j: int) -> int:
        """Smallest watermark at which window j fires."""
        return self.p.offset + j * self.p.slide_ms + self.p.size_ms - 1

    # ------------------------------------------------------------------
    def push(self, kid: np.ndarray, vals: Optional[np.ndarray], ts: np.ndarray) -> List[_Step]:
        """Normalize one data batch (no watermark advance)."""
        out: List[_Step] = []
        self._append_data(out, kid, vals, ts)
        return out

    def advance(self, wm: int) -> List[_Step]:
        """Normalize one watermark advance into fire-bounded steps. Held
        future records are re-injected between staged fire steps, and each
        staged watermark is capped so it never passes a held record's slice
        lifetime before the record was re-ingested."""
        out: List[_Step] = []
        if wm <= self.wm:
            return out
        while True:
            target = wm
            held_floor = self._held_min_slice()
            if held_floor is not None:
                cap_wm = self.p._wm_keeping_slice_live(held_floor)
                target = min(wm, max(cap_wm, self.wm))
            step_wm, n_fires = self._stage_fire_step(target)
            out.append(_Step(np.empty(0, np.int32), None, np.empty(0, np.int64),
                             step_wm, n_fires))
            self._commit_wm(step_wm, n_fires)
            held_before = self.num_future_held
            self._drain_future(out)
            if step_wm >= wm:
                break
            if step_wm >= target and target < wm:
                # the held-record cap binds and the drain re-ingested
                # nothing: only pathological geometry gets here; advance
                # past (the held records then count as late)
                if self.num_future_held >= held_before and \
                        self._held_min_slice() == held_floor:
                    out.extend(self._advance_uncapped(wm))
                    break
        return out

    def _advance_uncapped(self, wm: int) -> List[_Step]:
        out: List[_Step] = []
        while self.wm < wm:
            step_wm, n_fires = self._stage_fire_step(wm)
            out.append(_Step(np.empty(0, np.int32), None, np.empty(0, np.int64),
                             step_wm, n_fires))
            self._commit_wm(step_wm, n_fires)
            self._drain_future(out)
        return out

    def _stage_fire_step(self, target: int):
        """(step_wm, n_fires) of the next staged advance toward `target`:
        the largest watermark whose fire load fits one step's fire slots."""
        p = self.p
        n_fires = 0
        step_wm = target
        if self.fire_cursor is not None and self.max_seen is not None:
            cap = min(self._j_fired_upto(target), p._j_newest(self.max_seen))
            n_fires = max(0, cap - self.fire_cursor + 1)
            if n_fires > p.F:
                cap = self.fire_cursor + p.F - 1
                step_wm = min(target, self._fire_wm(cap))
                n_fires = p.F
        return step_wm, n_fires

    def _held_min_slice(self) -> Optional[int]:
        if not self._future:
            return None
        return min(int(self._slice_of(t).min()) for _, _, t in self._future)

    def pad_step(self, wm: Optional[int] = None) -> _Step:
        """An empty no-op step, stamped with `wm` (the enclosing group's last
        real step watermark) or the committed watermark."""
        w = self.wm if wm is None else wm
        return _Step(np.empty(0, np.int32), None, np.empty(0, np.int64), w, 0)

    # ------------------------------------------------------------------
    def _commit_wm(self, wm: int, n_fires: int) -> None:
        if wm <= self.wm:
            return
        j_hi = self._j_fired_upto(wm)
        if self.fire_cursor is not None and j_hi >= self.fire_cursor:
            self.fire_cursor = j_hi + 1
        new_min_live = self._min_live_slice(wm)
        self.purged_to = (new_min_live if self.purged_to is None
                          else max(self.purged_to, new_min_live))
        self.wm = wm

    def _append_data(self, out: List[_Step], kid, vals, ts) -> None:
        p = self.p
        n = len(ts)
        if n == 0:
            return
        s_abs = self._slice_of(ts)
        keep = np.ones(n, dtype=bool)
        if self.wm > MIN_WATERMARK:
            # late records: the pipeline drops and counts them itself; they
            # must not affect splits
            keep = s_abs >= self._min_live_slice(self.wm)
        if not keep.any():
            out.append(_Step(self._cast(kid), vals, np.asarray(ts, np.int64), self.wm, 0))
            return

        # ring-overflow hold-back: a record at slice s needs the span
        # [oldest live slice, s] resident
        floor = int(s_abs[keep].min())
        if self.min_used is not None:
            floor = min(floor, self.min_used)
        if self.wm > MIN_WATERMARK:
            floor = max(floor, self._min_live_slice(self.wm))
        if self.purged_to is not None:
            floor = max(floor, self.purged_to)
        limit = floor + p.S - p.NSB
        over = keep & (s_abs >= limit)
        if over.any():
            idx = np.flatnonzero(over)
            self._future.append((np.asarray(kid)[idx],
                                 None if vals is None else np.asarray(vals)[idx],
                                 np.asarray(ts)[idx]))
            self.num_future_held += len(idx)
            sel = ~over
            kid, ts = np.asarray(kid)[sel], np.asarray(ts)[sel]
            vals = None if vals is None else np.asarray(vals)[sel]
            s_abs, keep = s_abs[sel], keep[sel]
            if len(ts) == 0:
                return
            if not keep.any():
                out.append(_Step(self._cast(kid), vals, np.asarray(ts, np.int64), self.wm, 0))
                return

        # slice-span splitting: sub-steps each touching < nsb slices
        smin = int(s_abs[keep].min())
        smax = int(s_abs[keep].max())
        if smax - smin < p.NSB and bool(keep.all()):
            # hot path: one step, no column copy (the raw source column goes
            # to staging untouched)
            out.append(_Step(self._cast(kid), None if vals is None else np.asarray(vals),
                             np.asarray(ts, np.int64), self.wm, 0, s_abs=s_abs))
        else:
            group = np.where(keep, (s_abs - smin) // p.NSB, 0)
            for gval in np.unique(group):
                sel = group == gval
                out.append(_Step(self._cast(np.asarray(kid)[sel]),
                                 None if vals is None else np.asarray(vals)[sel],
                                 np.asarray(ts)[sel].astype(np.int64), self.wm, 0))
        self._note_data(smin, smax)

    def _drain_future(self, out: List[_Step]) -> None:
        if not self._future:
            return
        fut, self._future = self._future, []
        self.num_future_held = 0
        for kid, vals, ts in fut:
            self._append_data(out, kid, vals, ts)  # still-unfit rows re-buffer

    def _note_data(self, smin: int, smax: int) -> None:
        self.max_seen = smax if self.max_seen is None else max(self.max_seen, smax)
        self.min_used = smin if self.min_used is None else min(self.min_used, smin)
        cand = self.p._j_oldest(smin)
        if self.wm > MIN_WATERMARK:
            cand = max(cand, self._j_fired_upto(self.wm) + 1)
        self.fire_cursor = cand if self.fire_cursor is None else min(self.fire_cursor, cand)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "wm": self.wm,
            "fire_cursor": self.fire_cursor,
            "max_seen": self.max_seen,
            "min_used": self.min_used,
            "purged_to": self.purged_to,
            "future": [(k.tolist(), None if v is None else v.tolist(), t.tolist())
                       for k, v, t in self._future],
            # payload dtypes of the held columns (a tolist() round trip would
            # promote float32 raw columns to float64)
            "future_kdt": [str(np.asarray(k).dtype) for k, _v, _t in self._future],
        }

    def restore(self, snap: dict) -> None:
        self.wm = snap["wm"]
        self.fire_cursor = snap["fire_cursor"]
        self.max_seen = snap["max_seen"]
        self.min_used = snap.get("min_used")
        self.purged_to = snap["purged_to"]
        kdts = snap.get("future_kdt")
        self._future = [
            (self._cast(k) if kdts is None else np.asarray(k, np.dtype(kdts[i])),
             None if v is None else np.asarray(v, np.float32),
             np.asarray(t, np.int64))
            for i, (k, v, t) in enumerate(snap["future"])
        ]
        self.num_future_held = sum(len(t) for _, _, t in self._future)


class SharedStepNormalizer(StepNormalizer):
    """StepNormalizer over a SharedWindowPipeline (shared partials): one
    shared ingest/ring frontier, per-spec fire cursors, each member
    window's fire-slot budget binding the staged advance on its own."""

    def __init__(self, pipe, raw_payload: bool = False):
        super().__init__(pipe, raw_payload)
        self.fire_cursors: List[Optional[int]] = [None] * len(pipe.specs)

    def _note_data(self, smin: int, smax: int) -> None:
        p = self.p
        self.max_seen = smax if self.max_seen is None else max(self.max_seen, smax)
        self.min_used = smin if self.min_used is None else min(self.min_used, smin)
        for i in range(len(p.specs)):
            cand = p._spec_j_oldest(i, smin)
            if self.wm > MIN_WATERMARK:
                cand = max(cand, p._spec_j_fired_upto(i, self.wm) + 1)
            cur = self.fire_cursors[i]
            self.fire_cursors[i] = cand if cur is None else min(cur, cand)

    def _stage_fire_step(self, target: int):
        p = self.p
        if self.max_seen is None:
            return target, 0
        step_wm = target
        Fp = p.F_per_spec
        for i, spec in enumerate(p.specs):
            cur = self.fire_cursors[i]
            if cur is None:
                continue
            cap = min(p._spec_j_fired_upto(i, target), self.max_seen // spec.sl)
            if cap - cur + 1 > Fp:
                step_wm = min(step_wm, p._spec_fire_wm(i, cur + Fp - 1))
        # fire counts settle after the binding spec lowered step_wm (each
        # spec's count is monotone in wm, so every spec fits its budget)
        total = 0
        for i, spec in enumerate(p.specs):
            cur = self.fire_cursors[i]
            if cur is None:
                continue
            cap = min(p._spec_j_fired_upto(i, step_wm), self.max_seen // spec.sl)
            total += max(0, cap - cur + 1)
        return step_wm, total

    def _commit_wm(self, wm: int, n_fires: int) -> None:
        if wm <= self.wm:
            return
        p = self.p
        for i in range(len(p.specs)):
            j_hi = p._spec_j_fired_upto(i, wm)
            cur = self.fire_cursors[i]
            if cur is not None and j_hi >= cur:
                self.fire_cursors[i] = j_hi + 1
        # the minimum over specs: the longest member holds every slice it
        # still needs
        new_min_live = p._min_live_slice(wm)
        self.purged_to = (new_min_live if self.purged_to is None
                          else max(self.purged_to, new_min_live))
        self.wm = wm

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["fire_cursors"] = list(self.fire_cursors)
        return snap

    def restore(self, snap: dict) -> None:
        super().restore(snap)
        self.fire_cursors = list(snap["fire_cursors"])


def _own_window(w):
    """A window of either package as this package's TimeWindow (restored
    output may come from a JAX snapshot)."""
    return w if isinstance(w, TimeWindow) else TimeWindow(int(w.start), int(w.end))


def _own_row(row):
    k, w, r, ts = row
    if k is None and isinstance(r, tuple):          # a packed columnar fire
        r = (_own_window(r[0]),) + tuple(r[1:])
    return (k, _own_window(w), r, ts)


@inflight_ring("_inflight", drained_by="_resolve_inflight")
class FusedWindowOperator:
    """Operator-boundary adapter over FusedWindowPipeline, with one
    dispatch kept in flight (resolve of dispatch i overlaps the device's
    run of dispatch i+1), or up to `latency.max_inflight` in latency mode.
    `device=None` runs on CUDA or raises."""

    def __init__(
        self,
        assigner: Optional[WindowAssigner],
        aggregate,
        *,
        key_capacity: int = 1 << 12,
        superbatch_steps: int = 32,
        dense_int_keys: bool = False,
        num_slices: Optional[int] = None,
        nsb: int = 4,
        fires_per_step: int = 4,
        out_rows: int = 256,
        chunk: int = 4096,
        columnar_output: bool = False,
        prologue=None,
        mesh=None,
        tier=None,
        assigners=None,
        latency: Optional[LatencySpec] = None,
        device=None,
    ):
        for option, value, item in (("mesh", mesh, deferred.MESH),
                                    ("tier", tier, deferred.STATE_PLANE)):
            if value is not None:
                raise deferred.not_ported(f"FusedWindowOperator({option}=...)", item)
        self.agg = resolve(aggregate)
        if self.agg is None:
            raise ValueError(f"aggregate {aggregate!r} has no device form")
        # with a TracedPrologue steps carry RAW source columns and keying
        # is dense-int on the device (no host key dictionary)
        self.prologue = prologue
        # shared partials (graph/window_sharing.py): one output lane per
        # member window, routed by the shared runner to its member's edges
        self.spec_outputs: Optional[List[list]] = None
        geometry = dict(key_capacity=key_capacity, num_slices=num_slices, nsb=nsb,
                        fires_per_step=fires_per_step, out_rows=out_rows, chunk=chunk,
                        prologue=prologue, device=device)
        if assigners is not None:
            if prologue is None:
                raise ValueError(
                    "shared-partial windows run the traced-chain path "
                    "(dense device keying); a prologue is required")
            self.spec_outputs = [[] for _ in assigners]
            self.pipe = SharedWindowPipeline(assigners, self.agg, **geometry)
            self.norm = SharedStepNormalizer(self.pipe, raw_payload=True)
        else:
            self.pipe = FusedWindowPipeline(assigner, self.agg, **geometry)
            self.norm = StepNormalizer(self.pipe, raw_payload=prologue is not None)
        self.T = superbatch_steps
        self.keydict = KeyDictionary(dense_int_keys or prologue is not None)
        self._steps: List[_Step] = []
        # in-flight dispatch ring: (DeferredEmissions, wm) entries resolved
        # FIFO. Depth 1 (the default): dispatch N+1 enqueues, THEN N
        # resolves; latency mode deepens it so N+1 stages and launches
        # while N's copies land
        self._inflight: Deque[tuple] = deque()
        self._max_inflight = 1
        # latency mode (execution.latency.target-ms): the rung controller,
        # a deeper ring and streamed readback groups. None keeps every
        # dispatch decision throughput mode's.
        self.latency = latency
        self._controller: Optional[SuperbatchController] = None
        self._ladder_geoms: set = set()   # distinct dispatch depths seen
        if latency is not None and latency.target_ms > 0:
            self._controller = SuperbatchController(
                full_steps=superbatch_steps,
                target_ms=latency.target_ms,
                floor_steps=latency.floor_steps,
                min_dwell_ms=latency.min_dwell_ms,
                hysteresis_pct=latency.hysteresis_pct,
            )
            self._max_inflight = max(int(latency.max_inflight), 1)
            self.pipe.donate_carry = True
            if latency.readback_steps > 0:
                self.pipe.readback_steps = int(latency.readback_steps)
        self.output: List[Tuple[Any, Any, Any, int]] = []
        self.emitted_watermark = MIN_WATERMARK
        self.current_watermark = MIN_WATERMARK
        self.columnar_output = columnar_output
        self._needs_value = any(f.source == VALUE for f in self.agg.fields)

    # ------------------------------------------------------------------
    def process_batch(self, keys: np.ndarray, values: np.ndarray,
                      timestamps: np.ndarray) -> None:
        if self.prologue is not None:
            raise RuntimeError("this operator runs a traced chain prologue; feed it raw "
                               "columns via process_raw_batch")
        if len(timestamps) == 0:
            return
        ids, required = self.keydict.lookup_or_insert(np.asarray(keys))
        self.pipe.ensure_key_capacity(required)
        vals = np.asarray(values, np.float32) if self._needs_value else None
        self._push_steps(self.norm.push(ids.astype(np.int32), vals,
                                        np.asarray(timestamps, np.int64)))
        self._maybe_dispatch()

    def process_raw_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        """Whole-graph fusion ingest: raw source columns, untouched by any
        host transform — the prologue runs on the device in the dispatch."""
        if len(timestamps) == 0:
            return
        self._push_steps(self.norm.push(values, None, np.asarray(timestamps, np.int64)))
        self._maybe_dispatch()

    def process_watermark(self, watermark: int) -> None:
        if watermark <= self.current_watermark:
            return
        self.current_watermark = watermark
        steps = self.norm.advance(watermark)
        # a single-step advance rides the preceding data step (the pipeline
        # fires after ingesting step t's batch: the executor's
        # batch-then-watermark order)
        if steps and self._steps and self._steps[-1].n_fires == 0 and len(steps[0].ts) == 0:
            self._steps[-1].wm = steps[0].wm
            self._steps[-1].n_fires = steps[0].n_fires
            steps = steps[1:]
        self._push_steps(steps)
        if watermark >= MAX_WATERMARK - 1:
            self.flush_all()
        else:
            self._maybe_dispatch()

    # ------------------------------------------------------------------
    def _push_steps(self, steps: List[_Step]) -> None:
        """Append planner-safe steps and feed the latency controller's
        arrival estimate (watermark-only steps count: they take dispatch
        slots too)."""
        self._steps.extend(steps)
        if self._controller is not None and steps:
            self._controller.observe(len(steps))

    def _dispatch_target(self) -> int:
        """Steps a full dispatch cuts at: the controller's rung in latency
        mode, the fixed span otherwise."""
        if self._controller is None:
            return self.T
        return self._controller.steps()

    def _maybe_dispatch(self) -> None:
        target = self._dispatch_target()
        while len(self._steps) >= target:
            self._dispatch(self._take_group(target=target))
            target = self._dispatch_target()

    def flush_all(self) -> None:
        """Dispatch every buffered step and resolve all in-flight output.
        Tail groups pad to the next power of two instead of T."""
        while len(self._steps) >= self.T:
            self._dispatch(self._take_group())
        while self._steps:
            self._dispatch(self._take_group(tail=True))
        self._resolve_inflight()

    def _take_group(self, tail: bool = False,
                    target: Optional[int] = None) -> List[_Step]:
        limit = self.T if target is None else target
        group: List[_Step] = []
        fires = 0
        while self._steps and len(group) < limit:
            s = self._steps[0]
            if fires + s.n_fires > self.pipe.R and group:
                break  # out_rows budget: cut the dispatch early
            fires += s.n_fires
            group.append(self._steps.pop(0))
        target = (1 << max(len(group) - 1, 0).bit_length()) if tail else limit
        # pads carry the LAST REAL step's watermark: steps still queued
        # behind an early cut have lower watermarks
        pad_wm = group[-1].wm if group else None
        while len(group) < target:
            group.append(self.norm.pad_step(pad_wm))
        return group

    def _dispatch(self, group: List[_Step]) -> None:
        wms = [s.wm for s in group]
        if self.prologue is not None:
            d = self.pipe.process_superbatch_raw(
                [(s.kid, s.ts, s.s_abs) for s in group], wms, defer=True)
        else:
            d = self.pipe.process_superbatch(
                [(s.kid, s.vals, s.ts) for s in group], wms, defer=True)
        if self._controller is not None:
            self._ladder_geoms.add(len(group))
        self._inflight.append((d, group[-1].wm))
        while len(self._inflight) > self._max_inflight:
            self._resolve_oldest()

    def _resolve_inflight(self) -> None:
        """Drain the whole in-flight ring (FIFO): every barrier that needs
        the operator quiescent (flush_all, and thus snapshot) lands here."""
        while self._inflight:
            self._resolve_oldest()

    def _resolve_oldest(self) -> None:
        d, wm = self._inflight.popleft()
        for window, counts, fields in d.resolve():
            self._emit(window, counts, fields)
        if wm > self.emitted_watermark:
            self.emitted_watermark = wm

    def _emit(self, window, counts, fields) -> None:
        """One fire's rows (the JAX operator's `_emit_dense_rows` and
        `_emit_keydict_rows`): under the traced prologue a row id IS the key
        the traced selector produced; otherwise row i is the key
        dictionary's i-th key, and rows past its size are unused. A shared
        pipeline tags each fire with its member spec: (spec, window), and
        the rows go to that member's lane."""
        sink = self.output
        if self.spec_outputs is not None:
            spec, window = window
            sink = self.spec_outputs[spec]
        n = None if self.prologue is not None else len(self.keydict)
        counts = np.asarray(counts)[:n]
        live = np.flatnonzero(counts > 0)
        if live.size == 0:
            return
        fdict: Dict[str, Any] = {
            f.name: (counts if f.source == ONE else np.asarray(fields[f.name])[:n])
            for f in self.agg.fields
        }
        result = np.asarray(self.agg.extract(fdict))
        ts = window.max_timestamp()
        if self.columnar_output:
            # one packed row per fire: (window, dense key ids, values); map
            # ids back through .keydict when raw keys are needed
            sink.append((None, window, (window, live, result[live]), ts))
            return
        keys = live.tolist() if n is None else self.keydict.keys_for(live)
        for k, i in zip(keys, live):
            sink.append((k, window, result[i].item(), ts))

    def drain_output(self) -> List[Tuple[Any, Any, Any, int]]:
        out = self.output
        self.output = []
        return out

    def drain_spec_output(self, spec: int) -> List[Tuple[Any, Any, Any, int]]:
        """Shared partials: drain one member window's output lane (the
        shared runner routes lane i to member i's downstream edges)."""
        out = self.spec_outputs[spec]
        self.spec_outputs[spec] = []
        return out

    def query_state_for(self, key):
        raise deferred.not_ported("FusedWindowOperator.query_state_for", deferred.STATE_PLANE)

    # ------------------------------------------------------------------
    @property
    def num_late_records_dropped(self) -> int:
        return self.pipe.num_late_records_dropped

    def attach_device_stats(self, tracker, phase_counters: bool = True) -> None:
        raise deferred.not_ported("FusedWindowOperator.attach_device_stats", deferred.D4)

    def phase_totals(self):
        raise deferred.not_ported("FusedWindowOperator.phase_totals", deferred.D4)

    def latency_gauges(self):
        """The latency-mode controller's gauges, or None when the mode is
        off (registering them with a job's metrics waits for ROADMAP item
        15)."""
        if self._controller is None:
            return None
        return {
            "latencyModeActive": 1,
            "currentBatchRung": int(self._controller.current_steps()),
            "inflightDepth": len(self._inflight),
            "ladderRecompiles": len(self._ladder_geoms),
        }

    def _reset_dispatch_ring(self) -> None:
        """Restore quiescence: discard unresolved in-flight handles (their
        fires re-run from the restored state) and re-hold the controller's
        full-span rung (samples from before describe a stream position
        that no longer exists)."""
        self._inflight.clear()
        if self._controller is not None:
            self._controller.reset()

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """The JAX operator's snapshot form: buffered steps are flushed
        first so keyed state lives in one place (the rings); fires this
        triggers land in "output" and ride the snapshot."""
        self.flush_all()
        # shared partials: undrained member lanes ride the snapshot like
        # the plain output list
        extra = ({} if self.spec_outputs is None
                 else {"spec_outputs": [list(x) for x in self.spec_outputs]})
        return {
            **extra,
            "pipe": self.pipe.snapshot(),
            "keydict": self.keydict.snapshot(),
            "normalizer": self.norm.snapshot(),
            # self-describing metadata for offline tools
            "fields": [(f.name, f.scatter, f.identity, f.source, np.dtype(f.dtype).str)
                       for f in self.agg.fields],
            "geometry": {"g": self.pipe.g, "offset": self.pipe.offset},
            "output": list(self.output),
            "emitted_watermark": self.emitted_watermark,
            "current_watermark": self.current_watermark,
        }

    def restore(self, snap: dict) -> None:
        """Restore a snapshot of either package's operator."""
        if "tier" in snap or "tier_changelog" in snap:
            raise deferred.not_ported("restoring a tiered snapshot", deferred.STATE_PLANE)
        self.pipe.restore(snap["pipe"])
        self.keydict = KeyDictionary.restore(snap["keydict"])
        self.norm.restore(snap["normalizer"])
        self._steps = []
        self.emitted_watermark = snap["emitted_watermark"]
        self.current_watermark = snap["current_watermark"]
        self._reset_dispatch_ring()
        self.output = [_own_row(r) for r in snap["output"]]
        if self.spec_outputs is not None:
            self.spec_outputs = [[_own_row(r) for r in lane] for lane in snap["spec_outputs"]]
