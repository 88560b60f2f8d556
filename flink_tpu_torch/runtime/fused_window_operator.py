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

The million-key state plane (`tier=TierConfig(...)`, the `state.tier.*`
options; state/tier_manager.py): at most `hot_key_capacity` keys own ring
rows, chosen by a dynamic key vocabulary; the others aggregate in the cold
tier on the host, riding K1's steps as kid -1 so their windows still get
planned. Evictions demote a key's live cells into the cold tier and
promotions write them back (the pipeline's row surface), and each fire
merges both tiers in row mode. Snapshots are full (`"tier"`) or
incremental over a changelog (`"tier_changelog"`), in the JAX package's
forms both ways.

The mesh (`mesh=`, the `parallel.mesh.*` options; parallel/): the same
operator over a ShardedFusedPipeline, whose dispatch runs the keyBy
exchange and kernel K1 on every shard; snapshots stay canonical [K, S],
so the operator checkpoints and restores across mesh sizes. Shared
partials and the state tier run on the mesh too: the sharded pipeline
takes the members' `assigners` (its planner is the shared one), and the
tier manager moves rows through its sharded row surface.

The device plane (`attach_device_stats`, `phase_totals`, `key_loads`,
`per_device_key_loads`, `key_stats_ready`): the JAX operator's surface over
the pipeline's compile tracker, K1's phase counters and the rings' per-key
loads.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.api.windowing.assigners import WindowAssigner
from flink_tpu_torch.core.time import MAX_WATERMARK, MIN_WATERMARK, TimeWindow
from flink_tpu_torch.lint.contracts import inflight_ring
from flink_tpu_torch.metrics.traces import add, section
from flink_tpu_torch.ops.aggregators import ONE, VALUE, resolve
from flink_tpu_torch.runtime.fused_window_pipeline import (
    FusedWindowPipeline,
    SharedWindowPipeline,
)
from flink_tpu_torch.scheduler.latency_controller import LatencySpec, SuperbatchController
from flink_tpu_torch.state.columnar import KeyDictionary
from flink_tpu_torch.state.tier_manager import TieredStateManager


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
    # perf_counter_ns when the operator queued the step
    t_push: int = 0


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

    def note_slices(self, smin: int, smax: int) -> None:
        """Tier-promotion sibling of the pipeline's note_external_slices:
        rows written into the ring outside a pushed step count as resident
        data for the normalizer's fire capping and ring-floor math too, or
        the two frontier mirrors diverge."""
        self._note_data(smin, smax)

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
        mesh_local_combine: bool = False,
        mesh_skew_routing: bool = False,
        mesh_key_groups: int = 0,
        tier=None,
        assigners=None,
        latency: Optional[LatencySpec] = None,
        device=None,
    ):
        self.mesh = mesh
        self._construction_key_capacity = key_capacity
        self.agg = resolve(aggregate)
        if self.agg is None:
            raise ValueError(f"aggregate {aggregate!r} has no device form")
        # the million-key state plane: a TierConfig bounds the RESIDENT key
        # set to hot_key_capacity ring rows, fixed (the vocabulary evicts;
        # the capacity never grows). Host-keyed path only: a traced chain
        # keys on the device and has no vocabulary to evict from
        if tier is not None:
            if prologue is not None:
                raise ValueError(
                    "state.tier.enabled needs the host key dictionary; "
                    "a traced device chain keys on device (dense ids)")
            key_capacity = tier.hot_key_capacity
            dense_int_keys = False
            # dense ids are RECYCLED under eviction: packed columnar output
            # would alias keys downstream
            columnar_output = False
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
            if tier is not None:
                raise ValueError("state.tier does not apply to the shared-partial path")
            self.spec_outputs = [[] for _ in assigners]
        if mesh is not None:
            # the mesh (parallel.mesh.*): the same operator surface over the
            # sharded pipeline, shared partials included (the parallel
            # layer is imported where used)
            from flink_tpu_torch.parallel.sharded_superscan import ShardedFusedPipeline

            del geometry["device"]
            self.pipe = ShardedFusedPipeline(
                mesh, assigner, self.agg, **geometry, assigners=assigners,
                local_combine=mesh_local_combine, skew_routing=mesh_skew_routing,
                num_key_groups=mesh_key_groups)
        elif assigners is not None:
            self.pipe = SharedWindowPipeline(assigners, self.agg, **geometry)
        else:
            self.pipe = FusedWindowPipeline(assigner, self.agg, **geometry)
        self.norm = (SharedStepNormalizer(self.pipe, raw_payload=True) if assigners is not None
                     else StepNormalizer(self.pipe, raw_payload=prologue is not None))
        self.T = superbatch_steps
        self.keydict = KeyDictionary(dense_int_keys or prologue is not None)
        self.tier: Optional[TieredStateManager] = None
        if tier is not None:
            self.tier = TieredStateManager(self.agg, self.pipe.S, tier)
            self.tier.attach_device(self.pipe.gather_key_rows, self.pipe.clear_key_rows,
                                    self.pipe.write_cells)
        self._steps: List[_Step] = []
        # in-flight dispatch ring: (DeferredEmissions, wm, purged_to,
        # records, perf_counter_ns at launch)
        # entries resolved FIFO. Depth 1 (the default): dispatch N+1
        # enqueues, THEN N resolves; latency mode deepens it so N+1 stages
        # and launches while N's copies land
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
            if mesh is None and latency.readback_steps > 0:
                # the mesh keeps span-granular readback, as in the JAX
                # package: splitting a mesh dispatch multiplies its exchanges
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
        if self.tier is not None:
            self._process_batch_tiered(np.asarray(keys), values,
                                       np.asarray(timestamps, np.int64))
            return
        ids, required = self.keydict.lookup_or_insert(np.asarray(keys))
        self.pipe.ensure_key_capacity(required)
        vals = np.asarray(values, np.float32) if self._needs_value else None
        with section("flink.fused.normalize"):
            steps = self.norm.push(ids.astype(np.int32), vals, np.asarray(timestamps, np.int64))
        self._push_steps(steps)
        self._maybe_dispatch()

    # ------------------------------------------------------------------
    # tiered-state path (state/tier_manager.py)
    # ------------------------------------------------------------------
    def _tier_span(self):
        """(floor, device_hi, ring_limit): the live slice span the tier may
        move rows within. floor mirrors the normalizer's ring-floor math
        (min ever used, clamped by the purge frontier, cold touches
        included); ring_limit = floor + S - NSB is the hold-back bound — a
        promotion writing past it would alias ring positions that earlier
        data still owns."""
        p = self.pipe
        touched = self.tier._touched
        cands = [x for x in (p.min_used_slice, min(touched) if touched else None)
                 if x is not None]
        if not cands:
            return None, None, None
        lo = min(cands)
        if p.purged_to is not None:
            lo = max(lo, p.purged_to)
        hi = p.max_seen_slice if p.max_seen_slice is not None else lo
        return lo, hi, lo + p.S - p.NSB

    def _process_batch_tiered(self, keys: np.ndarray, values, ts: np.ndarray) -> None:
        tier = self.tier
        s_abs = np.asarray(self.pipe._slice_of(ts))
        wm = self.norm.wm
        late = (s_abs < self.norm._min_live_slice(wm)
                if wm > MIN_WATERMARK else np.zeros(len(ts), bool))
        # an eviction reassigns dense ids: every buffered or in-flight step
        # (and its pending emissions, which map ids back to keys at resolve)
        # must land BEFORE the vocabulary moves; the check over-approximates,
        # so a flush can be spurious but never missed
        if tier.vocab.would_evict(keys):
            self.flush_all()
        vals = (np.asarray(values, np.float32)
                if self._needs_value and values is not None else None)
        routed = tier.route(keys, s_abs, vals, np.asarray(late, bool))
        if routed.demotions or routed.promotions:
            lo, hi, limit = self._tier_span()
            tier.apply_demotions(routed.demotions, lo, hi)
            span = tier.apply_promotions(routed.promotions, lo,
                                         None if limit is None else limit - 1, limit)
            if span is not None:
                # promoted rows are resident data the planner never saw as
                # steps: both frontier mirrors must account for them, or
                # windows covering only promoted slices never fire
                self.pipe.note_external_slices(*span)
                self.norm.note_slices(*span)
        tier.journal_vocab_ops()
        ids = routed.ids
        live_hot = (ids >= 0) & ~np.asarray(late, bool)
        if live_hot.any():
            tier.note_hot_cells(ids[live_hot].astype(np.int64), s_abs[live_hot])
        with section("flink.fused.normalize"):
            steps = self.norm.push(ids.astype(np.int32), vals, ts)
        self._push_steps(steps)
        self._maybe_dispatch()

    def process_raw_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        """Whole-graph fusion ingest: raw source columns, untouched by any
        host transform — the prologue runs on the device in the dispatch."""
        if len(timestamps) == 0:
            return
        with section("flink.fused.normalize"):
            steps = self.norm.push(values, None, np.asarray(timestamps, np.int64))
        self._push_steps(steps)
        self._maybe_dispatch()

    def process_watermark(self, watermark: int) -> None:
        if watermark <= self.current_watermark:
            return
        self.current_watermark = watermark
        with section("flink.fused.normalize"):
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
        slots too). Each step is stamped for its queue wait."""
        now = time.perf_counter_ns()
        for s in steps:
            s.t_push = now
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
        records = sum(len(s.ts) for s in group)
        if records:
            now = time.perf_counter_ns()
            add("flink.fused.queue_wait_ns",
                sum(len(s.ts) * (now - s.t_push) for s in group))
            add("flink.fused.queued_records", records)
        if self.prologue is not None:
            d = self.pipe.process_superbatch_raw(
                [(s.kid, s.ts, s.s_abs) for s in group], wms, defer=True)
        else:
            d = self.pipe.process_superbatch(
                [(s.kid, s.vals, s.ts) for s in group], wms, defer=True)
        if self._controller is not None:
            self._ladder_geoms.add(len(group))
        # the purge frontier as of THIS dispatch's staging: cold-tier rows
        # below it may go only after this dispatch's emissions have resolved
        # (they read the cold rows of the windows that just fired); the
        # records and launch time time the dispatch's stay in flight
        self._inflight.append((d, group[-1].wm, self.pipe.purged_to, records,
                               time.perf_counter_ns()))
        while len(self._inflight) > self._max_inflight:
            self._resolve_oldest()

    def _resolve_inflight(self) -> None:
        """Drain the whole in-flight ring (FIFO): every barrier that needs
        the operator quiescent (flush_all, and thus snapshot) lands here."""
        while self._inflight:
            self._resolve_oldest()

    # emission-latency plane: set by the runner; each fire is stamped where
    # its readback group has been waited on (never at enqueue or dispatch)
    emission_tracker = None

    def _resolve_oldest(self) -> None:
        d, wm, purged_to, records, t_launched = self._inflight.popleft()
        tracker = self.emission_tracker
        for fires in d.resolve_groups():
            with section("flink.fused.emit", count=False):
                for window, counts, fields in fires:
                    if tracker is not None:
                        w = window[1] if type(window) is tuple else window
                        tracker.record_fire(w.end)
                    self._emit(window, counts, fields)
        if records:
            add("flink.fused.inflight_ns", records * (time.perf_counter_ns() - t_launched))
            add("flink.fused.inflight_records", records)
        if wm > self.emitted_watermark:
            self.emitted_watermark = wm
        if self.tier is not None:
            self.tier.purge_below(purged_to)

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
        elif self.tier is not None:
            self._emit_tiered(window, counts, fields)
            return
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

    def _emit_tiered(self, window, counts, fields) -> None:
        """Row-mode emission merging both tiers: resident keys fire from the
        device rows, cold keys from the cold store. A key whose data is
        SPLIT across tiers for this window (a partial promotion left
        far-future rows cold) combines per the field scatter ops before
        extraction, so placement never changes a result. The combine runs
        on Python scalars (the float32 device value with the cold f64 one)
        and stores back into the float32 row, as the JAX package does, so
        rows agree to the last bit."""
        p = self.pipe
        j = (window.start - p.offset) // p.slide_ms
        slice_range = range(j * p.sl, j * p.sl + p.spw)
        counts = np.asarray(counts).astype(np.int64).copy()
        vals = {f.name: np.asarray(fields[f.name]).copy()
                for f in self.agg.fields if f.source != ONE}
        cold = self.tier.cold_fire(slice_range)
        combine = {"add": lambda a, b: a + b, "min": min, "max": max}
        extras: List[tuple] = []   # (key, count, {field: value}): cold-only keys
        if cold is not None:
            ckids, cfields, ccounts = cold
            vocab = self.tier.vocab
            for i, cid in enumerate(ckids):
                key = vocab.key_of_cold_id(int(cid))
                hid = None if key is None else vocab.resident_id(key)
                if hid is not None:
                    counts[hid] += int(ccounts[i])
                    for f in self.agg.fields:
                        if f.source == ONE:
                            continue
                        vals[f.name][hid] = combine[f.scatter](
                            vals[f.name][hid].item(), cfields[f.name][i].item())
                elif key is not None:
                    extras.append((key, int(ccounts[i]),
                                   {n: cfields[n][i] for n in cfields}))
        ts = window.max_timestamp()
        live = np.flatnonzero(counts > 0)
        if live.size:
            fdict = {f.name: (counts if f.source == ONE else vals[f.name])
                     for f in self.agg.fields}
            result = np.asarray(self.agg.extract(fdict))
            vocab = self.tier.vocab
            for i in live:
                self.output.append((vocab.key_of_id(int(i)), window, result[i].item(), ts))
        if extras:
            e_counts = np.asarray([e[1] for e in extras], np.int64)
            fdict_e = {
                f.name: (e_counts if f.source == ONE
                         else np.asarray([e[2][f.name] for e in extras], np.dtype(f.dtype)))
                for f in self.agg.fields
            }
            result_e = np.asarray(self.agg.extract(fdict_e))
            for i, (key, _c, _f) in enumerate(extras):
                self.output.append((key, window, result_e[i].item(), ts))

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

    def query_state_for(self, key) -> Dict[int, Dict[str, Any]]:
        """Point lookup (queryable state): {abs_slice: {field..., count}} for
        one key, folding ring cells, buffered steps and held-back future
        records into one consistent view."""
        if self.prologue is not None:
            raise RuntimeError(
                "queryable state is unavailable on the fused chain path: "
                "buffered steps hold raw pre-transform columns, so a "
                "consistent per-key view would need the traced UDFs on host")
        if self.tier is not None:
            raise RuntimeError(
                "queryable state is unavailable on the tiered path: a key's "
                "cells may be split across the device ring and the cold "
                "store mid-movement; read the window emissions instead")
        kid = self.keydict.lookup(key)
        if kid is None:
            return {}
        pipe = self.pipe
        # the key's row of the canonical [K, S] view: the one-device rings'
        # column, or on the mesh its owner shard's local row (the JAX
        # package's contiguous-range reshape)
        counts, accs = pipe.gather_key_rows(np.asarray([kid]))
        count = counts[0]
        acc = {name: a[0] for name, a in accs.items()}
        slices: Dict[int, Dict[str, Any]] = {}
        lo = pipe.purged_to if pipe.purged_to is not None else pipe.min_used_slice
        hi = pipe.max_seen_slice
        if lo is not None and hi is not None:
            for s in range(lo, hi + 1):
                pos = s % pipe.S
                if count[pos] > 0:
                    entry = {name: arr[pos].item() for name, arr in acc.items()}
                    entry["count"] = int(count[pos])
                    slices[s] = entry
        combine = {"add": lambda a, b: a + b, "min": min, "max": max}
        pending = [(s.kid, s.vals, s.ts) for s in self._steps] + self.norm._future
        for kid_arr, val_arr, ts_arr in pending:
            sel = np.flatnonzero(np.asarray(kid_arr) == kid)
            for i in sel:
                s = int((int(ts_arr[i]) - pipe.offset) // pipe.g)
                entry = slices.setdefault(s, {"count": 0})
                entry["count"] = entry.get("count", 0) + 1
                for f in self.agg.fields:
                    if f.source != VALUE:
                        continue
                    v = float(val_arr[i]) if val_arr is not None else 1.0
                    entry[f.name] = combine[f.scatter](entry.get(f.name, f.identity), v)
        return slices

    # ------------------------------------------------------------------
    @property
    def num_late_records_dropped(self) -> int:
        return self.pipe.num_late_records_dropped

    # -- the device plane (metrics/device_stats.py, metrics/key_stats.py) --
    def attach_device_stats(self, tracker, phase_counters: bool = True) -> None:
        """Wire a CompileTracker around every superscan dispatch and turn
        K1's phase counters on. Call before the first batch: the phase flag
        is part of the program cache key."""
        self.pipe.attach_device_stats(tracker, phase_counters=phase_counters)

    def phase_totals(self) -> Dict[str, int]:
        """Cumulative phase counters of the resolved dispatches: records
        ingested, fire slots executed, steps that purged."""
        t = self.pipe.phase_totals
        return {"ingestRecords": int(t[0]), "fireSteps": int(t[1]),
                "purgeSteps": int(t[2])}

    def key_loads(self):
        """Device-resident per-key record counts ([K] int32) for the
        key-statistics fold."""
        return self.pipe.key_loads()

    def per_device_key_loads(self):
        """[n, K_local] per-shard local loads on the mesh (None on one
        device): the per-device skew fold's input."""
        fn = getattr(self.pipe, "per_device_key_loads", None)
        return fn() if fn is not None else None

    def key_stats_ready(self) -> bool:
        """O(1) host probe: has a dispatch landed data in the device rings
        yet? (Steps buffer on the host until the first dispatch.)"""
        return self.pipe.max_seen_slice is not None

    def state_row_bytes(self) -> int:
        return self.pipe.state_row_bytes()

    def mesh_devices(self) -> int:
        """Shards this operator's state is spread over (1 = one device)."""
        return int(getattr(self.pipe, "n", 1))

    # -- the key-group routing table (parallel.mesh.skew-rebalance) -------
    def routing_version(self) -> Optional[int]:
        """Version of the mesh routing table (None off the mesh or with
        static routing)."""
        fn = getattr(self.pipe, "routing_version", None)
        return fn() if callable(fn) else None

    def routing_payload(self) -> Optional[dict]:
        """The /jobs/:id/device routing block (None without a table)."""
        fn = getattr(self.pipe, "routing_payload", None)
        return fn() if callable(fn) else None

    def mesh_group_loads(self):
        """Per-key-group resident loads [G], the rebalancer's decision
        input; None without a routing table."""
        fn = getattr(self.pipe, "mesh_group_loads", None)
        return fn() if callable(fn) else None

    def set_routing_assignment(self, assign) -> int:
        """Apply a new key-group -> shard map at an operator-quiescent
        point: every in-flight dispatch resolves FIRST (its fire rows were
        produced under the old table and must come back to key order under
        it; on the card that waits on its pending host copies), then the
        table swaps and the rows re-lay. Exactly-once by construction:
        canonical state and cursors never change."""
        self._resolve_inflight()
        return self.pipe.set_routing_assignment(assign)

    def mesh_capacity(self) -> int:
        """The key capacity the mesh clamp used at construction: a rescale
        target is clamped against this, not the grown pipe.K (a rebuilt
        operator starts from this capacity again)."""
        return int(self._construction_key_capacity)

    def state_bytes(self) -> int:
        """Device bytes of the slice rings (0 until the pipeline's first
        dispatch materializes them)."""
        def nbytes(a) -> int:
            # a ring, or on the mesh one ring a shard
            if isinstance(a, list):
                return sum(nbytes(x) for x in a)
            return int(getattr(a, "nbytes", 0) or 0)

        state = getattr(self.pipe, "_state", None) or {}
        return sum(nbytes(a) for a in state.values()) + nbytes(getattr(self.pipe, "_count", None))

    def state_key_count(self) -> int:
        """Distinct keys the operator holds state for: the vocabulary's
        size (resident and cold) when tiered, else the key dictionary's."""
        if self.tier is not None:
            return self.tier.vocab.vocab_size
        return len(self.keydict)

    def tier_gauges(self):
        """The tier gauge family (vocabSize, residentKeys, evictions,
        promotions, spilledBytes, changelogBytes, tierHotFillRatio), or None
        when tiering is off; the runner registers them on the operator's
        metric group."""
        return None if self.tier is None else self.tier.gauges()

    def tier_payload(self):
        """The tier block of a job's device report (None when tiering is
        off)."""
        return None if self.tier is None else self.tier.payload()

    def latency_gauges(self):
        """The latency-mode controller's gauges, or None when the mode is
        off; the runner registers them on the operator's metric group."""
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
    def _pack_output(self):
        """Undrained emissions ride every tiered checkpoint; scalar numeric
        rows pack columnar (smaller pickled than a list of (key,
        TimeWindow, value, ts) tuples). Other rows stay a list."""
        rows = self.output
        if rows and all(isinstance(r[1], TimeWindow) and np.isscalar(r[2]) for r in rows):
            return {
                "packed": True,
                "keys": [r[0] for r in rows],
                "starts": np.asarray([r[1].start for r in rows], np.int64),
                "ends": np.asarray([r[1].end for r in rows], np.int64),
                "vals": np.asarray([r[2] for r in rows]),
                "ts": np.asarray([r[3] for r in rows], np.int64),
            }
        return {"packed": False, "rows": list(rows)}

    @staticmethod
    def _unpack_output(packed) -> list:
        if not packed.get("packed"):
            return [_own_row(r) for r in packed["rows"]]
        return [(k, TimeWindow(int(s), int(e)), v.item(), int(t))
                for k, s, e, v, t in zip(packed["keys"], packed["starts"], packed["ends"],
                                         packed["vals"], packed["ts"])]

    def _tier_meta(self) -> dict:
        """The stream position and operator state that ride every tiered
        checkpoint (full or incremental): what restore_changelog overlays
        on the reconstructed arrays."""
        p = self.pipe
        return {
            "watermark": p.watermark,
            "fire_cursor": p.fire_cursor,
            "purged_to": p.purged_to,
            "min_used_slice": p.min_used_slice,
            "max_seen_slice": p.max_seen_slice,
            "num_late_dropped": p.num_late_records_dropped,
            "norm": self.norm.snapshot(),
        }

    def _envelope(self) -> dict:
        """The transient operator surface that rides the checkpoint
        envelope, not the state changelog: resolved-but-undrained emissions
        are output, not keyed state."""
        return {
            "output": self._pack_output(),
            "emitted_watermark": self.emitted_watermark,
            "current_watermark": self.current_watermark,
        }

    def _apply_tier_meta(self, meta: dict, envelope: dict) -> None:
        self.norm.restore(meta["norm"])
        self._steps = []
        self._reset_dispatch_ring()
        self.output = self._unpack_output(envelope["output"])
        self.emitted_watermark = envelope["emitted_watermark"]
        self.current_watermark = envelope["current_watermark"]

    def snapshot(self) -> dict:
        """The JAX operator's snapshot form: buffered steps are flushed
        first so keyed state lives in one place (the rings, and the cold
        tier when tiered); fires this triggers land in "output" and ride
        the snapshot. A tiered operator's snapshot is full ("tier") or,
        with its changelog on, an incremental (base, offset) handle
        ("tier_changelog")."""
        self.flush_all()
        if self.tier is not None:
            meta = self._tier_meta()
            if self.tier.log is not None:
                return {"tier_changelog": self.tier.checkpoint(
                    meta, self.pipe.gather_cells, self.pipe.snapshot),
                    **self._envelope()}
            return {"pipe": self.pipe.snapshot(), "tier": self.tier.full_snapshot(),
                    "meta": meta, **self._envelope()}
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
        """Restore a snapshot of either package's operator. Tiered and
        classic snapshots restore only into an operator of their kind."""
        if "tier_changelog" in snap:
            if self.tier is None:
                raise RuntimeError(
                    "this checkpoint is an incremental (changelog) tiered "
                    "snapshot; the restoring operator has state.tier disabled")
            out = self.tier.restore_changelog(snap["tier_changelog"])
            self.pipe.restore(out["pipe"])
            self._apply_tier_meta(out["meta"], snap)
            return
        if "tier" in snap:
            if self.tier is None:
                raise RuntimeError(
                    "this checkpoint is a tiered snapshot; the restoring "
                    "operator has state.tier disabled")
            self.pipe.restore(snap["pipe"])
            self.tier.restore_full(snap["tier"])
            self._apply_tier_meta(snap["meta"], snap)
            return
        if self.tier is not None:
            # a classic (grow-only key dictionary) snapshot in a tiered
            # operator would route new keys through an EMPTY vocabulary
            # whose recycled dense ids alias the restored rows' old keys
            raise RuntimeError(
                "this checkpoint is a classic (untired) snapshot; the "
                "restoring operator has state.tier enabled — restore it "
                "with tiering off, or take a fresh tiered checkpoint")
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
