"""FusedWindowPipeline: whole-stream windowed aggregation, T steps per dispatch.

Counterpart of `flink_tpu/runtime/fused_window_pipeline.py` (the keyed,
shared-partial and global pipelines; see ROADMAP.md for the parts still to
port). Every
per-step control decision (ring column, fire slots, purge mask) is planned
on the host from the watermark schedule; the device runs the whole T-step
dispatch — on CUDA as kernel K1 (keyed) or K2 (global), on the CPU as their
plain PyTorch versions — and the fired rows come back in one copy per
dispatch.

With a `TracedPrologue` (whole-graph fusion, graph/fusion.py) a dispatch
takes the RAW source columns of its T steps instead of key ids: the
chain's map/filter/map_ts UDFs and the key/value extraction run as torch
code on the device over the flattened `[T*B, ...]` staging buffer, and
build the `idx`/`vals` that K1 (or its plain version) ingests.

Semantics preserved (parity-tested against the JAX package):
- slice-decomposed window assignment (TimeWindow.getWindowStartWithOffset),
- EventTimeTrigger firing: window j fires when wm >= end(j)-1, in j order,
  after the batch that advanced the watermark was ingested,
- fire-then-purge ordering at the same watermark,
- too-late records (newest containing window already cleaned) dropped and
  counted, matching isWindowLate.

State is slice-major, `[S, K]`, on every device (the plain version shares
the kernel's layout), so the JAX package's backend layout switches reduce
to the `[K, S]` conversion in `snapshot`/`restore`, whose dicts match the
JAX pipeline's keys, shapes and dtypes in both directions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.api.windowing.assigners import WindowAssigner
from flink_tpu_torch.core.time import MIN_WATERMARK, TimeWindow
from flink_tpu_torch.ops import cuda_superscan as cs
from flink_tpu_torch.ops.aggregators import VALUE, resolve, scan_identity, torch_dtype
from flink_tpu_torch.utils import deferred
from flink_tpu_torch.utils.arrays import canonical_column, canonical_dtype
from flink_tpu_torch.utils.device import HostCopy, resolve_device, staging_buffer, upload


def _ceil_div(a: int, b: int) -> int:
    return -((-a) // b)


@dataclasses.dataclass(frozen=True)
class TracedPrologue:
    """The traced pre-stage of a fused device chain: chain transforms
    applied to the raw value column on the device, then key/value
    extraction. Every callable is a pure function of torch tensor columns
    (row-local: map and filter see each row alone); `key_fn` must return
    non-negative int keys below the pipeline's key capacity (checked over
    every surviving record and raised at resolve — an out-of-range key
    never aliases another key's row and is never dropped)."""

    transforms: Tuple[Tuple[str, Any], ...]   # ('map'|'filter'|'map_ts', fn)
    key_fn: Any
    value_fn: Optional[Any] = None            # None: the column IS the value

    @property
    def needs_ts(self) -> bool:
        return any(kind == "map_ts" for kind, _fn in self.transforms)


@dataclasses.dataclass
class _PlannedFire:
    row: int          # output-buffer row
    j: int            # window index
    step: int         # step within the dispatch
    spec: int = 0     # window spec (shared-partial pipelines; 0 otherwise)


class DeferredEmissions:
    """Handle for fires of one dispatch; the device->host copy runs async.

    On CUDA the fire rows are copied with non_blocking=True into pinned
    host memory as soon as the dispatch is enqueued; a CUDA event recorded
    after the copies orders them, and `resolve` waits on that event only.
    A traced-chain dispatch also carries the [max, min] of the keys its
    surviving records produced; resolve raises if they leave [0, K)."""

    def __init__(self, pipe: "FusedWindowPipeline", fires, count_out, outs,
                 key_bounds=None, key_capacity: Optional[int] = None,
                 copy_stream=None):
        self._pipe = pipe
        self._fires = fires
        self._key_capacity = key_capacity
        self._names = list(outs)
        self._copy = HostCopy([count_out, key_bounds, *outs.values()], stream=copy_stream)

    def resolve(self):
        count_out, key_bounds, *outs = self._copy.wait()
        if key_bounds is not None:
            hi, lo = (int(v) for v in key_bounds.tolist())
            if hi >= self._key_capacity or lo < 0:
                raise ValueError(
                    f"traced key selector produced keys in [{lo}, {hi}] "
                    f"outside [0, {self._key_capacity}): the fused device "
                    "chain uses dense integer keys and cannot grow capacity "
                    "mid-dispatch. Raise 'execution.state.key-capacity' "
                    "above the largest key the selector can emit (and keep "
                    "keys non-negative), or drop traceable=True on key_by "
                    "to use the host key dictionary."
                )
        count_np = count_out.numpy()
        outs_np = {k: v.numpy() for k, v in zip(self._names, outs)}
        return [
            (
                self._pipe._window_of_fire(pf),
                count_np[pf.row],
                {k: v[pf.row] for k, v in outs_np.items()},
            )
            for pf in self._fires
        ]


class _StreamedEmissions:
    """The handle of a dispatch run as readback groups (latency mode): one
    DeferredEmissions per group of `readback_steps` steps, each of which
    started its device->host copy right after its group's launch, so fires
    of early groups reach the host while later groups still compute.
    resolve() joins the groups' rows in group order: the whole-span
    dispatch's rows, order and payloads."""

    def __init__(self, parts: List[DeferredEmissions]):
        self._parts = parts

    def resolve(self):
        out = []
        for p in self._parts:
            out.extend(p.resolve())
        return out


class _PlanCursor:
    """The fire/purge planning state machine for one dispatch.

    Both stage_superbatch (data-driven) and plan_superbatch (bounds-driven)
    drive this cursor; the plans they produce must be bit-identical for
    identical streams, so the per-step logic lives only here.
    """

    def __init__(self, pipe: "FusedWindowPipeline"):
        self.p = pipe
        self.wm = pipe.watermark
        self.fire_cursor = pipe.fire_cursor
        self.purged_to = pipe.purged_to
        self.min_used = pipe.min_used_slice
        self.max_seen = pipe.max_seen_slice

    def observe(self, smin: int, smax: int) -> None:
        """Account for a step whose live records occupy slices [smin, smax]."""
        p = self.p
        if smax - smin >= p.NSB:
            raise ValueError(
                f"batch spans {smax - smin + 1} slices > nsb={p.NSB}; "
                "raise nsb or shrink batches"
            )
        if self.purged_to is not None and smin < self.purged_to:
            raise AssertionError("late-drop check should bound smin")
        if self.max_seen is not None and self.max_seen - smin >= p.S:
            # the resident span must fit the ring: past-direction space
            # never reopens (the purge frontier moves forward)
            raise ValueError(
                f"slice ring too small for this skew: batch slice "
                f"{smin} is {self.max_seen - smin} slices below the "
                f"newest resident slice {self.max_seen}, but the ring "
                f"holds only num_slices={p.S}. Raise "
                f"'execution.window.num-slices' above the expected "
                f"pre-watermark timestamp skew (in slices), or "
                f"advance the watermark sooner so old slices purge."
            )
        self.min_used = smin if self.min_used is None else min(self.min_used, smin)
        self.max_seen = smax if self.max_seen is None else max(self.max_seen, smax)
        self._note_fire_candidate(smin)

    def _note_fire_candidate(self, smin: int) -> None:
        p = self.p
        cand = p._j_oldest(smin)
        if self.wm > MIN_WATERMARK:
            cand = max(cand, p._j_fired_upto(self.wm) + 1)
        self.fire_cursor = cand if self.fire_cursor is None else min(self.fire_cursor, cand)

    def advance(self, t: int, new_wm: int, fire_pos, fire_valid, fire_row,
                purge_mask, fires: list) -> None:
        """Watermark advance after step t: plan fires (window order) + purge."""
        p = self.p
        if new_wm <= self.wm:
            return
        self._plan_fires(t, new_wm, fire_pos, fire_valid, fire_row, fires)
        # purge columns whose slices expired
        new_min_live = p._min_live_slice(new_wm)
        if self.min_used is not None:
            lo = self.min_used if self.purged_to is None else max(self.purged_to, self.min_used)
            hi_p = min(new_min_live, self.max_seen + 1)
            if hi_p - lo >= p.S:
                purge_mask[t, :] = 0
            elif hi_p > lo:
                dead = (np.arange(lo, hi_p) % p.S).astype(np.int64)
                purge_mask[t, dead] = 0
        self.purged_to = new_min_live if self.purged_to is None else max(self.purged_to, new_min_live)
        self.wm = new_wm

    def _plan_fires(self, t: int, new_wm: int, fire_pos, fire_valid,
                    fire_row, fires: list) -> None:
        p = self.p
        if self.fire_cursor is not None and self.max_seen is not None:
            hi = min(p._j_fired_upto(new_wm), p._j_newest(self.max_seen))
            slot = 0
            for j in range(self.fire_cursor, hi + 1):
                if slot >= p.F:
                    raise ValueError(
                        f"{hi + 1 - self.fire_cursor} windows fire in one step "
                        f"> fires_per_step={p.F}"
                    )
                if len(fires) >= p.R:
                    raise ValueError(f"more than out_rows={p.R} fires per dispatch")
                row = len(fires)
                fires.append(_PlannedFire(row, j, t))
                fire_pos[t, slot] = (j * p.sl) % p.S
                fire_valid[t, slot] = 1
                fire_row[t, slot] = row
                slot += 1
            if p._j_fired_upto(new_wm) >= self.fire_cursor:
                self.fire_cursor = p._j_fired_upto(new_wm) + 1

    def commit(self) -> None:
        p = self.p
        p.watermark = self.wm
        p.fire_cursor = self.fire_cursor
        p.purged_to = self.purged_to
        p.min_used_slice = self.min_used
        p.max_seen_slice = self.max_seen


class FusedWindowPipeline:
    """One shard's keyed window aggregation, executed T steps per dispatch.

    `device=None` runs on `cuda` and raises when there is no GPU; pass
    `device="cpu"` for the plain PyTorch path. `chunk` is the staging
    granule: `stage_superbatch` pads the batch width up to a multiple of it
    (with dropped records) so dispatch shapes stay stable; the kernels take
    any width. With `prologue` the pipeline takes raw source columns
    (`process_superbatch_raw`)."""

    def __init__(
        self,
        assigner: WindowAssigner,
        aggregate,
        *,
        key_capacity: int,
        num_slices: Optional[int] = None,
        nsb: int = 4,                 # max distinct slices touched per batch
        fires_per_step: int = 2,
        out_rows: int = 64,           # max fires per dispatch
        chunk: int = 8192,
        exact_sums: bool = True,
        plan_only: bool = False,      # host planner/cursors only, no device state
        prologue: Optional[TracedPrologue] = None,
        device=None,
    ):
        agg = resolve(aggregate)
        if agg is None:
            raise ValueError(f"aggregate {aggregate!r} has no device form")
        for f in agg.fields:
            if f.scatter not in ("add", "min", "max"):
                raise ValueError(
                    f"fused pipeline supports add/min/max-combining fields; "
                    f"{f.name!r} uses {f.scatter!r}"
                )
        if assigner.slice_ms is None or not assigner.is_event_time:
            raise ValueError(f"{assigner!r} is not a sliceable event-time assigner")
        self.device = resolve_device(device)
        self.agg = agg
        self.K = key_capacity
        self.NSB = nsb
        self.F = fires_per_step
        self.R = out_rows
        self.chunk = chunk
        self.exact_sums = exact_sums
        self.prologue = prologue
        # traced chain: the raw column layout, fixed by the first data
        self._raw_shape: Optional[tuple] = None
        self._raw_dtype = None
        # latency mode (scheduler/latency_controller.py), set by the
        # operator when execution.latency.target-ms is on: readback_steps >
        # 0 runs a T-step dispatch as T/readback_steps K1 launches whose
        # fired rows each start their copy as soon as they are launched.
        # donate_carry is kept for the JAX package's flag (it donates the
        # [K, S] carry to its executable); K1 and its plain version update
        # the rings in place, so there is no carry copy to donate here.
        self.donate_carry = False
        self.readback_steps = 0
        self._copy_stream = None      # the readback groups' side stream
        # window length (slices) of each fire slot; None: every slot folds
        # spw (a shared-partial pipeline sets its members' lengths)
        self._fire_spws: Optional[Tuple[int, ...]] = None

        self.g = assigner.slice_ms
        self.sl = assigner.slide_slices
        self.spw = assigner.slices_per_window
        self.offset = assigner.offset_ms
        self.size_ms = self.spw * self.g
        self.slide_ms = self.sl * self.g
        if num_slices is None:
            num_slices = 1 << (self.spw + nsb + 8 - 1).bit_length()
        self.S = num_slices

        self._value_fields = [f for f in agg.fields if f.source == VALUE]
        self._needs_vals = bool(self._value_fields)

        self.plan_only = plan_only
        if plan_only:
            # pure host planner (the global pipeline's control plane)
            self._state = {}
            self._count = None
        else:
            self._state = {
                f.name: torch.full((self.S, self.K), f.device_identity,
                                   dtype=torch_dtype(f.dtype), device=self.device)
                for f in self._value_fields
            }
            self._count = torch.zeros((self.S, self.K), dtype=torch.int32,
                                      device=self.device)

        # host-side stream position
        self.watermark = MIN_WATERMARK
        self.fire_cursor: Optional[int] = None
        self.purged_to: Optional[int] = None
        self.min_used_slice: Optional[int] = None
        self.max_seen_slice: Optional[int] = None
        self.num_late_records_dropped = 0

    def _require_state(self) -> None:
        if self.plan_only:
            raise RuntimeError(
                "this FusedWindowPipeline is plan_only (host planner); it "
                "has no device state to dispatch/snapshot/restore/grow"
            )

    def ensure_key_capacity(self, required: int) -> None:
        """Grow the key dimension (next pow2) when the dictionary outgrows K;
        existing rows keep their accumulators, new rows start at identity."""
        if required <= self.K:
            return
        self._require_state()
        new_k = 1 << (required - 1).bit_length()
        pad = new_k - self.K
        self._state = {
            f.name: torch.cat(
                [self._state[f.name],
                 torch.full((self.S, pad), f.device_identity, dtype=torch_dtype(f.dtype),
                            device=self.device)], dim=1)
            for f in self._value_fields
        }
        self._count = torch.cat(
            [self._count, torch.zeros((self.S, pad), dtype=torch.int32,
                                      device=self.device)], dim=1)
        self.K = new_k

    def attach_device_stats(self, tracker, phase_counters: bool = True) -> None:
        raise deferred.not_ported("attach_device_stats", deferred.D4)

    # ------------------------------------------------------------------
    # window geometry (identical formulas to the JAX pipeline)
    # ------------------------------------------------------------------
    def _slice_of(self, ts: np.ndarray) -> np.ndarray:
        return (ts - np.int64(self.offset)) // np.int64(self.g)

    def _j_fired_upto(self, wm: int) -> int:
        return (wm + 1 - self.offset - self.size_ms) // self.slide_ms

    def _min_live_slice(self, wm: int) -> int:
        return (self._j_fired_upto(wm) + 1) * self.sl

    def _j_newest(self, s: int) -> int:
        return s // self.sl

    def _j_oldest(self, s: int) -> int:
        return _ceil_div(s - self.spw + 1, self.sl)

    def _window_of(self, j: int) -> TimeWindow:
        start = self.offset + j * self.slide_ms
        return TimeWindow(start, start + self.size_ms)

    def _window_of_fire(self, pf: _PlannedFire) -> TimeWindow:
        return self._window_of(pf.j)

    def _wm_keeping_slice_live(self, s: int) -> int:
        """Largest watermark at which slice `s` has not been purged."""
        return self.offset + (s // self.sl) * self.slide_ms + self.size_ms - 1 - 1

    def _cursor(self) -> _PlanCursor:
        return _PlanCursor(self)

    def slot_spws(self) -> Tuple[int, ...]:
        """The window length in slices that each fire slot folds: K1's
        `spws`."""
        return self._fire_spws or (self.spw,) * self.F

    def key_loads(self) -> Optional[torch.Tensor]:
        """Device-resident per-key record counts ([K] int32) over the ring;
        None on a plan-only planner."""
        if self._count is None:
            return None
        return self._count.sum(dim=0, dtype=torch.int32)

    def state_row_bytes(self) -> int:
        """Device bytes per key row (all slice cells of one key across count
        + value fields)."""
        n = 4 * self.S  # int32 count ring
        for f in self._value_fields:
            n += f.device_dtype.itemsize * self.S
        return n

    # ------------------------------------------------------------------
    # host planner + dispatch
    # ------------------------------------------------------------------
    def _plan_arrays(self, T: int):
        return (np.zeros(T, dtype=np.int32),
                np.zeros((T, self.F), dtype=np.int32),
                np.zeros((T, self.F), dtype=np.int32),
                np.zeros((T, self.F), dtype=np.int32),
                np.ones((T, self.S), dtype=np.int32))

    def _to_device_plan(self, arrays, fires) -> tuple:
        """One host->device copy for the whole plan, split into views."""
        flat_h, flat_t = staging_buffer((sum(a.size for a in arrays),), np.int32, self.device)
        np.concatenate([a.reshape(-1) for a in arrays], out=flat_h)
        flat = upload(flat_t, self.device)
        out, off = [], 0
        for a in arrays:
            out.append(flat[off:off + a.size].view(a.shape))
            off += a.size
        return tuple(out) + (fires,)

    def process_superbatch(
        self,
        batches: Optional[Sequence[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]],
        watermarks: Optional[Sequence[int]],
        *,
        staged: Optional[tuple] = None,
        defer: bool = False,
    ):
        """Run T = len(batches) steps in one dispatch.

        batches: (key_ids int32[B], values f32[B] | None, timestamps int64[B]);
        watermarks[i] is the watermark after batch i. Returns one
        (window, count_row[K], {field: row[K]}) per fired window, in fire
        order; row entries for keys with count 0 are meaningless.

        staged=(idx [T*B] int32, vals [T*B] float32 | None, plan) runs a
        dispatch staged by `stage_superbatch` or by the caller (with
        `plan_superbatch`). defer=True returns a DeferredEmissions handle
        right after enqueuing the dispatch and its async readback; the next
        dispatch may be enqueued before resolving (state stays on device).
        """
        self._require_state()
        if staged is not None:
            idx_d, vals_d, plan = staged
        else:
            idx_d, vals_d, plan = self.stage_superbatch(batches, watermarks)
        T = int(plan[0].shape[0])
        if watermarks is not None and T != len(watermarks):
            raise ValueError(f"{len(watermarks)} watermarks for {T} steps")
        if self._grouped(T):
            d = self._process_grouped(T, idx_d, vals_d, plan)
        else:
            d = self._dispatch(idx_d, vals_d, plan)
        return d if defer else d.resolve()

    def _grouped(self, T: int) -> bool:
        """Whether a T-step dispatch runs as readback groups: latency mode
        splits it when readback_steps divides it (the ladder's pow2 rungs
        do); other depths run whole."""
        Tg = self.readback_steps
        return 0 < Tg < T and T % Tg == 0

    def _dispatch(self, idx_d, vals_d, plan, key_bounds=None, rows=None,
                  copy_stream=None) -> DeferredEmissions:
        """Run one staged dispatch and start its readback. `rows`: fire
        rows to allocate (a readback group's; None: R, read back up to the
        multiple of 16 the fires need)."""
        fires = plan[5]
        names = [f.name for f in self._value_fields]
        # K1 for CUDA state, its plain version for CPU state; what K1
        # refuses raises NotImplementedError there
        count_out, field_outs = cs.keyed_superscan(
            self.agg, self._count, [self._state[n] for n in names],
            idx_d.reshape(-1), vals_d.reshape(-1) if self._needs_vals else None,
            plan[:5], NSB=self.NSB, R=self.R if rows is None else rows,
            spws=self.slot_spws(), exact=self.exact_sums)
        outs = dict(zip(names, field_outs))

        # read back only the rows actually fired (padded to a multiple of 16
        # so readback shapes stay few)
        used = -(-max(len(fires), 1) // 16) * 16
        if rows is None and used < self.R:
            count_out = count_out[:used]
            outs = {k: v[:used] for k, v in outs.items()}
        return DeferredEmissions(self, fires, count_out, outs, key_bounds=key_bounds,
                                 key_capacity=self.K, copy_stream=copy_stream)

    def _process_grouped(self, T, idx_d, vals_d, plan, raw=None) -> _StreamedEmissions:
        """Streamed fire readback (latency mode): one T-step dispatch as G
        = T / readback_steps K1 launches over consecutive step groups, the
        rings carried in place from one to the next. Fire rows keep the
        span's global row numbers, so group g allocates the rows up to the
        fires of groups 0..g (a multiple of 16, at most R: the rows the
        whole-span dispatch reads back by then) and its fires index them
        as they would the span's; resolving the groups in order gives the
        whole-span rows byte for byte. On CUDA each group's copy runs on a
        side stream after the group's launch, so the next group's launch
        does not wait behind it. K1 splits a group further into step
        groups of its own where the step partials outgrow its budget
        (ops/cuda_superscan.step_groups); those nest inside.

        raw: the traced-chain form, (raw [T*B, ...], srel [T*B], ts | None):
        each group runs the prologue over its own rows first (so each
        group's key bounds cover its surviving records), then K1."""
        Tg = self.readback_steps
        fires = plan[5]
        if raw is None:
            B = idx_d.numel() // T
        else:
            B = raw[1].numel() // T
        stream = None
        if self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            stream = self._copy_stream
        parts: List[DeferredEmissions] = []
        done = 0
        for lo in range(0, T, Tg):
            hi = lo + Tg
            g_fires = [pf for pf in fires if lo <= pf.step < hi]
            done += len(g_fires)
            rows = min(self.R, -(-max(done, 1) // 16) * 16)
            g_plan = tuple(p[lo:hi] for p in plan[:5]) + (g_fires,)
            key_bounds = None
            if raw is None:
                g_idx = idx_d.reshape(-1)[lo * B:hi * B]
                g_vals = vals_d.reshape(-1)[lo * B:hi * B] if self._needs_vals else None
            else:
                raw_d, srel_d, ts_d = raw
                g_idx, g_vals, key_bounds = self._run_prologue(
                    raw_d[lo * B:hi * B], srel_d[lo * B:hi * B],
                    None if ts_d is None else ts_d[lo * B:hi * B])
            parts.append(self._dispatch(g_idx, g_vals, g_plan, key_bounds=key_bounds,
                                        rows=rows, copy_stream=stream))
        return _StreamedEmissions(parts)

    def stage_superbatch(self, batches, watermarks):
        """Host planning + device staging for one dispatch (separable so
        callers can overlap staging of superbatch i+1 with running i)."""
        T = len(batches)
        B = max(max((len(b[2]) for b in batches), default=0), 1)
        B = -(-B // self.chunk) * self.chunk

        idx_h, idx_t = staging_buffer((T, B), np.int32, self.device)
        idx_h.fill(-1)
        vals_h = vals_t = None
        if self._needs_vals:
            vals_h, vals_t = staging_buffer((T, B), np.float32, self.device)
            vals_h.fill(0.0)
        arrays = self._plan_arrays(T)
        smin_pos, fire_pos, fire_valid, fire_row, purge_mask = arrays
        fires: List[_PlannedFire] = []

        cur = self._cursor()
        for t, (kid, vals, ts) in enumerate(batches):
            n = len(ts)
            s_abs = self._slice_of(np.asarray(ts, dtype=np.int64))
            keep = np.ones(n, dtype=bool)
            if cur.wm > MIN_WATERMARK:
                keep = s_abs >= self._min_live_slice(cur.wm)
                self.num_late_records_dropped += int(n - keep.sum())
            if keep.any():
                live = s_abs[keep]
                smin = int(live.min())
                cur.observe(smin, int(live.max()))
                srel = (s_abs - smin).astype(np.int32)
                # kid -1 = a cold-routed record: it rides the step so fires
                # over its slices get planned, but never scatters
                kid64 = np.asarray(kid, dtype=np.int64)
                idx_h[t, :n] = np.where(
                    keep & (kid64 >= 0), kid64 * self.NSB + srel, -1
                ).astype(np.int32)
                if vals is not None and self._needs_vals:
                    vals_h[t, :n] = np.where(keep, vals, 0.0)
                smin_pos[t] = smin % self.S
            cur.advance(t, watermarks[t], fire_pos, fire_valid, fire_row,
                        purge_mask, fires)
        cur.commit()

        idx_d = upload(idx_t.view(-1), self.device)
        vals_d = upload(vals_t.view(-1), self.device) if self._needs_vals else None
        return idx_d, vals_d, self._to_device_plan(arrays, fires)

    def plan_superbatch(self, slice_bounds, watermarks):
        """Host planning from per-step slice BOUNDS only — for callers that
        stage the record stream themselves (e.g. an on-device generator that
        writes `idx = key_id * NSB + (slice - smin)` straight into device
        memory).

        slice_bounds: [(smin_abs, smax_abs)] per step — inclusive bounds on
        the absolute slices the step's records can occupy. The caller must
        guarantee no record falls outside its step's bounds and no record is
        late (bounds below the live frontier raise here).

        Returns (plan, smin_abs[int32 T]); pass `staged=(idx, vals, plan)`
        to process_superbatch.
        """
        T = len(slice_bounds)
        if T != len(watermarks):
            raise ValueError(f"{len(watermarks)} watermarks for {T} steps")
        arrays = self._plan_arrays(T)
        smin_pos, fire_pos, fire_valid, fire_row, purge_mask = arrays
        smin_abs = np.zeros(T, dtype=np.int32)
        fires: List[_PlannedFire] = []

        cur = self._cursor()
        for t, (smin, smax) in enumerate(slice_bounds):
            if cur.wm > MIN_WATERMARK and smin < self._min_live_slice(cur.wm):
                raise ValueError(
                    "plan_superbatch requires a late-free schedule: step "
                    f"{t} smin={smin} is below the live frontier "
                    f"{self._min_live_slice(cur.wm)}"
                )
            cur.observe(smin, smax)
            smin_pos[t] = smin % self.S
            smin_abs[t] = smin
            cur.advance(t, watermarks[t], fire_pos, fire_valid, fire_row,
                        purge_mask, fires)
        cur.commit()
        return self._to_device_plan(arrays, fires), smin_abs

    # ------------------------------------------------------------------
    # traced-chain path (whole-graph fusion): raw source columns go to the
    # device; filter, projection and key/value extraction run there
    # ------------------------------------------------------------------
    def stage_superbatch_raw(self, steps, watermarks):
        """Host planning + device staging for one traced-chain dispatch.

        steps: [(raw_column [n, ...], timestamps int64 [n][, slice_ids])] —
        raw source values before any chain transform (slice_ids optional:
        the normalizer's precomputed `_slice_of(ts)`). Fires and purges are
        planned from the timestamps alone (the chain never changes them, and
        a filter only removes records, so the slice bounds stay valid;
        windows planned over filtered-out slices fire empty rows, which
        emission drops). Late records are staged as srel -1 (and counted),
        so the prologue never sees them as live.

        Returns (raw [T*B, ...], srel [T*B] int32, ts [T*B] int32 | None,
        plan) on the pipeline's device."""
        raw_h, srel_h, ts_h, arrays, fires = self._stage_raw_host(steps, watermarks)
        raw_d, srel_d = upload(raw_h, self.device), upload(srel_h, self.device)
        ts_d = upload(ts_h, self.device) if ts_h is not None else None
        return raw_d, srel_d, ts_d, self._to_device_plan(arrays, fires)

    def _stage_raw_host(self, steps, watermarks):
        """The host half of stage_superbatch_raw: plan, and fill the staging
        buffers (tensors over pinned memory when the device is CUDA).
        Returns (raw_h, srel_h, ts_h | None, plan arrays, fires)."""
        if self.prologue is None:
            raise RuntimeError("stage_superbatch_raw requires a prologue")
        T = len(steps)
        if T != len(watermarks):
            raise ValueError(f"{len(watermarks)} watermarks for {T} steps")
        B = max(max((len(step[1]) for step in steps), default=0), 1)
        # width quantized to power-of-two multiples of the chunk: ragged and
        # watermark-only tails land on few shapes; pad rows are srel -1
        B = self.chunk * (1 << max(0, -(-B // self.chunk) - 1).bit_length())

        for raw, ts, *_rest in steps:
            if not len(ts):
                continue
            arr = np.asarray(raw)
            if self._raw_shape is None:
                if arr.dtype == object:
                    raise TypeError(
                        "the fused device chain needs numeric record "
                        "columns; this source yields Python objects — use a "
                        "columnar source (numeric ndarray batches) or drop "
                        "traceable=True to stay on the host chain"
                    )
                self._raw_shape, self._raw_dtype = arr.shape[1:], arr.dtype
            elif arr.shape[1:] != self._raw_shape or arr.dtype != self._raw_dtype:
                raise ValueError(
                    f"record column geometry changed mid-stream: "
                    f"{arr.dtype}{list(arr.shape[1:])} after "
                    f"{self._raw_dtype}{list(self._raw_shape)} — the fused "
                    "chain is shaped on a fixed column layout"
                )
        raw_shape, raw_dtype = self._raw_shape, self._raw_dtype
        if raw_shape is None:
            # all-empty superbatch before any data: a placeholder column for
            # this dispatch only (pinning it would turn the first real batch
            # into a geometry change)
            raw_shape, raw_dtype = (), np.dtype(np.float32)

        # uninitialized staging, in the canonical dtypes (float64→float32,
        # int64→int32) the JAX package stages: every prologue consumer masks
        # pad rows (srel -1) before they matter, and vals are zeroed there
        raw_h, raw_t = staging_buffer((T * B,) + raw_shape, canonical_dtype(raw_dtype),
                                      self.device)
        srel_h, srel_t = staging_buffer((T * B,), np.int32, self.device)
        srel_h.fill(-1)
        ts_h = ts_t = None
        if self.prologue.needs_ts:
            ts_h, ts_t = staging_buffer((T * B,), canonical_dtype(np.int64), self.device)
        arrays = self._plan_arrays(T)
        smin_pos, fire_pos, fire_valid, fire_row, purge_mask = arrays
        fires: List[_PlannedFire] = []

        cur = self._cursor()
        for t, step in enumerate(steps):
            raw, ts = step[0], step[1]
            pre_s_abs = step[2] if len(step) > 2 else None
            n = len(ts)
            if n:
                lo = t * B
                ts_arr = np.asarray(ts, dtype=np.int64)
                s_abs = pre_s_abs if pre_s_abs is not None else self._slice_of(ts_arr)
                keep = np.ones(n, dtype=bool)
                if cur.wm > MIN_WATERMARK:
                    keep = s_abs >= self._min_live_slice(cur.wm)
                    self.num_late_records_dropped += int(n - keep.sum())
                if keep.any():
                    live = s_abs[keep]
                    smin = int(live.min())
                    cur.observe(smin, int(live.max()))
                    srel_h[lo:lo + n] = np.where(keep, s_abs - smin, -1)
                    smin_pos[t] = smin % self.S
                # checked canonical cast: a column that does not survive the
                # narrowing raises (the host chain casts through the same
                # helper, so both routes compute on identical inputs)
                raw_h[lo:lo + n] = canonical_column(raw, "fused chain record column")
                if ts_h is not None:
                    info = np.iinfo(ts_h.dtype)
                    if int(ts_arr.max()) > info.max or int(ts_arr.min()) < info.min:
                        raise TypeError(
                            "traceable map_with_timestamp under the fused "
                            "chain stages timestamps in the canonical "
                            f"{ts_h.dtype} and these event timestamps do not "
                            "fit — they would silently wrap inside the UDF. "
                            "Rebase event time near zero, or drop "
                            "traceable=True to run the host chain."
                        )
                    ts_h[lo:lo + n] = ts_arr
            cur.advance(t, watermarks[t], fire_pos, fire_valid, fire_row,
                        purge_mask, fires)
        cur.commit()
        return raw_t, srel_t, ts_t, arrays, fires

    def process_superbatch_raw(self, steps, watermarks, *,
                               staged: Optional[tuple] = None,
                               defer: bool = False):
        """Run T traced-chain steps in one dispatch (the prologue-bearing
        sibling of process_superbatch; same defer contract). The prologue
        runs once over the flattened staging buffer on the device, then K1
        (its plain version for CPU state) ingests, fires and purges."""
        if staged is None and all(len(step[1]) == 0 for step in steps):
            # watermark-only dispatch: with zero rows the prologue is
            # irrelevant (and the record geometry may still be unknown, as
            # right after a restore), so fire/purge through the plain path
            empty = [(np.empty(0, np.int32), None, np.empty(0, np.int64)) for _ in steps]
            return self.process_superbatch(empty, watermarks, defer=defer)
        self._require_state()
        if staged is None:
            staged = self.stage_superbatch_raw(steps, watermarks)
        raw_d, srel_d, ts_d, plan = staged
        T = int(plan[0].shape[0])
        if self._grouped(T):
            d = self._process_grouped_raw(T, raw_d, srel_d, ts_d, plan)
        else:
            idx, vals, key_bounds = self._run_prologue(raw_d, srel_d, ts_d)
            d = self._dispatch(idx, vals, plan, key_bounds=key_bounds)
        return d if defer else d.resolve()

    def _process_grouped_raw(self, T, raw_d, srel_d, ts_d, plan) -> _StreamedEmissions:
        """Streamed fire readback for the traced-chain path: the
        `_process_grouped` contract, each group's prologue run over its own
        rows through `_run_prologue` (the groups partition the span's
        steps, so their key bounds together cover every surviving
        record)."""
        return self._process_grouped(T, None, None, plan, raw=(raw_d, srel_d, ts_d))

    def _run_prologue(self, raw, srel, ts):
        """The user's chain over all staged rows, then key/value extraction:
        (idx [T*B] int32 = key*NSB + srel for live rows else -1, vals [T*B]
        float32 zeroed off the live rows | None, key_bounds [max, min] of
        the keys of every record that survived the filters)."""
        pro = self.prologue
        col = raw
        mask = srel >= 0
        for kind, fn in pro.transforms:
            if kind == "map":
                col = fn(col)
            elif kind == "map_ts":
                col = fn(col, ts)
            else:  # filter
                mask = mask & torch.as_tensor(fn(col)).to(torch.bool)
        keys = torch.as_tensor(pro.key_fn(col)).to(torch.int32)
        live = mask & (keys >= 0) & (keys < self.K)
        idx = torch.where(live, keys * self.NSB + srel, -1).to(torch.int32)
        vals = None
        if self._needs_vals:
            vcol = pro.value_fn(col) if pro.value_fn is not None else col
            # dead and pad rows hold uninitialized staging bytes (maybe NaN):
            # zero them so K1 and its plain version see identical inputs
            vals = torch.where(live, torch.as_tensor(vcol).to(torch.float32), 0.0)
        # key range over every SURVIVING record, out-of-range keys included
        key_bounds = torch.stack([torch.where(mask, keys, -1).max(),
                                  torch.where(mask, keys, 0).min()])
        return idx, vals, key_bounds

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """State in the JAX pipeline's snapshot form: canonical [K, S]
        numpy arrays plus the planner's plain ints."""
        self._require_state()
        return {
            "state": {k: cs.from_kernel_layout(v).cpu().numpy()
                      for k, v in self._state.items()},
            "count": cs.from_kernel_layout(self._count).cpu().numpy(),
            "watermark": self.watermark,
            "fire_cursor": self.fire_cursor,
            "purged_to": self.purged_to,
            "min_used_slice": self.min_used_slice,
            "max_seen_slice": self.max_seen_slice,
            "num_late_dropped": self.num_late_records_dropped,
        }

    def restore(self, snap: dict) -> None:
        """Restore a snapshot of either package (canonical [K, S] arrays)."""
        self._require_state()

        def load(a):
            return cs.to_kernel_layout(torch.from_numpy(np.array(a))).to(self.device)

        self._state = {k: load(v) for k, v in snap["state"].items()}
        self._count = load(snap["count"])
        self.K = int(self._count.shape[1])  # capacity may have grown pre-snapshot
        self.watermark = snap["watermark"]
        self.fire_cursor = snap["fire_cursor"]
        self.purged_to = snap["purged_to"]
        self.min_used_slice = snap["min_used_slice"]
        self.max_seen_slice = snap["max_seen_slice"]
        self.num_late_records_dropped = snap["num_late_dropped"]


# ---------------------------------------------------------------------------
# shared-partial multi-window pipeline (Factor Windows, PAPERS.md): several
# correlated window shapes over one gcd-granule ring
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _WindowSpec:
    """One member window of a shared-partial group, in shared-granule
    units: window j of this spec covers slices [j*sl, j*sl + spw)."""

    spw: int
    sl: int
    size_ms: int
    slide_ms: int


@dataclasses.dataclass(frozen=True)
class _SharedGridView:
    """The sliceable-assigner view the base pipeline is built from:
    granule = the group's gcd, spw = the longest member (ring sizing), sl =
    the shortest slide."""

    slice_ms: int
    slices_per_window: int
    slide_slices: int
    offset_ms: int
    is_event_time: bool = True


class _SharedPlanCursor(_PlanCursor):
    """The multi-spec fire planner: one shared ingest/purge frontier,
    per-spec fire cursors, fire slots partitioned F_per_spec per spec."""

    def __init__(self, pipe: "SharedWindowPipeline"):
        super().__init__(pipe)
        self.fire_cursors = list(pipe.fire_cursors)

    def _note_fire_candidate(self, smin: int) -> None:
        p = self.p
        for i in range(len(p.specs)):
            cand = p._spec_j_oldest(i, smin)
            if self.wm > MIN_WATERMARK:
                cand = max(cand, p._spec_j_fired_upto(i, self.wm) + 1)
            cur = self.fire_cursors[i]
            self.fire_cursors[i] = cand if cur is None else min(cur, cand)

    def _plan_fires(self, t: int, new_wm: int, fire_pos, fire_valid,
                    fire_row, fires: list) -> None:
        p = self.p
        if self.max_seen is None:
            return
        Fp = p.F_per_spec
        for i, spec in enumerate(p.specs):
            cur = self.fire_cursors[i]
            if cur is None:
                continue
            hi = min(p._spec_j_fired_upto(i, new_wm), self.max_seen // spec.sl)
            slot = i * Fp
            n = 0
            for j in range(cur, hi + 1):
                if n >= Fp:
                    raise ValueError(
                        f"window spec {i}: {hi + 1 - cur} windows fire in "
                        f"one step > fires_per_step={Fp}")
                if len(fires) >= p.R:
                    raise ValueError(f"more than out_rows={p.R} fires per dispatch")
                row = len(fires)
                fires.append(_PlannedFire(row, j, t, spec=i))
                fire_pos[t, slot + n] = (j * spec.sl) % p.S
                fire_valid[t, slot + n] = 1
                fire_row[t, slot + n] = row
                n += 1
            if p._spec_j_fired_upto(i, new_wm) >= cur:
                self.fire_cursors[i] = p._spec_j_fired_upto(i, new_wm) + 1

    def commit(self) -> None:
        super().commit()
        self.p.fire_cursors = list(self.fire_cursors)


class SharedWindowPipeline(FusedWindowPipeline):
    """N correlated window shapes over one shared slice ring.

    Counterpart of the JAX package's `SharedWindowPipeline`. A job that
    computes several windows over the same keyed stream (1m/5m/1h
    dashboards) pays for one ingest: K1 lands gcd-granule partials once,
    and every member window folds its result from the shared ring at fire
    time, each fire slot with its member's window length (`_fire_spws`,
    K1's per-slot `spws`).

    What differs from the base pipeline is all planner-side:
    - per-spec fire cursors (`fire_cursors`); the F fire slots are
      partitioned F_per_spec per member;
    - the purge frontier is the minimum over the members' live frontiers
      (a slice purges only when the longest window is done with it);
    - `_window_of_fire` returns `(spec_index, TimeWindow)`, which only the
      shared-partial operator consumes, routing each row to its member.

    Every member assigner must be sliceable, event-time, and share one
    offset; the granule is the gcd of their slice granules, and each
    member's decomposition onto it must be exact (WindowAssigner.slices_on)."""

    def __init__(self, assigners, aggregate, *, key_capacity: int,
                 num_slices: Optional[int] = None, nsb: int = 4,
                 fires_per_step: int = 4, out_rows: int = 256,
                 chunk: int = 4096, exact_sums: bool = True,
                 plan_only: bool = False, prologue=None, device=None):
        if len(assigners) < 2:
            raise ValueError("shared partials need >= 2 window shapes")
        offs = {a.offset_ms for a in assigners}
        if len(offs) != 1:
            raise ValueError(f"shared partials need one common window offset, got {offs}")
        for a in assigners:
            if a.slice_ms is None or not a.is_event_time:
                raise ValueError(f"{a!r} is not a sliceable event-time assigner")
        g = 0
        for a in assigners:
            g = math.gcd(g, a.slice_ms)
        specs = []
        for a in assigners:
            spw, sl = a.slices_on(g)   # exact or ValueError
            specs.append(_WindowSpec(spw, sl, spw * g, sl * g))
        n = len(specs)
        view = _SharedGridView(
            slice_ms=g,
            slices_per_window=max(s.spw for s in specs),
            slide_slices=min(s.sl for s in specs),
            offset_ms=assigners[0].offset_ms,
        )
        super().__init__(
            view, aggregate, key_capacity=key_capacity, num_slices=num_slices,
            nsb=nsb, fires_per_step=n * fires_per_step, out_rows=out_rows,
            chunk=chunk, exact_sums=exact_sums, plan_only=plan_only,
            prologue=prologue, device=device,
        )
        self.specs = tuple(specs)
        self.F_per_spec = fires_per_step
        self._fire_spws = tuple(s.spw for s in specs for _ in range(fires_per_step))
        self.fire_cursors: List[Optional[int]] = [None] * n

    # -- per-spec geometry ---------------------------------------------
    def _spec_j_fired_upto(self, i: int, wm: int) -> int:
        s = self.specs[i]
        return (wm + 1 - self.offset - s.size_ms) // s.slide_ms

    def _spec_j_oldest(self, i: int, smin: int) -> int:
        s = self.specs[i]
        return _ceil_div(smin - s.spw + 1, s.sl)

    def _spec_fire_wm(self, i: int, j: int) -> int:
        s = self.specs[i]
        return self.offset + j * s.slide_ms + s.size_ms - 1

    def _spec_window_of(self, i: int, j: int) -> TimeWindow:
        s = self.specs[i]
        start = self.offset + j * s.slide_ms
        return TimeWindow(start, start + s.size_ms)

    # -- shared frontier -----------------------------------------------
    def _min_live_slice(self, wm: int) -> int:
        return min((self._spec_j_fired_upto(i, wm) + 1) * s.sl
                   for i, s in enumerate(self.specs))

    def _wm_keeping_slice_live(self, s: int) -> int:
        # the largest wm at which some member still holds slice s live
        return max(self._spec_fire_wm(i, s // sp.sl) - 1
                   for i, sp in enumerate(self.specs))

    def _window_of_fire(self, pf: _PlannedFire):
        return (pf.spec, self._spec_window_of(pf.spec, pf.j))

    def _cursor(self) -> _SharedPlanCursor:
        return _SharedPlanCursor(self)

    # -- snapshot ------------------------------------------------------
    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["fire_cursors"] = list(self.fire_cursors)
        return snap

    def restore(self, snap: dict) -> None:
        super().restore(snap)
        self.fire_cursors = list(snap["fire_cursors"])


# ---------------------------------------------------------------------------
# global-window pipeline: keyed-partial -> cross-segment fold, [S] state
# ---------------------------------------------------------------------------

class FusedGlobalWindowPipeline:
    """Per-window GLOBAL aggregation (the Nexmark Q7 shape) on the
    superscan schedule: a plan-only FusedWindowPipeline plans dispatches
    exactly like the keyed path, but the device state is a [S] slice ring of
    partials and every fire folds its slice run into ONE scalar. On CUDA the
    dispatch runs as kernel K2, on the CPU as its plain version. Staged
    inputs are the keyed pipeline's (`idx = kid * NSB + srel` folds by
    `idx % NSB`), and any batch width runs on the kernel."""

    def __init__(self, assigner, aggregate, *, num_slices: Optional[int] = None,
                 nsb: int = 4, fires_per_step: int = 2, out_rows: int = 64,
                 chunk: int = 8192, device=None):
        self._planner = FusedWindowPipeline(
            assigner, aggregate, key_capacity=128, num_slices=num_slices,
            nsb=nsb, fires_per_step=fires_per_step, out_rows=out_rows,
            chunk=chunk, plan_only=True, device=resolve_device(device),
        )
        self.agg = self._planner.agg
        self.device = self._planner.device
        self.S = self._planner.S
        self.NSB = nsb
        self.F = fires_per_step
        self.R = out_rows
        self.chunk = chunk
        self._value_fields = [f for f in self.agg.fields if f.source == VALUE]
        self._needs_vals = bool(self._value_fields)
        self._count = torch.zeros((self.S,), dtype=torch.int32, device=self.device)
        self._state = {
            f.name: torch.full((self.S,),
                               scan_identity(np.dtype(f.dtype), f.scatter),
                               dtype=torch_dtype(f.dtype), device=self.device)
            for f in self._value_fields
        }

    # planner-geometry delegation
    @property
    def planner(self):
        return self._planner

    def __getattr__(self, name):
        if name == "_planner":
            raise AttributeError(name)
        return getattr(self._planner, name)

    def attach_device_stats(self, tracker, phase_counters: bool = True) -> None:
        raise deferred.not_ported("attach_device_stats", deferred.D4)

    def plan_superbatch(self, slice_bounds, watermarks):
        return self._planner.plan_superbatch(slice_bounds, watermarks)

    def stage_superbatch(self, batches, watermarks):
        return self._planner.stage_superbatch(batches, watermarks)

    def process_superbatch(self, batches, watermarks, *, staged=None,
                           defer: bool = False):
        if staged is None:
            staged = self._planner.stage_superbatch(batches, watermarks)
        idx_d, vals_d, plan = staged
        names = [f.name for f in self._value_fields]
        # K2 for CUDA state (what it refuses raises), the plain version for CPU
        count_out, field_outs = cs.global_superscan(
            self.agg, self._count, [self._state[n] for n in names],
            idx_d.reshape(-1), vals_d.reshape(-1) if self._needs_vals else None,
            plan[:5], NSB=self.NSB, R=self.R,
            spws=(self._planner.spw,) * self.F)
        deferred = DeferredEmissions(self._planner, plan[5], count_out,
                                     dict(zip(names, field_outs)))
        return deferred if defer else deferred.resolve()

    def snapshot(self) -> dict:
        return {
            "count": self._count.cpu().numpy(),
            "state": {k: v.cpu().numpy() for k, v in self._state.items()},
            "watermark": self._planner.watermark,
            "fire_cursor": self._planner.fire_cursor,
            "purged_to": self._planner.purged_to,
            "min_used_slice": self._planner.min_used_slice,
            "max_seen_slice": self._planner.max_seen_slice,
            "num_late_dropped": self._planner.num_late_records_dropped,
        }

    def restore(self, snap: dict) -> None:
        self._count = torch.from_numpy(np.array(snap["count"])).to(self.device)
        self._state = {k: torch.from_numpy(np.array(v)).to(self.device)
                       for k, v in snap["state"].items()}
        self._planner.watermark = snap["watermark"]
        self._planner.fire_cursor = snap["fire_cursor"]
        self._planner.purged_to = snap["purged_to"]
        self._planner.min_used_slice = snap["min_used_slice"]
        self._planner.max_seen_slice = snap["max_seen_slice"]
        self._planner.num_late_records_dropped = snap["num_late_dropped"]
