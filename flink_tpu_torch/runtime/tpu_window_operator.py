"""TpuWindowOperator: per-batch device execution of keyed window aggregation.

Counterpart of `flink_tpu/runtime/tpu_window_operator.py`: the window
operator the JAX package selects when a device aggregate meets allowed
lateness, a late side output or a disabled fused path. Each batch is one
ingest of (key, slice, value) lanes into the `[S, K]` rings of
`state/columnar.py::ColumnarWindowState`, then one fire per window due,
instead of per-record state mutation, with the reference's contracts:

- window start/assignment math (TimeWindow.getWindowStartWithOffset,
  SlidingEventTimeWindows.assignWindows) via the slice decomposition:
  slice granule g = gcd(size, slide); window j covers slices
  [j*(slide/g), j*(slide/g) + size/g);
- EventTimeTrigger firing: window j fires when watermark >= end(j) - 1,
  emitting every key with data in the window (empty windows emit nothing);
- allowed lateness: slices are retained until cleanup(j) = end(j) - 1 +
  lateness for the newest window containing them; late elements within
  lateness trigger a *masked re-fire* of each affected already-fired
  window, one re-fire per (window x batch), covering exactly the keys the
  batch updated in that window (K late updates of one key and window in a
  batch coalesce into one emission with the final ACC, as in the JAX
  package);
- too-late elements (newest containing window already cleaned) are
  dropped and counted, or side-output (isWindowLate/isElementLate).

Watermarks gate everything; the operator is event-time only. Records
beyond the ring wait on the host, and a watermark advance is staged so
they are ingested before it passes their windows. Each fired window reads
its keys and values back (one host sync a window, as the reference's
`np.asarray(mask)`); `columnar_output` emits them as one packed row.

Hot/cold key split (`hot_key_capacity`, `cold_tier_dir`): dense ids below
the hot capacity live as ring columns on the device; the ids past it
aggregate in the cold tier on the host (state/cold_tier.py, over the
native spill store) under absolute slices, and each fire emits both. The
split is grow-only (no vocabulary, no eviction: that is the fused
operator's `tier=`), and, as in the JAX package, it refuses allowed
lateness.

The emission-latency hook (`emission_tracker`, set by the runner) stamps
each fired window once its readback has been waited on.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.api.functions import LATE_DATA_TAG
from flink_tpu_torch.api.windowing.assigners import WindowAssigner
from flink_tpu_torch.core.time import MIN_WATERMARK, TimeWindow
from flink_tpu_torch.lint.contracts import inflight_ring
from flink_tpu_torch.ops import segment_ops
from flink_tpu_torch.ops.aggregators import DeviceAggregator, resolve
from flink_tpu_torch.state.cold_tier import ColdKeyTier
from flink_tpu_torch.state.columnar import ColumnarWindowState
from flink_tpu_torch.utils.device import HostCopy


def _ceil_div(a: int, b: int) -> int:
    return -((-a) // b)


@inflight_ring("_pending", drained_by="flush")
class TpuWindowOperator:
    """One operator instance (one shard's key space) on one device."""

    def __init__(
        self,
        assigner: WindowAssigner,
        aggregate,
        *,
        allowed_lateness: int = 0,
        key_capacity: int = 1 << 12,
        num_slices: Optional[int] = None,
        dense_int_keys: bool = False,
        emit_late_to_side_output: bool = False,
        columnar_output: bool = False,
        ingest_kernel: str = "scatter",
        hot_key_capacity: Optional[int] = None,
        cold_tier_dir: Optional[str] = None,
        device=None,
    ):
        agg = resolve(aggregate)
        if agg is None:
            raise ValueError(
                f"Aggregate {aggregate!r} has no device form; it needs the oracle operator")
        if assigner.slice_ms is None:
            raise ValueError(f"{assigner!r} is not sliceable; it needs the oracle operator")
        if not assigner.is_event_time:
            raise ValueError("TpuWindowOperator is event-time only")
        self.assigner = assigner
        self.agg: DeviceAggregator = agg
        self.allowed_lateness = allowed_lateness
        self.emit_late_to_side_output = emit_late_to_side_output
        self.columnar_output = columnar_output

        # slice geometry (all host ints)
        self.g = assigner.slice_ms
        self.sl = assigner.slide_slices          # slices between window starts
        self.spw = assigner.slices_per_window    # slices per window
        self.offset = assigner.offset_ms
        self.size_ms = self.spw * self.g
        self.slide_ms = self.sl * self.g
        self.lateness_slices = _ceil_div(allowed_lateness, self.g)

        if num_slices is None:
            # live span ~ window + lateness + out-of-orderness headroom
            need = self.spw + self.lateness_slices + 2 * self.spw + 16
            num_slices = 1 << (need - 1).bit_length()
        self.S = num_slices

        # hot/cold key split (S3/S4 analogue): dense ids below
        # hot_key_capacity live as device columns; the overflow aggregates
        # into the native spill store (state/cold_tier.py)
        self.hot_key_capacity = hot_key_capacity
        self.cold_tier: Optional[ColdKeyTier] = None
        if hot_key_capacity is not None:
            if allowed_lateness > 0:
                raise ValueError("hot/cold key tiering does not support allowed_lateness yet")
            self.cold_tier = ColdKeyTier(agg, self.S, directory=cold_tier_dir)
            key_capacity = min(key_capacity, hot_key_capacity)

        self.state = ColumnarWindowState(
            agg,
            key_capacity=key_capacity,
            num_slices=num_slices,
            dense_int_keys=dense_int_keys,
            ingest_kernel=ingest_kernel,
            device=device,
        )

        self.current_watermark = MIN_WATERMARK
        self.fire_cursor: Optional[int] = None  # next window index to fire
        self._pending: List[Tuple[Any, Any, int]] = []  # (key, value, ts)
        self._future: List[Tuple[Any, Any, int]] = []   # beyond-ring records
        self.output: List[Tuple[Any, Any, Any, int]] = []
        self.side_output: Dict[str, List] = {}
        self.num_late_records_dropped = 0

    # emission-latency plane: set by the runner; _emit_window stamps each
    # fire where its rows have reached the host
    emission_tracker = None

    # ------------------------------------------------------------------
    # window/slice math
    # ------------------------------------------------------------------
    def slice_of(self, ts: int) -> int:
        return (ts - self.offset) // self.g

    def slice_of_np(self, ts: np.ndarray) -> np.ndarray:
        return (ts - np.int64(self.offset)) // np.int64(self.g)

    def j_newest(self, s: int) -> int:
        """Newest window index containing slice s."""
        return s // self.sl

    def j_oldest(self, s: int) -> int:
        """Oldest window index containing slice s."""
        return _ceil_div(s - self.spw + 1, self.sl)

    def window_of(self, j: int) -> TimeWindow:
        start = self.offset + j * self.slide_ms
        return TimeWindow(start, start + self.size_ms)

    def end_ms(self, j: int) -> int:
        return self.offset + j * self.slide_ms + self.size_ms

    def cleanup_of(self, j: int) -> int:
        return self.end_ms(j) - 1 + self.allowed_lateness

    def j_fired_upto(self, wm: int) -> int:
        """Largest window index whose fire time (end-1) has passed at wm."""
        return (wm + 1 - self.offset - self.size_ms) // self.slide_ms

    def j_min_live(self, wm: int) -> int:
        """Smallest window index whose cleanup time has NOT passed at wm."""
        return (wm + 1 - self.offset - self.size_ms - self.allowed_lateness) // self.slide_ms + 1

    def min_live_slice(self, wm: int) -> int:
        return self.j_min_live(wm) * self.sl

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------
    def process_record(self, key, value, timestamp: int) -> None:
        self._pending.append((key, value, timestamp))

    def process_batch(self, keys: np.ndarray, values: np.ndarray, timestamps: np.ndarray) -> None:
        """Columnar ingest (the executor's hot path)."""
        self.flush()
        self._ingest_arrays(keys, values, np.asarray(timestamps, dtype=np.int64))

    def flush(self) -> None:
        if not self._pending:
            return
        pend, self._pending = self._pending, []
        keys = np.asarray([p[0] for p in pend], dtype=object)
        vals = np.asarray([p[1] for p in pend], dtype=np.float32)
        ts = np.asarray([p[2] for p in pend], dtype=np.int64)
        self._ingest_arrays(keys, vals, ts)

    def _ring_floor(self, batch_min_slice: int) -> int:
        f = self.state.frontiers
        floor = batch_min_slice
        if f.min_used is not None:
            floor = min(floor, f.min_used)
        if f.purged_to is not None:
            floor = max(floor, f.purged_to)
        return floor

    def _ingest_arrays(self, keys: np.ndarray, vals: np.ndarray, ts: np.ndarray) -> None:
        if len(ts) == 0:
            return
        wm = self.current_watermark
        s_abs = self.slice_of_np(ts)

        # 1. too-late drop (isWindowLate over the newest containing window)
        if wm > MIN_WATERMARK:
            late = s_abs < self.min_live_slice(wm)
        else:
            late = np.zeros(len(ts), dtype=bool)
        if late.any():
            if self.emit_late_to_side_output:
                lt = self.side_output.setdefault(LATE_DATA_TAG.tag_id, [])
                for i in np.flatnonzero(late):
                    lt.append((keys[i], vals[i].item(), int(ts[i])))
            else:
                self.num_late_records_dropped += int(late.sum())

        keep = ~late
        if not keep.any():
            return

        # 2. ring overflow: records too far in the future wait on the host
        floor = self._ring_floor(int(s_abs[keep].min()))
        over = keep & (s_abs >= floor + self.S)
        if over.any():
            for i in np.flatnonzero(over):
                self._future.append((keys[i], vals[i], int(ts[i])))
            keep = keep & ~over
            if not keep.any():
                return

        # 3. dense key ids (grow capacity first so the scatter shape is right)
        ids, required = self.state.keydict.lookup_or_insert(keys[keep])
        if self.cold_tier is not None and required > self.hot_key_capacity:
            # overflow ids take the host/LSM path with ABSOLUTE slices
            cold = ids >= self.hot_key_capacity
            if cold.any():
                cold_rows = np.flatnonzero(keep)[cold]
                self.cold_tier.ingest(
                    (ids[cold] - self.hot_key_capacity).astype(np.int64),
                    s_abs[cold_rows], np.asarray(vals[cold_rows], dtype=np.float32))
                ids = np.where(cold, segment_ops.INVALID_INDEX, ids)
            required = min(required, self.hot_key_capacity)
        self.state.ensure_key_capacity(required)
        kid = np.full(len(ts), segment_ops.INVALID_INDEX, dtype=np.int32)
        kid[keep] = ids
        self.state.ingest(kid, s_abs, vals)
        live_slices = s_abs[keep]
        live_lo, live_hi = int(live_slices.min()), int(live_slices.max())
        if self.cold_tier is not None:
            # cold-only slices must still advance the used-slice frontiers
            f = self.state.frontiers
            f.min_used = live_lo if f.min_used is None else min(f.min_used, live_lo)
            f.max_used = live_hi if f.max_used is None else max(f.max_used, live_hi)

        # 4. fire-cursor init/advance bookkeeping
        cand = self.j_oldest(live_lo)
        if wm > MIN_WATERMARK:
            cand = max(cand, self.j_fired_upto(wm) + 1)
        self.fire_cursor = cand if self.fire_cursor is None else min(self.fire_cursor, cand)

        # 5. late re-fires: already-fired live windows touched by this batch
        if wm > MIN_WATERMARK:
            lo = max(self.j_oldest(live_lo), self.j_min_live(wm))
            hi = min(self.j_newest(live_hi), self.j_fired_upto(wm))
            for j in range(lo, hi + 1):
                self._emit_window(j, touch_mask=True)

    # ------------------------------------------------------------------
    # watermark advance: fire then purge (mirrors onEventTime: trigger fire
    # precedes cleanup at the same timestamp)
    # ------------------------------------------------------------------
    def process_watermark(self, watermark: int) -> None:
        self.flush()
        if watermark <= self.current_watermark:
            return
        # Staged advance: beyond-ring records buffered on the host must be
        # ingested BEFORE the watermark passes their windows' fire times
        # (the reference processed them in stream order; the ring is the
        # resource limit, so ring space opens first, then the advance goes on).
        while True:
            step_target = watermark
            if self._future:
                min_s = min(self.slice_of(ts) for _, _, ts in self._future)
                wm_open = self._ring_opening_watermark(min_s)
                if wm_open > self.current_watermark:
                    step_target = min(watermark, wm_open)
            self._advance_to(step_target)
            self._drain_future()
            if step_target >= watermark:
                break

    def _ring_opening_watermark(self, s: int) -> int:
        """Smallest watermark at which slice s fits in the ring (the purge
        frontier has advanced past s - S)."""
        q = (s - self.S) // self.sl + 1  # need j_min_live > (s - S) / sl
        return q * self.slide_ms + self.offset + self.size_ms + self.allowed_lateness - 1

    def _advance_to(self, watermark: int) -> None:
        if watermark <= self.current_watermark:
            return
        f = self.state.frontiers
        # 1. fire newly eligible windows in time order
        if self.fire_cursor is not None and f.max_used is not None:
            hi = min(self.j_fired_upto(watermark), self.j_newest(f.max_used))
            for j in range(self.fire_cursor, hi + 1):
                self._emit_window(j, touch_mask=False)
            if self.j_fired_upto(watermark) >= self.fire_cursor:
                self.fire_cursor = self.j_fired_upto(watermark) + 1

        # 2. purge expired slices (cleanup frontier)
        new_min_live = self.min_live_slice(watermark)
        if f.min_used is not None:
            purge_from = f.min_used if f.purged_to is None else max(f.purged_to, f.min_used)
            purge_to = min(new_min_live, f.max_used + 1)
            if purge_to - purge_from >= self.S:
                self.state.reset_all()  # the entire used range expired
            elif purge_to > purge_from:
                self.state.purge_slices(list(range(purge_from, purge_to)))
        f.purged_to = new_min_live if f.purged_to is None else max(f.purged_to, new_min_live)
        if self.cold_tier is not None:
            # the same retention cut for spilled rows: without it the store
            # keeps every (key, slice) cell ever written
            self.cold_tier.purge_below_slice(new_min_live)
        self.current_watermark = watermark

    def _drain_future(self) -> None:
        if not self._future:
            return
        fut, self._future = self._future, []
        keys = np.asarray([p[0] for p in fut], dtype=object)
        vals = np.asarray([p[1] for p in fut], dtype=np.float32)
        ts = np.asarray([p[2] for p in fut], dtype=np.int64)
        self._ingest_arrays(keys, vals, ts)  # unfit records re-buffer themselves

    def advance_processing_time(self, time: int) -> None:
        pass  # event-time only

    # ------------------------------------------------------------------
    # emission
    # ------------------------------------------------------------------
    def _emit_window(self, j: int, *, touch_mask: bool) -> None:
        window = self.window_of(j)
        start_slice = j * self.sl
        result, _cnt, mask = self.state.fire(
            range(start_slice, start_slice + self.spw), touch_mask=touch_mask)
        idx_t = torch.nonzero(mask).squeeze(1)      # reads the mask's size back
        cold_emit = None
        if self.cold_tier is not None:
            n_cold = max(0, len(self.state.keydict) - self.hot_key_capacity)
            if n_cold:
                c_res, c_cnt = self.cold_tier.fire(
                    n_cold, range(start_slice, start_slice + self.spw))
                live = np.flatnonzero(c_cnt > 0)
                if live.size:
                    cold_emit = (live, c_res[live])
        if idx_t.numel() == 0 and cold_emit is None:
            self._stamp(window)
            return
        idx, vals = (t.numpy() for t in HostCopy([idx_t, result[idx_t]]).wait())
        self._stamp(window)
        ts = window.max_timestamp()
        if self.columnar_output:
            if cold_emit is not None:
                # cold ids follow the hot ones, offset by the hot capacity
                idx = np.concatenate([idx, cold_emit[0] + self.hot_key_capacity])
                vals = np.concatenate([vals, cold_emit[1]]) if len(vals) else cold_emit[1]
            self.output.append((None, window, (idx, vals), ts))
            return
        key_at = self.state.keydict.key_at
        self.output.extend((key_at(i), window, v, ts)
                           for i, v in zip(idx.tolist(), vals.tolist()))
        if cold_emit is not None:
            for ci, cv in zip(cold_emit[0], cold_emit[1]):
                self.output.append((key_at(int(ci) + self.hot_key_capacity), window,
                                    cv.item(), ts))

    def _stamp(self, window) -> None:
        """One fired window's emission latency, after its readback (the
        mask's size read back above, or the rows' copy waited on)."""
        if self.emission_tracker is not None:
            self.emission_tracker.record_fire(window.end, lateness_ms=self.allowed_lateness)

    def drain_output(self) -> List[Tuple[Any, Any, Any, int]]:
        out = self.output
        self.output = []
        return out

    # -- observability gauges ------------------------------------------
    def state_bytes(self) -> int:
        return self.state.state_bytes()

    def state_key_count(self) -> int:
        return len(self.state.keydict)

    def key_loads(self) -> torch.Tensor:
        """Per-key record counts (int32[K]) on the device: one sum over the
        count ring."""
        return self.state.count.sum(0, dtype=torch.int32)

    def key_stats_ready(self) -> bool:
        """Any slice ever written to the device ring."""
        return self.state.frontiers.max_used is not None

    def state_row_bytes(self) -> int:
        """Device bytes per key across the count and accumulator rings."""
        n = 4 * self.state.S
        for a in self.state.acc.values():
            n += a.element_size() * self.state.S
        return n

    # ------------------------------------------------------------------
    # snapshot / restore (the JAX package's form, both ways)
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        self.flush()
        return {
            "columnar": self.state.snapshot(),
            "watermark": self.current_watermark,
            "fire_cursor": self.fire_cursor,
            "future": [(k, float(v), int(t)) for k, v, t in self._future],
            "num_late_dropped": self.num_late_records_dropped,
            "side_output": {k: list(v) for k, v in self.side_output.items()},
            "cold": self.cold_tier.snapshot() if self.cold_tier is not None else None,
        }

    def restore(self, snap: dict) -> None:
        self.state.restore(snap["columnar"])
        self.current_watermark = snap["watermark"]
        self.fire_cursor = snap["fire_cursor"]
        self._future = list(snap["future"])
        self.num_late_records_dropped = snap["num_late_dropped"]
        self.side_output = {k: list(v) for k, v in snap.get("side_output", {}).items()}
        if snap.get("cold") is not None and self.cold_tier is not None:
            self.cold_tier.restore(snap["cold"])
        self._pending = []
        self.output = []
