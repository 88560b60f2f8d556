"""DeviceJoinRunner: the two-input keyed window join on the device ring.

Counterpart of `flink_tpu/runtime/device_join_operator.py`. A StepRunner
(kind 'window_join', two gates) that keeps both sides' records in the
`flink_tpu_torch.joins` bucketed-ring pipeline instead of host dicts:
each batch is keyed, bucketed, and scattered into the device rings in one
`index_put_`; when the two-gate watermark valve advances, every ripe
window becomes one gather + segment cross-match whose (left, right)
row-id pairs the host expands into join_fn outputs. Inherits the valve
semantics — watermarks min-combine across the inputs and end-of-input
fires only after BOTH sides end — so its behavior is batch-for-batch
comparable to the host `WindowJoinRunner` oracle.

Refusal vs degrade: shapes the ring cannot represent AT BUILD TIME
(processing time, session windows, coGroup, outer joins, device joins
disabled) raise `JoinUnsupported` out of the constructor and the factory
falls back to the host runner — an attributed refusal, not an error.
Shapes that break MID-STREAM (a (key, bucket) past its record capacity,
event time wrapping the ring, key cardinality past the key capacity)
degrade in place: the live ring contents replay into a freshly built host
`WindowJoinRunner` (its watermark set first, so already-fired windows
drop as late instead of re-emitting — exactly-once), the failed batch
replays whole (ring ingest is all-or-nothing per batch), and the reason
lands in `fallback_reason`.

With `parallel.mesh.enabled` the rings split over the shards of the
executor's `_mesh_for_config` mesh (joins/sharded.py), and `sharded` says
so; under 2 usable devices they stay on one device.

Observability: the JAX runner's join gauge family (joinRingOccupancy,
joinMatchesEmitted, joinFallbackReason, stateBytes, stateKeyCount,
numLateRecordsDropped, currentWatermark) and its emission tracker, which
stamps each ripe window after its matches' rows reached the host.

The chaos plane's device seam (`HOOK("device", uid)`) sits at the top of
each device ingest, as in the JAX runner, before any key is staged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from flink_tpu_torch.chaos import plan as _chaos
from flink_tpu_torch.config import Configuration, ExecutionOptions
from flink_tpu_torch.core.time import MAX_WATERMARK, MIN_WATERMARK
from flink_tpu_torch.joins.pipeline import FusedJoinPipeline
from flink_tpu_torch.joins.sharded import ShardedJoinPipeline
from flink_tpu_torch.joins.spec import JoinUnsupported, fallback_code, plan_join_geometry
from flink_tpu_torch.metrics.emission_latency import watermark_lag_ms
from flink_tpu_torch.runtime.executor import (
    StepRunner,
    WindowJoinRunner,
    _mesh_for_config,
    make_emission_tracker,
)
from flink_tpu_torch.utils.arrays import obj_array
from flink_tpu_torch.utils.device import resolve_device


class DeviceJoinRunner(StepRunner):

    num_inputs = 2

    def __init__(self, step, config: Configuration, device=None):
        t = step.terminal
        if t.kind == "co_group":
            raise JoinUnsupported("join-cogroup")
        if not config.get(ExecutionOptions.DEVICE_JOINS):
            raise JoinUnsupported("join-device-disabled")
        assigner = t.config["assigner"]
        if not assigner.is_event_time:
            raise JoinUnsupported("join-processing-time")
        if assigner.slice_ms is None:
            raise JoinUnsupported("join-session-window")
        if t.config.get("join_type", "inner") != "inner":
            raise JoinUnsupported("join-outer-windowed")
        self.step = step
        self.config = config
        self.device = resolve_device(device)
        self.uid = t.uid
        self.sql_origin = bool(t.config.get("sql_origin"))
        self.key_selectors = (t.config["key_selector1"], t.config["key_selector2"])
        self.join_fn = t.config["join_fn"]
        self.assigner = assigner
        size = assigner.slices_per_window * assigner.slice_ms
        slide = assigner.slide_slices * assigner.slice_ms
        # the configured capacities are CAPS; the rings allocate small and
        # double toward them on demand (the key-capacity growth contract),
        # so a join over a handful of keys never pins cap-sized arrays
        self._max_keys = config.get(ExecutionOptions.KEY_CAPACITY)
        self._max_slots = config.get(ExecutionOptions.JOIN_BUCKET_CAPACITY)
        self.geom = plan_join_geometry(
            size, slide, assigner.offset_ms,
            key_capacity=min(1024, self._max_keys),
            bucket_capacity=min(16, self._max_slots),
            ring_slack_buckets=config.get(ExecutionOptions.JOIN_RING_SLACK))
        self.pipeline: Optional[FusedJoinPipeline] = self._new_pipeline()
        self.sharded = isinstance(self.pipeline, ShardedJoinPipeline)
        # key -> dense key lane; per-lane inverse is never needed (pairs
        # come back as row ids whose payloads the rings own)
        self._keys: Dict[Any, int] = {}
        self._wm = MIN_WATERMARK
        self.num_late_dropped = 0
        self.matches_emitted = 0
        self.fallback_reason: Optional[str] = None
        self._host: Optional[WindowJoinRunner] = None
        self.emission_tracker = make_emission_tracker(t.uid, config)

    def _new_pipeline(self) -> FusedJoinPipeline:
        """The rings at the current geometry: split over the job's mesh
        (parallel.mesh.*), else on the runner's device."""
        mesh = _mesh_for_config(self.config, self.geom.key_capacity, self.device)
        if mesh is not None:
            return ShardedJoinPipeline(self.geom, mesh)
        return FusedJoinPipeline(self.geom, self.device)

    # -- adaptive geometry -------------------------------------------------
    @staticmethod
    def _fit(cur: int, need: int, cap: int) -> int:
        while cur < need:
            cur *= 2
        return min(cur, cap)

    def _grow(self, **changes) -> None:
        self.geom = dataclasses.replace(self.geom, **changes)
        self.pipeline.regrow(self.geom)

    # -- degrade-to-host ---------------------------------------------------
    def _degrade(self, reason: str, detail: str = "") -> WindowJoinRunner:
        host = WindowJoinRunner(self.step, self.config)
        host.downstream = self.downstream
        host.sides = self.sides
        # watermark FIRST: replayed records re-assign their windows and
        # the already-fired ones drop as late — nothing double-emits
        host._wm = self._wm
        pipeline, self.pipeline = self.pipeline, None
        if pipeline is not None and pipeline.ts_base is not None:
            for side, ring in ((0, pipeline.left), (1, pipeline.right)):
                recs = ring.live_records()
                if recs:
                    host.on_batch_n(
                        side,
                        obj_array([row for _kid, row, _ts in recs]),
                        np.asarray([ts for _kid, _row, ts in recs], dtype=np.int64))
        # the replay's late drops were counted (and emitted) on the device
        # path already — the public counter carries on from ours
        host.num_late_dropped = self.num_late_dropped
        self.fallback_reason = reason
        self._host = host
        return host

    # -- ingest ------------------------------------------------------------
    def on_batch_n(self, ordinal: int, values, timestamps) -> None:
        if self._host is not None:
            self._host.on_batch_n(ordinal, values, timestamps)
            self._sync_late()
            return
        hook = _chaos.HOOK
        if hook is not None:
            hook("device", self.uid)
        n = len(timestamps)
        if n == 0:
            return
        ts = np.asarray(timestamps, dtype=np.int64)
        ks = self.key_selectors[ordinal]
        kdict = self._keys
        kids = np.empty(n, dtype=np.int64)
        for i, v in enumerate(values):
            k = ks(v)
            kid = kdict.get(k)
            if kid is None:
                kid = len(kdict)
                kdict[k] = kid
            kids[i] = kid
        if len(kdict) > self.geom.key_capacity:
            if len(kdict) > self._max_keys:
                self._degrade(
                    "join-key-capacity",
                    f"distinct join keys exceeded "
                    f"execution.state.key-capacity={self._max_keys}"
                ).on_batch_n(ordinal, values, timestamps)
                self._sync_late()
                return
            self._grow(key_capacity=self._fit(self.geom.key_capacity, len(kdict),
                                              self._max_keys))
        g = self.geom
        # late accounting, mirroring the host oracle's per-(record, window)
        # drop counts: a record whose LAST window already fired is dropped
        # whole; a straggler with only some windows late still ingests (its
        # bucket feeds the remaining live windows) and counts the late ones
        ws_last = (ts - g.offset_ms) // g.slide_ms * g.slide_ms + g.offset_ms
        covered = ((ts - g.offset_ms) // g.slide_ms
                   - (ts - g.size_ms - g.offset_ms) // g.slide_ms)
        if self._wm >= MAX_WATERMARK - g.size_ms:
            # terminal watermark: every window is closed, the whole batch
            # is late (int64-safe: no wm+1 arithmetic at the MAX bound)
            self.num_late_dropped += int(covered.sum())
            return
        if self._wm > MIN_WATERMARK:
            ws_late_max = ((self._wm + 1 - g.size_ms - g.offset_ms)
                           // g.slide_ms * g.slide_ms + g.offset_ms)
            ws_first = ws_last - (covered - 1) * g.slide_ms
            n_late = np.clip(
                (np.minimum(ws_late_max, ws_last) - ws_first) // g.slide_ms + 1, 0, covered)
        else:
            n_late = np.zeros(n, dtype=np.int64)
        self.num_late_dropped += int(n_late.sum())
        keep = n_late < covered
        if not np.all(keep):
            kids, ts = kids[keep], ts[keep]
            values = [v for v, k in zip(values, keep) if k]
            if len(ts) == 0:
                return
        while True:
            try:
                self.pipeline.ingest(ordinal, kids, ts, list(values))
                return
            except JoinUnsupported as e:
                # a slots overflow under the configured cap grows the ring
                # and retries (ingest is all-or-nothing, so retry is safe);
                # at-cap overflows and ring wraps degrade to the host
                need = getattr(e, "required", 0)
                if getattr(e, "overflow", "") == "slots" and need <= self._max_slots:
                    self._grow(bucket_capacity=self._fit(
                        self.geom.bucket_capacity, need, self._max_slots))
                    continue
                # nothing of this batch landed: the host replay takes the
                # WHOLE (filtered) batch; late drops were already counted
                # above and the host recounts them on replay — reset after
                saved_late = self.num_late_dropped
                host = self._degrade(e.reason, e.detail)
                host.on_batch_n(ordinal, obj_array(list(values)), ts)
                host.num_late_dropped = saved_late
                self._sync_late()
                return

    def on_batch(self, values, timestamps) -> None:  # pragma: no cover
        raise AssertionError("DeviceJoinRunner consumes via input gates")

    def _sync_late(self) -> None:
        if self._host is not None:
            self.num_late_dropped = self._host.num_late_dropped

    # -- fire --------------------------------------------------------------
    def _ripe_windows(self, prev_wm: int, wm: int) -> List[tuple]:
        """(start, end) of every window over an occupied bucket with
        prev_wm < end-1 <= wm — bounded by resident state, so a terminal
        MAX watermark enumerates only what exists."""
        g = self.geom
        out = set()
        for b in self.pipeline.occupied_buckets():
            bt = g.offset_ms + b * g.bucket_ms
            ws_max = (bt - g.offset_ms) // g.slide_ms * g.slide_ms + g.offset_ms
            ws = ((bt - g.size_ms - g.offset_ms) // g.slide_ms + 1) * g.slide_ms + g.offset_ms
            while ws <= ws_max:
                if prev_wm < ws + g.size_ms - 1 <= wm:
                    out.add((ws, ws + g.size_ms))
                ws += g.slide_ms
        return sorted(out, key=lambda w: w[1])

    def on_watermark(self, watermark: int) -> None:
        if self._host is not None:
            self._host.on_watermark(watermark)
            return
        prev, self._wm = self._wm, max(self._wm, watermark)
        out_vals: List[Any] = []
        out_ts: List[int] = []
        fn = self.join_fn
        tracker = self.emission_tracker
        for start, end in self._ripe_windows(prev, self._wm):
            lids, rids, _kids = self.pipeline.fire_window(start, end)
            if len(lids) == 0:
                continue
            lrows = self.pipeline.left.take_rows(lids)
            rrows = self.pipeline.right.take_rows(rids)
            if tracker is not None:
                # take_rows is this window's host-visibility point: stamp
                # after it, never before
                tracker.record_fire(end)
            max_ts = end - 1
            out_vals.extend(fn(a, b) for a, b in zip(lrows, rrows))
            out_ts.extend([max_ts] * len(lrows))
        if out_vals:
            self.matches_emitted += len(out_vals)
            if self.downstream:
                self.downstream.on_batch(obj_array(out_vals), np.asarray(out_ts, dtype=np.int64))
        g = self.geom
        # purge horizon: the start of the earliest window still live
        min_live_ws = ((self._wm + 1 - g.size_ms - g.offset_ms)
                       // g.slide_ms + 1) * g.slide_ms + g.offset_ms
        self.pipeline.purge_below_window(min_live_ws)
        super().on_watermark(watermark)

    def on_end(self) -> None:
        if self._host is not None:
            self._host.on_end()
        else:
            super().on_end()

    # -- metrics -----------------------------------------------------------
    def register_metrics(self, group) -> None:
        super().register_metrics(group)

        def _wm():
            return self._host._wm if self._host is not None else self._wm

        group.gauge("currentWatermark", _wm, fold="min")
        if self.emission_tracker is not None:
            group.gauge("emissionLatencyMs", self.emission_tracker.snapshot,
                        fold="emission", kind="histogram")
            group.gauge("watermarkLagMs", lambda: watermark_lag_ms(_wm()), fold="max")
        group.gauge("numLateRecordsDropped",
                    lambda: (self._sync_late(), self.num_late_dropped)[1],
                    fold="sum", kind="counter")
        group.gauge("joinRingOccupancy", self.occupancy, fold="sum")
        group.gauge("joinMatchesEmitted", lambda: self.matches_emitted,
                    fold="sum", kind="counter")
        # a catalogued reason code, not a count: "did any shard degrade"
        group.gauge("joinFallbackReason", lambda: fallback_code(self.fallback_reason),
                    fold="max")
        group.gauge("stateBytes", self.state_bytes, fold="sum")
        group.gauge("stateKeyCount", lambda: len(self._keys), fold="sum")

    # -- introspection -----------------------------------------------------
    def occupancy(self) -> int:
        """Resident records of both rings (the JAX joinRingOccupancy gauge's
        value; 0 once degraded)."""
        return 0 if self.pipeline is None else self.pipeline.occupancy()

    def state_bytes(self) -> int:
        """Device bytes of both sides' rings (the JAX stateBytes gauge's
        value; 0 once degraded)."""
        return 0 if self.pipeline is None else self.pipeline.state_bytes()

    # -- checkpointing -----------------------------------------------------
    def snapshot(self) -> dict:
        if self._host is not None:
            return {"mode": "host", "reason": self.fallback_reason,
                    "late": self._host.num_late_dropped,
                    "matches": self.matches_emitted,
                    "host": self._host.snapshot()}
        return {"mode": "device",
                "wm": self._wm,
                "late": self.num_late_dropped,
                "matches": self.matches_emitted,
                "keys": list(self._keys.items()),
                "geom": (self.geom.key_capacity, self.geom.bucket_capacity),
                "pipeline": self.pipeline.snapshot()}

    def restore(self, snap: dict) -> None:
        self.matches_emitted = snap["matches"]
        if snap["mode"] == "host":
            host = WindowJoinRunner(self.step, self.config)
            host.downstream = self.downstream
            host.sides = self.sides
            host.restore(snap["host"])
            self.fallback_reason = snap["reason"]
            self.pipeline = None
            self._host = host
            self.num_late_dropped = snap["late"]
            return
        self._host = None
        self.fallback_reason = None
        self._wm = snap["wm"]
        self.num_late_dropped = snap["late"]
        self._keys = dict(snap["keys"])
        # the snapshot's geometry may have grown past a fresh runner's
        # initial rings: restore at the snapshotted shape BEFORE replay
        k_cap, c_cap = snap["geom"]
        self.geom = dataclasses.replace(self.geom, key_capacity=k_cap, bucket_capacity=c_cap)
        self.pipeline = None            # free the old rings before the new allocate
        self.pipeline = self._new_pipeline()
        self.sharded = isinstance(self.pipeline, ShardedJoinPipeline)
        self.pipeline.restore(snap["pipeline"])
