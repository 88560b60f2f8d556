"""Device-path session windows: per-slice fragments + gap-merge scan.

Counterpart of `flink_tpu/runtime/tpu_session_operator.py`. The reference
merges session windows per record through MergingWindowSet
(WindowOperator.java:303-403, EventTimeSessionWindows.java): each
element's [ts, ts+gap) window is merged with intersecting in-flight
windows, state namespaces are merged, and the merged window's trigger
fires when the watermark passes its end.

The re-design exploits one invariant: with slice width == gap, ALL events
that land in the same slice belong to the same session (any two timestamps
in a slice differ by < gap). Ingest therefore needs no merge logic: it
accumulates per-(slice, key) *fragments* (kernel K3, `ops/cuda_session.py`)

    count[s, k], min_rel[s, k], max_rel[s, k], field[s, k]...

(min/max slice-relative, so int32 never overflows millisecond timestamps;
rings slice-major [S, K] on the device, snapshots in the JAX package's
[K, S]). Merging collapses to a LINEAR SCAN over the slice axis: fragment
s+i joins the current session iff ``min_ts(frag) - max_ts(session) <=
gap`` (kernel K4, a thread per key). A session is emitted when a later
fragment proves a gap, or when the watermark passes ``max_ts + gap - 1``;
emitted cells purge, open sessions stay resident.

Late contract: a record whose standalone session is already expired
(ts + gap - 1 <= watermark) is dropped and counted, matching the oracle
whenever the stream's out-of-orderness is below the session gap (the
merging analogue of isWindowLate, WindowOperator.java:609). The executor
hands streams with out-of-orderness >= gap to the per-record oracle
operator, as the JAX package does.

Every merge runs on the device: K4 keeps its times in 64-bit ms, so any
gap and span fit, and a per-watermark merge takes M = span + 1 emission
slots, which no key can overflow (each closed session consumes a slice
column). Unlike JAX arrays the rings are updated in place, so a fused
superspan, which may have to be undone, keeps a copy of the pre-dispatch
rings; its exact per-step replay (the reference's own path, on K3/K4 as
well) is counted by `superspan_replays`.

A field declared 64-bit (`sum_agg(np.float64)`) computes in 32 bits on
K3/K4, as on every other path of both packages. The JAX operator merges
such a field on its host path instead, whose accumulator starts as an
int64 array, so it truncates each slice cell of a float sum (a float64
sum over 0.1 and 0.2 gives 0 there). The port does not reproduce that
truncation: it gives the JAX package's float32 sum.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.api.windowing.assigners import EventTimeSessionWindows
from flink_tpu_torch.core.time import MIN_WATERMARK, TimeWindow
from flink_tpu_torch.lint.contracts import inflight_ring
from flink_tpu_torch.ops import cuda_session
from flink_tpu_torch.ops.aggregators import VALUE, DeviceAggregator, resolve, torch_dtype
from flink_tpu_torch.ops.superscan import unpack_sessions
from flink_tpu_torch.state.columnar import KeyDictionary
from flink_tpu_torch.utils.device import HostCopy, resolve_device, staging_buffer, upload


def _i64(x: int) -> int:
    """x clamped into int64 (a watermark far past every session)."""
    return min(max(int(x), -(1 << 63)), (1 << 63) - 1)


@inflight_ring("_pending", drained_by="_resolve_pending")
class TpuSessionWindowOperator:
    """One shard's keyed session-window aggregation on one device."""

    # emission-latency plane: set by the runner; each merged session is
    # stamped once its merge's packed emissions have reached the host
    emission_tracker = None

    def __init__(
        self,
        assigner: EventTimeSessionWindows,
        aggregate,
        *,
        key_capacity: int = 1 << 12,
        num_slices: int = 64,
        batch_pad: int = 256,
        defer_emissions: bool = False,
        device=None,
    ):
        agg = resolve(aggregate)
        if agg is None:
            raise ValueError(f"aggregate {aggregate!r} has no device form")
        for f in agg.fields:
            if f.source == VALUE and f.scatter not in ("add", "min", "max"):
                raise ValueError(f"unsupported scatter {f.scatter!r}")
        if not assigner.is_event_time:
            raise ValueError("TpuSessionWindowOperator is event-time only")
        if not 0 < assigner.gap < (1 << 31):
            raise ValueError(f"session gap {assigner.gap} ms: the rings hold ms within a "
                             "gap-slice as int32, so the gap must be below 2^31 ms")
        self.device = resolve_device(device)
        self.agg: DeviceAggregator = agg
        self.g = assigner.gap
        self.S = num_slices
        self.batch_pad = batch_pad
        self.keydict = KeyDictionary()
        self.K = key_capacity

        self._vfields = tuple(
            (f.name, f.device_dtype.name, f.scatter)
            for f in agg.fields
            if f.source == VALUE
        )
        self._idents = tuple(
            f.device_identity for f in agg.fields if f.source == VALUE
        )
        if not cuda_session.supports(self._vfields):
            raise NotImplementedError(
                f"session value fields {self._vfields}: the session kernels K3/K4 take at "
                "most 4, each an add, min or max of an int or float of 32 bits or, computed "
                "in 32, of 64")
        self._init_state()

        self.current_watermark = MIN_WATERMARK
        self.ring_lo: Optional[int] = None     # lowest resident slice
        self.max_used: Optional[int] = None
        self._future: List[Tuple[Any, float, int]] = []
        self.output: List[Tuple[Any, Any, Any, int]] = []
        self.num_late_records_dropped = 0
        # deferred-emission mode: merges are enqueued without a device
        # sync; the packed emission arrays resolve at drain_output (or when
        # the ring needs fresh bounds). Ring bookkeeping stays conservative
        # (stale-low ring_lo only widens the next scan's span over provably
        # empty slices).
        self.defer_emissions = defer_emissions
        self._pending: List[dict] = []
        self._since_dispatch: Optional[Tuple[int, int]] = None
        self._dense = False
        # the reference's exact per-step replay, counted so it cannot hide
        self.superspan_replays = 0

    # ------------------------------------------------------------------
    def _ring(self, K: int, fill, dtype) -> torch.Tensor:
        return torch.full((self.S, K), fill, dtype=dtype, device=self.device)

    def _init_state(self) -> None:
        K = self.K
        self._cnt = self._ring(K, 0, torch.int32)
        self._mn = self._ring(K, self.g, torch.int32)    # identity: > any rel
        self._mx = self._ring(K, -1, torch.int32)
        self._fields = tuple(
            self._ring(K, ident, torch_dtype(dt))
            for (_n, dt, _s), ident in zip(self._vfields, self._idents)
        )

    def _rings(self):
        return (self._cnt, self._mn, self._mx, self._fields)

    def _copy_rings(self):
        return (self._cnt.clone(), self._mn.clone(), self._mx.clone(),
                tuple(f.clone() for f in self._fields))

    def ensure_key_capacity(self, required: int) -> None:
        if required <= self.K:
            return
        new_k = 1 << (required - 1).bit_length()
        pad = new_k - self.K

        def grow(arr, fill):
            return torch.cat([arr, self._ring(pad, fill, arr.dtype)], dim=1).contiguous()

        self._cnt = grow(self._cnt, 0)
        self._mn = grow(self._mn, self.g)
        self._mx = grow(self._mx, -1)
        self._fields = tuple(
            grow(f, ident) for f, ident in zip(self._fields, self._idents)
        )
        self.K = new_k

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        host, t = staging_buffer(arr.shape, arr.dtype, self.device)
        host[...] = arr
        return upload(t, self.device)

    # ------------------------------------------------------------------
    def process_record(self, key, value, timestamp: int) -> None:
        self.process_batch(
            np.asarray([key]), np.asarray([value], dtype=np.float32),
            np.asarray([timestamp], dtype=np.int64),
        )

    def process_batch(self, keys: np.ndarray, vals: np.ndarray,
                      ts: np.ndarray) -> None:
        ts = np.asarray(ts, dtype=np.int64)
        if len(ts) == 0:
            return
        if self._dense:
            raise ValueError(
                "process_batch (keydict path) cannot be mixed with "
                "process_batch_staged dense ids on one operator"
            )
        vals = np.asarray(vals, dtype=np.float32)
        wm = self.current_watermark

        # standalone-expired records are late (see module docstring)
        late = ts + self.g - 1 <= wm
        if late.any():
            self.num_late_records_dropped += int(late.sum())
            keep = ~late
            keys, vals, ts = keys[keep], vals[keep], ts[keep]
            if len(ts) == 0:
                return

        s_abs = ts // self.g
        # the ring floor this batch will actually occupy: its own lowest
        # slice can move ring_lo DOWN, so the overflow check must use the
        # post-batch floor or aliased positions corrupt state
        lo = int(s_abs.min())
        if self.ring_lo is not None:
            lo = min(self.ring_lo, lo)
        if self._pending and self.max_used is not None \
                and self.max_used - lo >= self.S:
            self._resolve_pending()    # stale bounds: learn the truth first
            lo = int(s_abs.min())
            if self.ring_lo is not None:
                lo = min(self.ring_lo, lo)
        if self.max_used is not None and self.max_used - lo >= self.S:
            # a record this far BELOW resident fragments cannot be ingested
            # (existing cells cannot be held back retroactively) — the
            # resident span must fit the ring, same contract as the fused
            # pipeline's inverted-skew check
            raise ValueError(
                f"session slice ring too small for this skew: batch slice "
                f"{lo} is {self.max_used - lo} gap-slices below resident "
                f"slice {self.max_used}, ring holds num_slices={self.S}. "
                f"Raise num_slices above the expected out-of-orderness "
                f"(in units of the session gap)."
            )
        # ring overflow: far-future records wait on host until purge opens
        # space (same hold-back contract as the per-batch window operator)
        over = s_abs >= lo + self.S
        if over.any() and self._pending:
            # stale deferred bounds must not park records sync mode would
            # ingest (parking past a watermark advance turns them late)
            self._resolve_pending()
            lo = int(s_abs.min())
            if self.ring_lo is not None:
                lo = min(self.ring_lo, lo)
            over = s_abs >= lo + self.S
        if over.any():
            for i in np.flatnonzero(over):
                self._future.append((keys[i], float(vals[i]), int(ts[i])))
            keep = ~over
            keys, vals, ts, s_abs = keys[keep], vals[keep], ts[keep], s_abs[keep]
            if len(ts) == 0:
                return

        ids, required = self.keydict.lookup_or_insert(keys)
        self.ensure_key_capacity(required)

        n = len(ts)
        padded = self.batch_pad
        while padded < n:
            padded *= 2
        recs = np.zeros((3, padded), dtype=np.int32)    # kid, spos, rel
        recs[0, n:] = -1
        recs[0, :n] = ids.astype(np.int32)
        recs[1, :n] = (s_abs % self.S).astype(np.int32)
        recs[2, :n] = (ts - s_abs * self.g).astype(np.int32)
        v = np.zeros(padded, dtype=np.float32)
        v[:n] = vals

        smin, smax = int(s_abs.min()), int(s_abs.max())
        r = self._upload(recs)
        cuda_session.session_ingest(*self._rings(), r[0], r[1], r[2], self._upload(v),
                                    self._vfields, window=(smin, smax))

        self.ring_lo = smin if self.ring_lo is None else min(self.ring_lo, smin)
        self.max_used = smax if self.max_used is None else max(self.max_used, smax)
        self._track_ingest(smin, smax)

    def _track_ingest(self, smin: int, smax: int) -> None:
        """Record post-dispatch ingest bounds so a deferred merge scan's
        resolved ring bounds can be merged with what arrived after it."""
        s = self._since_dispatch
        self._since_dispatch = (
            (smin, smax) if s is None else (min(s[0], smin), max(s[1], smax))
        )

    def process_batch_staged(self, kid, spos, rel, vals,
                             smin: int, smax: int) -> None:
        """Device-staged dense-key ingest: `kid`/`spos`/`rel`/`vals` are
        int32/float32 tensors on the operator's device, already in ring
        coordinates (kid < the declared key capacity or -1 to drop, spos =
        abs_slice % S, rel = ts - abs_slice*gap). The caller guarantees no
        record is late and that [smin, smax] keeps the resident span inside
        the ring — the zero-host-copy path for device-side sources."""
        self._sync_superspan()
        lo = smin if self.ring_lo is None else min(self.ring_lo, smin)
        if self._pending and (
            (self.max_used is not None and self.max_used - lo >= self.S)
            or smax - lo >= self.S
        ):
            # deferred-mode bookkeeping is conservative (stale-low ring_lo);
            # resolve to learn the true bounds before declaring overflow
            self._resolve_pending()
            lo = smin if self.ring_lo is None else min(self.ring_lo, smin)
        if (self.max_used is not None and self.max_used - lo >= self.S) or (
                smax - lo >= self.S):
            raise ValueError(
                f"session slice ring too small: span [{lo}, "
                f"{max(smax, self.max_used or smax)}] exceeds num_slices={self.S}"
            )
        if len(self.keydict) > 0:
            raise ValueError(
                "process_batch_staged (dense ids) cannot be mixed with the "
                "keydict-backed process_batch path on one operator"
            )
        self._dense = True
        cuda_session.session_ingest(*self._rings(), kid, spos, rel, vals, self._vfields,
                                    window=(smin, smax))
        self.ring_lo = lo
        self.max_used = smax if self.max_used is None else max(self.max_used, smax)
        self._track_ingest(smin, smax)

    def _key_of(self, kid: int):
        return kid if self._dense else self.keydict.key_at(kid)

    # ------------------------------------------------------------------
    # fused superspan: T staged ingest steps + their gap-merges, one K3
    # launch per run of steps up to a merge and one K4 launch per merge,
    # with ONE packed readback — sessions never round-trip to host per
    # watermark
    # ------------------------------------------------------------------
    MAX_SUPERSPAN_SLOTS = 40

    def process_superspan_staged(self, kid, spos, rel, vals,
                                 step_bounds, merge_wms) -> None:
        """Device-staged fused superspan: `kid`/`spos`/`rel`/`vals` are
        [T, B] tensors in ring coordinates (the per-step contract of
        process_batch_staged, stacked), `step_bounds[t] = (smin, smax)`
        the step's absolute gap-slice bounds, and `merge_wms[t]` the
        watermark to gap-merge at after step t (None = ingest-only step).

        Closed sessions accumulate into M emission slots per key and come
        back as one packed array, resolved deferred exactly like the
        per-watermark merge scans. Geometries the fused dispatch cannot
        bound (emission slots past MAX_SUPERSPAN_SLOTS) replay through the
        exact per-step path instead, and an
        in-dispatch slot overflow (pathological re-filled-slice churn)
        discards the fused result and replays from the retained
        pre-dispatch state — placement never changes a result."""
        T = int(kid.shape[0])
        if not any(w is not None for w in merge_wms):
            raise ValueError("a superspan needs at least one merge step")
        if len(self.keydict) > 0:
            raise ValueError(
                "process_superspan_staged (dense ids) cannot be mixed with "
                "the keydict-backed process_batch path on one operator"
            )
        self._dense = True
        self._resolve_pending()   # learn true bounds; one dispatch in flight

        smin_all = min(b[0] for b in step_bounds)
        smax_all = max(b[1] for b in step_bounds)
        lo0 = smin_all if self.ring_lo is None else min(self.ring_lo, smin_all)
        hi = smax_all if self.max_used is None else max(self.max_used, smax_all)
        if hi - lo0 >= self.S:
            raise ValueError(
                f"session slice ring too small: superspan [{lo0}, {hi}] "
                f"exceeds num_slices={self.S}"
            )
        g = self.g
        span = hi - lo0 + 1
        n_merges = sum(1 for w in merge_wms if w is not None)
        # emission-slot bound: sessions closed per key per dispatch <=
        # fragments consumed <= span slices + per-merge re-fills; rounded
        # up to a multiple of 8 (the JAX package's compile-shape rounding,
        # kept so both packages take the same paths)
        M = -(-(span + n_merges + 2) // 8) * 8
        wm_last = max(w for w in merge_wms if w is not None)
        if M > min(self.S, self.MAX_SUPERSPAN_SLOTS):
            self._replay_superspan(kid, spos, rel, vals, step_bounds,
                                   merge_wms)
            return

        merge_flag = np.asarray(
            [1 if w is not None else 0 for w in merge_wms], np.int32)
        lo_pos = np.full(T, lo0 % self.S, np.int32)
        lo_rel = np.zeros(T, np.int32)
        wm_rel = np.asarray(
            [_i64(w - lo0 * g) if w is not None else 0 for w in merge_wms],
            np.int64)

        old_state = self._copy_rings() + (
            self.ring_lo, self.max_used, self.current_watermark)
        packed = cuda_session.session_superscan(
            *self._rings(), kid, spos, rel, vals, merge_flag, lo_pos, lo_rel,
            wm_rel, g=g, M=M, vfields=self._vfields, idents=self._idents,
            step_bounds=step_bounds)
        self.ring_lo = lo0          # stale-low; refreshed at resolve
        self.max_used = hi
        self.current_watermark = max(self.current_watermark, wm_last)
        self._since_dispatch = None   # packed live bounds are dispatch-final
        entry = {
            "packed": HostCopy([packed]), "lo": lo0, "M": M, "K": self.K,
            "watermark": wm_last, "old_state": old_state,
            "superspan": (kid, spos, rel, vals, step_bounds, merge_wms),
        }
        if self.defer_emissions:
            self._pending.append(entry)
            if self._future:
                self._resolve_pending()
        else:
            self._resolve_entry(entry, last=True)
        self._drain_future()

    def _replay_superspan(self, kid, spos, rel, vals, step_bounds,
                          merge_wms) -> None:
        """Exact per-step replay of a superspan (fused-path fallback and
        the overflow recovery path): per-step staged ingest + sync
        per-watermark merge scans — bit-identical semantics, more
        dispatches."""
        self.superspan_replays += 1
        was_deferred, self.defer_emissions = self.defer_emissions, False
        try:
            for t in range(int(kid.shape[0])):
                self.process_batch_staged(
                    kid[t], spos[t], rel[t], vals[t], *step_bounds[t])
                if merge_wms[t] is not None:
                    self.process_watermark(merge_wms[t])
        finally:
            self.defer_emissions = was_deferred

    # ------------------------------------------------------------------
    def process_watermark(self, watermark: int) -> None:
        if watermark <= self.current_watermark:
            return
        self._sync_superspan()
        self.current_watermark = watermark
        if self.ring_lo is None:
            self._drain_future()
            return

        g = self.g
        lo, hi = self.ring_lo, self.max_used
        span = hi - lo + 1
        pos_d = self._upload((np.arange(lo, hi + 1) % self.S).astype(np.int32))
        wm_rel = _i64(watermark - lo * g)
        if not self.defer_emissions:
            # cheap closable test before the merge dispatch (torch code):
            # while no fragment's standalone window has expired, nothing can
            # emit (break-closed sessions wait for the watermark to pass
            # their end — exactly the oracle's trigger time). Skipped in
            # deferred mode: the dispatch itself is async and costs no sync.
            p = pos_d.long()
            end = self._mx[p].long() + torch.arange(span, device=self.device)[:, None] * g
            closable = ((self._cnt[p] > 0) & (end + g - 1 <= wm_rel)).any()
            if not bool(closable):
                self._drain_future()
                return

        # gather + gap-merge scan + emit + purge in ONE K4 launch over the
        # span's columns; emissions come back as one packed array. Each
        # closed session consumes a column, so M = span + 1 slots cannot
        # overflow.
        M = span + 1
        packed = cuda_session.session_merge(
            *self._rings(), pos_d, wm_rel, g=g, M=M,
            vfields=self._vfields, idents=self._idents)
        entry = {"packed": HostCopy([packed]), "lo": lo, "M": M, "K": self.K,
                 "watermark": watermark}
        self._since_dispatch = None
        if self.defer_emissions:
            if len(self._pending) >= 32:
                # bound the in-flight packed buffers (one sync per 32 scans)
                self._resolve_pending()
            self._pending.append(entry)
            if self._future:
                # parked records need the TRUE post-scan bounds now, or the
                # stale-bounds drain below re-parks them past further
                # watermark advances (which would late-drop them — a
                # divergence from sync mode)
                self._resolve_pending()
        else:
            self._resolve_pending()          # keep emission order
            self._resolve_entry(entry, last=True)
        self._drain_future()

    def _sync_superspan(self) -> None:
        """Resolve a pending fused-superspan entry before dispatching ANY
        new device work on top of it. Its resolve may overflow-replay:
        discard the fused lineage wholesale and rebuild state through the
        per-step path — so a merge scan dispatched meanwhile would resolve
        against the discarded lineage (duplicate emissions, corrupted ring
        bounds) and an ingest into it would be lost with it. The guard
        also keeps the superspan entry the ONLY pending entry when its
        overflow flag is read, which is what lets the replay restore
        `old_state` without reconciling later dispatches."""
        if any("superspan" in e for e in self._pending):
            self._resolve_pending()

    def _resolve_pending(self) -> None:
        pending, self._pending = self._pending, []
        for i, entry in enumerate(pending):
            self._resolve_entry(entry, last=(i == len(pending) - 1))
        if pending:
            # bounds are fresh now: records parked while they were stale can
            # re-enter (or be counted late), matching the sync path's order
            self._drain_future()

    def _resolve_entry(self, entry: dict, last: bool) -> None:
        """Pull one merge's packed emissions, append outputs, and (for the
        latest entry) refresh the ring bounds — merged with any ingest
        that happened after the merge was dispatched."""
        g = self.g
        M, lo, K = entry["M"], entry["lo"], entry["K"]
        arr = entry["packed"].wait()[0].numpy()
        times, blocks, e_n, scal = unpack_sessions(arr, K, M, len(self._vfields))
        lo_rel, hi_rel, ovf = (int(x) for x in scal)
        if ovf:
            if "superspan" not in entry:
                raise RuntimeError(f"a per-watermark session merge overflowed its M = {M} "
                                   "emission slots, one more than its span")
            # a key closed > M sessions across the fused superspan
            # (pathological re-filled-slice churn): discard the fused
            # result wholesale and replay the exact per-step path from
            # the retained pre-dispatch state
            (self._cnt, self._mn, self._mx, self._fields,
             self.ring_lo, self.max_used,
             self.current_watermark) = entry["old_state"]
            self._replay_superspan(*entry["superspan"])
            return
        total = int(e_n.sum())
        if total:
            kk, mm_ = np.nonzero(np.arange(M)[None, :] < e_n[:, None])
            start_ts = lo * g + times[0][mm_, kk]
            end_ts = lo * g + times[1][mm_, kk]
            cnts = blocks[0][mm_, kk]
            fdict = {}
            for j, (name, dt, _s) in enumerate(self._vfields):
                block = np.ascontiguousarray(blocks[1 + j])
                if np.dtype(dt) == np.float32:
                    block = block.view(np.float32)   # undo the bitcast
                fdict[name] = block[mm_, kk]
            for f in self.agg.fields:
                if f.source != VALUE:   # ONE-source fields carry the count
                    fdict[f.name] = cnts
            results = np.asarray(self.agg.extract(fdict))
            # fire order: merged-window end then key id (oracle's timers);
            # rows built from whole columns, not one session at a time
            order = np.lexsort((kk, end_ts))
            kids = kk[order].tolist()
            keys = kids if self._dense else [self.keydict.key_at(k) for k in kids]
            ends = (end_ts[order] + g).tolist()
            tracker = self.emission_tracker
            if tracker is not None:
                for e in ends:
                    tracker.record_fire(e)
            self.output.extend(zip(keys, map(TimeWindow, start_ts[order].tolist(), ends),
                                   results[order].tolist(), [e - 1 for e in ends]))
        if not last:
            return
        resolved = (lo + lo_rel, lo + hi_rel) if hi_rel >= 0 else None
        since = self._since_dispatch
        if resolved is None:
            merged = since
        elif since is None:
            merged = resolved
        else:
            merged = (min(resolved[0], since[0]), max(resolved[1], since[1]))
        self.ring_lo, self.max_used = merged if merged else (None, None)

    def _drain_future(self) -> None:
        if not self._future:
            return
        lo = self.ring_lo
        pending, self._future = self._future, []
        ready_k, ready_v, ready_t = [], [], []
        for k, v, t in pending:
            s = t // self.g
            if lo is None or s < lo + self.S:
                ready_k.append(k)
                ready_v.append(v)
                ready_t.append(t)
                if lo is None:
                    lo = s
            else:
                self._future.append((k, v, t))
        if ready_k:
            self.process_batch(
                np.asarray(ready_k), np.asarray(ready_v, dtype=np.float32),
                np.asarray(ready_t, dtype=np.int64),
            )

    def drain_output(self) -> List[Tuple[Any, Any, Any, int]]:
        if self._pending:
            self._resolve_pending()
        out = self.output
        self.output = []
        return out

    # -- observability gauges ------------------------------------------
    def state_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self._cnt, self._mn, self._mx) + tuple(self._fields))

    def state_key_count(self) -> int:
        return len(self.keydict)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """The JAX package's snapshot form: numpy [K, S] rings, so a
        snapshot restores in either package."""
        if self._pending:
            self._resolve_pending()
        host = lambda t: t.T.contiguous().cpu().numpy()   # noqa: E731
        return {
            "cnt": host(self._cnt),
            "mn": host(self._mn),
            "mx": host(self._mx),
            "fields": [host(f) for f in self._fields],
            "keys": self.keydict.snapshot(),
            "watermark": self.current_watermark,
            "ring_lo": self.ring_lo,
            "max_used": self.max_used,
            "future": [(k, float(v), int(t)) for k, v, t in self._future],
            "num_late_dropped": self.num_late_records_dropped,
            "dense": self._dense,
        }

    def restore(self, snap: dict) -> None:
        ring = lambda a: torch.from_numpy(   # noqa: E731
            np.ascontiguousarray(np.asarray(a).T)).to(self.device)
        self._cnt = ring(snap["cnt"])
        self._mn = ring(snap["mn"])
        self._mx = ring(snap["mx"])
        self._fields = tuple(ring(f) for f in snap["fields"])
        self.K = int(self._cnt.shape[1])
        self.keydict = KeyDictionary.restore(snap["keys"])
        self.current_watermark = snap["watermark"]
        self.ring_lo = snap["ring_lo"]
        self.max_used = snap["max_used"]
        self._future = list(snap["future"])
        self.num_late_records_dropped = snap["num_late_dropped"]
        self._dense = snap.get("dense", False)
        # in-flight deferred scans belong to the pre-restore timeline:
        # resolving them against restored state would replay emissions and
        # corrupt the restored ring bounds
        self._pending = []
        self._since_dispatch = None
