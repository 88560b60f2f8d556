"""Two rings + the segment cross-match: the fused join pipeline.

Counterpart of `flink_tpu/joins/pipeline.py`. `FusedJoinPipeline` owns
the left and right `BucketRing`s of one keyed join operator and turns a
fired window (or interval frontier) into pairs of ROW IDS: the match
program gathers both sides' bucket runs into per-key slot lanes on the
device, the lanes come back through `utils/device.py::HostCopy`, and the
host expands the per-key cross product into flat (left rowid, right
rowid, key) arrays with vectorized index arithmetic — no per-pair Python
until the caller applies its join function to the payload rows.

Both sides share one `ts_base` (set by the first ingested batch, floored
to the bucket grid) so relative timestamps are comparable across sides —
interval-join deltas are (right rel-ts − left rel-ts) directly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from flink_tpu_torch.joins.ring import BucketRing
from flink_tpu_torch.joins.spec import JoinGeometry
from flink_tpu_torch.ops.join_ring import build_join_match
from flink_tpu_torch.utils.device import HostCopy, resolve_device, staging_buffer, upload


def _excl_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a), dtype=np.int64)
    np.cumsum(a[:-1], out=out[1:])
    return out


def expand_pairs(lidx, lval, ridx, rval):
    """Per-key cross product of valid lanes -> (l_rowids, r_rowids, kids).

    All inputs are host [K, *] arrays read back from the match program;
    the expansion is vectorized end to end (the classic repeat/tile-by-
    group construction), so cost is O(pairs) numpy work, not Python."""
    lval = np.asarray(lval, dtype=bool)
    rval = np.asarray(rval, dtype=bool)
    lcnt = lval.sum(axis=1).astype(np.int64)
    rcnt = rval.sum(axis=1).astype(np.int64)
    pairs = lcnt * rcnt
    total = int(pairs.sum())
    empty = np.empty(0, dtype=np.int64)
    if total == 0:
        return empty, empty, empty
    lflat = np.asarray(lidx)[lval].astype(np.int64)
    rflat = np.asarray(ridx)[rval].astype(np.int64)
    out_l = np.repeat(lflat, np.repeat(rcnt, lcnt))
    kids = np.repeat(np.arange(len(pairs), dtype=np.int64), pairs)
    ordinal = np.arange(total, dtype=np.int64) - np.repeat(_excl_cumsum(pairs), pairs)
    out_r = rflat[_excl_cumsum(rcnt)[kids] + ordinal % rcnt[kids]]
    return out_l, out_r, kids


def match_rings(g: JoinGeometry, device, left, right, rbs_l, cnt_l, rbs_r, cnt_r,
                interval: bool, lo: int, hi: int):
    """The match program over one (idx, ts) ring pair per side on `device`,
    of cnt_l.shape[1] keys: the host-shipped counts and ring slots go up
    in one pinned copy."""
    parts = (cnt_l.ravel(), rbs_l, cnt_r.ravel(), rbs_r)
    ends = np.cumsum([len(p) for p in parts])
    host, staged = staging_buffer((int(ends[-1]),), np.int32, device)
    for p, a, b in zip(parts, np.r_[0, ends[:-1]], ends):
        host[a:b] = p
    dev = upload(staged, device)
    cl, rl, cr, rr = (dev[a:b] for a, b in zip(np.r_[0, ends[:-1]], ends))
    kern = build_join_match(g.ring_buckets, int(cnt_l.shape[1]), g.bucket_capacity,
                            len(rbs_l), len(rbs_r), interval)
    return kern(left[0], left[1], cl.view(len(rbs_l), -1), rl,
                right[0], right[1], cr.view(len(rbs_r), -1), rr, lo, hi)


class FusedJoinPipeline:
    """Single-device orchestration of one device join operator's state."""

    def __init__(self, geom: JoinGeometry, device=None):
        self.geom = geom
        self.device = resolve_device(device)
        self.left = self._new_ring(geom)
        self.right = self._new_ring(geom)
        self.ts_base: Optional[int] = None

    def _new_ring(self, geom: JoinGeometry) -> BucketRing:
        return BucketRing(geom, self.device)

    def regrow(self, geom: JoinGeometry) -> None:
        """Swap to a larger geometry (more key lanes or record slots),
        carrying every resident record over — the rings start SMALL and
        double toward the configured caps, so an idle join never pins
        cap-sized device arrays (the key-capacity growth contract)."""
        snap = self.snapshot()
        self.geom = geom
        # drop the old rings before the new ones allocate
        self.left = self.right = None
        self.left = self._new_ring(geom)
        self.right = self._new_ring(geom)
        base = self.ts_base if self.ts_base is not None else 0
        self.left.restore(snap["left"], base)
        self.right.restore(snap["right"], base)

    # -- ingest ------------------------------------------------------------
    def ingest(self, side: int, kids: np.ndarray, ts: np.ndarray, rows) -> None:
        if len(kids) == 0:
            return
        if self.ts_base is None:
            g = self.geom
            self.ts_base = int(g.offset_ms + g.bucket_of(int(np.min(ts))) * g.bucket_ms)
        ring = self.left if side == 0 else self.right
        ring.ingest(kids, ts, rows, self.ts_base)

    # -- fire --------------------------------------------------------------
    def _window_buckets(self, start: int, end: int) -> np.ndarray:
        g = self.geom
        b0 = (start - g.offset_ms) // g.bucket_ms
        return np.arange(b0, b0 + (end - start) // g.bucket_ms, dtype=np.int64)

    def _match(self, rbs_l, cnt_l, rbs_r, cnt_r, interval: bool, lo: int, hi: int):
        """The match program over both runs."""
        return match_rings(self.geom, self.device, (self.left.idx_arr, self.left.ts_arr),
                           (self.right.idx_arr, self.right.ts_arr),
                           rbs_l, cnt_l, rbs_r, cnt_r, interval, lo, hi)

    def fire_window(self, start: int, end: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Inner window-join emission for [start, end): (left rowids,
        right rowids, dense key ids), per-key cross-product order."""
        buckets = self._window_buckets(start, end)
        rbs_l, cnt_l = self.left.run_counts(buckets)
        rbs_r, cnt_r = self.right.run_counts(buckets)
        if not cnt_l.any() or not cnt_r.any():
            e = np.empty(0, dtype=np.int64)
            return e, e, e
        lidx, _lts, lval, ridx, _rts, rval, _pairs = self._match(
            rbs_l, cnt_l, rbs_r, cnt_r, False, 0, 0)
        lidx, lval, ridx, rval = (t.numpy() for t in HostCopy((lidx, lval, ridx, rval)).wait())
        return expand_pairs(lidx, lval, ridx, rval)

    def match_interval(self, left_buckets, right_buckets, lo_ms: int, hi_ms: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Interval-join emission: pairs over the given bucket runs whose
        (right ts − left ts) lies in [lo_ms, hi_ms]."""
        lb = np.asarray(left_buckets, dtype=np.int64)
        rb = np.asarray(right_buckets, dtype=np.int64)
        rbs_l, cnt_l = self.left.run_counts(lb)
        rbs_r, cnt_r = self.right.run_counts(rb)
        e = np.empty(0, dtype=np.int64)
        if not cnt_l.any() or not cnt_r.any():
            return e, e, e
        lidx, _lts, _lv, ridx, _rts, _rv, _pairs, mask = self._match(
            rbs_l, cnt_l, rbs_r, cnt_r, True, int(lo_ms), int(hi_ms))
        lidx, ridx, mask = (t.numpy() for t in HostCopy((lidx, ridx, mask)).wait())
        k, li, ri = np.nonzero(mask)
        if len(k) == 0:
            return e, e, e
        return (lidx[k, li].astype(np.int64), ridx[k, ri].astype(np.int64),
                k.astype(np.int64))

    # -- bookkeeping -------------------------------------------------------
    def purge_below_window(self, min_live_window_start: int) -> None:
        g = self.geom
        min_bucket = (min_live_window_start - g.offset_ms) // g.bucket_ms
        self.left.purge_below(min_bucket)
        self.right.purge_below(min_bucket)

    def occupancy(self) -> int:
        return self.left.occupancy() + self.right.occupancy()

    def occupied_buckets(self) -> list:
        return sorted(set(self.left.occupied_buckets()) | set(self.right.occupied_buckets()))

    def state_bytes(self) -> int:
        return self.left.state_bytes() + self.right.state_bytes()

    # -- checkpointing -----------------------------------------------------
    def snapshot(self) -> dict:
        return {"ts_base": self.ts_base,
                "left": self.left.snapshot(),
                "right": self.right.snapshot()}

    def restore(self, snap: dict) -> None:
        self.ts_base = snap["ts_base"]
        base = self.ts_base if self.ts_base is not None else 0
        self.left.restore(snap["left"], base)
        self.right.restore(snap["right"], base)
