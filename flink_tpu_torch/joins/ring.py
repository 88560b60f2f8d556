"""One side's per-key time-bucketed ring: device arrays + host occupancy mirror.

Counterpart of `flink_tpu/joins/ring.py`. The device holds two
[NB, K, C] int32 tensors (row index and relative timestamp) on the
operator's device; the host holds the ONLY mutable bookkeeping — per-
(bucket, key) occupancy counts, the absolute bucket id resident in each
ring slot, and the row payloads themselves (device state is row INDICES;
payload rows never cross to the device). Every ingest batch is planned on
the host first — ring slot, key lane, record slot — and every overflow (a
(key, bucket) past its record capacity, or event time running so far
ahead of the watermark that the ring would wrap onto a live bucket)
raises `JoinUnsupported` BEFORE any mirror or device mutation, so the
operator can degrade to the host join by replaying the live rows plus the
whole untouched batch: all-or-nothing per batch, which is what makes
degrade exactly-once.

Fire-time validity is derived from the host-shipped counts, never from
device state, so purging a bucket is pure host bookkeeping (counts to
zero, slot marked free) — no device-side zeroing exists at all.

The host mirror is the JAX package's numpy code line for line; a batch's
five coordinate columns go up in one pinned, non-blocking copy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from flink_tpu_torch.joins.spec import JoinGeometry, JoinUnsupported
from flink_tpu_torch.ops.join_ring import build_join_ingest
from flink_tpu_torch.utils.device import resolve_device, staging_buffer, upload


def _pad_len(n: int) -> int:
    """Dispatch-length bucketing: next power of two, min 256 (the JAX
    package's, which bounds its compiled executables; here it bounds the
    staging buffers' sizes)."""
    return max(256, 1 << (max(n, 1) - 1).bit_length())


class BucketRing:
    """Host mirror + device arrays for one join side."""

    def __init__(self, geom: JoinGeometry, device=None):
        self.geom = geom
        self.device = resolve_device(device)
        self._reset_device()
        self._ingest = build_join_ingest(geom.ring_buckets, geom.key_capacity,
                                         geom.bucket_capacity)
        nb, k = geom.ring_buckets, geom.key_capacity
        # host mirror
        self.cnt = np.zeros((nb, k), dtype=np.int32)
        self.bucket_at = np.full(nb, -1, dtype=np.int64)
        # host row store: rowid -> payload; purged slots are None'd so the
        # payloads are collectable while rowids stay stable for the device
        self._rows: List[Any] = []
        self._row_ts: List[int] = []
        # ring slot -> [(kid, rowid), ...] in ingest order (slot order per
        # (bucket, key) is ingest order, so this is enough to rebuild the
        # device arrays exactly on restore — no device readback needed)
        self._staged: Dict[int, List[Tuple[int, int]]] = {}

    def _zeros(self) -> torch.Tensor:
        g = self.geom
        return torch.zeros((g.ring_buckets, g.key_capacity, g.bucket_capacity),
                           dtype=torch.int32, device=self.device)

    def _reset_device(self) -> None:
        """Fresh (all-zero) device arrays."""
        self.idx_arr, self.ts_arr = self._zeros(), self._zeros()

    def _scatter(self, cols, n: int) -> None:
        """Write one validated batch's lanes — the (ring bucket, key id,
        slot, row id, relative ts) columns — into the device arrays."""
        m = _pad_len(n)
        host, staged = staging_buffer((5, m), np.int32, self.device)
        for row, a in zip(host, cols):
            # int32 lanes, as the JAX package's pad: a row id or relative
            # timestamp past 2**31 raises OverflowError here (ROADMAP Queue C)
            row[:n] = a
            row[n:] = a[-1]           # idempotent re-write of the last lane
        dev = upload(staged, self.device)
        self.idx_arr, self.ts_arr = self._ingest(self.idx_arr, self.ts_arr, *dev)

    # -- ingest ------------------------------------------------------------
    def ingest(self, kids: np.ndarray, ts: np.ndarray, rows, ts_base: int) -> None:
        """Plan, validate, then scatter one batch. Raises JoinUnsupported
        ("join-ring-overflow") with NOTHING mutated on any overflow."""
        n = len(kids)
        if n == 0:
            return
        g = self.geom
        kids = np.asarray(kids, dtype=np.int64)
        ts = np.asarray(ts, dtype=np.int64)
        buckets = (ts - g.offset_ms) // g.bucket_ms
        rb = buckets % g.ring_buckets
        # ring-wrap conflicts: against resident buckets ...
        resident = self.bucket_at[rb]
        if np.any((resident >= 0) & (resident != buckets)):
            err = JoinUnsupported(
                "join-ring-overflow",
                f"event time ran {g.ring_buckets}+ buckets ahead of the "
                f"purge horizon; the ring would wrap onto a live bucket")
            err.overflow = "wrap"
            raise err
        # ... and within the batch itself
        order = np.argsort(rb, kind="stable")
        rbs, bks = rb[order], buckets[order]
        same = rbs[1:] == rbs[:-1]
        if np.any(same & (bks[1:] != bks[:-1])):
            err = JoinUnsupported(
                "join-ring-overflow",
                "one batch spans more event time than the whole ring")
            err.overflow = "wrap"
            raise err
        # slot = resident count + rank within this batch's (bucket, key)
        # group, in arrival order
        grp = rb * np.int64(g.key_capacity) + kids
        gorder = np.argsort(grp, kind="stable")
        gs = grp[gorder]
        starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
        run = np.zeros(n, dtype=np.int64)
        run[starts] = 1
        run = np.cumsum(run) - 1
        rank_sorted = np.arange(n, dtype=np.int64) - starts[run]
        rank = np.empty(n, dtype=np.int64)
        rank[gorder] = rank_sorted
        slot = self.cnt[rb, kids].astype(np.int64) + rank
        if np.any(slot >= g.bucket_capacity):
            worst = int(np.max(slot)) + 1
            err = JoinUnsupported(
                "join-ring-overflow",
                f"a (key, bucket) side needs {worst} record slots but "
                f"execution.join.bucket-capacity is {g.bucket_capacity}")
            err.overflow = "slots"
            err.required = worst
            raise err
        # -- validated: mutate mirror, store rows, dispatch the scatter --
        base = len(self._rows)
        self._rows.extend(rows)
        self._row_ts.extend(int(t) for t in ts)
        np.add.at(self.cnt, (rb, kids), 1)
        self.bucket_at[rb] = buckets
        for i in range(n):
            self._staged.setdefault(int(rb[i]), []).append((int(kids[i]), base + i))
        rowids = np.arange(base, base + n, dtype=np.int64)
        self._scatter((rb, kids, slot, rowids, ts - ts_base), n)

    # -- fire support ------------------------------------------------------
    def run_counts(self, buckets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(ring slots, per-key counts) for one window's bucket run;
        buckets not resident (never filled, or purged) count zero."""
        buckets = np.asarray(buckets, dtype=np.int64)
        rbs = (buckets % self.geom.ring_buckets).astype(np.int32)
        live = self.bucket_at[rbs] == buckets
        cnt = np.where(live[:, None], self.cnt[rbs], 0).astype(np.int32)
        return rbs, cnt

    def row(self, rowid: int) -> Any:
        return self._rows[rowid]

    def take_rows(self, rowids: np.ndarray) -> List[Any]:
        rows = self._rows
        return [rows[i] for i in rowids]

    # -- purge / introspection --------------------------------------------
    def purge_below(self, min_bucket: int) -> None:
        dead = np.flatnonzero((self.bucket_at >= 0) & (self.bucket_at < min_bucket))
        for rb in dead:
            self.cnt[rb] = 0
            self.bucket_at[rb] = -1
            for _kid, rid in self._staged.pop(int(rb), ()):
                self._rows[rid] = None
                self._row_ts[rid] = None

    def occupancy(self) -> int:
        return int(self.cnt.sum())

    def occupied_buckets(self) -> List[int]:
        return [int(b) for b in self.bucket_at[self.bucket_at >= 0]]

    def live_records(self) -> List[Tuple[int, Any, int]]:
        """(kid, row, ts) for every resident record, bucket order then
        ingest order — the degrade-to-host replay set."""
        out = []
        for rb in sorted(self._staged, key=lambda r: int(self.bucket_at[r])):
            for kid, rid in self._staged[rb]:
                out.append((kid, self._rows[rid], self._row_ts[rid]))
        return out

    def state_bytes(self) -> int:
        g = self.geom
        return 2 * 4 * g.ring_buckets * g.key_capacity * g.bucket_capacity

    # -- checkpointing -----------------------------------------------------
    def snapshot(self) -> dict:
        buckets = []
        for rb, ents in self._staged.items():
            buckets.append((int(self.bucket_at[rb]),
                            [(kid, self._rows[rid], self._row_ts[rid]) for kid, rid in ents]))
        buckets.sort(key=lambda b: b[0])
        return {"buckets": buckets}

    def restore(self, snap: dict, ts_base: int) -> None:
        self._reset_device()
        self.cnt[:] = 0
        self.bucket_at[:] = -1
        self._rows, self._row_ts, self._staged = [], [], {}
        for _bucket, ents in snap["buckets"]:
            if not ents:
                continue
            kids = np.asarray([k for k, _r, _t in ents], dtype=np.int64)
            ts = np.asarray([t for _k, _r, t in ents], dtype=np.int64)
            self.ingest(kids, ts, [r for _k, r, _t in ents], ts_base)
