"""Mesh variant of the fused join pipeline: rings split over keys.

Counterpart of `flink_tpu/joins/sharded.py`. Both sides' [NB, K, C] ring
arrays are split along the KEY axis over the mesh's shards, so each shard
owns the SAME contiguous key range for both inputs — the two-sides-one-
owner layout (co-partitioning both sides removes cross-shard match
traffic). Ingest routes each validated (key lane, slot) write to the shard
owning its key; the match program is per key throughout, so it runs on
each shard over its own key range with no exchange, and the shards'
[K_local, ...] lanes concatenate along the key axis into the single-ring
pipeline's [K, ...] result.

The host mirror (occupancy counts, resident buckets, row payloads) stays
whole and global; only the device arrays split. The mesh size is clamped
by `usable_mesh_size` (the key capacity must divide evenly).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from flink_tpu_torch.joins.pipeline import FusedJoinPipeline, match_rings
from flink_tpu_torch.joins.ring import BucketRing, _pad_len
from flink_tpu_torch.joins.spec import JoinGeometry
from flink_tpu_torch.ops.join_ring import build_join_ingest
from flink_tpu_torch.parallel.mesh import SHARD_AXIS
from flink_tpu_torch.utils.device import staging_buffer, upload


class ShardedBucketRing(BucketRing):
    """One join side's ring with the device arrays split over the shards:
    shard d holds keys [d * K_local, (d + 1) * K_local)."""

    def __init__(self, geom: JoinGeometry, mesh):
        self.devices: List[torch.device] = list(mesh.devices)
        self.K_local = geom.key_capacity // len(self.devices)
        super().__init__(geom, self.devices[0])
        self._ingest = build_join_ingest(geom.ring_buckets, self.K_local, geom.bucket_capacity)

    def _reset_device(self) -> None:
        g = self.geom
        shape = (g.ring_buckets, self.K_local, g.bucket_capacity)
        self.idx_arrs = [torch.zeros(shape, dtype=torch.int32, device=d) for d in self.devices]
        self.ts_arrs = [torch.zeros(shape, dtype=torch.int32, device=d) for d in self.devices]

    def _scatter(self, cols, n: int) -> None:
        rb, kids, slot, rowids, tsrel = cols
        shard = kids // self.K_local
        for d, dev in enumerate(self.devices):
            sel = np.flatnonzero(shard == d)
            if sel.size == 0:
                continue
            m = _pad_len(sel.size)
            host, staged = staging_buffer((5, m), np.int32, dev)
            for row, a in zip(host, (rb[sel], kids[sel] - d * self.K_local, slot[sel],
                                     rowids[sel], tsrel[sel])):
                row[:sel.size] = a
                row[sel.size:] = a[-1]     # idempotent re-write of the last lane
            lanes = upload(staged, dev)
            self.idx_arrs[d], self.ts_arrs[d] = self._ingest(
                self.idx_arrs[d], self.ts_arrs[d], *lanes)


class ShardedJoinPipeline(FusedJoinPipeline):
    """FusedJoinPipeline with key-split ring placement on a mesh."""

    def __init__(self, geom: JoinGeometry, mesh):
        n = mesh.shape[SHARD_AXIS]
        if geom.key_capacity % n != 0:
            raise ValueError(
                f"key capacity {geom.key_capacity} does not divide over {n} shards "
                "(usable_mesh_size must clamp the mesh before building the join pipeline)")
        self.mesh = mesh
        super().__init__(geom, mesh.devices[0])

    @property
    def num_shards(self) -> int:
        return self.mesh.shape[SHARD_AXIS]

    def _new_ring(self, geom: JoinGeometry) -> BucketRing:
        return ShardedBucketRing(geom, self.mesh)

    def _match(self, rbs_l, cnt_l, rbs_r, cnt_r, interval: bool, lo: int, hi: int):
        """The match per shard over its key range; the shards' per-key
        lanes concatenate along the key axis on the first shard's device."""
        Kl = self.left.K_local
        outs = []
        for d, dev in enumerate(self.mesh.devices):
            keys = slice(d * Kl, (d + 1) * Kl)
            outs.append(match_rings(
                self.geom, dev, (self.left.idx_arrs[d], self.left.ts_arrs[d]),
                (self.right.idx_arrs[d], self.right.ts_arrs[d]),
                rbs_l, np.ascontiguousarray(cnt_l[:, keys]), rbs_r,
                np.ascontiguousarray(cnt_r[:, keys]), interval, lo, hi))
        dev0 = self.mesh.devices[0]
        return tuple(torch.cat([o[i].to(dev0) for o in outs]) for i in range(len(outs[0])))
