"""Sharded window state: key-group data parallelism over a mesh.

Counterpart of `flink_tpu/parallel/sharded_window.py`: the multi-shard
form of state/columnar.py. Each shard holds its own rings on its own
device (slice-major [S, K], the layout of the single-device state) and
its own host key dictionary (keys are disjoint across shards by
key-group ownership); ingest, fire and purge run on every shard. They are
XLA programs in the JAX package, so torch code here (B6): segment_ops'
programs, once a shard.

Snapshots keep the JAX package's form, [n, K, S] numpy arrays, so a
snapshot of either package restores into either and, through the
operator's key-group re-routing, onto any shard count.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from flink_tpu_torch.ops import segment_ops
from flink_tpu_torch.ops.aggregators import DeviceAggregator, torch_dtype
from flink_tpu_torch.parallel.mesh import SHARD_AXIS
from flink_tpu_torch.state.columnar import KeyDictionary, RingFrontiers


class ShardedColumnarState:
    """n shards of [S, K] accumulator rings, shard d on mesh.devices[d],
    with one host key dictionary a shard."""

    PURGE_CHUNK = 8

    def __init__(
        self,
        agg: DeviceAggregator,
        mesh,
        *,
        key_capacity: int = 1 << 12,
        num_slices: int = 64,
        dense_int_keys: bool = False,
        axis: str = SHARD_AXIS,
    ):
        self.agg = agg
        self.mesh = mesh
        self.axis = axis
        self.n = mesh.shape[axis]
        self.devices = list(mesh.devices)
        self.K = key_capacity
        self.S = num_slices
        self.keydicts = [KeyDictionary(dense_int_keys) for _ in range(self.n)]
        self.frontiers = RingFrontiers()
        self._init_arrays()
        self.last_touch: Optional[List[segment_ops.Lanes]] = None

    def _init_arrays(self) -> None:
        shards = [segment_ops.init_state_arrays(self.agg, self.K, self.S, d)
                  for d in self.devices]
        self.acc = [a for a, _c in shards]       # per shard {field: [S, K]}
        self.count = [c for _a, c in shards]     # per shard [S, K] int32

    def ensure_key_capacity(self, required: int) -> None:
        if required <= self.K:
            return
        new_k = self.K
        while new_k < required:
            new_k *= 2
        for d in range(self.n):
            self.acc[d], self.count[d] = segment_ops.grow_keys(
                self.acc[d], self.count[d], self.agg, new_k)
        self.K = new_k
        self.last_touch = None

    def ingest(self, kid: np.ndarray, slices_abs: np.ndarray, vals: np.ndarray) -> None:
        """kid/slices/vals are [n, B] routed arrays (INVALID-padded)."""
        f = self.frontiers
        valid = kid != segment_ops.INVALID_INDEX
        live = slices_abs[valid]
        if live.size:
            lo, hi = int(live.min()), int(live.max())
            f.min_used = lo if f.min_used is None else min(f.min_used, lo)
            f.max_used = hi if f.max_used is None else max(f.max_used, hi)
        spos = np.where(valid, slices_abs % self.S, segment_ops.INVALID_INDEX).astype(np.int32)
        touch = []
        for d in range(self.n):
            lanes = segment_ops.stage_lanes(kid[d], spos[d], vals[d], self.K, self.S,
                                            self.devices[d])
            segment_ops.ingest(self.agg, self.acc[d], self.count[d], lanes)
            touch.append(lanes)
        self.last_touch = touch

    def fire(self, slice_range: range, *, touch_mask: bool = False):
        """Per shard (result [K], counts [K], mask [K]) on its device; None
        for a masked fire with nothing ingested since a restore."""
        positions = [s % self.S for s in slice_range]
        if touch_mask and self.last_touch is None:
            return None
        return [segment_ops.fire(self.agg, self.acc[d], self.count[d], positions,
                                 self.last_touch[d] if touch_mask else None)
                for d in range(self.n)]

    def purge_slices(self, slices_abs: List[int]) -> None:
        for i in range(0, len(slices_abs), self.PURGE_CHUNK):
            chunk = slices_abs[i : i + self.PURGE_CHUNK]
            for d in range(self.n):
                segment_ops.purge(self.agg, self.acc[d], self.count[d],
                                  [s % self.S for s in chunk])

    def reset_all(self) -> None:
        self._init_arrays()
        self.last_touch = None

    def state_bytes(self) -> int:
        n = sum(a.numel() * a.element_size() for acc in self.acc for a in acc.values())
        return n + sum(c.numel() * c.element_size() for c in self.count)

    def put_host(self, acc: dict, count: np.ndarray) -> None:
        """Load [n, K, S] host arrays (the snapshot form) onto the shards."""
        self.K = int(count.shape[1])

        def ring(a, d, dt):
            return torch.from_numpy(np.ascontiguousarray(a[d].T)).to(dt).to(self.devices[d])

        self.acc = [{f.name: ring(acc[f.name], d, torch_dtype(f.dtype))
                     for f in self.agg.fields} for d in range(self.n)]
        self.count = [ring(count, d, torch.int32) for d in range(self.n)]
        self.last_touch = None

    def snapshot(self) -> dict:
        def host(t):
            return t.t().contiguous().cpu().numpy()

        return {
            "acc": {f.name: np.stack([host(self.acc[d][f.name]) for d in range(self.n)])
                    for f in self.agg.fields},
            "count": np.stack([host(c) for c in self.count]),
            "keydicts": [d.snapshot() for d in self.keydicts],
            "frontiers": dataclasses.asdict(self.frontiers),
            "n": self.n,
            "K": self.K,
            "S": self.S,
        }


def __getattr__(name):
    """ShardedTpuWindowOperator subclasses the runtime's TpuWindowOperator
    and so lives in runtime/sharded_window_operator.py (the parallel layer
    imports nothing above it); the lazy attribute keeps the JAX package's
    import path working without a module-level runtime edge."""
    if name == "ShardedTpuWindowOperator":
        from flink_tpu_torch.runtime.sharded_window_operator import (
            ShardedTpuWindowOperator,
        )

        return ShardedTpuWindowOperator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
