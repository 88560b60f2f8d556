"""Host-routed multi-shard window operator over a mesh.

Counterpart of `flink_tpu/runtime/sharded_window_operator.py`.
`ShardedTpuWindowOperator` inherits all window/slice math and the
watermark protocol from the single-shard TpuWindowOperator, overriding
the state plumbing with `parallel/sharded_window.ShardedColumnarState`:
each batch routes per key group on the host (the reference's
KeyGroupRangeAssignment: shard = key_group * n // max_parallelism, with
the JAX package's `hash_keys`), and every shard ingests, fires and purges
on its own device. It lives in `runtime/` (not `parallel/`) because it
subclasses a runtime operator.

Snapshots are the JAX package's (`sharded`: [n, K, S] arrays and one key
dictionary a shard); restore re-routes every key to its new owner, so a
snapshot of either package restores onto any shard count.
"""

from __future__ import annotations

import numpy as np

from flink_tpu_torch.api.functions import LATE_DATA_TAG
from flink_tpu_torch.core.keygroups import key_groups_for_hashes
from flink_tpu_torch.core.records import hash_keys
from flink_tpu_torch.core.time import MIN_WATERMARK
from flink_tpu_torch.lint.contracts import inflight_ring
from flink_tpu_torch.ops import segment_ops
from flink_tpu_torch.parallel.mesh import SHARD_AXIS
from flink_tpu_torch.parallel.sharded_window import ShardedColumnarState
from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator
from flink_tpu_torch.state.columnar import KeyDictionary, RingFrontiers
from flink_tpu_torch.utils.device import HostCopy


@inflight_ring("_pending", drained_by="flush")
class ShardedTpuWindowOperator(TpuWindowOperator):
    """Host-routed multi-shard operator; inherits all window/slice math and
    the watermark protocol from the single-shard operator, overriding the
    state plumbing to route per key group and emit from all shards."""

    def __init__(self, assigner, aggregate, mesh, *, max_parallelism: int = 128,
                 axis: str = SHARD_AXIS, **kwargs):
        self.mesh = mesh
        self.axis = axis
        self.max_parallelism = max_parallelism
        dense = kwargs.pop("dense_int_keys", False)
        key_capacity = kwargs.pop("key_capacity", 1 << 12)
        num_slices = kwargs.pop("num_slices", None)
        for unsupported in ("hot_key_capacity", "cold_tier_dir"):
            if kwargs.get(unsupported) is not None:
                raise ValueError(f"{unsupported} does not apply to the sharded operator")
        kwargs["device"] = mesh.devices[0]
        super().__init__(assigner, aggregate, key_capacity=key_capacity,
                         num_slices=num_slices, dense_int_keys=dense, **kwargs)
        # replace the single-shard state with the sharded one (same interface)
        self.state = ShardedColumnarState(
            self.agg, mesh, key_capacity=key_capacity, num_slices=self.S,
            dense_int_keys=dense, axis=axis)
        self.n_shards = self.state.n

    # -- routed ingest --------------------------------------------------
    def _shard_of(self, keys: np.ndarray) -> np.ndarray:
        kg = key_groups_for_hashes(hash_keys(keys), self.max_parallelism)
        return (kg.astype(np.int64) * self.n_shards // self.max_parallelism).astype(np.int32)

    def _route(self, keys: np.ndarray, s_abs: np.ndarray, vals: np.ndarray):
        """Partition a host batch into [n, B] INVALID-padded routed arrays."""
        shard = self._shard_of(keys)
        counts = np.bincount(shard, minlength=self.n_shards)
        B = max(int(counts.max()) if counts.size else 0, 1)
        B = 1 << (B - 1).bit_length()  # pow2: few staging shapes
        kid = np.full((self.n_shards, B), segment_ops.INVALID_INDEX, dtype=np.int64)
        sl = np.zeros((self.n_shards, B), dtype=np.int64)
        vl = np.zeros((self.n_shards, B), dtype=np.float32)
        required = 0
        for d in range(self.n_shards):
            idx = np.flatnonzero(shard == d)
            if idx.size == 0:
                continue
            ids, req = self.state.keydicts[d].lookup_or_insert(keys[idx])
            required = max(required, req)
            kid[d, : idx.size] = ids
            sl[d, : idx.size] = s_abs[idx]
            vl[d, : idx.size] = vals[idx]
        self.state.ensure_key_capacity(required)
        return kid, sl, vl

    def _ingest_arrays(self, keys: np.ndarray, vals: np.ndarray, ts: np.ndarray) -> None:
        if len(ts) == 0:
            return
        wm = self.current_watermark
        s_abs = self.slice_of_np(ts)
        if wm > MIN_WATERMARK:
            late = s_abs < self.min_live_slice(wm)
        else:
            late = np.zeros(len(ts), dtype=bool)
        if late.any():
            if self.emit_late_to_side_output:
                lt = self.side_output.setdefault(LATE_DATA_TAG.tag_id, [])
                for i in np.flatnonzero(late):
                    lt.append((keys[i], float(vals[i]), int(ts[i])))
            else:
                self.num_late_records_dropped += int(late.sum())
        keep = ~late
        if not keep.any():
            return
        floor = self._ring_floor(int(s_abs[keep].min()))
        over = keep & (s_abs >= floor + self.S)
        if over.any():
            for i in np.flatnonzero(over):
                self._future.append((keys[i], vals[i], int(ts[i])))
            keep = keep & ~over
            if not keep.any():
                return

        kid, sl, vl = self._route(keys[keep], s_abs[keep], vals[keep].astype(np.float32))
        self.state.ingest(kid.astype(np.int32), sl, vl)

        live_slices = s_abs[keep]
        cand = self.j_oldest(int(live_slices.min()))
        if wm > MIN_WATERMARK:
            cand = max(cand, self.j_fired_upto(wm) + 1)
        self.fire_cursor = cand if self.fire_cursor is None else min(self.fire_cursor, cand)

        if wm > MIN_WATERMARK:
            fired_hi = self.j_fired_upto(wm)
            lo = max(self.j_oldest(int(live_slices.min())), self.j_min_live(wm))
            hi = min(self.j_newest(int(live_slices.max())), fired_hi)
            for j in range(lo, hi + 1):
                self._emit_window(j, touch_mask=True)

    # -- sharded emission -----------------------------------------------
    # (stamps no emission latency, as the JAX sharded operator stamps none:
    # a mesh per-batch job's emissionLatencyMs stays empty, ROADMAP Queue C)
    def _emit_window(self, j: int, *, touch_mask: bool) -> None:
        window = self.window_of(j)
        start_slice = j * self.sl
        fired = self.state.fire(range(start_slice, start_slice + self.spw),
                                touch_mask=touch_mask)
        if fired is None:
            return
        host = HostCopy([t for res, _cnt, mask in fired for t in (res, mask)]).wait()
        result_np = np.stack([host[2 * d].numpy() for d in range(self.n_shards)])
        mask_np = np.stack([host[2 * d + 1].numpy() for d in range(self.n_shards)])
        if not mask_np.any():
            return
        ts = window.max_timestamp()
        if self.columnar_output:
            self.output.append((None, window, (mask_np, result_np), ts))
            return
        for d in range(self.n_shards):
            keydict = self.state.keydicts[d]
            for i in np.flatnonzero(mask_np[d]):
                self.output.append((keydict.key_at(int(i)), window, result_np[d, i].item(), ts))

    # -- gauges over the shards ------------------------------------------
    def state_key_count(self) -> int:
        return sum(len(d) for d in self.state.keydicts)

    # -- snapshot / restore / rescale ------------------------------------
    def snapshot(self) -> dict:
        self.flush()
        return {
            "sharded": self.state.snapshot(),
            "watermark": self.current_watermark,
            "fire_cursor": self.fire_cursor,
            "future": [(k, float(v), int(t)) for k, v, t in self._future],
            "num_late_dropped": self.num_late_records_dropped,
            "max_parallelism": self.max_parallelism,
        }

    def restore(self, snap: dict) -> None:
        """Restore with key-group re-routing: works across different shard
        counts (rescale) because keys re-route by key group."""
        src = snap["sharded"]
        self.current_watermark = snap["watermark"]
        self.fire_cursor = snap["fire_cursor"]
        self._future = list(snap["future"])
        self.num_late_records_dropped = snap["num_late_dropped"]
        self._pending = []
        self.output = []
        self.state.frontiers = RingFrontiers(**src["frontiers"])
        if src["S"] != self.S:
            raise ValueError("slice-ring size change across restore is unsupported")

        # host-side re-route of every key's accumulator row
        n_old = src["n"]
        K = self.state.K
        acc_h = {f.name: np.full((self.n_shards, K, self.S), f.device_identity,
                                 dtype=f.device_dtype) for f in self.agg.fields}
        cnt_h = np.zeros((self.n_shards, K, self.S), dtype=np.int32)
        new_dicts = [KeyDictionary(self.state.keydicts[0].dense_int)
                     for _ in range(self.n_shards)]
        for d_old in range(n_old):
            kd = KeyDictionary.restore(src["keydicts"][d_old])
            if len(kd) == 0:
                continue
            keys = np.asarray(kd._keys, dtype=object)
            new_shard = self._shard_of(keys)
            for d_new in range(self.n_shards):
                idx = np.flatnonzero(new_shard == d_new)
                if idx.size == 0:
                    continue
                ids, req = new_dicts[d_new].lookup_or_insert(keys[idx])
                if req > cnt_h.shape[1]:
                    grow = cnt_h.shape[1]
                    while grow < req:
                        grow *= 2
                    pad = grow - cnt_h.shape[1]
                    for f in self.agg.fields:
                        filler = np.full((self.n_shards, pad, self.S), f.device_identity,
                                         dtype=f.device_dtype)
                        acc_h[f.name] = np.concatenate([acc_h[f.name], filler], axis=1)
                    cnt_h = np.concatenate(
                        [cnt_h, np.zeros((self.n_shards, pad, self.S), np.int32)], axis=1)
                for f in self.agg.fields:
                    acc_h[f.name][d_new, ids, :] = src["acc"][f.name][d_old, idx, :]
                cnt_h[d_new, ids, :] = src["count"][d_old, idx, :]
        self.state.keydicts = new_dicts
        self.state.put_host(acc_h, cnt_h)
