"""Device programs of the two-input keyed join ring, as torch code.

Counterpart of `flink_tpu/ops/join_ring.py`, whose two jitted XLA
programs have no Pallas form (ROADMAP B5), so they become torch code on
the device:

- `build_join_ingest` (:48) is one `index_put_` (no accumulate) of a
  staged batch of host-planned (ring bucket, key id, slot) coordinates
  into both `[NB, K, C]` int32 ring arrays, in place;
- `build_join_match` (:70) gathers one fired window's (or interval
  frontier's) bucket run from both rings and lays each side out as
  `[K, nb*C]` slot lanes, with validity from the host-shipped
  occupancy counts (never from device state, so a purged bucket needs
  no device-side zeroing). The window form returns the per-key pair
  counts `lcnt * rcnt`; the interval form also the `[K, L, R]` pair
  mask restricted by the relative-time bound.

One function per geometry, cached as the JAX package's `lru_cache` does,
so operators of one shape share it. `CALLS` counts the calls of each
program (CPU and CUDA alike).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import torch

__all__ = ["CALLS", "build_join_ingest", "build_join_match", "reset_call_counts"]

#: calls of each program (CPU and CUDA alike)
CALLS: Dict[str, int] = {"join_ingest": 0, "join_match": 0, "join_match_interval": 0}


def reset_call_counts() -> None:
    for name in CALLS:
        CALLS[name] = 0


@lru_cache(maxsize=None)
def build_join_ingest(NB: int, K: int, C: int):
    """Scatter of one staged batch into a side's ring arrays, in place.

    fn(idx_arr [NB,K,C] i32, ts_arr [NB,K,C] i32,
       rb [n] i32, kid [n] i32, slot [n] i32, rowidx [n] i32, tsrel [n] i32)
      -> (idx_arr, ts_arr)

    Coordinates are host-planned and in bounds (the host mirror raised on
    overflow before dispatch), so the JAX program's `mode="drop"` has no
    counterpart here. Real lanes never collide: the host plans a unique
    slot per (bucket, key) record. Padding lanes rewrite the last real
    lane with equal values. So CUDA's unordered writes of duplicate
    indices (`index_put_` without accumulate) cannot change a result."""

    def ingest(idx_arr, ts_arr, rb, kid, slot, rowidx, tsrel):
        CALLS["join_ingest"] += 1
        cell = (rb.long() * K + kid.long()) * C + slot.long()
        idx_arr.view(-1).index_put_((cell,), rowidx)
        ts_arr.view(-1).index_put_((cell,), tsrel)
        return idx_arr, ts_arr

    return ingest


@lru_cache(maxsize=None)
def build_join_match(NB: int, K: int, C: int, n_lb: int, n_rb: int, interval: bool):
    """Gather + cross-match over one fired window's bucket run.

    fn(idx_l, ts_l [NB,K,C], cnt_l [n_lb,K] i32, rbs_l [n_lb] i32,
       idx_r, ts_r [NB,K,C], cnt_r [n_rb,K] i32, rbs_r [n_rb] i32,
       lo, hi)
      -> window join: (lidx [K,L], lts [K,L], lval [K,L] bool,
                       ridx [K,R], rts [K,R], rval [K,R] bool,
                       pairs [K] i32)
      -> interval:    the same, plus mask [K,L,R] bool where the pair's
                      rel-time delta (rts - lts) lies in [lo, hi]

    L = n_lb*C, R = n_rb*C. For the window join the mask is implied by
    the validity lanes (the full per-key cross product), so it is never
    built."""

    def lanes(idx_arr, ts_arr, cnt, rbs, nb):
        r = rbs.long()
        # [nb, K, C] -> [K, nb*C]: per-key slot lanes over the run
        gi = idx_arr[r].permute(1, 0, 2).reshape(K, nb * C)
        gt = ts_arr[r].permute(1, 0, 2).reshape(K, nb * C)
        # valid: [K, nb, C] -> [K, nb*C], matching the gather layout
        slots = torch.arange(C, dtype=torch.int32, device=idx_arr.device)
        valid = slots[None, None, :] < cnt.t()[:, :, None]
        return gi, gt, valid.reshape(K, nb * C)

    def match(idx_l, ts_l, cnt_l, rbs_l, idx_r, ts_r, cnt_r, rbs_r, lo, hi):
        CALLS["join_match_interval" if interval else "join_match"] += 1
        lidx, lts, lval = lanes(idx_l, ts_l, cnt_l, rbs_l, n_lb)
        ridx, rts, rval = lanes(idx_r, ts_r, cnt_r, rbs_r, n_rb)
        lcnt = lval.sum(dim=1, dtype=torch.int32)
        rcnt = rval.sum(dim=1, dtype=torch.int32)
        if not interval:
            return lidx, lts, lval, ridx, rts, rval, lcnt * rcnt
        delta = rts[:, None, :] - lts[:, :, None]           # [K, L, R]
        mask = lval[:, :, None] & rval[:, None, :] & (delta >= lo) & (delta <= hi)
        pairs = mask.sum(dim=(1, 2), dtype=torch.int32)
        return lidx, lts, lval, ridx, rts, rval, pairs, mask

    return match
