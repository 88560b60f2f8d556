"""Per-batch programs of the window operators: scatter-combine ingest,
windowed fire, slice purge, as torch code.

Counterpart of `flink_tpu/ops/segment_ops.py`, whose XLA programs have no
Pallas form (ROADMAP B6), so they become torch code on the device:

- `ingest` is `make_ingest_fn` (:60): one `index_add_` a count or sum
  field and one `scatter_reduce_(..., include_self=True)` a min or max
  field, over the flattened cell index, in place;
- `fire` is `make_fire_fn` (:97), plain and `masked`: the window's ring
  rows folded by sum, amin or amax;
- `purge` is `make_purge_fn` (:132): whole rows reset to the identity;
- `init_state_arrays` (:211), `grow_keys` (:220), `masked_top_k` (:200)
  and `bounded_segment_fold` (:165).

The rings are slice-major, `[S, K]` (the JAX package's are `[K, S]`): a
fire reads `spw` contiguous rows and a purge rewrites whole rows, each a
view of the ring, so neither copies positions to the device. A ring
position list is split into its contiguous runs on the host.

Invalid lanes: the JAX programs take `INVALID_INDEX` lanes and drop them
with `mode="drop"`; torch has no drop mode and an out-of-range index is a
device-side assert on CUDA. `stage_lanes` keeps the valid lanes on the
host (a `kid` that is `INVALID_INDEX`, negative or past the key capacity
contributes nothing) and uploads them in one pinned copy, so the device
programs only ever see valid lanes.

The touch mask: the JAX ingest builds a fresh `bool[K, S]` each batch for
the re-fires. Here the staged lanes are the touch: a masked fire marks the
keys of the lanes whose ring position lies in the window, which is what
`take(touch, positions).any()` computes, without a `[K, S]` fill per
batch.

No `lru_cache` of compiled programs and no pow2 batch padding: they bound
XLA recompiles, and padding lanes are invalid anyway. `CALLS` counts the
calls of each program.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_tpu_torch.ops.aggregators import ONE, DeviceAggregator, torch_dtype
from flink_tpu_torch.utils.device import staging_buffer, upload

# the JAX package's invalid-lane sentinel (dropped on the host here)
INVALID_INDEX = np.int32(2**31 - 1)

#: calls of each program (CPU and CUDA alike)
CALLS: Dict[str, int] = {"ingest": 0, "ingest_sort": 0, "fire": 0, "fire_masked": 0,
                         "purge": 0}


def reset_call_counts() -> None:
    for name in CALLS:
        CALLS[name] = 0


class Lanes(NamedTuple):
    """A batch's valid lanes on the device: key ids, ring positions (int32)
    and values. Also the batch's touch: the (key, position) cells it wrote."""

    kid: torch.Tensor
    spos: torch.Tensor
    vals: torch.Tensor

    def cells(self, K: int) -> torch.Tensor:
        """Flat int64 cell index of each lane in a slice-major [S, K] ring."""
        return self.spos.long() * K + self.kid.long()


def stage_lanes(kid: np.ndarray, spos: np.ndarray, vals: np.ndarray, K: int, S: int,
                device: torch.device) -> Lanes:
    """Keep the lanes with 0 <= kid < K and 0 <= spos < S (drops
    INVALID_INDEX lanes) and upload them in one copy (pinned and
    non-blocking on CUDA): the kid, spos and float32 value columns of one
    int32 buffer."""
    kid = np.asarray(kid)
    spos = np.asarray(spos)
    valid = (kid >= 0) & (kid < K) & (spos >= 0) & (spos < S)
    n = int(valid.sum())
    host, t = staging_buffer((3, n), np.int32, device)
    if n == kid.shape[0]:
        host[0], host[1] = kid, spos
        host[2] = np.asarray(vals, np.float32).view(np.int32)
    else:
        host[0], host[1] = kid[valid], spos[valid]
        host[2] = np.asarray(vals, np.float32)[valid].view(np.int32)
    dev = upload(t, device)
    return Lanes(dev[0], dev[1], dev[2].view(torch.float32))


def _source(f, vals: torch.Tensor) -> torch.Tensor:
    dt = torch_dtype(f.dtype)
    if f.source == ONE:
        return torch.ones(vals.shape, dtype=dt, device=vals.device)
    return vals.to(dt)


def _scatter(ring: torch.Tensor, cells: torch.Tensor, src: torch.Tensor, op: str) -> None:
    flat = ring.view(-1)
    if op == "add":
        flat.index_add_(0, cells, src)
    elif op in ("min", "max"):
        flat.scatter_reduce_(0, cells, src, "a" + op, include_self=True)
    else:
        raise ValueError(op)


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

def ingest(agg: DeviceAggregator, acc: Dict[str, torch.Tensor], count: torch.Tensor,
           lanes: Lanes) -> None:
    """Scatter-combine a batch's lanes into the rings, in place (the JAX
    `make_ingest_fn`'s ingest; the lanes are its touch)."""
    CALLS["ingest"] += 1
    if lanes.kid.numel() == 0:
        return
    cells = lanes.cells(count.shape[1])
    for f in agg.fields:
        _scatter(acc[f.name], cells, _source(f, lanes.vals), f.scatter)
    count.view(-1).index_add_(0, cells, torch.ones_like(lanes.kid))


# ---------------------------------------------------------------------------
# fire
# ---------------------------------------------------------------------------

def ring_runs(positions: Sequence[int]) -> List[Tuple[int, int]]:
    """The contiguous runs [a, b) of ring rows in `positions`, in order
    (INVALID_INDEX entries dropped)."""
    runs: List[List[int]] = []
    for p in positions:
        p = int(p)
        if p == INVALID_INDEX:
            continue
        if runs and runs[-1][1] == p:
            runs[-1][1] += 1
        else:
            runs.append([p, p + 1])
    return [(a, b) for a, b in runs]


def _fold_rows(ring: torch.Tensor, runs, op: str) -> torch.Tensor:
    out = None
    for a, b in runs:
        rows = ring[a:b]
        if op == "add":
            part = rows.sum(0, dtype=ring.dtype)
            out = part if out is None else out + part
        elif op == "min":
            part = rows.amin(0)
            out = part if out is None else torch.minimum(out, part)
        elif op == "max":
            part = rows.amax(0)
            out = part if out is None else torch.maximum(out, part)
        else:
            raise ValueError(op)
    return out


def touched_keys(touch: Lanes, runs, K: int) -> torch.Tensor:
    """bool[K]: the keys of the lanes whose ring position lies in `runs`."""
    spos = touch.spos
    inside = torch.zeros(spos.shape, dtype=torch.bool, device=spos.device)
    for a, b in runs:
        inside |= (spos >= a) & (spos < b)
    marks = torch.zeros(K + 1, dtype=torch.bool, device=spos.device)
    # lanes outside the window mark the scratch entry K
    marks[torch.where(inside, touch.kid.long(), K)] = True
    return marks[:K]


def fire(agg: DeviceAggregator, acc: Dict[str, torch.Tensor], count: torch.Tensor,
         positions: Sequence[int], touch: Optional[Lanes] = None):
    """Fold the window's ring rows per key: (result [K], counts int32[K],
    mask bool[K]). The mask is the keys with data in the window; with
    `touch` (the masked fire of a late re-fire) only those the batch
    touched inside the window."""
    CALLS["fire_masked" if touch is not None else "fire"] += 1
    runs = ring_runs(positions)
    combined = {f.name: _fold_rows(acc[f.name], runs, f.scatter) for f in agg.fields}
    cnt = _fold_rows(count, runs, "add")
    mask = cnt > 0
    if touch is not None:
        mask &= touched_keys(touch, runs, count.shape[1])
    result = agg.extract(combined)
    return result.to(torch_dtype(agg.result_dtype)), cnt, mask


# ---------------------------------------------------------------------------
# purge
# ---------------------------------------------------------------------------

def purge(agg: DeviceAggregator, acc: Dict[str, torch.Tensor], count: torch.Tensor,
          positions: Sequence[int]) -> None:
    """Reset the ring rows at `positions` to each field's identity, in place
    (INVALID_INDEX entries dropped): the recycled rows take future slices."""
    CALLS["purge"] += 1
    for a, b in ring_runs(positions):
        for f in agg.fields:
            acc[f.name][a:b].fill_(f.device_identity)
        count[a:b].zero_()


# ---------------------------------------------------------------------------
# state arrays
# ---------------------------------------------------------------------------

def init_state_arrays(agg: DeviceAggregator, K: int, S: int, device):
    """Fresh accumulator rings and count ring, [S, K] each, on `device`."""
    acc = {f.name: torch.full((S, K), f.device_identity, dtype=torch_dtype(f.dtype),
                              device=device)
           for f in agg.fields}
    count = torch.zeros((S, K), dtype=torch.int32, device=device)
    return acc, count


def grow_keys(acc: Dict[str, torch.Tensor], count: torch.Tensor, agg: DeviceAggregator,
              new_k: int):
    """The rings widened to new_k keys, the new keys at the identity."""
    S, K = count.shape
    pad = new_k - K
    new_acc = {}
    for f in agg.fields:
        ring = acc[f.name]
        filler = torch.full((S, pad), f.device_identity, dtype=ring.dtype, device=ring.device)
        new_acc[f.name] = torch.cat([ring, filler], dim=1)
    new_count = torch.cat([count, count.new_zeros((S, pad))], dim=1)
    return new_acc, new_count


# ---------------------------------------------------------------------------
# small folds
# ---------------------------------------------------------------------------

def masked_top_k(values: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k values among masked lanes: (values[k], indices[k]). Unmasked
    lanes rank below everything (-inf / int min); ties keep the lower
    index first, as `lax.top_k` does."""
    if values.is_floating_point():
        neg = float("-inf")
    else:
        neg = torch.iinfo(values.dtype).min
    masked = torch.where(mask, values, torch.full_like(values, neg))
    vals, idx = torch.sort(masked, descending=True, stable=True)
    return vals[:k], idx[:k]


def bounded_segment_fold(vals: torch.Tensor, seg: torch.Tensor, nseg: int, op: str,
                         identity) -> torch.Tensor:
    """Fold a value column into `nseg` per-segment partials with one masked
    whole-column reduction a segment (nseg is small); seg < 0 lanes are
    dropped."""
    ident = torch.full((), identity, dtype=vals.dtype, device=vals.device)
    parts = []
    for s in range(nseg):
        lane = torch.where(seg == s, vals, ident)
        if op == "add":
            parts.append(lane.sum(dtype=vals.dtype))
        elif op == "min":
            parts.append(lane.amin())
        elif op == "max":
            parts.append(lane.amax())
        else:
            raise ValueError(op)
    return torch.stack(parts)
