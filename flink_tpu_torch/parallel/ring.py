"""Ring collectives over a mesh's shards: bandwidth-optimal merges.

Counterpart of `flink_tpu/parallel/ring.py`. The JAX functions run inside
`shard_map` with `ppermute` moving each shard's block to its right
neighbour. The port's mesh has one controller, so each function takes
the shards' tensors as a list (shard i's on devices[i]) and returns a
list, and a `ppermute` step is every shard's block moved to its right
neighbour's device (no copy where the two share a device). The steps and
the order of every combine are the JAX package's, so the results are
its results: n-1 steps each, each moving 1/n of the state.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def _ppermute(xs: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Shard i's tensor to shard (i + 1) % n."""
    n = len(xs)
    return [xs[(j - 1) % n].to(devices[j], non_blocking=True) for j in range(n)]


def ring_reduce_scatter(xs: Sequence[torch.Tensor], devices: Sequence[torch.device],
                        combine=torch.add) -> List[torch.Tensor]:
    """xs[i]: [n, chunk, ...] per shard (chunked along dim 0). Returns
    each shard's fully combined chunk [chunk, ...]: shard me gets chunk me."""
    n = len(xs)
    send = [x[(me - 1) % n] for me, x in enumerate(xs)]
    for k in range(n - 1):
        recv = _ppermute(send, devices)
        send = [combine(recv[me], xs[me][(me - k - 2) % n]) for me in range(n)]
    return send


def ring_all_gather(chunks: Sequence[torch.Tensor], devices: Sequence[torch.device]
                    ) -> List[torch.Tensor]:
    """Every shard ends with all chunks stacked [n, ...]."""
    n = len(chunks)
    outs = []
    for me, c in enumerate(chunks):
        o = torch.zeros((n,) + tuple(c.shape), dtype=c.dtype, device=c.device)
        o[me] = c
        outs.append(o)
    send = list(chunks)
    for k in range(n - 1):
        send = _ppermute(send, devices)
        for me in range(n):
            outs[me][(me - k - 1) % n] = send[me]
    return outs


def ring_all_reduce(xs: Sequence[torch.Tensor], devices: Sequence[torch.device],
                    combine=torch.add) -> List[torch.Tensor]:
    """All-reduce of same-shaped per-shard tensors: chunk along dim 0
    (padded to n), reduce-scatter, all-gather, unpad."""
    n = len(xs)
    rows = xs[0].shape[0]
    pad = (-rows) % n
    chunked = []
    for x in xs:
        if pad:
            x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                                          device=x.device)])
        chunked.append(x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:])))
    mine = ring_reduce_scatter(chunked, devices, combine)
    full = ring_all_gather(mine, devices)
    return [f.reshape((rows + pad,) + tuple(xs[0].shape[1:]))[:rows] for f in full]


def _top_k(v: torch.Tensor, k: int):
    """lax.top_k's order: descending, ties keep the lower index first."""
    vals, idx = torch.sort(v, descending=True, stable=True)
    return vals[:k], idx[:k]


def ring_global_topk(values: Sequence[torch.Tensor], k: int,
                     devices: Sequence[torch.device]):
    """Global top-k across shards by rotating each shard's own candidate
    set around the ring and re-selecting at each hop. values[i]: shard
    i's scores [m]. Returns, per shard, (top-k values [k], owning shard
    [k]), equal on every shard."""
    n = len(values)
    best_v, best_s = [], []
    for me, x in enumerate(values):
        v, _ = _top_k(x, min(k, x.shape[0]))
        if v.shape[0] < k:
            v = torch.cat([v, torch.full((k - v.shape[0],), float("-inf"), dtype=v.dtype,
                                         device=v.device)])
        best_v.append(v)
        best_s.append(torch.full((k,), me, dtype=torch.int32, device=v.device))
    trav_v, trav_s = list(best_v), list(best_s)
    for _ in range(n - 1):
        trav_v, trav_s = _ppermute(trav_v, devices), _ppermute(trav_s, devices)
        for me in range(n):
            allv = torch.cat([best_v[me], trav_v[me]])
            alls = torch.cat([best_s[me], trav_s[me]])
            best_v[me], idx = _top_k(allv, k)
            best_s[me] = alls[idx]
    return list(zip(best_v, best_s))
