"""The keyBy exchange between a mesh's shards (B8).

Counterpart of `flink_tpu/ops/exchange.py`. The JAX package shuffles
records with one `lax.all_to_all` over ICI inside a `shard_map` program.
The port's mesh has one controller too (parallel/mesh.py), so the
all-to-all becomes per-pair block copies: shard i's send buffer is split
into n blocks, and block j goes to shard j's device with
`.to(device_j, non_blocking=True)`. Where shards i and j share a device
no copy is made (the block is the received tensor itself); across GPUs
the copy is a peer copy. Shard j receives the blocks concatenated in
source order, so within a destination the lanes stay in
source-shard-then-position order: the global order.

Lane protocol (the JAX package's): each source shard holds B lanes; the
destination of a lane is key_group * n // max_parallelism. Lanes are
routed positionally — block j keeps every lane, the lanes bound elsewhere
masked INVALID (integer columns) or 0 (float columns) — so the exchange
needs no compaction and each shard receives n*B lanes.

`EXCHANGES` counts the exchanges, `COPIES` the blocks that crossed to
another device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from flink_tpu_torch.ops.segment_ops import INVALID_INDEX

#: exchanges run, and blocks copied to another device (same-device blocks
#: are not copied)
EXCHANGES: Dict[str, int] = {"all_to_all": 0, "copies": 0}


def reset_counts() -> None:
    for name in EXCHANGES:
        EXCHANGES[name] = 0


def all_to_all(blocks: Sequence[Sequence[torch.Tensor]], devices: Sequence[torch.device],
               dim: int = 0) -> List[torch.Tensor]:
    """blocks[i][j]: what shard i sends to shard j (on shard i's device).
    Returns recv[j]: the blocks sent to shard j, concatenated along `dim`
    in source order, on devices[j]."""
    n = len(devices)
    EXCHANGES["all_to_all"] += 1
    recv = []
    for j in range(n):
        parts = []
        for i in range(n):
            b = blocks[i][j]
            if b.device != devices[j]:
                EXCHANGES["copies"] += 1
                b = b.to(devices[j], non_blocking=True)
            parts.append(b)
        recv.append(parts[0] if n == 1 else torch.cat(parts, dim=dim))
    return recv


def _pad_of(col: torch.Tensor):
    if col.dtype in (torch.int32, torch.int64):
        return int(INVALID_INDEX)
    return 0


def keyby_exchange_fn(n_shards: int, max_parallelism: int, devices: Sequence[torch.device]):
    """The whole-mesh exchange body: route lanes to their key-group owners.

    fn(key_groups: n tensors [B] int32 (INVALID_INDEX for padding lanes),
       columns: {name: n tensors [B]} to route alongside)
      -> (key groups received: n tensors [n*B], {name: n tensors [n*B]})
    Shard i's inputs lie on devices[i]; its outputs too."""

    def body(key_groups: Sequence[torch.Tensor], columns: Dict[str, Sequence[torch.Tensor]]):
        rows = [torch.arange(n_shards, dtype=torch.int32, device=kg.device)[:, None]
                for kg in key_groups]
        route = []
        for kg, r in zip(key_groups, rows):
            valid = kg != int(INVALID_INDEX)
            dst = torch.where(valid, (kg.long() * n_shards // max_parallelism).to(torch.int32),
                              torch.full_like(kg, -1))
            route.append(r == dst[None, :])                              # [n, B]
        out = {}
        for name, cols in columns.items():
            send = [torch.where(rt, col[None, :], torch.full((), _pad_of(col), dtype=col.dtype,
                                                             device=col.device))
                    for rt, col in zip(route, cols)]                     # [n, B] each
            out[name] = all_to_all([list(s) for s in send], devices)
        kg_send = [torch.where(rt, kg[None, :], torch.full((), int(INVALID_INDEX),
                                                            dtype=kg.dtype, device=kg.device))
                   for rt, kg in zip(route, key_groups)]
        kg_recv = all_to_all([list(s) for s in kg_send], devices)
        return kg_recv, out

    return body


def make_keyby_exchange(mesh, max_parallelism: int, axis_name: str = "shards"):
    """The exchange over `mesh`: fn(key_groups, columns) with per-shard
    lists as `keyby_exchange_fn` takes them."""
    n = mesh.shape[axis_name]
    return keyby_exchange_fn(n, max_parallelism, mesh.devices)
