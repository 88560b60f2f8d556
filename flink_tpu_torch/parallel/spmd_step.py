"""The whole-mesh SPMD window step: keyBy exchange → scatter ingest →
window fire → global merge, over every shard at once.

Counterpart of `flink_tpu/parallel/spmd_step.py`, whose one `shard_map`
program becomes torch code over the mesh's shards: the exchange is
ops/exchange.py's block copies, each shard's ingest and fire run on its
device, and the global merge (the JAX package's `psum` over the mesh) is
a sum of the shards' window counts. These are XLA programs in the JAX
package, so they are torch code here (B6, B8).

Key ids are globally dense (source-assigned), so owner shards index state
rows directly after the exchange. State keeps the JAX package's layout at
this function's surface: per shard, [K, S] rings.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import torch

from flink_tpu_torch.ops.aggregators import ONE, DeviceAggregator, torch_dtype
from flink_tpu_torch.ops.exchange import keyby_exchange_fn


def _scatter_2d(ring: torch.Tensor, kid: torch.Tensor, spos: torch.Tensor,
                src: torch.Tensor, op: str) -> torch.Tensor:
    """ring.at[kid, spos].<op>(src, mode='drop') on a [K, S] ring, out of
    place (the JAX program's functional update)."""
    K, S = ring.shape
    keep = (kid >= 0) & (kid < K) & (spos >= 0) & (spos < S)
    cell = (kid.long() * S + spos.long())[keep]
    out = ring.clone().view(-1)
    if op == "add":
        out.index_add_(0, cell, src[keep])
    else:
        out.scatter_reduce_(0, cell, src[keep], "a" + op, include_self=True)
    return out.view(K, S)


@functools.lru_cache(maxsize=None)
def make_spmd_step(mesh, max_parallelism: int, agg: DeviceAggregator, axis: str = "shards"):
    """Build the whole-mesh step.

    step(acc {f: n [K, S]}, count n [K, S] int32,
         key_groups n [B] i32, kid n [B] i32 (global dense), spos n [B] i32,
         vals n [B] f32, fire_positions [spw] i32)
      -> (acc', count', result n [K], mask n [K], global_count n scalars)
    Each list holds one tensor a shard, on that shard's device."""
    n = mesh.shape[axis]
    exchange = keyby_exchange_fn(n, max_parallelism, mesh.devices)

    def step(acc: Dict[str, Sequence[torch.Tensor]], count: Sequence[torch.Tensor],
             key_groups, kid, spos, vals, fire_positions):
        # 1. the keyBy exchange between the shards
        _kg_r, cols = exchange(key_groups, {"kid": kid, "spos": spos, "vals": vals})
        new_acc: Dict[str, List[torch.Tensor]] = {f.name: [] for f in agg.fields}
        new_count, results, masks, cnts = [], [], [], []
        for d in range(n):
            kid_r, spos_r, vals_r = cols["kid"][d], cols["spos"][d], cols["vals"][d]
            # 2. scatter-combine ingest into this shard's cells
            acc1 = {}
            for f in agg.fields:
                dt = torch_dtype(f.dtype)
                src = (torch.ones(vals_r.shape, dtype=dt, device=vals_r.device)
                       if f.source == ONE else vals_r.to(dt))
                acc1[f.name] = _scatter_2d(acc[f.name][d], kid_r, spos_r, src, f.scatter)
                new_acc[f.name].append(acc1[f.name])
            c1 = _scatter_2d(count[d], kid_r, spos_r,
                             torch.ones(kid_r.shape, dtype=count[d].dtype,
                                        device=kid_r.device), "add")
            new_count.append(c1)
            # 3. window fire: fold the window's slice columns
            pos = torch.as_tensor(fire_positions, device=c1.device).long()
            combined = {}
            for f in agg.fields:
                cols_f = acc1[f.name][:, pos]
                combined[f.name] = (cols_f.sum(1, dtype=cols_f.dtype) if f.scatter == "add"
                                    else cols_f.amin(1) if f.scatter == "min"
                                    else cols_f.amax(1))
            cnt = c1[:, pos].sum(1, dtype=torch.int32)
            masks.append(cnt > 0)
            results.append(agg.extract(combined).to(torch_dtype(agg.result_dtype)))
            cnts.append(cnt.sum())
        # 4. the global merge across shards (the JAX package's psum)
        total = sum(int(c) for c in cnts)
        global_count = [torch.tensor(total, dtype=torch.int32, device=d) for d in mesh.devices]
        return new_acc, new_count, results, masks, global_count

    return step
