"""Sort-based ingest: the alternative to the scatter-combine ingest for
batches whose records pile onto few cells (key skew).

Counterpart of `flink_tpu/ops/sorted_ingest.py::make_sorted_ingest_fn`
(:54): sort the lanes by flat cell index, combine each run of equal cells
(`_segment_combine_sorted`, :33, an inclusive segmented scan there; a
segment reduce over the run offsets here), then write once per distinct
cell, so no two writes meet on one address. An operator option
(`ingest_kernel="sort"`); it gives the same cells as `segment_ops.ingest`
(float sums bit-equal on integer-valued payloads, as any reordering of
adds). Unlike the scatter form it reads one number back: the run count,
whose offsets size the segment reduce (one host sync a batch).
"""

from __future__ import annotations

from typing import Dict

import torch

from flink_tpu_torch.ops import segment_ops
from flink_tpu_torch.ops.aggregators import ONE, DeviceAggregator, torch_dtype
from flink_tpu_torch.ops.segment_ops import Lanes

_REDUCE = {"add": "sum", "min": "min", "max": "max"}


def _segment_combine_sorted(values: torch.Tensor, offsets: torch.Tensor,
                            op: str) -> torch.Tensor:
    """The combine of each run of a sorted column, runs delimited by
    `offsets` (int64, first lane of each run, then the lane count).
    Integer columns reduce in float64 (exact for int32 values and for
    sums below 2^53) and wrap back to their width."""
    if values.is_floating_point():
        return torch.segment_reduce(values, _REDUCE[op], offsets=offsets)
    out = torch.segment_reduce(values.double(), _REDUCE[op], offsets=offsets)
    return out.long().to(values.dtype)


def sorted_ingest(agg: DeviceAggregator, acc: Dict[str, torch.Tensor], count: torch.Tensor,
                  lanes: Lanes) -> None:
    """Same contract as `segment_ops.ingest`, sort-based internals."""
    segment_ops.CALLS["ingest_sort"] += 1
    B = lanes.kid.numel()
    if B == 0:
        return
    flat_s, order = torch.sort(lanes.cells(count.shape[1]))
    last = torch.ones(B, dtype=torch.bool, device=flat_s.device)
    last[:-1] = flat_s[1:] != flat_s[:-1]
    ends = torch.nonzero(last).squeeze(1)          # the one host sync
    offsets = torch.cat([ends.new_zeros(1), ends + 1])
    cells = flat_s[ends]
    runs = (offsets[1:] - offsets[:-1]).to(torch.int32)
    vals_s = lanes.vals[order]
    for f in agg.fields:
        if f.source == ONE and f.scatter == "add":
            seg = runs.to(torch_dtype(f.dtype))
        else:
            seg = _segment_combine_sorted(segment_ops._source(f, vals_s), offsets, f.scatter)
        segment_ops._scatter(acc[f.name], cells, seg, f.scatter)
    count.view(-1).index_add_(0, cells, runs)
