"""Segment histograms: count and weighted sum per segment id (B7).

Counterpart of `flink_tpu/ops/matmul_hist.py`. On the TPU the scatter of
records into segments is re-expressed as one-hot matrix products so it
lands on the MXU instead of the slow scatter unit. Those are XLA programs,
not Pallas kernels, and the GPU scatters natively: here they are one
`torch.bincount` (counts) and one `index_add_` (sums) under the same names
and contracts, so a caller of either package gets the same segments.

Out-of-range segment ids (idx < 0 or >= num_segments) contribute nothing,
the INVALID_INDEX drop of segment_ops.
"""

from __future__ import annotations

import torch


def _live(idx: torch.Tensor, num_segments: int) -> torch.Tensor:
    return (idx >= 0) & (idx < num_segments)


def count_hist(idx: torch.Tensor, num_segments: int, *, chunk: int = 8192) -> torch.Tensor:
    """int32[num_segments] counts of idx values; out-of-range ids dropped.
    `chunk` is the JAX package's staging granule and is not needed here."""
    live = idx[_live(idx, num_segments)].long()
    return torch.bincount(live, minlength=num_segments).to(torch.int32)


def weighted_hist(idx: torch.Tensor, vals: torch.Tensor, num_segments: int, *,
                  chunk: int = 8192, exact: bool = True) -> torch.Tensor:
    """float32[num_segments] per-segment sums of vals; out-of-range ids
    dropped. exact=True adds each float32 value as it is (the JAX
    package's three-term bf16 split reaches the same: every value enters
    the float32 accumulator unquantized); exact=False rounds each value to
    bf16 once, as the JAX package's single-term form does. The sum is a
    float32 accumulation in some order, bit-equal to the JAX package's for
    integer-valued payloads."""
    keep = _live(idx, num_segments)
    v = vals[keep].to(torch.float32)
    if not exact:
        v = v.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros(num_segments, dtype=torch.float32, device=idx.device)
    out.index_add_(0, idx[keep].long(), v)
    return out

