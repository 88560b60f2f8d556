"""Device global-window operator with count-based triggers.

Counterpart of `flink_tpu/runtime/tpu_global_window_operator.py`.
GlobalWindows + CountTrigger (the Nexmark Q7-style keyed pre-aggregation
pattern: GlobalWindows.java + CountTrigger.java, fired per key every N
elements, optionally purging via PurgingTrigger) on per-key device
columns: after each batch's ingest, the keys whose count reached N fire in
one masked extract, and purging resets exactly the fired keys, one step
(`step`, the JAX `_make_step` :35) a batch.

Batching semantics (the reference's documented deviation, kept): a key
crossing several multiples of N within one batch fires once, with its
current accumulator, not once per multiple. With one record a batch the
two coincide.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.api.windowing.assigners import GlobalWindow
from flink_tpu_torch.api.windowing.triggers import CountTrigger, PurgingTrigger
from flink_tpu_torch.core.time import MAX_WATERMARK, MIN_WATERMARK
from flink_tpu_torch.lint.contracts import inflight_ring
from flink_tpu_torch.ops import segment_ops
from flink_tpu_torch.ops.aggregators import DeviceAggregator, resolve, torch_dtype
from flink_tpu_torch.state.columnar import KeyDictionary
from flink_tpu_torch.utils.device import HostCopy, resolve_device, staging_buffer, upload

#: calls of the step (CPU and CUDA alike)
CALLS: Dict[str, int] = {"global_count_step": 0}


def step(agg: DeviceAggregator, acc: Dict[str, torch.Tensor], count: torch.Tensor,
         fired: torch.Tensor, kid: torch.Tensor, vals: torch.Tensor, n: int, purge: bool):
    """Ingest a batch's valid lanes and fire, in place: (result [K],
    mask bool[K]). `count` counts elements since the last purge; `fired`
    holds the count at the last fire of a non-purging trigger (fire when
    the count crosses a new multiple of n)."""
    CALLS["global_count_step"] += 1
    cell = kid.long()
    for f in agg.fields:
        segment_ops._scatter(acc[f.name], cell, segment_ops._source(f, vals), f.scatter)
    count.index_add_(0, cell, torch.ones_like(kid))
    mask = count >= n if purge else (count // n) > (fired // n)
    # a copy: the extract may be a field itself, which the purge resets
    result = agg.extract(acc).to(torch_dtype(agg.result_dtype), copy=True)
    if purge:
        for f in agg.fields:
            acc[f.name].masked_fill_(mask, f.device_identity)
        count.masked_fill_(mask, 0)
    else:
        fired.copy_(torch.where(mask, count, fired))
    return result, mask


def supported_trigger(trigger) -> Optional[Tuple[int, bool]]:
    """(n, purging) when the trigger is CountTrigger or
    PurgingTrigger(CountTrigger); None otherwise."""
    if isinstance(trigger, PurgingTrigger) and isinstance(trigger.inner, CountTrigger):
        return trigger.inner.max_count, True
    if isinstance(trigger, CountTrigger):
        return trigger.max_count, False
    return None


@inflight_ring("_pending", drained_by="flush")
class TpuGlobalWindowOperator:
    """Duck-types the window-operator runner interface."""

    _WINDOW = GlobalWindow()
    # the emission-latency plane (ROADMAP item 15): stays None on the port
    emission_tracker = None

    def __init__(
        self,
        aggregate,
        *,
        count_n: int,
        purging: bool,
        key_capacity: int = 1 << 12,
        dense_int_keys: bool = False,
        device=None,
    ):
        agg = resolve(aggregate)
        if agg is None:
            raise ValueError(f"{aggregate!r} has no device form")
        self.agg = agg
        self.n = count_n
        self.purging = purging
        self.K = key_capacity
        self.device = resolve_device(device)
        self.keydict = KeyDictionary(dense_int_keys)
        self._init_arrays()
        self.current_watermark = MIN_WATERMARK
        self._pending: List[Tuple[Any, Any, int]] = []
        self.output: List[Tuple[Any, Any, Any, int]] = []
        self.side_output: Dict[str, List] = {}
        self.num_late_records_dropped = 0

    def _init_arrays(self) -> None:
        self.acc = {f.name: torch.full((self.K,), f.device_identity, dtype=torch_dtype(f.dtype),
                                       device=self.device) for f in self.agg.fields}
        self.count = torch.zeros(self.K, dtype=torch.int32, device=self.device)
        self.fired = torch.zeros(self.K, dtype=torch.int32, device=self.device)

    def _grow(self, required: int) -> None:
        if required <= self.K:
            return
        new_k = self.K
        while new_k < required:
            new_k *= 2
        pad = new_k - self.K
        for f in self.agg.fields:
            a = self.acc[f.name]
            self.acc[f.name] = torch.cat([a, torch.full((pad,), f.device_identity, dtype=a.dtype,
                                                        device=a.device)])
        self.count = torch.cat([self.count, self.count.new_zeros(pad)])
        self.fired = torch.cat([self.fired, self.fired.new_zeros(pad)])
        self.K = new_k

    # -- runner interface --------------------------------------------------
    def process_record(self, key, value, timestamp: int) -> None:
        self._pending.append((key, value, timestamp))

    def process_batch(self, keys: np.ndarray, values: np.ndarray, timestamps) -> None:
        self.flush()
        self._ingest(keys, values.astype(np.float32))

    def flush(self) -> None:
        if not self._pending:
            return
        pend, self._pending = self._pending, []
        keys = np.empty(len(pend), dtype=object)
        keys[:] = [p[0] for p in pend]
        vals = np.asarray([p[1] for p in pend], dtype=np.float32)
        self._ingest(keys, vals)

    def _ingest(self, keys: np.ndarray, vals: np.ndarray) -> None:
        if len(keys) == 0:
            return
        ids, required = self.keydict.lookup_or_insert(keys)
        self._grow(required)
        # one pinned upload of the key ids and the float32 values' bits
        host, t = staging_buffer((2, len(ids)), np.int32, self.device)
        host[0] = ids
        host[1] = vals.view(np.int32)
        lanes = upload(t, self.device)
        result, mask = step(self.agg, self.acc, self.count, self.fired, lanes[0],
                            lanes[1].view(torch.float32), self.n, self.purging)
        idx_t = torch.nonzero(mask).squeeze(1)      # reads the mask's size back
        if idx_t.numel() == 0:
            return
        idx, res = (t.numpy() for t in HostCopy([idx_t, result[idx_t]]).wait())
        key_at = self.keydict.key_at
        self.output.extend((key_at(i), self._WINDOW, v, MAX_WATERMARK)
                           for i, v in zip(idx.tolist(), res.tolist()))

    def process_watermark(self, watermark: int) -> None:
        self.flush()
        self.current_watermark = max(self.current_watermark, watermark)

    def advance_processing_time(self, time: int) -> None:
        pass

    def drain_output(self):
        out = self.output
        self.output = []
        return out

    # -- observability gauges ---------------------------------------------
    def state_bytes(self) -> int:
        arrays = list(self.acc.values()) + [self.count, self.fired]
        return sum(a.numel() * a.element_size() for a in arrays)

    def state_key_count(self) -> int:
        return len(self.keydict)

    # -- snapshot (the JAX package's form, both ways) ----------------------
    def snapshot(self) -> dict:
        self.flush()
        return {
            "acc": {k: v.cpu().numpy().copy() for k, v in self.acc.items()},
            "count": self.count.cpu().numpy().copy(),
            "fired": self.fired.cpu().numpy().copy(),
            "keydict": self.keydict.snapshot(),
            "K": self.K,
            "watermark": self.current_watermark,
        }

    def restore(self, snap: dict) -> None:
        def col(a):
            return torch.from_numpy(np.array(a)).to(self.device)

        self.K = snap["K"]
        self.acc = {k: col(v) for k, v in snap["acc"].items()}
        self.count = col(snap["count"])
        self.fired = col(snap["fired"])
        self.keydict = KeyDictionary.restore(snap["keydict"])
        self.current_watermark = snap["watermark"]
        self._pending = []
        self.output = []
