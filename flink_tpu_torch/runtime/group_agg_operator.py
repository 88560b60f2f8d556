"""Continuous (non-windowed) group aggregation over a changelog stream.

Counterpart of `flink_tpu/runtime/group_agg_operator.py`. Reference
semantics: `GroupAggFunction` (flink-table-runtime
.../operators/aggregate/GroupAggFunction.java:33): for every input row,
update the key's accumulator and emit the transition on the result
changelog:

  first live row for a key              ->  +I(new result)
  result changed                        ->  -U(old result), +U(new result)
  result unchanged                      ->  nothing (RecordEqualiser check)
  live-row count drops to zero          ->  -D(old result), state dropped
  retraction of a never-seen row        ->  error (corrupt changelog)

Mini-batch emission (`MiniBatchGroupAggFunction`, table.exec.mini-batch.*)
emits one transition per DISTINCT key per input batch; `mini_batch=False`
gives the exact per-record sequence.

Aggregates: COUNT / SUM / AVG retract by sign: the accumulator is a linear
sum, so a batch applies as one signed segment-sum (np.add.at on the host;
one scatter-add plus gathers of the touched keys' old and new values on
the device). MIN / MAX keep the retractable multiset of
`MinWithRetractAggFunction` (value -> multiplicity) as a per-key Counter.

Device path (`device=True`, linear aggregates only): the accumulators are
device columns, `[capacity]` int32 live-row counts, `[n, capacity]`
float32 sums and int32 non-null counts; a batch is one upload, one
scatter-add a column and one readback (`_DeviceLinearState.apply`). No
pow2 padding of the batch or the distinct keys: the JAX package pads to
bound XLA recompiles. COUNT stays exact (int32, wrapping past 2^31 as the
reference does); SUM and AVG accumulate in float32 where the host path
uses float64.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flink_tpu_torch.runtime.executor import StepRunner
from flink_tpu_torch.table.changelog import (
    DELETE,
    INSERT,
    ROW_KIND_FIELD,
    UPDATE_AFTER,
    UPDATE_BEFORE,
    is_additive,
    is_retractive,
    row_kind,
)
from flink_tpu_torch.utils.arrays import obj_array
from flink_tpu_torch.utils.device import HostCopy, staging_buffer, upload

LINEAR_FUNCS = frozenset(("COUNT", "SUM", "AVG"))
MINMAX_FUNCS = frozenset(("MIN", "MAX"))

#: calls of the device step (CPU and CUDA alike)
CALLS: Dict[str, int] = {"group_agg_step": 0}


def device_step(cnt: torch.Tensor, sums: torch.Tensor, nn: torch.Tensor, slots: torch.Tensor,
                signs: torch.Tensor, vals: torch.Tensor, nnvals: torch.Tensor,
                uniq: torch.Tensor):
    """One batch, in place: the distinct keys' (cnt, sums, nn) before the
    signed scatter-add, then after it (the JAX `_DeviceLinearState._fn`
    step)."""
    CALLS["group_agg_step"] += 1
    old = (cnt[uniq], sums[:, uniq], nn[:, uniq])
    idx = slots.long()
    cnt.index_add_(0, idx, signs)
    sums.index_add_(1, idx, signs.to(vals.dtype) * vals)
    nn.index_add_(1, idx, signs * nnvals)
    return old + (cnt[uniq], sums[:, uniq], nn[:, uniq])


class _DeviceLinearState:
    """Linear accumulators as device columns: cnt[capacity] (live rows per
    key), sums[n_linear, capacity] (float32 signed value-sums) and
    nn[n_linear, capacity] (int32 signed non-null counts: COUNT stays exact;
    only SUM/AVG carry float32 rounding)."""

    def __init__(self, n_linear: int, capacity: int, device: torch.device):
        self.device = device
        self.capacity = capacity
        self.cnt = torch.zeros(capacity, dtype=torch.int32, device=device)
        self.sums = torch.zeros((n_linear, capacity), dtype=torch.float32, device=device)
        self.nn = torch.zeros((n_linear, capacity), dtype=torch.int32, device=device)

    def grow(self, capacity: int) -> None:
        def wider(t):
            out = t.new_zeros(t.shape[:-1] + (capacity,))
            out[..., : t.shape[-1]] = t
            return out

        self.cnt, self.sums, self.nn = wider(self.cnt), wider(self.sums), wider(self.nn)
        self.capacity = capacity

    def apply(self, slots: np.ndarray, signs: np.ndarray, vals: np.ndarray,
              nnvals: np.ndarray, uniq: np.ndarray):
        """Returns (old_cnt, old_sums, old_nn, new_cnt, new_sums, new_nn)
        for the `uniq` slots, as numpy."""
        b, u, L = len(slots), len(uniq), vals.shape[0]
        # one pinned upload: slots, signs, uniq, the values' float32 bits,
        # the non-null counts
        host, t = staging_buffer((2 * b + u + 2 * L * b,), np.int32, self.device)
        host[:b], host[b:2 * b], host[2 * b:2 * b + u] = slots, signs, uniq
        lo = 2 * b + u
        host[lo:lo + L * b] = np.ascontiguousarray(vals, np.float32).view(np.int32).reshape(-1)
        host[lo + L * b:] = nnvals.reshape(-1)
        dev = upload(t, self.device)
        out = device_step(self.cnt, self.sums, self.nn, dev[:b], dev[b:2 * b],
                          dev[lo:lo + L * b].view(torch.float32).view(L, b),
                          dev[lo + L * b:].view(L, b), dev[2 * b:2 * b + u].long())
        return tuple(x.numpy() for x in HostCopy(out).wait())

    def zero_slots(self, slots: List[int]) -> None:
        """Clear freed slots so a recycled slot starts clean."""
        host, t = staging_buffer((len(slots),), np.int64, self.device)
        host[:] = slots
        idx = upload(t, self.device)
        self.cnt.index_fill_(0, idx, 0)
        self.sums.index_fill_(1, idx, 0.0)
        self.nn.index_fill_(1, idx, 0)

    def to_host(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return tuple(t.cpu().numpy() for t in (self.cnt, self.sums, self.nn))

    def from_host(self, cnt: np.ndarray, sums: np.ndarray, nn: np.ndarray) -> None:
        self.cnt, self.sums, self.nn = (torch.from_numpy(np.array(a)).to(self.device)
                                        for a in (cnt, sums, nn))
        self.capacity = int(cnt.shape[0])


class GroupAggRunner(StepRunner):
    """StepRunner (terminal kind 'group_agg') keeping per-key accumulators
    and emitting the result changelog. NULL handling follows SQL:
    COUNT(col)/SUM/AVG/MIN/MAX ignore NULL inputs (COUNT(*) counts every
    row); SUM/AVG/MIN/MAX over only-NULL inputs yield NULL."""

    def __init__(self, step, config, device: torch.device):
        from flink_tpu_torch.config import ExecutionOptions

        t = step.terminal
        self.key_selector = t.config["key_selector"]
        self.specs: List[Tuple[str, Optional[str]]] = list(t.config["specs"])
        self.key_fields: List[str] = list(t.config["key_fields"])
        self.out_names: List[str] = list(t.config["out_names"])
        mb = t.config.get("mini_batch")
        self.mini_batch: bool = (
            config.get(ExecutionOptions.MINI_BATCH_GROUP_AGG) if mb is None else mb)
        self.update_before: bool = t.config.get("generate_update_before", True)
        self.uid = t.uid
        for f, _c in self.specs:
            if f not in LINEAR_FUNCS and f not in MINMAX_FUNCS:
                raise ValueError(f"unsupported aggregate {f!r}")
        self._linear_idx = [i for i, (f, _c) in enumerate(self.specs) if f in LINEAR_FUNCS]
        self._minmax_idx = [i for i, (f, _c) in enumerate(self.specs) if f in MINMAX_FUNCS]
        dev = t.config.get("device")
        self.device: bool = (
            config.get(ExecutionOptions.DEVICE_GROUP_AGG) if dev is None else bool(dev))
        if self.device and self._minmax_idx:
            raise ValueError(
                "device group aggregation supports COUNT/SUM/AVG; MIN/MAX "
                "need the retractable multiset (host path)")
        # key -> slot; slots index the accumulator columns
        self._slots: Dict[Any, int] = {}
        self._free: List[int] = []
        self._cap = 1024
        # two linear columns per COUNT/SUM/AVG spec: the signed value-sum
        # (float) and the signed NON-NULL count (integer: exact on both
        # paths; SQL aggregates ignore NULL inputs, and AVG divides by the
        # non-null count, not the live-row count)
        n_lin = len(self._linear_idx)
        if self.device:
            self._dev = _DeviceLinearState(n_lin, self._cap, device)
            self._cnt = self._sums = self._nn = None
        else:
            self._dev = None
            self._cnt = np.zeros(self._cap, dtype=np.int64)
            self._sums = np.zeros((n_lin, self._cap), dtype=np.float64)
            self._nn = np.zeros((n_lin, self._cap), dtype=np.int64)
        # per-key multisets for MIN/MAX: spec idx -> slot -> Counter
        self._msets: Dict[int, Dict[int, Counter]] = {i: {} for i in self._minmax_idx}

    # -- slots --------------------------------------------------------------
    def _slot_of(self, key) -> int:
        slot = self._slots.get(key)
        if slot is not None:
            return slot
        if self._free:
            slot = self._free.pop()
        else:
            slot = len(self._slots)
            # the JAX package keeps one slot spare (its padding lanes' scratch
            # slot); the same rule keeps the two packages' capacities and
            # snapshots alike
            if slot >= self._cap - 1:
                self._cap *= 2
                if self._dev is not None:
                    self._dev.grow(self._cap)
                else:
                    self._cnt = np.resize(self._cnt, self._cap)
                    self._cnt[self._cap // 2:] = 0
                    sums = np.zeros((self._sums.shape[0], self._cap))
                    sums[:, : self._cap // 2] = self._sums
                    self._sums = sums
                    nn = np.zeros((self._nn.shape[0], self._cap), dtype=np.int64)
                    nn[:, : self._cap // 2] = self._nn
                    self._nn = nn
        self._slots[key] = slot
        return slot

    # -- aggregation --------------------------------------------------------
    def _result_of(self, slot: int, cnt: int, sums: np.ndarray,
                   nns: np.ndarray) -> Optional[tuple]:
        """Aggregate outputs for one key given its live-row count, the
        linear sums column and the non-null count column (index j for the
        j-th linear spec)."""
        if cnt <= 0:
            return None
        out: List[Any] = []
        li = 0
        for i, (f, _c) in enumerate(self.specs):
            if f in LINEAR_FUNCS:
                s = float(sums[li])
                nn = int(nns[li])
                if f == "COUNT":
                    out.append(nn)
                elif f == "SUM":
                    out.append(s if nn > 0 else None)
                else:  # AVG
                    out.append(s / nn if nn > 0 else None)
                li += 1
            elif f == "MIN":
                ms = self._msets[i].get(slot)
                out.append(min(ms) if ms else None)
            else:  # MAX
                ms = self._msets[i].get(slot)
                out.append(max(ms) if ms else None)
        return tuple(out)

    def on_batch(self, values: np.ndarray, timestamps: np.ndarray) -> None:
        n = len(timestamps)
        if n == 0:
            return
        ts = np.asarray(timestamps, dtype=np.int64)
        if self.mini_batch:
            self._apply(values, ts)
        else:
            for i in range(n):
                self._apply(values[i:i + 1], ts[i:i + 1])

    def _apply(self, rows, tss) -> None:
        n = len(rows)
        L = len(self._linear_idx)
        slots = np.empty(n, dtype=np.int32)
        signs = np.empty(n, dtype=np.int32)
        vals = np.zeros((L, n), dtype=np.float64)
        nnvals = np.zeros((L, n), dtype=np.int64)
        keys_of: Dict[int, Any] = {}
        for i, row in enumerate(rows):
            kind = row_kind(row)
            if is_additive(kind):
                signs[i] = 1
            elif is_retractive(kind):
                signs[i] = -1
            else:
                raise ValueError(f"unknown row kind {kind!r}")
            key = self.key_selector(row)
            slot = self._slot_of(key)
            slots[i] = slot
            keys_of[slot] = key
            for j, si in enumerate(self._linear_idx):
                f, col = self.specs[si]
                if col is None:                       # COUNT(*)
                    v, nn = 1.0, 1
                else:
                    raw = row.get(col)
                    if raw is None:                   # SQL: NULL is ignored
                        v, nn = 0.0, 0
                    else:
                        v = 1.0 if f == "COUNT" else float(raw)
                        nn = 1
                vals[j, i] = v
                nnvals[j, i] = nn
        _, first_idx = np.unique(slots, return_index=True)
        uniq = slots[np.sort(first_idx)]   # distinct, first-appearance order

        if self._dev is not None:
            (old_cnt, old_sums, old_nn, new_cnt, new_sums,
             new_nn) = self._dev.apply(slots, signs, vals.astype(np.float32),
                                       nnvals.astype(np.int32), uniq)
        else:
            old_cnt = self._cnt[uniq].copy()
            old_sums = self._sums[:, uniq].copy()
            old_nn = self._nn[:, uniq].copy()
            np.add.at(self._cnt, slots, signs)
            np.add.at(self._sums.T, slots, (signs.astype(np.float64) * vals).T)
            np.add.at(self._nn.T, slots, (signs * nnvals).T)
            new_cnt = self._cnt[uniq]
            new_sums = self._sums[:, uniq]
            new_nn = self._nn[:, uniq]

        # old results BEFORE multiset mutation
        old_res = [self._result_of(int(s), int(c), old_sums[:, k], old_nn[:, k])
                   for k, (s, c) in enumerate(zip(uniq, old_cnt))]
        for i in range(n):
            slot = int(slots[i])
            for si in self._minmax_idx:
                _f, col = self.specs[si]
                ms = self._msets[si].setdefault(slot, Counter())
                v = rows[i].get(col)
                if v is None:
                    continue                          # SQL: NULL is ignored
                if signs[i] > 0:
                    ms[v] += 1
                else:
                    if ms[v] <= 0:
                        raise ValueError(
                            f"retraction of unseen value {v!r} for key {keys_of[slot]!r}")
                    ms[v] -= 1
                    if ms[v] == 0:
                        del ms[v]

        out_rows: List[dict] = []
        out_ts: List[int] = []
        dropped: List[int] = []
        ts = int(tss.max())
        for k, slot_np in enumerate(uniq):
            slot = int(slot_np)
            cnt_new = int(new_cnt[k])
            if cnt_new < 0:
                raise ValueError(
                    f"negative live-row count for key {keys_of[slot]!r}: the "
                    "input changelog retracted more rows than it inserted")
            new_res = self._result_of(slot, cnt_new, new_sums[:, k], new_nn[:, k])
            old = old_res[k]
            if old is None and new_res is None:
                dropped.append(self._drop_key(keys_of[slot], slot))
                continue
            if old is None:
                out_rows.append(self._row(keys_of[slot], new_res, INSERT))
                out_ts.append(ts)
            elif new_res is None:
                out_rows.append(self._row(keys_of[slot], old, DELETE))
                out_ts.append(ts)
                dropped.append(self._drop_key(keys_of[slot], slot))
            elif new_res != old:
                if self.update_before:
                    out_rows.append(self._row(keys_of[slot], old, UPDATE_BEFORE))
                    out_ts.append(ts)
                out_rows.append(self._row(keys_of[slot], new_res, UPDATE_AFTER))
                out_ts.append(ts)
        if dropped and self._dev is not None:
            self._dev.zero_slots(dropped)
        if out_rows and self.downstream:
            self.downstream.on_batch(obj_array(out_rows), np.asarray(out_ts, dtype=np.int64))

    def _drop_key(self, key, slot: int) -> int:
        """Count hit zero: free the slot (state retention on delete,
        GroupAggFunction.java's 'state.clear()' branch). The host columns
        are zeroed here; the device columns of a batch's dropped slots in
        one step at its end."""
        del self._slots[key]
        self._free.append(slot)
        for si in self._minmax_idx:
            self._msets[si].pop(slot, None)
        if self._dev is None:
            self._cnt[slot] = 0
            self._sums[:, slot] = 0.0
            self._nn[:, slot] = 0
        return slot

    def _row(self, key, res: tuple, kind: str) -> dict:
        row: Dict[str, Any] = {}
        parts = key if isinstance(key, tuple) and len(self.key_fields) > 1 else (key,)
        for name, part in zip(self.key_fields, parts):
            row[name] = part
        for name, v in zip(self.out_names, res):
            row[name] = v
        row[ROW_KIND_FIELD] = kind
        return row

    # -- checkpointing (the JAX package's form, both ways) ------------------
    def snapshot(self) -> dict:
        cnt, sums, nn = (self._dev.to_host() if self._dev is not None
                         else (self._cnt, self._sums, self._nn))
        return {
            "slots": dict(self._slots),
            "free": list(self._free),
            "cap": self._cap,
            "cnt": np.asarray(cnt).copy(),
            "sums": np.asarray(sums).copy(),
            "nn": np.asarray(nn).copy(),
            "msets": {i: {s: dict(c) for s, c in d.items()} for i, d in self._msets.items()},
        }

    def restore(self, snap: dict) -> None:
        self._slots = dict(snap["slots"])
        self._free = list(snap["free"])
        self._cap = snap["cap"]
        self._msets = {i: {s: Counter(c) for s, c in d.items()}
                       for i, d in snap["msets"].items()}
        if self._dev is not None:
            self._dev.from_host(snap["cnt"].astype(np.int32), snap["sums"].astype(np.float32),
                                snap["nn"].astype(np.int32))
        else:
            self._cnt = snap["cnt"].astype(np.int64).copy()
            self._sums = snap["sums"].astype(np.float64).copy()
            self._nn = snap["nn"].astype(np.int64).copy()
