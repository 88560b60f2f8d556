"""Regular (non-windowed) streaming equi-join over changelog streams.

Counterpart of `flink_tpu/runtime/stream_join_operator.py` (host code,
line for line), over the port's `table/changelog.py`.

Reference: `StreamingJoinOperator`
(flink-table-runtime .../operators/join/stream/StreamingJoinOperator.java:40)
— both sides buffer EVERY live row per join key indefinitely; an arriving
row joins against the opposite side's current buffer and emits immediately;
a retraction removes its row from the buffer and retracts the joins it had
produced. Without an upsert key the output changelog uses +I / -D only
(the reference's "retract stream" join mode; JoinRecordStateViews
.InputSideHasNoUniqueKey keeps row -> appearance-count, exactly the
multiset kept here).

Inner join only matches; LEFT/RIGHT OUTER additionally emit (row, NULL)
paddings when the opposite buffer is empty and retract them when the first
match arrives (StreamingJoinOperator.processElement outerRecord handling).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from flink_tpu_torch.table.changelog import (
    DELETE,
    INSERT,
    ROW_KIND_FIELD,
    is_additive,
    is_retractive,
    row_kind,
    strip_kind,
)
from flink_tpu_torch.runtime.executor import StepRunner
from flink_tpu_torch.utils.arrays import obj_array


def _freeze(row: dict) -> Tuple:
    return tuple(sorted(row.items()))


class StreamingJoinRunner(StepRunner):
    """StepRunner (terminal kind 'regular_join'). Inherits the two-gate
    valve: watermarks min-combine across the inputs and on_end fires only
    after BOTH sides end (StatusWatermarkValve semantics — a finished
    dimension side must not flush downstream state while the other side is
    still joining)."""

    num_inputs = 2

    def __init__(self, step, config):
        t = step.terminal
        self.key_selectors = (t.config["key_selector1"],
                              t.config["key_selector2"])
        self.merge_fn: Callable[[dict, dict], dict] = t.config["merge_fn"]
        self.join_type: str = t.config.get("join_type", "inner")
        if self.join_type not in ("inner", "left", "right"):
            # typed + attributed, never a bare job-build crash: FULL OUTER
            # is a catalogued refusal the SQL front door surfaces with the
            # same reason code (joins/spec.py, docs/joins.md)
            from flink_tpu_torch.joins.spec import JoinUnsupported

            if self.join_type == "full":
                raise JoinUnsupported(
                    "join-full-outer",
                    "FULL OUTER JOIN is not supported: neither the host "
                    "StreamingJoinRunner nor the device join ring "
                    "implements two-sided padding retraction")
            raise ValueError(f"unsupported join type {self.join_type!r}")
        # per side: a schema-shaped all-NULL row used to pad the opposite
        # side of an unmatched outer row (fields present, values None — so
        # downstream predicates/projections see SQL NULL, not a missing key)
        self.null_rows: Tuple[dict, dict] = tuple(
            t.config.get("null_rows") or ({}, {}))
        self.uid = t.uid
        # per side: key -> {frozen_row: [row, count]}
        self._state: Tuple[Dict, Dict] = ({}, {})
        # outer-side keys currently padded with NULLs: key -> {frozen: [row, count]}
        self._padded: Dict[Any, Dict] = {}
        self._out: List[dict] = []
        self._out_ts: List[int] = []

    def on_batch(self, values, timestamps) -> None:  # pragma: no cover
        raise AssertionError("StreamingJoinRunner consumes via input gates")

    # -- join ----------------------------------------------------------------
    def _merge(self, ordinal: int, mine: dict, other: dict) -> dict:
        return (self.merge_fn(mine, other) if ordinal == 0
                else self.merge_fn(other, mine))

    def _emit(self, row: dict, kind: str, ts: int) -> None:
        out = dict(row)
        out[ROW_KIND_FIELD] = kind
        self._out.append(out)
        self._out_ts.append(ts)

    def _outer_side(self) -> int:
        return {"left": 0, "right": 1}.get(self.join_type, -1)

    def _null_pad(self, ordinal: int, row: dict) -> dict:
        """(row, NULL) padding for the outer side: merge against the
        opposite side's all-NULL schema row."""
        return self._merge(ordinal, row, self.null_rows[1 - ordinal])

    def on_batch_n(self, ordinal: int, values, timestamps) -> None:
        ks = self.key_selectors[ordinal]
        mine, other = self._state[ordinal], self._state[1 - ordinal]
        outer = self._outer_side()
        for v, ts_np in zip(values, np.asarray(timestamps, dtype=np.int64)):
            ts = int(ts_np)
            kind = row_kind(v)
            row = strip_kind(v)
            key = ks(row)
            f = _freeze(row)
            # SQL equi-join: NULL never matches (not even NULL = NULL) —
            # a NULL-keyed row joins nothing; on the outer side it stays a
            # NULL-padded row for its whole lifetime
            if key is None and ordinal != outer:
                # on every OTHER side (both sides of an inner join, the
                # non-outer side of an outer join) a NULL-keyed row can
                # never match and never pads: buffering it would only grow
                # state without bound under NULL-keyed streams, so inserts
                # and their retractions pass through without touching state
                if not (is_additive(kind) or is_retractive(kind)):
                    raise ValueError(f"unknown row kind {kind!r}")
                continue
            matches = None if key is None else other.get(key)
            if is_additive(kind):
                if matches:
                    for orow, cnt in matches.values():
                        joined = self._merge(ordinal, row, orow)
                        for _ in range(cnt):
                            self._emit(joined, INSERT, ts)
                    if ordinal != outer and 1 - ordinal == outer:
                        # first match(es) arrived for padded outer rows:
                        # retract their NULL paddings
                        padded = self._padded.pop(key, None)
                        if padded:
                            for orow, cnt in padded.values():
                                pad = self._null_pad(1 - ordinal, orow)
                                for _ in range(cnt):
                                    self._emit(pad, DELETE, ts)
                elif ordinal == outer:
                    self._emit(self._null_pad(ordinal, row), INSERT, ts)
                    slot = self._padded.setdefault(key, {})
                    ent = slot.setdefault(f, [row, 0])
                    ent[1] += 1
                bucket = mine.setdefault(key, {})
                ent = bucket.setdefault(f, [row, 0])
                ent[1] += 1
            elif is_retractive(kind):
                bucket = mine.get(key)
                if bucket is None or f not in bucket:
                    raise ValueError(
                        f"join input retracts a row that is not buffered: "
                        f"{row!r}")
                ent = bucket[f]
                ent[1] -= 1
                if ent[1] == 0:
                    del bucket[f]
                    if not bucket:
                        del mine[key]
                if matches:
                    for orow, cnt in matches.values():
                        joined = self._merge(ordinal, row, orow)
                        for _ in range(cnt):
                            self._emit(joined, DELETE, ts)
                elif ordinal == outer:
                    self._emit(self._null_pad(ordinal, row), DELETE, ts)
                padded = self._padded.get(key)
                if padded is not None and ordinal == outer and f in padded:
                    padded[f][1] -= 1
                    if padded[f][1] == 0:
                        del padded[f]
                        if not padded:
                            del self._padded[key]
                if key is not None and 1 - ordinal == outer and (
                        bucket is None or key not in mine):
                    # this side's buffer for the key just emptied: the outer
                    # side's surviving rows fall back to NULL paddings
                    surv = other.get(key)
                    if surv:
                        for orow, cnt in surv.values():
                            pad = self._null_pad(1 - ordinal, orow)
                            for _ in range(cnt):
                                self._emit(pad, INSERT, ts)
                            slot = self._padded.setdefault(key, {})
                            ent2 = slot.setdefault(_freeze(orow), [orow, 0])
                            ent2[1] += cnt
            else:
                raise ValueError(f"unknown row kind {kind!r}")
        self._flush()

    def _flush(self) -> None:
        if self._out and self.downstream:
            self.downstream.on_batch(
                obj_array(self._out),
                np.asarray(self._out_ts, dtype=np.int64))
        self._out, self._out_ts = [], []

    # -- checkpointing -------------------------------------------------------
    def snapshot(self) -> dict:
        def dump(side):
            return {k: {f: (row, cnt) for f, (row, cnt) in b.items()}
                    for k, b in side.items()}

        return {"left": dump(self._state[0]), "right": dump(self._state[1]),
                "padded": dump(self._padded)}

    def restore(self, snap: dict) -> None:
        def load(d):
            return {k: {f: [row, cnt] for f, (row, cnt) in b.items()}
                    for k, b in d.items()}

        self._state = (load(snap["left"]), load(snap["right"]))
        self._padded = load(snap.get("padded", {}))
