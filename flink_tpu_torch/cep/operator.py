"""CepOperator: keyed NFA evaluation with event-time ordering.

Reference semantics (flink-cep .../operator/CepOperator.java:83): in event
time, elements are buffered per key in a priority queue and fed to the NFA
in timestamp order when the watermark passes them (:processElement buffers,
:onEventTime drains up to the watermark); per-key NFA state lives in keyed
state and is part of snapshots.

Counterpart of `flink_tpu/cep/operator.py`, copied.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

from flink_tpu_torch.cep.nfa import NFA, Run
from flink_tpu_torch.cep.pattern import Pattern
from flink_tpu_torch.core.time import MIN_WATERMARK


class CepOperator:
    """Duck-types the window-operator runner interface (process_record /
    process_watermark / drain_output / snapshot / restore)."""

    def __init__(self, pattern: Pattern, select_fn: Optional[Callable] = None):
        self.pattern = pattern
        self.nfa = NFA(pattern)
        self.select_fn = select_fn or (lambda match: match)
        self._buffers: Dict[Any, List[Tuple[int, int, Any]]] = {}  # key -> heap
        self._runs: Dict[Any, List[Run]] = {}
        self._seq = 0
        self.current_watermark = MIN_WATERMARK
        self.output: List[Tuple[Any, Any, Any, int]] = []
        self.side_output: Dict[str, List] = {}
        self.num_late_records_dropped = 0

    def process_record(self, key, value, timestamp: int) -> None:
        if timestamp <= self.current_watermark:
            self.num_late_records_dropped += 1  # late events are dropped (ref)
            return
        heapq.heappush(self._buffers.setdefault(key, []), (timestamp, self._seq, value))
        self._seq += 1

    def process_watermark(self, watermark: int) -> None:
        if watermark <= self.current_watermark:
            return
        for key, heap in self._buffers.items():
            runs = self._runs.get(key, [])
            while heap and heap[0][0] <= watermark:
                ts, _, event = heapq.heappop(heap)
                runs, matches = self.nfa.advance(runs, event, ts)
                for m in matches:
                    self.output.append((key, None, self.select_fn(m), ts))
            self._runs[key] = runs
        self.current_watermark = watermark

    def advance_processing_time(self, time: int) -> None:
        pass

    def drain_output(self):
        out = self.output
        self.output = []
        return out

    # -- snapshot ---------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "buffers": {k: list(v) for k, v in self._buffers.items()},
            "runs": {
                k: [(r.stage, r.taken, list(r.events), r.start_ts) for r in v]
                for k, v in self._runs.items()
            },
            "watermark": self.current_watermark,
            "seq": self._seq,
            "late": self.num_late_records_dropped,
        }

    def restore(self, snap: dict) -> None:
        self._buffers = {k: list(map(tuple, v)) for k, v in snap["buffers"].items()}
        for h in self._buffers.values():
            heapq.heapify(h)
        self._runs = {
            k: [Run(s, t, tuple(map(tuple, ev)), st) for (s, t, ev, st) in v]
            for k, v in snap["runs"].items()
        }
        self.current_watermark = snap["watermark"]
        self._seq = snap["seq"]
        self.num_late_records_dropped = snap["late"]
        self.output = []
