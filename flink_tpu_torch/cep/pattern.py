"""Pattern API (reference: flink-cep .../pattern/Pattern.java).

Supported surface: begin/next (strict contiguity) / followed_by (relaxed
contiguity, skips non-matching events) / where (predicates, ANDed) /
times(n) / one_or_more() (greedy, relaxed-internal) / optional() /
within(ms) — the core of the reference's quantifier model.

Counterpart of `flink_tpu/cep/pattern.py`, copied.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional


@dataclasses.dataclass
class PatternStage:
    name: str
    contiguity: str              # 'strict' | 'relaxed' (first stage: 'relaxed')
    conditions: List[Callable]   # ANDed predicates event -> bool
    min_times: int = 1
    max_times: int = 1           # -1 = unbounded (one_or_more)
    optional: bool = False

    def accepts(self, event) -> bool:
        return all(c(event) for c in self.conditions)


class Pattern:
    def __init__(self, stages: List[PatternStage], within_ms: Optional[int] = None):
        self.stages = stages
        self.within_ms = within_ms

    # -- construction -----------------------------------------------------
    @staticmethod
    def begin(name: str) -> "Pattern":
        return Pattern([PatternStage(name, "relaxed", [])])

    def next(self, name: str) -> "Pattern":
        """Strict contiguity: the very next event must match (Pattern.next)."""
        return Pattern(self.stages + [PatternStage(name, "strict", [])], self.within_ms)

    def followed_by(self, name: str) -> "Pattern":
        """Relaxed contiguity: non-matching events in between are skipped
        (Pattern.followedBy)."""
        return Pattern(self.stages + [PatternStage(name, "relaxed", [])], self.within_ms)

    def where(self, condition: Callable) -> "Pattern":
        last = self.stages[-1]
        new_last = dataclasses.replace(last, conditions=last.conditions + [condition])
        return Pattern(self.stages[:-1] + [new_last], self.within_ms)

    def times(self, n: int) -> "Pattern":
        last = dataclasses.replace(self.stages[-1], min_times=n, max_times=n)
        return Pattern(self.stages[:-1] + [last], self.within_ms)

    def one_or_more(self) -> "Pattern":
        last = dataclasses.replace(self.stages[-1], min_times=1, max_times=-1)
        return Pattern(self.stages[:-1] + [last], self.within_ms)

    def optional(self) -> "Pattern":
        last = dataclasses.replace(self.stages[-1], optional=True, min_times=0)
        return Pattern(self.stages[:-1] + [last], self.within_ms)

    def within(self, ms: int) -> "Pattern":
        return Pattern(list(self.stages), ms)

    def __repr__(self) -> str:
        return "Pattern(" + " -> ".join(s.name for s in self.stages) + ")"
