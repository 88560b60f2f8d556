"""NFA over pattern stages (reference: flink-cep nfa/NFA.java — states with
TAKE/IGNORE/PROCEED transitions over shared-buffer runs).

A *run* is a partial match: (stage_index, taken_in_stage, events, start_ts).
On each event, every run branches per the reference's transition semantics:

  TAKE    — event matches the current stage: extend the run
  PROCEED — stage satisfied (>= min_times): also advance to the next stage
            and re-evaluate (epsilon transition)
  IGNORE  — relaxed contiguity: keep the run alive without consuming;
            strict contiguity kills the run on a non-matching event

Completed runs (all stages satisfied) emit {stage_name: [events]}.
`within` prunes runs whose span exceeds the window (timed-out runs die,
matching the reference's timeout pruning; partial-timeout side output is a
later addition).

Counterpart of `flink_tpu/cep/nfa.py`, copied.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from flink_tpu_torch.cep.pattern import Pattern, PatternStage


@dataclasses.dataclass(frozen=True)
class Run:
    stage: int                        # current stage index
    taken: int                        # events taken in the current stage
    events: Tuple[Tuple[str, int, Any], ...]  # (stage_name, event_seq, event)
    start_ts: int

    def to_match(self, pattern: Pattern) -> Dict[str, List[Any]]:
        out: Dict[str, List[Any]] = {s.name: [] for s in pattern.stages}
        for name, _seq, ev in self.events:
            out[name].append(ev)
        return out


class NFA:
    def __init__(self, pattern: Pattern):
        self.pattern = pattern
        self.stages = pattern.stages
        self._auto_seq = 0

    def initial_runs(self) -> List[Run]:
        return []

    def _stage_satisfied(self, stage: PatternStage, taken: int) -> bool:
        return taken >= stage.min_times

    def _stage_can_take(self, stage: PatternStage, taken: int) -> bool:
        return stage.max_times == -1 or taken < stage.max_times

    def advance(
        self, runs: List[Run], event: Any, timestamp: int, seq: int = None
    ) -> Tuple[List[Run], List[Dict[str, List[Any]]]]:
        """Process one event (per key, in timestamp order). `seq` is a
        unique event ordinal distinguishing equal-valued events (match dedup
        is per event *instance*). Returns (surviving runs, matches)."""
        if seq is None:
            seq = self._auto_seq
            self._auto_seq += 1
        self._event_seq = seq
        within = self.pattern.within_ms
        new_runs: List[Run] = []
        matches: List[Dict[str, List[Any]]] = []
        seen: set = set()
        seen_matches: set = set()

        def add_run(run: Run) -> None:
            key = (run.stage, run.taken, run.events)
            if key not in seen:
                seen.add(key)
                new_runs.append(run)

        def emit(run: Run) -> None:
            key = tuple((n, s) for n, s, _ in run.events)
            if key not in seen_matches:
                seen_matches.add(key)
                matches.append(run.to_match(self.pattern))

        # start a fresh run at every event (every event may begin a match)
        candidates = list(runs) + [Run(0, 0, (), timestamp)]

        for run in candidates:
            if within is not None and run.events and timestamp - run.start_ts > within:
                continue  # timed out
            self._branch(run, event, timestamp, add_run, emit)
        return new_runs, matches

    def _after_take(self, run: Run, add_run, emit) -> None:
        """Post-TAKE bookkeeping: emit complete matches, keep loops open,
        eagerly advance satisfied stages (so the NEXT stage's contiguity
        policy governs subsequent events — strict `next` dies on a gap)."""
        stage = self.stages[run.stage]
        last = len(self.stages) - 1
        if run.stage == last:
            if self._stage_satisfied(stage, run.taken):
                emit(run)
                if stage.max_times == -1:
                    add_run(run)  # looping final stage may still grow
            else:
                add_run(run)  # e.g. times(n) not yet reached
            return
        if self._stage_can_take(stage, run.taken):
            add_run(run)  # looping stage stays open
        if self._stage_satisfied(stage, run.taken):
            add_run(Run(run.stage + 1, 0, run.events, run.start_ts))

    def _branch(self, run: Run, event, timestamp, add_run, emit) -> None:
        stage = self.stages[run.stage]
        matched = stage.accepts(event)

        # TAKE in current stage
        if matched and self._stage_can_take(stage, run.taken):
            taken_run = Run(
                run.stage,
                run.taken + 1,
                run.events + ((stage.name, self._event_seq, event),),
                run.start_ts if run.events else timestamp,
            )
            self._after_take(taken_run, add_run, emit)
            return  # took: the run's successors were registered

        # PROCEED (epsilon): satisfied without taking (optional stages) ->
        # evaluate the same event against the next stage
        if run.stage < len(self.stages) - 1 and self._stage_satisfied(stage, run.taken):
            self._branch(
                Run(run.stage + 1, 0, run.events, run.start_ts),
                event, timestamp, add_run, emit,
            )

        # IGNORE: survive a non-matching event?
        if run.taken == 0 and run.stage > 0 and stage.contiguity == "strict":
            return  # strict `next`: a gap kills the run
        if run.events:  # started runs survive under relaxed contiguity
            add_run(run)
