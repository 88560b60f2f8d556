"""Frozen-violation baseline: known debt lives here, explicitly and justified.

The ArchUnit freeze-store analogue (`FreezingArchRule` /
`archunit_store/*.txt` in the reference), with one deliberate tightening:
**every entry must carry a written justification**. An entry without one
is an engine error (exit 2), not a suppression — the file documents *why*
each violation is allowed to live, so the reason itself can be challenged
instead of archaeology-ing the commit history.

Matching is by fingerprint (rule id + project-relative path + enclosing
scope + rule-chosen symbol), never by line number, so a baseline survives
unrelated edits to the same file. Stale entries — fingerprints no rule
reports anymore — are also engine errors: debt that got fixed must leave
the ledger, otherwise the ledger rots into noise.

``python -m flink_tpu_torch.lint --write-baseline`` seeds entries for all
current violations with a ``TODO`` justification that the engine refuses
until a human replaces it.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BASELINE_VERSION = 1
TODO_MARKER = "TODO"


@dataclasses.dataclass
class BaselineEntry:
    rule: str
    path: str
    scope: str
    symbol: str
    justification: str
    line: int = 0          # informational only; never used for matching

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}::{self.path}::{self.scope}::{self.symbol}"

    @property
    def justified(self) -> bool:
        j = self.justification.strip()
        return bool(j) and not j.upper().startswith(TODO_MARKER)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "scope": self.scope,
                "symbol": self.symbol, "line": self.line,
                "justification": self.justification}


class Baseline:
    def __init__(self, entries: Optional[Iterable[BaselineEntry]] = None,
                 path: Optional[pathlib.Path] = None):
        self.path = path
        self.entries: List[BaselineEntry] = list(entries or [])
        self._by_fp: Dict[str, BaselineEntry] = {}
        for e in self.entries:
            self._by_fp[e.fingerprint] = e
        self._matched: set = set()

    def __len__(self) -> int:
        return len(self.entries)

    @classmethod
    def load(cls, path) -> "Baseline":
        path = pathlib.Path(path)
        data = json.loads(path.read_text())
        if data.get("version") != BASELINE_VERSION:
            raise ValueError(
                f"{path}: unsupported baseline version {data.get('version')!r}"
            )
        entries = [BaselineEntry(
            rule=e["rule"], path=e["path"], scope=e.get("scope", ""),
            symbol=e.get("symbol", ""), line=int(e.get("line", 0)),
            justification=e.get("justification", ""),
        ) for e in data.get("entries", [])]
        return cls(entries, path=path)

    def save(self, path=None) -> None:
        target = pathlib.Path(path or self.path)
        entries = sorted(self.entries,
                         key=lambda e: (e.rule, e.path, e.scope, e.symbol))
        doc = {"version": BASELINE_VERSION,
               "entries": [e.to_dict() for e in entries]}
        target.write_text(json.dumps(doc, indent=2, sort_keys=False) + "\n")

    # -- engine interface --------------------------------------------------
    def match(self, violation) -> Optional[BaselineEntry]:
        """The entry suppressing `violation`, marking it live; None when
        the violation is new (and must fail the run)."""
        entry = self._by_fp.get(violation.fingerprint)
        if entry is not None:
            self._matched.add(entry.fingerprint)
        return entry

    def prune_stale(self, project_root,
                    known_rule_ids: Sequence[str]
                    ) -> List[Tuple[BaselineEntry, str]]:
        """Drop entries that can never match again — their file is gone
        or their rule id is no longer registered — and return the pruned
        ``(entry, reason)`` pairs so the caller can warn (and rewrite the
        file with :meth:`save` under ``--prune-baseline``).

        Distinct from :meth:`stale_entries`: that catches *fixed* debt
        after a run (fingerprint reported by no rule), which is an engine
        error demanding human attention; this catches entries that
        structurally cannot match (deleted file, retired rule), which
        previously were carried forever because the engine error pointed
        at a file nobody could re-lint."""
        root = pathlib.Path(project_root)
        known = set(known_rule_ids)
        pruned: List[Tuple[BaselineEntry, str]] = []
        kept: List[BaselineEntry] = []
        for e in self.entries:
            if e.rule not in known:
                pruned.append((e, f"unknown rule {e.rule!r}"))
            elif not (root / e.path).exists():
                pruned.append((e, f"file {e.path} no longer exists"))
            else:
                kept.append(e)
        if pruned:
            self.entries = kept
            self._by_fp = {e.fingerprint: e for e in kept}
        return pruned

    def stale_entries(self) -> List[BaselineEntry]:
        """Entries whose violation no rule reports anymore — fixed debt
        that must be removed from the ledger."""
        return [e for e in self.entries
                if e.fingerprint not in self._matched]

    def add(self, violation, justification: str = "") -> BaselineEntry:
        entry = BaselineEntry(
            rule=violation.rule_id, path=violation.path,
            scope=violation.scope, symbol=violation.symbol,
            line=violation.line,
            justification=justification or
            f"{TODO_MARKER}: justify or fix (added by --write-baseline)")
        self._by_fp[entry.fingerprint] = entry
        self.entries.append(entry)
        return entry
