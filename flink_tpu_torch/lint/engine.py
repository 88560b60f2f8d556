"""The lint engine: run the registry over an index, apply the baseline.

Exit-code contract (CI-friendly, mirrors the CLI):

- 0 — clean: no unbaselined violations, no baseline errors
- 1 — violations: at least one finding not covered by a justified entry
- 2 — baseline/config errors: an entry without a written justification,
  a stale entry (its violation no longer exists), or an unparseable
  source file — states where the *ledger* is wrong, which must not be
  conflated with (or masked by) code findings
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Optional, Sequence, Tuple

from flink_tpu_torch.lint.baseline import Baseline, BaselineEntry
from flink_tpu_torch.lint.index import ModuleIndex
from flink_tpu_torch.lint.rule import Rule, Violation, all_rules

EXIT_CLEAN = 0
EXIT_VIOLATIONS = 1
EXIT_BASELINE_ERROR = 2


@dataclasses.dataclass
class LintReport:
    root: pathlib.Path
    rules: List[Rule]
    violations: List[Violation]                      # active (fail the run)
    suppressed: List[Tuple[Violation, BaselineEntry]]
    baseline_errors: List[str]
    modules_scanned: int

    @property
    def exit_code(self) -> int:
        if self.baseline_errors:
            return EXIT_BASELINE_ERROR
        if self.violations:
            return EXIT_VIOLATIONS
        return EXIT_CLEAN

    def by_rule(self, rule_id: str) -> List[Violation]:
        return [v for v in self.violations if v.rule_id == rule_id]


def run_lint(root, package: Optional[str] = None,
             rules: Optional[Sequence[Rule]] = None,
             baseline: Optional[Baseline] = None,
             index: Optional[ModuleIndex] = None) -> LintReport:
    """Run `rules` (default: the full registry) over the package at
    `root`, suppressing findings matched by justified baseline entries."""
    index = index or ModuleIndex(pathlib.Path(root), package=package)
    rules = list(rules) if rules is not None else all_rules()
    baseline_errors: List[str] = []
    for fail in index.parse_failures:
        baseline_errors.append(
            f"{fail.rel}:{fail.line}: cannot parse: {fail.error}")

    active: List[Violation] = []
    suppressed: List[Tuple[Violation, BaselineEntry]] = []
    for rule in rules:
        for violation in rule.check(index):
            entry = baseline.match(violation) if baseline is not None else None
            if entry is None:
                active.append(violation)
            elif not entry.justified:
                baseline_errors.append(
                    f"baseline entry {entry.fingerprint} has no written "
                    f"justification — justify it or fix the violation")
                suppressed.append((violation, entry))
            else:
                suppressed.append((violation, entry))

    if baseline is not None:
        # stale detection is only meaningful against the full registry —
        # a filtered run would call every other rule's entries stale
        full_run = {r.id for r in rules} >= {r.id for r in all_rules()}
        if full_run:
            for entry in baseline.stale_entries():
                baseline_errors.append(
                    f"stale baseline entry {entry.fingerprint}: the "
                    f"violation no longer exists — remove it from the "
                    f"baseline")

    active.sort(key=lambda v: (v.path, v.line, v.rule_id))
    return LintReport(root=index.root, rules=rules, violations=active,
                      suppressed=suppressed, baseline_errors=baseline_errors,
                      modules_scanned=len(index.modules))
