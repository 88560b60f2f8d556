"""``python -m flink_tpu_torch.lint`` — run the analyzer from the shell / CI.

Usage:
    python -m flink_tpu_torch.lint                       # lint flink_tpu_torch/ + baseline
    python -m flink_tpu_torch.lint --format sarif        # SARIF 2.1.0 to stdout
    python -m flink_tpu_torch.lint --rule CONC002        # one rule family member
    python -m flink_tpu_torch.lint --list-rules          # registry catalog
    python -m flink_tpu_torch.lint --write-baseline      # freeze current findings
    python -m flink_tpu_torch.lint path/to/pkg --no-baseline

Exit codes: 0 clean, 1 violations, 2 baseline/config errors (see
engine.py). ``--write-baseline`` seeds entries with a TODO justification
the engine refuses until a human writes the real reason — freezing debt
is explicit, not a side effect.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional

from flink_tpu_torch.lint.baseline import Baseline
from flink_tpu_torch.lint.engine import (
    EXIT_BASELINE_ERROR,
    EXIT_CLEAN,
    LintReport,
    run_lint,
)
from flink_tpu_torch.lint.rule import all_rules, get_rule

DEFAULT_BASELINE_NAME = "lint_baseline_torch.json"


def _default_root() -> pathlib.Path:
    import flink_tpu_torch

    return pathlib.Path(flink_tpu_torch.__file__).parent


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m flink_tpu_torch.lint",
        description="ArchUnit-style static analysis for flink_tpu_torch "
                    "(concurrency, device-discipline, wire-safety rules).")
    p.add_argument("root", nargs="?", default=None,
                   help="package directory to lint (default: the installed "
                        "flink_tpu_torch package)")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text", help="output format (default: text)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="frozen-violation file (default: "
                        f"<project-root>/{DEFAULT_BASELINE_NAME} when it "
                        "exists)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline: report every violation")
    p.add_argument("--write-baseline", action="store_true",
                   help="add entries (justification=TODO) for all current "
                        "violations, then exit 0; the engine fails until "
                        "each TODO is replaced with a real justification")
    p.add_argument("--prune-baseline", action="store_true",
                   help="rewrite the baseline file without entries whose "
                        "file no longer exists or whose rule id is unknown "
                        "(pruning always happens in memory with a warning; "
                        "this flag persists it)")
    p.add_argument("--rule", action="append", default=None, metavar="ID",
                   help="run only this rule id/name (repeatable)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def _render_text(report: LintReport, baseline: Optional[Baseline]) -> str:
    lines: List[str] = []
    for v in report.violations:
        lines.append(v.render())
    for msg in report.baseline_errors:
        lines.append(f"baseline error: {msg}")
    n_rules = len(report.rules)
    summary = (f"{report.modules_scanned} modules, {n_rules} rules: "
               f"{len(report.violations)} violation"
               f"{'s' if len(report.violations) != 1 else ''}")
    if baseline is not None:
        summary += f", {len(report.suppressed)} baselined"
    if report.baseline_errors:
        summary += f", {len(report.baseline_errors)} baseline errors"
    lines.append(summary)
    return "\n".join(lines)


def _render_json(report: LintReport) -> str:
    doc = {
        "root": str(report.root),
        "modules_scanned": report.modules_scanned,
        "rules": [r.id for r in report.rules],
        "violations": [{
            "rule": v.rule_id, "path": v.path, "line": v.line,
            "message": v.message, "scope": v.scope, "symbol": v.symbol,
            "hint": v.hint, "fingerprint": v.fingerprint,
        } for v in report.violations],
        "suppressed": [{
            "rule": v.rule_id, "path": v.path, "line": v.line,
            "justification": e.justification,
        } for v, e in report.suppressed],
        "baseline_errors": report.baseline_errors,
        "exit_code": report.exit_code,
    }
    return json.dumps(doc, indent=2)


def render_sarif(report: LintReport) -> str:
    """SARIF 2.1.0 — the format CI annotation surfaces (GitHub code
    scanning et al.) ingest natively."""
    rules_meta = [{
        "id": r.id,
        "name": r.name,
        "shortDescription": {"text": r.name},
        "fullDescription": {"text": r.rationale},
        "help": {"text": r.hint},
        "properties": {"family": r.family},
    } for r in report.rules]
    results = [{
        "ruleId": v.rule_id,
        "level": "error",
        "message": {"text": v.message + (f" (hint: {v.hint})" if v.hint
                                         else "")},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": v.path},
                "region": {"startLine": max(v.line, 1)},
            },
        }],
        "partialFingerprints": {"flinkTpuLint/v1": v.fingerprint},
    } for v in report.violations]
    doc = {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "flink-tpu-torch-lint",
                "informationUri": "docs/lint.md",
                "rules": rules_meta,
            }},
            "results": results,
        }],
    }
    return json.dumps(doc, indent=2)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            print(f"{r.id}  {r.name:28s} [{r.family}]")
        return EXIT_CLEAN

    if args.no_baseline and (args.write_baseline or args.prune_baseline):
        # --write-baseline must MERGE into the existing file; with
        # --no-baseline it would rebuild from empty and overwrite every
        # human-written justification. --prune-baseline has nothing to
        # prune when the baseline is ignored.
        print("error: --no-baseline is mutually exclusive with "
              "--write-baseline / --prune-baseline", file=sys.stderr)
        return EXIT_BASELINE_ERROR

    root = pathlib.Path(args.root) if args.root else _default_root()
    if not root.is_dir():
        print(f"error: {root} is not a directory", file=sys.stderr)
        return EXIT_BASELINE_ERROR

    rules = None
    if args.rule:
        try:
            rules = [get_rule(rid) for rid in args.rule]
        except KeyError as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return EXIT_BASELINE_ERROR

    baseline: Optional[Baseline] = None
    baseline_path = pathlib.Path(args.baseline) if args.baseline else \
        root.parent / DEFAULT_BASELINE_NAME
    if not args.no_baseline:
        if baseline_path.exists():
            baseline = Baseline.load(baseline_path)
            # entries that can never match again (deleted file, retired
            # rule) are dropped up front — otherwise the engine's stale
            # check reports them forever against a file nobody can re-lint
            pruned = baseline.prune_stale(
                baseline_path.parent, [r.id for r in all_rules()])
            for entry, reason in pruned:
                print(f"baseline: pruned stale entry {entry.fingerprint} "
                      f"({reason})", file=sys.stderr)
            if args.prune_baseline:
                baseline.save(baseline_path)
                print(f"rewrote {baseline_path}: {len(pruned)} stale entr"
                      f"{'y' if len(pruned) == 1 else 'ies'} removed, "
                      f"{len(baseline)} kept", file=sys.stderr)
        elif args.write_baseline:
            baseline = Baseline(path=baseline_path)
        elif args.baseline:
            print(f"error: baseline {baseline_path} not found",
                  file=sys.stderr)
            return EXIT_BASELINE_ERROR

    report = run_lint(root, rules=rules, baseline=baseline)

    if args.write_baseline:
        if baseline is None:
            baseline = Baseline(path=baseline_path)
        for v in report.violations:
            baseline.add(v)
        baseline.save(baseline_path)
        print(f"wrote {len(report.violations)} new entr"
              f"{'y' if len(report.violations) == 1 else 'ies'} to "
              f"{baseline_path} — replace each TODO justification before "
              f"the engine will accept them")
        return EXIT_CLEAN

    if args.format == "text":
        print(_render_text(report, baseline))
    elif args.format == "json":
        print(_render_json(report))
    else:
        print(render_sarif(report))
    return report.exit_code


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
