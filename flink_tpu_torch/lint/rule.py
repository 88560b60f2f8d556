"""Rule base class, violation record, and the rule registry.

A rule is a small class over the shared :class:`ModuleIndex`; its
``check`` yields :class:`Violation` records carrying ``file:line``, the
rule id, and a fix hint. The registry is the single source of truth for
what CI enforces: ``tests/test_torch_lint.py`` runs every registered
rule over the port, the CLI lists/filters by rule id, and SARIF output
publishes each rule's rationale as its help text.

Fingerprints (rule id + project-relative path + enclosing scope + a
rule-chosen stable symbol) intentionally exclude line numbers, so a
baseline entry keeps matching its violation across unrelated edits to the
same file.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Iterator, List, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from flink_tpu_torch.lint.index import ModuleIndex


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: where, what, and how to fix it."""

    rule_id: str
    path: str                 # project-relative, e.g. "flink_tpu_torch/runtime/rpc.py"
    line: int
    message: str
    scope: str = ""           # dotted enclosing qualname (Class.method)
    symbol: str = ""          # rule-chosen stable id within the scope
    hint: str = ""

    @property
    def fingerprint(self) -> str:
        """Line-independent identity used for baseline matching."""
        return f"{self.rule_id}::{self.path}::{self.scope}::{self.symbol}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        out = f"{loc}: [{self.rule_id}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


class Rule:
    """Base class. Subclasses set the class attributes and implement
    :meth:`check`; decorating with :func:`register` adds an instance to
    the registry."""

    id: str = ""
    name: str = ""            # short kebab-case slug
    family: str = ""          # "concurrency" | "device" | "wire" | "architecture"
    rationale: str = ""       # why the invariant matters (docs + SARIF help)
    hint: str = ""            # default fix hint attached to violations

    def check(self, index: "ModuleIndex") -> Iterator[Violation]:
        raise NotImplementedError

    def violation(self, mod, line: int, message: str, *, scope: str = "",
                  symbol: str = "", hint: str = "") -> Violation:
        return Violation(rule_id=self.id, path=mod.rel_to_project, line=line,
                         message=message, scope=scope, symbol=symbol,
                         hint=hint or self.hint)


_REGISTRY: Dict[str, Rule] = {}

# Modules that register rules on import; extended here when a new family
# module is added.
_RULE_MODULES = (
    "flink_tpu_torch.lint.rules_concurrency",
    "flink_tpu_torch.lint.rules_device",
    "flink_tpu_torch.lint.rules_wire",
    "flink_tpu_torch.lint.rules_architecture",
    "flink_tpu_torch.lint.rules_exactly_once",
)


def register(cls):
    """Class decorator: instantiate and add to the registry (id must be
    unique — a duplicate id means two rules would fight over one baseline
    namespace, so it fails loudly)."""
    rule = cls()
    if not rule.id or not rule.name:
        raise ValueError(f"rule {cls.__name__} must set `id` and `name`")
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    _REGISTRY[rule.id] = rule
    return cls


def all_rules() -> List[Rule]:
    """Every registered rule, sorted by id (imports the rule modules on
    first use so the registry is complete without import-order games)."""
    for mod in _RULE_MODULES:
        importlib.import_module(mod)
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get_rule(rule_id: str) -> Rule:
    for r in all_rules():
        if r.id == rule_id or r.name == rule_id:
            return r
    raise KeyError(f"no lint rule {rule_id!r} (known: "
                   f"{', '.join(sorted(_REGISTRY))})")
