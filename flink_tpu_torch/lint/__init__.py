"""flink_tpu_torch.lint — ArchUnit-style static analysis for the runtime.

The reference project enforces its architectural invariants with
flink-architecture-tests: ArchUnit rules over the compiled classes, plus
frozen violation stores that let known debt live on explicitly while new
violations fail CI. This package is the same capability for flink_tpu_torch,
built on the Python AST:

- ``index``     — parse every module once into a shared :class:`ModuleIndex`
- ``rule``      — :class:`Rule` base class, :class:`Violation`, the registry
- ``locks``     — per-class lock model (lock attrs, guarded regions,
                  nested acquisitions) consumed by the concurrency rules
- ``contracts`` — the exactly-once declaration vocabulary
                  (``@inflight_ring`` / ``@drains`` / ``@absorbs_faults``):
                  behavior-neutral runtime decorators plus the AST-side
                  extraction the analyzer reads them back with
- ``dataflow``  — interprocedural summary layer (self-call chains to
                  MAX_COMPOSE_DEPTH, device/dtype option inputs, cache sites,
                  fault-carrying fixpoint) shared by the EXON rules via
                  :meth:`DataflowIndex.shared`
- ``rules_concurrency`` / ``rules_device`` / ``rules_wire`` /
  ``rules_architecture`` / ``rules_exactly_once`` — the rule families
  (CONC/DEV/WIRE+ARCH+DOC/EXON), sixteen rules total
- ``baseline``  — frozen-violation store; every entry carries a written
                  justification or the engine refuses it, with stale-entry
                  auto-prune for retired rules and deleted files
- ``engine``    — runs the registry over an index, applies the baseline
- ``cli``       — ``python -m flink_tpu_torch.lint`` with text/JSON/SARIF output

Rules are small classes over the shared index; violations carry
``file:line`` + rule id + fix hint, so CI output is directly actionable.

This is the counterpart of ``flink_tpu/lint/`` under the same rule ids.
Twelve rules are the JAX package's unchanged; the device family and
EXON002 read torch and CUDA code instead of ``jax.jit``: DEV001 host syncs
in a function that launches a hand-written kernel, DEV002 kernel-library
builds in a loop, DEV003 a module-level torch import on the control
plane, EXON002 a cached torch program's device and dtype in its memo key.
The analyzer imports nothing it checks, so it loads neither torch nor jax.
"""

from flink_tpu_torch.lint.baseline import Baseline, BaselineEntry
from flink_tpu_torch.lint.engine import LintReport, run_lint
from flink_tpu_torch.lint.index import ModuleIndex, ModuleInfo
from flink_tpu_torch.lint.rule import Rule, Violation, all_rules, get_rule

__all__ = [
    "Baseline",
    "BaselineEntry",
    "LintReport",
    "ModuleIndex",
    "ModuleInfo",
    "Rule",
    "Violation",
    "all_rules",
    "get_rule",
    "run_lint",
]
