"""Architecture & completeness rule family (ARCH/DOC).

The JAX package's architecture rules as registry rules (the reference
keeps the same rules in flink-architecture-tests as ArchUnit layer
definitions with frozen stores):

- ARCH001 layer-dag — foundation layers must not import upward at module
  level (lazy, function-scoped imports are the sanctioned escape hatch).
- ARCH002 checkpoint-below-runtime — flink_tpu_torch/checkpoint must not import
  flink_tpu_torch.runtime anywhere, lazy imports included.
- DOC001 config-docs-complete — every declared ConfigOption key must
  appear in docs/configuration_torch.md.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Tuple

from flink_tpu_torch.lint.index import ModuleIndex
from flink_tpu_torch.lint.rule import Rule, Violation, register  # noqa: F401 — Violation used in annotations

#: layer dir -> package-relative module prefixes it must NOT import at
#: module level ("{pkg}" is substituted with the indexed package name)
LAYER_FORBIDDEN: Dict[str, List[str]] = {
    "core": ["{pkg}.runtime", "{pkg}.api", "{pkg}.table", "{pkg}.cep",
             "{pkg}.ops", "{pkg}.state", "{pkg}.scheduler"],
    "utils": ["{pkg}.runtime", "{pkg}.api", "{pkg}.table", "{pkg}.cep",
              "{pkg}.scheduler"],
    "ops": ["{pkg}.runtime", "{pkg}.api", "{pkg}.table", "{pkg}.cep",
            "{pkg}.scheduler"],
    # the state plane (columnar/heap backends, vocab, tier manager,
    # changelog) is composed BY the runtime: operators hand device
    # accessors in as callables; a runtime import here would invert that
    # and drag the executor into every state-backend import
    "state": ["{pkg}.api", "{pkg}.table", "{pkg}.cep", "{pkg}.scheduler",
              "{pkg}.runtime"],
    # the mesh/shard-map library sits below the runtime like ops/state: it
    # may import core/ops/state/config, never the runtime (the sharded
    # pipeline's planner handle is a function-scoped lazy import), api, or
    # the table/cep layers above — the runtime composes parallel, not the
    # other way around
    "parallel": ["{pkg}.runtime", "{pkg}.api", "{pkg}.table", "{pkg}.cep",
                 "{pkg}.scheduler"],
    # the join subsystem (geometry/catalog, bucket rings, the fused match
    # pipeline) sits beside parallel: it may import core/ops/state/config
    # (and parallel, for the sharded pipeline's mesh handles) — never the
    # runtime (DeviceJoinRunner composes the pipeline, not the reverse),
    # api, table, cep, or the scheduler
    "joins": ["{pkg}.runtime", "{pkg}.api", "{pkg}.table", "{pkg}.cep",
              "{pkg}.scheduler"],
    # job translation: step planning, the fusion planner (fusion.py) and
    # the Factor-Windows sharing optimizer (window_sharing.py) — all emit
    # pure plan data the executor consumes; a runtime import would invert
    # the translation DAG
    "graph": ["{pkg}.table", "{pkg}.cep", "{pkg}.runtime"],
    # the SQL planner translates table plans into graph transformations:
    # it may import table (parsed Query shapes), graph, core, and config —
    # never the runtime (it emits plans, the executor runs them), the api
    # (assigner construction is a function-scoped lazy import), the
    # scheduler, or cep
    "planner": ["{pkg}.runtime", "{pkg}.api", "{pkg}.scheduler",
                "{pkg}.cep"],
    "api": ["{pkg}.table", "{pkg}.runtime"],
    # the autoscaler consumes metric-snapshot/state/config shapes and is
    # driven by the runtime through injected callables — it may import
    # metrics/state/config, never the runtime (or anything above it); and
    # the layers it consumes must not import it back
    "metrics": ["{pkg}.runtime", "{pkg}.api", "{pkg}.table", "{pkg}.cep",
                "{pkg}.scheduler"],
    "scheduler": ["{pkg}.runtime", "{pkg}.api", "{pkg}.table", "{pkg}.cep"],
}


@register
class LayerDagRule(Rule):
    id = "ARCH001"
    name = "layer-dag"
    family = "architecture"
    rationale = (
        "The layer DAG — core/utils at the bottom, ops above them, "
        "state/graph next, api on top, runtime/table/cep reachable only "
        "lazily — keeps `import flink_tpu_torch.api` from dragging in the whole "
        "runtime (and torch with a CUDA context) at import time. Function-scoped "
        "imports are the sanctioned escape hatch, playing the role of "
        "ArchUnit's frozen store but enforced structurally: execution "
        "entry points import the executor when called."
    )
    hint = ("import lazily inside the function that needs it, or move the "
            "code to the layer it actually belongs to")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        for layer, banned_tpl in LAYER_FORBIDDEN.items():
            banned = [b.format(pkg=index.package) for b in banned_tpl]
            for mod in index.in_subtree(layer):
                for imp, line in index.module_level_imports(mod):
                    for b in banned:
                        if imp == b or imp.startswith(b + "."):
                            yield self.violation(
                                mod, line,
                                (f"layer {layer!r} imports {imp} at module "
                                 f"level (must not depend on {b})"),
                                symbol=f"{layer}->{imp}")


@register
class CheckpointBelowRuntimeRule(Rule):
    id = "ARCH002"
    name = "checkpoint-below-runtime"
    family = "architecture"
    rationale = (
        "flink_tpu_torch/checkpoint must not import flink_tpu_torch.runtime — "
        "anywhere, lazy imports included. Checkpoint/failure/recovery "
        "statistics flow OUTWARD: the coordinator reports into trackers "
        "the runtime hands it (metrics/checkpoint_stats.py stats + "
        "state_bytes_fn callbacks); it never reaches into the scheduler "
        "or executor. A runtime import here inverts the dependency and "
        "lets coordinator changes drag in the whole cluster stack (and, "
        "on GPU hosts, risk CUDA init from a checkpoint utility)."
    )
    hint = "pass data outward via callbacks/trackers instead"

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        banned = f"{index.package}.runtime"
        for mod in index.in_subtree("checkpoint"):
            seen: Dict[str, int] = {}
            for imp, line in index.all_imports(mod):
                if imp == banned or imp.startswith(banned + "."):
                    base = f"import:{imp}"
                    n = seen[base] = seen.get(base, 0) + 1
                    yield self.violation(
                        mod, line,
                        (f"checkpoint layer imports {imp} (must stay below "
                         f"the runtime, lazy imports included)"),
                        symbol=base if n == 1 else f"{base}#{n}")


def _declared_config_keys(index: ModuleIndex) -> List[Tuple[str, int, str]]:
    """(key, line, holder_scope) for every ConfigOptions.key("...") call in
    the package's config.py — the AST-level equivalent of
    docs.generate.collect_options, so the rule also runs on fixture
    packages that are never importable."""
    mod = index.get("config.py")
    if mod is None:
        return []
    out: List[Tuple[str, int, str]] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "key" and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id == "ConfigOptions" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            out.append((node.args[0].value, node.lineno, "config.py"))
    return out


@register
class ConfigDocsCompleteRule(Rule):
    id = "DOC001"
    name = "config-docs-complete"
    family = "architecture"
    rationale = (
        "Every ConfigOption declared in config.py must appear in "
        "docs/configuration_torch.md (regenerate with `python -m "
        "flink_tpu_torch.docs.generate`). The reference gates its docs the same "
        "way (ConfigOptionsDocsCompletenessITCase): an undocumented "
        "option fails CI before it ships, so the generated reference can "
        "be trusted to be the full surface."
    )
    hint = "run `python -m flink_tpu_torch.docs.generate` and commit the result"

    #: the reference the option keys must appear in, relative to the
    #: project root (the JAX package's generator owns docs/configuration.md)
    doc = "docs/configuration_torch.md"

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        keys = _declared_config_keys(index)
        if not keys:
            return
        doc_path = index.project_root / self.doc
        doc = doc_path.read_text() if doc_path.exists() else ""
        mod = index.get("config.py")
        for key, line, _holder in keys:
            if f"`{key}`" not in doc:
                yield self.violation(
                    mod, line,
                    f"config option `{key}` missing from "
                    f"{self.doc}",
                    symbol=f"option:{key}")
