"""Wire-safety rule family (WIRE): deserialization and data-path hygiene.

The JAX package's wire rules, over the port's network planes:

- WIRE001 no-bare-pickle — modules handling socket-originated bytes must
  deserialize through flink_tpu_torch.security only (the invariant:
  MAC-verify BEFORE deserialize, allowlisted unpickler).
- WIRE002 serialization-free-dataplane — runtime/dataplane.py must not
  serialize batch payloads itself (the zero-copy invariant).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Tuple

from flink_tpu_torch.lint.index import ModuleIndex, ModuleInfo
from flink_tpu_torch.lint.rule import Rule, Violation, register  # noqa: F401 — Violation used in annotations

#: package-relative subtrees whose bytes can originate from a socket
NETWORK_PLANES = ("runtime", "fs")


def _pickle_load_sites(mod: ModuleInfo) -> List[Tuple[str, str, int]]:
    """Every way raw deserialization can be spelled, anywhere in the file
    (function bodies included — lazy code paths must be seen too):
    `pickle.loads/load(...)`, `pickle.Unpickler` references, and
    `from pickle import loads/load/Unpickler` (which would make later
    bare-name calls invisible to attribute matching — the import itself
    is the violation)."""
    found: List[Tuple[str, str, int]] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module in (
                "pickle", "cloudpickle"):
            for a in node.names:
                if a.name in ("loads", "load", "Unpickler", "*"):
                    found.append((node.module, f"import {a.name}",
                                  node.lineno))
        elif isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in ("pickle", "cloudpickle"):
            if node.attr in ("loads", "load", "Unpickler"):
                found.append((node.value.id, node.attr, node.lineno))
    return found


@register
class NoBarePickleRule(Rule):
    id = "WIRE001"
    name = "no-bare-pickle"
    family = "wire"
    rationale = (
        "Everything under runtime/ and fs/ handles bytes that can "
        "originate from a socket (RPC frames, exchange batches, blob "
        "payloads, object-store reads), so no module there may "
        "deserialize with pickle directly — loads/load calls, Unpickler "
        "subclassing, and `from pickle import loads` are all banned. "
        "Deserialization goes through flink_tpu_torch.security "
        "(restricted_loads after MAC verification; trusted_loads for "
        "post-auth job specs). A new raw-pickle path on a network plane "
        "must fail CI before it fails an incident review."
    )
    hint = ("route it through flink_tpu_torch.security.framing "
            "(restricted_loads/trusted_loads)")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        for layer in NETWORK_PLANES:
            for mod in index.in_subtree(layer):
                # occurrence index, NOT the line number: fingerprints must
                # survive unrelated edits to the file (baseline contract)
                seen: Dict[str, int] = {}
                for pkg, what, line in _pickle_load_sites(mod):
                    base = f"{pkg}.{what}"
                    n = seen[base] = seen.get(base, 0) + 1
                    yield self.violation(
                        mod, line,
                        f"uses {pkg}.{what} on a network plane",
                        scope="",
                        symbol=base if n == 1 else f"{base}#{n}")


@register
class SerializationFreeDataplaneRule(Rule):
    id = "WIRE002"
    name = "serialization-free-dataplane"
    family = "wire"
    rationale = (
        "runtime/dataplane.py may not serialize batch payloads itself — "
        "no pickle/cloudpickle import, no dumps(/loads( call anywhere in "
        "the module. Batch bytes cross the process boundary only through "
        "flink_tpu_torch.security: the zero-copy binary columnar wire "
        "(security/wire.py via transport.send_data_frame/recv_msg) or the "
        "legacy restricted-pickle codec (transport.send_obj/recv_obj). A "
        "convenience dumps(batch) creeping back into the data path "
        "reintroduces the full-copy serialization tax (and a "
        "deserialize-before-MAC hazard on the receive side) that the "
        "binary wire exists to remove."
    )
    hint = "route batches through security.transport / security.wire"

    DATAPLANE = "runtime/dataplane.py"

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        mod = index.get(self.DATAPLANE)
        if mod is None:
            return
        seen: Dict[str, int] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name in ("pickle", "cloudpickle"):
                        yield self.violation(
                            mod, node.lineno, f"import {a.name}",
                            symbol=f"import:{a.name}")
            elif isinstance(node, ast.ImportFrom):
                if node.module in ("pickle", "cloudpickle"):
                    yield self.violation(
                        mod, node.lineno,
                        f"from {node.module} import ...",
                        symbol=f"from:{node.module}")
                elif node.module and any(
                        a.name in ("dumps", "loads", "dump", "load")
                        for a in node.names):
                    yield self.violation(
                        mod, node.lineno,
                        f"from {node.module} imports a serializer name",
                        symbol=f"from-serializer:{node.module}")
            elif isinstance(node, ast.Call):
                fn = node.func
                name = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else None)
                if name in ("dumps", "loads", "dump", "load"):
                    base = f"call:{name}"
                    n = seen[base] = seen.get(base, 0) + 1
                    yield self.violation(
                        mod, node.lineno,
                        f"call to {name}(...) on the data path",
                        symbol=base if n == 1 else f"{base}#{n}")
