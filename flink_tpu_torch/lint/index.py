"""Shared module index: every ``*.py`` under a package root, parsed once.

Rules never touch the filesystem themselves — they iterate
:class:`ModuleIndex.modules` and reuse the cached ASTs, so a full lint run
parses each file exactly once no matter how many rules inspect it (the
ArchUnit "imported classes" analogue).

The index is package-relative on purpose: rules address modules by their
path relative to the package root (``runtime/rpc.py``) and by dotted name
(``<package>.runtime.rpc``), never by absolute path, so the same rules run
unchanged over the real ``flink_tpu_torch`` package and over the tiny fixture
packages the rule tests synthesize in ``tmp_path``.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, Iterator, List, Optional, Tuple


@dataclasses.dataclass
class ModuleInfo:
    """One parsed module."""

    path: pathlib.Path        # absolute file path
    rel: str                  # posix path relative to the package root
    module: str               # dotted module name, package-qualified
    source: str
    tree: ast.Module

    @property
    def rel_to_project(self) -> str:
        """Path relative to the PROJECT root (package dir's parent) — what
        violations and baselines record, e.g. ``flink_tpu_torch/runtime/rpc.py``."""
        return f"{self.module.split('.')[0]}/{self.rel}"


@dataclasses.dataclass
class ParseFailure:
    path: pathlib.Path
    rel: str
    error: str
    line: int


class ModuleIndex:
    """Parses every module under ``root`` once; shared by all rules.

    ``root`` is the package directory (e.g. ``.../flink_tpu_torch``);
    ``package`` defaults to the directory name and prefixes every dotted
    module name, so import-matching rules compare against
    ``f"{index.package}.runtime"`` instead of a hardcoded ``flink_tpu_torch``.
    """

    def __init__(self, root: pathlib.Path, package: Optional[str] = None):
        self.root = pathlib.Path(root).resolve()
        if not self.root.is_dir():
            raise NotADirectoryError(f"lint root {self.root} is not a directory")
        self.package = package or self.root.name
        self.modules: List[ModuleInfo] = []
        self.parse_failures: List[ParseFailure] = []
        self._by_rel: Dict[str, ModuleInfo] = {}
        for path in sorted(self.root.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            rel = path.relative_to(self.root).as_posix()
            try:
                source = path.read_text()
                tree = ast.parse(source, filename=str(path))
            except SyntaxError as e:
                self.parse_failures.append(
                    ParseFailure(path, rel, str(e), e.lineno or 0))
                continue
            except (UnicodeDecodeError, ValueError) as e:
                # undecodable bytes: report like a syntax error (exit 2)
                # instead of killing the whole run with a traceback
                self.parse_failures.append(ParseFailure(path, rel, str(e), 0))
                continue
            mod = ModuleInfo(path=path, rel=rel,
                             module=self._dotted(rel), source=source,
                             tree=tree)
            self.modules.append(mod)
            self._by_rel[rel] = mod

    @property
    def project_root(self) -> pathlib.Path:
        """Directory holding the package (where ``docs/`` and the baseline
        live)."""
        return self.root.parent

    def _dotted(self, rel: str) -> str:
        parts = rel[:-3].split("/")          # strip ".py"
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join([self.package, *parts]) if parts else self.package

    def get(self, rel: str) -> Optional[ModuleInfo]:
        return self._by_rel.get(rel)

    def in_subtree(self, prefix: str) -> Iterator[ModuleInfo]:
        """Modules whose package-relative path starts with ``prefix + '/'``
        (or equals ``prefix`` for a single file)."""
        for mod in self.modules:
            if mod.rel == prefix or mod.rel.startswith(prefix.rstrip("/") + "/"):
                yield mod

    # ------------------------------------------------------------------
    # import extraction (shared by the architecture/device/wire families)
    # ------------------------------------------------------------------
    def resolve_import_from(self, mod: ModuleInfo,
                            node: ast.ImportFrom) -> Optional[str]:
        """Absolute dotted module an ``ImportFrom`` targets, resolving
        relative imports (``from ..runtime import x``) against the module's
        own location; None for unresolvable over-deep relatives."""
        if node.level == 0:
            return node.module
        base = mod.module.split(".")
        # "from . import x" (level 1) in pkg/sub/mod.py resolves against
        # pkg.sub; in pkg/sub/__init__.py the dotted name ALREADY names the
        # package (``_dotted`` strips __init__), so one less level drops
        drop = node.level - 1 if mod.rel.endswith("__init__.py") \
            else node.level
        if drop >= len(base):
            return None           # escapes above the indexed package
        anchor = base[:-drop] if drop else base
        return ".".join([*anchor, node.module]) if node.module else \
            ".".join(anchor) or None

    def _import_from_names(self, mod: ModuleInfo,
                           node: ast.ImportFrom) -> List[str]:
        """Dotted names an ImportFrom can bind: the base module AND
        base.<alias> for each imported name — `from flink_tpu_torch import
        runtime` must resolve to flink_tpu_torch.runtime, or the ordinary
        spelling of a layering violation bypasses every banned-prefix
        check. base.<alias> for a non-module symbol (a class, a function)
        is harmless over-approximation: it never prefix-matches a banned
        MODULE unless the module itself does."""
        target = self.resolve_import_from(mod, node)
        if not target:
            return []
        names = [f"{target}.{a.name}" for a in node.names if a.name != "*"]
        # base alone only for `import *` — otherwise it is a prefix of
        # every alias name and would double-report each statement
        return names or [target]

    def module_level_imports(
            self, mod: ModuleInfo) -> List[Tuple[str, int]]:
        """Imports executed at import time: module body + class bodies, but
        NOT function bodies (lazy imports are the sanctioned layering
        escape hatch — execution entry points import the executor when
        called, so importing the API layer never drags in the runtime)."""
        found: List[Tuple[str, int]] = []

        def walk(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                if isinstance(child, ast.Import):
                    found.extend((a.name, child.lineno) for a in child.names)
                elif isinstance(child, ast.ImportFrom):
                    found.extend((name, child.lineno) for name in
                                 self._import_from_names(mod, child))
                else:
                    walk(child)

        walk(mod.tree)
        return found

    def all_imports(self, mod: ModuleInfo) -> List[Tuple[str, int]]:
        """EVERY import in the file, function bodies included — for rules
        where even a lazy import is a violation."""
        found: List[Tuple[str, int]] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                found.extend((a.name, node.lineno) for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                found.extend((name, node.lineno) for name in
                             self._import_from_names(mod, node))
        return found


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    """child -> parent for every node; rules use it to answer "is this call
    inside a loop / a locked region / a kernel launcher" lexically."""
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def enclosing_scope(parents: Dict[ast.AST, ast.AST], node: ast.AST) -> str:
    """Dotted qualname of the classes/functions enclosing ``node`` — the
    stable part of a violation fingerprint (survives line churn)."""
    names: List[str] = []
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            names.append(cur.name)
        cur = parents.get(cur)
    return ".".join(reversed(names))
