"""Per-class lock model for the concurrency rule family.

For every class (and for module-level functions, treated as a pseudo-class
guarding ``global`` state), the model records:

- **lock attributes** — ``self._x = threading.Lock()/RLock()/Condition()``
  (module level: ``NAME = threading.Lock()``), each with its kind;
- **locked regions** — ``with self._x:`` blocks, tracked lexically while
  walking each method, so every attribute write, call, and nested
  acquisition knows exactly which locks are held around it;
- **attribute writes** — plain assigns, augmented assigns, tuple unpacks,
  subscript stores/deletes, and mutating container method calls
  (``.append()``/``.pop()``/...) on ``self.<attr>`` receivers;
- **nested acquisitions** — ``with a: ... with b:`` edges feeding the
  cross-module lock-order graph (static deadlock detection);
- **self-call propagation (one hop)** — a helper that is *only* invoked
  from regions holding lock L is treated as running under L
  (``RpcGateway._close_locked`` / ``Meter._trim`` pattern: the lock-held
  private helper). No fixpoint — one hop keeps the model predictable.

Lexicality is a feature: aliases (``task = self`` captured by a nested
class) make both the region and the write invisible *symmetrically*, so
the guarded-by rule never produces evidence it cannot defend.
"""

from __future__ import annotations

import ast
import dataclasses
import weakref
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from flink_tpu_torch.lint.index import ModuleIndex, ModuleInfo

LOCK_FACTORIES = {"Lock": "Lock", "RLock": "RLock", "Condition": "Condition"}

# container-mutating method names treated as writes to the receiver attr
MUTATOR_METHODS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft", "popitem",
    "remove", "clear", "update", "setdefault", "add", "discard",
}

#: methods whose unguarded writes are construction, not racing state
CONSTRUCTION_METHODS = {"__init__", "__new__", "__init_subclass__"}


@dataclasses.dataclass(frozen=True)
class LockAttr:
    name: str          # attribute (or module-global) name
    kind: str          # "Lock" | "RLock" | "Condition"
    line: int


@dataclasses.dataclass
class AttrWrite:
    attr: str
    line: int
    method: str
    held: FrozenSet[str]      # lock names held lexically (post-propagation)
    nested: bool              # inside a nested def (deferred execution)
    scope: str


@dataclasses.dataclass
class TrackedCall:
    """Every call in a lock-declaring class, with the lock set held around
    it (post-propagation) — CONC003 filters for blocking calls whose held
    set is non-empty."""

    func_repr: str            # dotted best-effort, e.g. "time.sleep" or ".accept"
    line: int
    method: str
    held: FrozenSet[str]
    scope: str


@dataclasses.dataclass
class ClassLockModel:
    mod: ModuleInfo
    qualname: str             # "" for the module-level pseudo-class
    locks: Dict[str, LockAttr]
    writes: List[AttrWrite]
    calls: List[TrackedCall]
    #: (outer_lock, inner_lock, line, method) — lock names are local here;
    #: the graph qualifies them with module + class. Includes one-hop
    #: call-mediated edges: a self-method invoked while holding A
    #: contributes A -> each lock it acquires.
    acquisition_edges: List[Tuple[str, str, int, str]]
    #: every lock acquisition per method: method -> [(lock, line)]
    method_acquisitions: Dict[str, List[Tuple[str, int]]] = \
        dataclasses.field(default_factory=dict)

    def lock_node(self, lock_name: str) -> str:
        """Graph-global node id for one of this model's locks."""
        owner = self.qualname or "<module>"
        return f"{self.mod.rel_to_project}:{owner}.{lock_name}"


def _receiver_names(func: Optional[ast.AST]) -> Set[str]:
    names = {"self"}
    if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
        args = func.args.posonlyargs + func.args.args
        if args and not any(
                isinstance(d, ast.Name) and d.id == "staticmethod"
                for d in func.decorator_list):
            names.add(args[0].arg)
    return names


def _lock_factory_kind(value: ast.AST) -> Optional[str]:
    """'Lock'/'RLock'/'Condition' when `value` is a call to a threading
    lock factory (``threading.Lock()`` or a bare imported ``Lock()``)."""
    if not isinstance(value, ast.Call):
        return None
    fn = value.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == "threading":
        return LOCK_FACTORIES.get(fn.attr)
    if isinstance(fn, ast.Name):
        return LOCK_FACTORIES.get(fn.id)
    return None


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted repr of a call target: ``time.sleep``,
    ``.accept`` (unknown receiver), ``sleep`` (bare name)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base and "." not in base else f".{node.attr}"
    return ""


class _MethodWalker:
    """Walks one method (or module-level function) body, tracking the
    lexically-held lock set."""

    def __init__(self, model: ClassLockModel, method_name: str, scope: str,
                 receivers: Set[str], global_names: Set[str],
                 module_names: Set[str] = frozenset()):
        self.model = model
        self.method = method_name
        self.scope = scope
        self.receivers = receivers
        self.global_names = global_names
        # module-level assigned names: in-place mutation (`_CACHE[k] = v`,
        # `_CACHE.pop(k)`) hits the module object WITHOUT a `global`
        # declaration, so these count as writes for mutations only —
        # direct `name = ...` without `global` rebinds a local instead
        self.module_names = module_names
        #: (method, held) for every self.<meth>() call — propagation input
        self.self_calls: List[Tuple[str, FrozenSet[str], int]] = []

    # -- helpers -----------------------------------------------------------
    def _lock_name(self, expr: ast.AST) -> Optional[str]:
        """Lock name when `expr` is `self.<lockattr>` or a module lock."""
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
                and expr.value.id in self.receivers and not self.model.qualname == "":
            if expr.attr in self.model.locks:
                return expr.attr
        if isinstance(expr, ast.Name) and self.model.qualname == "" \
                and expr.id in self.model.locks:
            return expr.id
        return None

    def _self_attr(self, expr: ast.AST,
                   mutation: bool = False) -> Optional[str]:
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
                and expr.value.id in self.receivers and self.model.qualname != "":
            return expr.attr
        if isinstance(expr, ast.Name) and self.model.qualname == "" \
                and (expr.id in self.global_names
                     or (mutation and expr.id in self.module_names)):
            return expr.id
        return None

    def _record_write(self, attr: str, line: int, held: FrozenSet[str],
                      nested: bool) -> None:
        self.model.writes.append(AttrWrite(
            attr=attr, line=line, method=self.method, held=held,
            nested=nested, scope=self.scope))

    def _write_targets(self, target: ast.AST, line: int,
                       held: FrozenSet[str], nested: bool) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._write_targets(elt, line, held, nested)
            return
        if isinstance(target, ast.Starred):
            self._write_targets(target.value, line, held, nested)
            return
        attr = self._self_attr(target)
        if attr is not None:
            self._record_write(attr, line, held, nested)
            return
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            # self._d[k] = v / self._obj.field = v: mutation of self._d/_obj
            inner = self._self_attr(target.value, mutation=True)
            if inner is not None:
                self._record_write(inner, line, held, nested)

    # -- the walk ----------------------------------------------------------
    def walk(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self._visit(stmt, frozenset(), nested=False)

    def _visit(self, node: ast.AST, held: FrozenSet[str], nested: bool) -> None:
        if isinstance(node, ast.ClassDef):
            return                      # different `self`; out of scope
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # deferred execution: the held set at def time means nothing
            for stmt in node.body:
                self._visit(stmt, frozenset(), nested=True)
            return
        if isinstance(node, ast.Lambda):
            self._visit(node.body, frozenset(), nested=True)
            return

        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: List[str] = []
            for item in node.items:
                name = self._lock_name(item.context_expr)
                if name is not None:
                    self.model.method_acquisitions.setdefault(
                        self.method, []).append((name, node.lineno))
                    for outer in held:
                        self.model.acquisition_edges.append(
                            (outer, name, node.lineno, self.method))
                    for prev in acquired:   # `with a, b:` orders a before b
                        self.model.acquisition_edges.append(
                            (prev, name, node.lineno, self.method))
                    acquired.append(name)
                else:
                    self._visit(item.context_expr, held, nested)
                if item.optional_vars is not None:
                    self._write_targets(item.optional_vars, node.lineno,
                                        held, nested)
            inner_held = held | frozenset(acquired)
            for stmt in node.body:
                self._visit(stmt, inner_held, nested)
            return

        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                self._write_targets(t, node.lineno, held, nested)
            value = getattr(node, "value", None)
            if value is not None:
                self._visit(value, held, nested)
            return

        if isinstance(node, ast.Delete):
            for t in node.targets:
                self._write_targets(t, node.lineno, held, nested)
            return

        if isinstance(node, ast.Call):
            fn = node.func
            # mutating container call: self._ring.append(x)
            if isinstance(fn, ast.Attribute) and fn.attr in MUTATOR_METHODS:
                owner = self._self_attr(fn.value, mutation=True)
                if owner is not None:
                    self._record_write(owner, node.lineno, held, nested)
            # self-method call (propagation input)
            if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
                    and fn.value.id in self.receivers:
                self.self_calls.append((fn.attr, held, node.lineno))
            self.model.calls.append(TrackedCall(
                func_repr=_dotted(fn), line=node.lineno,
                method=self.method, held=held, scope=self.scope))
            for child in ast.iter_child_nodes(node):
                self._visit(child, held, nested)
            return

        for child in ast.iter_child_nodes(node):
            self._visit(child, held, nested)


def _class_lock_attrs(cls: ast.ClassDef) -> Dict[str, LockAttr]:
    locks: Dict[str, LockAttr] = {}
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        receivers = _receiver_names(meth)
        for node in ast.walk(meth):
            if isinstance(node, ast.Assign):
                kind = _lock_factory_kind(node.value)
                if kind is None:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id in receivers:
                        locks.setdefault(t.attr, LockAttr(t.attr, kind,
                                                          node.lineno))
    return locks


def _module_lock_attrs(tree: ast.Module) -> Dict[str, LockAttr]:
    locks: Dict[str, LockAttr] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            kind = _lock_factory_kind(node.value)
            if kind is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    locks.setdefault(t.id, LockAttr(t.id, kind, node.lineno))
    return locks


def _propagate_helper_locks(model: ClassLockModel,
                            call_ctx: Dict[str, List[FrozenSet[str]]]) -> None:
    """One-hop: a method invoked ONLY while holding a common lock set is
    treated as running under that set (the `_locked`-helper pattern)."""
    for method, contexts in call_ctx.items():
        if not contexts or any(not c for c in contexts):
            continue                     # some caller holds nothing: no help
        common = frozenset.intersection(*contexts)
        if not common:
            continue
        for w in model.writes:
            if w.method == method:
                w.held = w.held | common
        for c in model.calls:
            if c.method == method:
                c.held = c.held | common


_MODEL_CACHE: "weakref.WeakKeyDictionary[ModuleIndex, List[ClassLockModel]]" \
    = weakref.WeakKeyDictionary()


def build_lock_models(index: ModuleIndex) -> List[ClassLockModel]:
    """One model per class declaring at least one lock (plus one per
    module with module-level locks); cached per index — CONC001/002/003
    all consume the same models, and the models are read-only after
    construction."""
    cached = _MODEL_CACHE.get(index)
    if cached is None:
        cached = list(_build_lock_models(index))
        _MODEL_CACHE[index] = cached
    return cached


def _build_lock_models(index: ModuleIndex) -> Iterator[ClassLockModel]:
    for mod in index.modules:
        # module-level pseudo-class
        mod_locks = _module_lock_attrs(mod.tree)
        if mod_locks:
            model = ClassLockModel(mod=mod, qualname="", locks=mod_locks,
                                   writes=[], calls=[], acquisition_edges=[])
            module_names: Set[str] = set()
            for node in mod.tree.body:
                if isinstance(node, ast.Assign):
                    module_names.update(t.id for t in node.targets
                                        if isinstance(t, ast.Name))
                elif isinstance(node, ast.AnnAssign) and \
                        isinstance(node.target, ast.Name):
                    module_names.add(node.target.id)
            module_names -= set(mod_locks)
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    globals_declared = {
                        name for sub in ast.walk(node)
                        if isinstance(sub, ast.Global) for name in sub.names}
                    walker = _MethodWalker(model, node.name, node.name,
                                           set(), globals_declared,
                                           module_names)
                    walker.walk(node.body)
            yield model

        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            locks = _class_lock_attrs(node)
            if not locks:
                continue
            model = ClassLockModel(mod=mod, qualname=node.name, locks=locks,
                                   writes=[], calls=[], acquisition_edges=[])
            call_ctx: Dict[str, List[FrozenSet[str]]] = {}
            lock_held_calls: List[Tuple[str, FrozenSet[str], int, str]] = []
            method_names = {m.name for m in node.body
                            if isinstance(m, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))}
            for meth in node.body:
                if not isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                walker = _MethodWalker(
                    model, meth.name, f"{node.name}.{meth.name}",
                    _receiver_names(meth), set())
                walker.walk(meth.body)
                for callee, held, line in walker.self_calls:
                    if callee in method_names:
                        call_ctx.setdefault(callee, []).append(held)
                        if held:
                            lock_held_calls.append(
                                (callee, held, line, meth.name))
            _propagate_helper_locks(model, call_ctx)
            # one-hop call-mediated lock-order edges (ANY-site semantics —
            # a single call path that can deadlock is enough, unlike the
            # guarded-by propagation above which needs ALL sites locked):
            # calling a method that acquires B while holding A orders A->B
            for callee, held, line, caller in lock_held_calls:
                for inner, _ in model.method_acquisitions.get(callee, ()):
                    for outer in held:
                        model.acquisition_edges.append(
                            (outer, inner, line, caller))
            yield model
