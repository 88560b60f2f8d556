"""Call-graph + summary layer over :mod:`flink_tpu_torch.lint.index`.

The exactly-once rules (EXON001–003) need more than lexical pattern
matching: "does ``snapshot`` drain the ring" is a property of the call
*chain* (``snapshot -> flush_all -> _resolve_inflight``), "is the cache
key complete" is a property of the *builder* the memo function calls, and
"is the fault re-raised" may happen inside a helper the handler delegates
to.  This module computes per-function summaries once per module and
composes them interprocedurally to a bounded depth.

Soundness limits (documented, deliberate — this is a linter, not a
verifier):

- **Depth**: self-call chains are followed to :data:`MAX_COMPOSE_DEPTH`
  hops with a cycle guard; deeper delegation is invisible.
- **Dominance** is approximated lexically: a call dominates the exit if
  it sits on the function's unconditional statement spine (top-level
  statements, ``with``/``try`` bodies, ``finally`` blocks), or inside an
  ``if``/``while`` whose test references *only* the attribute being
  drained (the ``if self._pending: self._resolve_pending()`` guard is a
  legal drain: an empty ring needs no draining).  An early-exit guard
  (``if not self._pending: return``) extends the guard over the rest of
  the spine.
- **Aliases** resolve one hop within a function (``phases =
  self.phase_counters`` makes ``phases`` in a cache key stand for
  ``self.phase_counters``); aliases of aliases do not.
- **Call targets** resolve to methods of the same class (``self.m()``)
  and module-level functions by name; anything else (cross-module calls,
  dynamic dispatch) contributes nothing to a summary.
- **Program options** (EXON002) are the values that fix what a cached
  torch program does on the device: the ``device=``/``dtype=`` of a
  tensor constructor or a ``.to(...)``, the positional arguments of
  ``.to(...)``, and the argument of ``torch.cuda.device(...)``. Names
  bound by the built program itself (the parameters and locals of a def
  or lambda nested in the builder) are the program's runtime inputs, not
  options; module constants (``torch.float32``, ``np.int32``) are fixed.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from flink_tpu_torch.lint import contracts
from flink_tpu_torch.lint.index import ModuleIndex, ModuleInfo

#: interprocedural composition depth (self-call hops followed)
MAX_COMPOSE_DEPTH = 4

#: keywords whose values fix where and in what type a cached torch
#: program computes — a cache key must cover every input of them
OPTION_KWARGS = frozenset({"device", "dtype"})

#: roots of module constants (dtypes, devices named by literal): a name
#: under one of these never varies between calls of a builder
CONSTANT_ROOTS = frozenset({"torch", "np", "numpy"})

#: sentinel guard element for conditions the analysis cannot prove are
#: pure ring-emptiness tests — a drain under such a guard is conditional
OPAQUE_GUARD = "<opaque>"


# ----------------------------------------------------------------------
# small AST utilities
# ----------------------------------------------------------------------
def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` / ``self.x`` / ``name`` for a Name/Attribute chain rooted
    at a Name; None for anything else (calls, subscripts)."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def dotted_names(expr: ast.AST, *, skip_callees: bool = True) -> Set[str]:
    """Every maximal dotted name referenced in ``expr``.  Names in callee
    position (``self._use_kernel()``'s func) are skipped by default —
    calling a method is not *using its value* as data."""
    out: Set[str] = set()
    skip: Set[int] = set()
    if skip_callees:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                f = node.func
                while isinstance(f, ast.Attribute):
                    skip.add(id(f))
                    f = f.value
                skip.add(id(f))
    # collect maximal chains only: mark inner nodes of each chain
    inner: Set[int] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute):
            inner.add(id(node.value))
    for node in ast.walk(expr):
        if id(node) in skip or id(node) in inner:
            continue
        if isinstance(node, (ast.Attribute, ast.Name)):
            d = dotted(node)
            if d is not None:
                out.add(d)
    return out


def option_exprs(call: ast.Call) -> List[ast.AST]:
    """The expressions of ``call`` that fix a torch program's device or
    type: ``device=``/``dtype=`` keywords of any call (the tensor
    constructors, ``.to``), the positional arguments of ``.to(...)``, and
    the arguments of ``torch.cuda.device(...)``."""
    out: List[ast.AST] = [kw.value for kw in call.keywords
                          if kw.arg in OPTION_KWARGS]
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "to":
        out.extend(call.args)
    elif dotted(f) in ("torch.cuda.device", "cuda.device"):
        out.extend(call.args)
    return out


def _container_ctor(expr: ast.AST) -> bool:
    """deque()/list()/[]/{}  — the shapes an in-flight structure is born
    with in ``__init__``."""
    if isinstance(expr, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(expr, ast.Call):
        d = dotted(expr.func)
        return d is not None and d.split(".")[-1] in (
            "deque", "list", "dict", "OrderedDict", "defaultdict")
    return False


# ----------------------------------------------------------------------
# summaries
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DominantCall:
    """A call on the function's unconditional spine.  ``guard_attrs`` is
    empty for truly unconditional calls; ``{"_pending"}`` for a call
    guarded by a pure emptiness test of that attribute; contains
    :data:`OPAQUE_GUARD` when the guard tests anything else."""

    name: str                      # "self.flush_all" / "helper" (dotted)
    guard_attrs: FrozenSet[str]
    line: int


@dataclasses.dataclass
class CacheKeySite:
    """A dict-memo lookup: ``key = (...)`` then ``CACHE.get(key)`` /
    ``CACHE.setdefault(key, ...)`` / ``key in CACHE`` in the same
    function."""

    cache_name: str                # "self._fn_cache" / "_CHAINED_CACHE"
    key_var: str
    line: int                      # line of the key assignment
    components: Set[str]           # alias-resolved dotted names in the key
    opaque: bool = False           # key expression was not a plain tuple


@dataclasses.dataclass
class HandlerInfo:
    """One ``except`` clause."""

    type_names: Tuple[str, ...]    # trailing names; () for a bare except
    line: int
    node: ast.ExceptHandler
    try_node: ast.Try


@dataclasses.dataclass
class FunctionSummary:
    name: str
    qualname: str                  # "Class.method" or "func"
    node: ast.AST                  # FunctionDef | AsyncFunctionDef
    line: int
    params: Tuple[str, ...]
    self_calls: Set[str]           # method names called on self, anywhere
    calls: Set[str]                # dotted names of all calls, anywhere
    call_nodes: List[ast.Call]     # every call site (argument mapping)
    attrs_written: Set[str]        # self.X assigned/augassigned
    attrs_read: Set[str]           # self.X read
    handlers: List[HandlerInfo]
    dominant_calls: List[DominantCall]
    option_inputs: Set[str]        # dotted names fixing device/dtype
    cache_sites: List[CacheKeySite]
    reraise_params: Set[str]       # params re-raised alongside an
                                   # InjectedCrash/InjectedFault reference
    drains_decl: Tuple[str, ...]   # @drains(...) attributes
    absorbs_reason: Optional[str]  # @absorbs_faults reason (None: absent)
    has_lru_cache: bool            # functools.lru_cache / functools.cache
    has_seam_call: bool            # calls the chaos HOOK directly


@dataclasses.dataclass
class ClassSummary:
    name: str
    node: ast.ClassDef
    line: int
    bases: Tuple[str, ...]                # base-class expressions (dotted)
    rings: List[contracts.RingDecl]
    drain_map: Dict[str, List[str]]       # attr -> draining method names
    methods: Dict[str, FunctionSummary]
    init_container_attrs: Dict[str, int]  # self.X = deque()/[] in __init__

    @property
    def has_bases(self) -> bool:
        """True when the class inherits from anything but object — its
        methods/attrs may live on the base, outside this summary."""
        return any(b != "object" for b in self.bases)


@dataclasses.dataclass
class ModuleSummary:
    mod: ModuleInfo
    classes: Dict[str, ClassSummary]
    functions: Dict[str, FunctionSummary]  # module-level defs


# ----------------------------------------------------------------------
# per-function summarization
# ----------------------------------------------------------------------
def _guard_attrs(test: ast.AST) -> FrozenSet[str]:
    """Attributes a guard condition tests.  Pure emptiness tests of
    ``self.X`` (optionally through ``not``/``len``/comparisons against
    constants) yield ``{X}``; anything else contributes
    :data:`OPAQUE_GUARD` so the caller treats the branch as conditional."""
    attrs: Set[str] = set()
    for node in ast.walk(test):
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                attrs.add(node.attr)
            elif not isinstance(node.value, ast.Attribute):
                attrs.add(OPAQUE_GUARD)
        elif isinstance(node, ast.Name):
            if node.id not in ("self", "len"):
                attrs.add(OPAQUE_GUARD)
        elif isinstance(node, ast.Call):
            if not (isinstance(node.func, ast.Name) and
                    node.func.id == "len"):
                attrs.add(OPAQUE_GUARD)
        elif not isinstance(node, (ast.UnaryOp, ast.BoolOp, ast.Compare,
                                   ast.Constant, ast.Load, ast.Not,
                                   ast.USub, ast.And, ast.Or, ast.Eq,
                                   ast.NotEq, ast.Gt, ast.GtE, ast.Lt,
                                   ast.LtE, ast.Is, ast.IsNot, ast.In,
                                   ast.NotIn)):
            attrs.add(OPAQUE_GUARD)
    return frozenset(attrs)


def _only_exits(body: Sequence[ast.stmt]) -> bool:
    return all(isinstance(s, (ast.Return, ast.Raise, ast.Continue,
                              ast.Pass)) for s in body)


def _spine_calls(body: Sequence[ast.stmt],
                 guards: FrozenSet[str]) -> Iterator[DominantCall]:
    """Calls on the unconditional spine of ``body`` (see module
    docstring for the dominance approximation)."""
    guards = frozenset(guards)
    for stmt in body:
        if isinstance(stmt, (ast.Expr, ast.Assign, ast.AugAssign,
                             ast.AnnAssign, ast.Return)):
            value = getattr(stmt, "value", None)
            if value is not None:
                for node in ast.walk(value):
                    if isinstance(node, ast.Call):
                        d = dotted(node.func)
                        if d:
                            yield DominantCall(d, guards, node.lineno)
        elif isinstance(stmt, ast.With):
            yield from _spine_calls(stmt.body, guards)
        elif isinstance(stmt, ast.Try):
            yield from _spine_calls(stmt.body, guards)
            yield from _spine_calls(stmt.finalbody, guards)
        elif isinstance(stmt, (ast.If, ast.While)):
            g = _guard_attrs(stmt.test)
            if isinstance(stmt, ast.If) and _only_exits(stmt.body) and \
                    not stmt.orelse:
                # early-exit guard: the REST of the spine runs under it
                guards = guards | g
                continue
            yield from _spine_calls(stmt.body, guards | g)
            if isinstance(stmt, ast.If) and stmt.orelse:
                yield from _spine_calls(stmt.orelse, guards | g)
        # For loops / nested defs: never dominant
        if isinstance(stmt, (ast.Return, ast.Raise)):
            return


def _alias_map(fn: ast.AST) -> Dict[str, str]:
    """One-hop local aliases: ``phases = self.phase_counters`` lets a
    cache-key component named ``phases`` resolve to the attribute."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            src = dotted(node.value)
            if src is not None:
                aliases[node.targets[0].id] = src
    return aliases


def _cache_sites(fn: ast.AST) -> List[CacheKeySite]:
    aliases = _alias_map(fn)
    # key-var candidates: name = (tuple ...) assignments
    key_assigns: Dict[str, ast.Assign] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Tuple):
            key_assigns[node.targets[0].id] = node
    if not key_assigns:
        return []
    sites: List[CacheKeySite] = []
    seen: Set[Tuple[str, str]] = set()
    # a memo is looked up the dict way (`.get`, `.setdefault`, `in`): a
    # tensor indexed by a tuple (`ring[cell]`) is no cache
    for node in ast.walk(fn):
        cache = keyvar = None
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("get", "setdefault") and node.args and \
                isinstance(node.args[0], ast.Name):
            cache, keyvar = dotted(node.func.value), node.args[0].id
        elif isinstance(node, ast.Compare) and \
                isinstance(node.left, ast.Name) and len(node.ops) == 1 and \
                isinstance(node.ops[0], (ast.In, ast.NotIn)):
            cache, keyvar = dotted(node.comparators[0]), node.left.id
        if cache is None or keyvar not in key_assigns:
            continue
        if (cache, keyvar) in seen:
            continue
        seen.add((cache, keyvar))
        assign = key_assigns[keyvar]
        components: Set[str] = set()
        for name in dotted_names(assign.value):
            components.add(aliases.get(name, name))
        sites.append(CacheKeySite(cache_name=cache, key_var=keyvar,
                                  line=assign.lineno,
                                  components=components))
    return sites


def _bound_names(fn: ast.AST) -> Set[str]:
    """Names a def or lambda binds: its parameters and the targets of its
    assignments, loops, ``with ... as`` and comprehensions."""
    args = fn.args
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    names |= {a.arg for a in (args.vararg, args.kwarg) if a is not None}
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
    return names


def _option_inputs(fn: ast.AST) -> Set[str]:
    """Dotted names that fix a torch program's device or type inside
    ``fn`` (see :func:`option_exprs`), resolved one hop through local
    derivations: ``dt = torch.float64 if wide else torch.float32`` makes
    the option input ``dt`` stand for ``wide``, and a local computed from
    constants alone stands for nothing. Names bound inside a nested def or
    lambda (the built program's own arguments and locals) are skipped."""
    inputs: Set[str] = set()

    def visit(node: ast.AST, runtime: FrozenSet[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                visit(child, runtime | _bound_names(child))
                continue
            if isinstance(child, ast.Call):
                for expr in option_exprs(child):
                    for name in dotted_names(expr):
                        root = name.split(".")[0]
                        if root not in runtime and root not in CONSTANT_ROOTS:
                            inputs.add(name)
            visit(child, runtime)

    visit(fn, frozenset())
    if not inputs:
        return inputs
    # resolve locals to their roots (one hop); a local assigned from
    # constants alone (`dev = torch.device("cuda")`) is no input at all
    derived: Dict[str, Set[str]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            derived.setdefault(node.targets[0].id, set()).update(
                n for n in dotted_names(node.value)
                if n.split(".")[0] not in CONSTANT_ROOTS)
    resolved: Set[str] = set()
    for name in inputs:
        if "." not in name and name in derived:
            resolved |= derived[name]
        else:
            resolved.add(name)
    return resolved


_INJECTED = ("InjectedCrash", "InjectedFault")


def _reraise_params(fn: ast.AST, params: Sequence[str]) -> Set[str]:
    """Params the function re-raises while referencing the injected fault
    types — the ``coordinator._failed`` transparency-helper pattern."""
    mentions_injected = any(
        isinstance(n, (ast.Name, ast.Attribute)) and
        (dotted(n) or "").split(".")[-1] in _INJECTED
        for n in ast.walk(fn))
    if not mentions_injected:
        return set()
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Raise) and isinstance(node.exc, ast.Name) \
                and node.exc.id in params:
            out.add(node.exc.id)
    return out


def _handler_type_names(h: ast.ExceptHandler) -> Tuple[str, ...]:
    if h.type is None:
        return ()
    types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    names = []
    for t in types:
        d = dotted(t)
        names.append(d.split(".")[-1] if d else "<expr>")
    return tuple(names)


def seam_calls(root: ast.AST,
               aliases: Optional[Dict[str, str]] = None) -> List[ast.Call]:
    """Chaos-seam invocations inside ``root``: calls through a local
    alias of ``*.HOOK`` (the ``hook = _chaos.HOOK; hook(scope, site)``
    idiom) or directly on a ``*.HOOK`` attribute.  These are the ONLY
    program points where an InjectedFault/InjectedCrash originates."""
    if aliases is None:
        aliases = _alias_map(root)
    hook_names = {name for name, src in aliases.items()
                  if src.endswith(".HOOK") or src == "HOOK"}
    out: List[ast.Call] = []
    for node in ast.walk(root):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in hook_names:
            out.append(node)
        elif isinstance(f, ast.Attribute) and f.attr == "HOOK":
            out.append(node)
    return out


def _has_lru_cache(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        d = dotted(target)
        if d and d.split(".")[-1] in ("lru_cache", "cache"):
            return True
    return False


def summarize_function(fn: ast.AST, qualname: str) -> FunctionSummary:
    params = tuple(a.arg for a in
                   fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs)
    self_calls: Set[str] = set()
    calls: Set[str] = set()
    call_nodes: List[ast.Call] = []
    attrs_written: Set[str] = set()
    attrs_read: Set[str] = set()
    handlers: List[HandlerInfo] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            call_nodes.append(node)
            d = dotted(node.func)
            if d:
                calls.add(d)
                if d.startswith("self.") and d.count(".") == 1:
                    self_calls.add(d.split(".", 1)[1])
        elif isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                attrs_written.add(node.attr)
            else:
                attrs_read.add(node.attr)
        elif isinstance(node, ast.Try):
            for h in node.handlers:
                handlers.append(HandlerInfo(_handler_type_names(h),
                                            h.lineno, h, node))
    return FunctionSummary(
        name=fn.name, qualname=qualname, node=fn, line=fn.lineno,
        params=params, self_calls=self_calls, calls=calls,
        call_nodes=call_nodes, attrs_written=attrs_written,
        attrs_read=attrs_read, handlers=handlers,
        dominant_calls=list(_spine_calls(fn.body, frozenset())),
        option_inputs=_option_inputs(fn),
        cache_sites=_cache_sites(fn),
        reraise_params=_reraise_params(fn, params),
        drains_decl=contracts.drain_decls(fn),
        absorbs_reason=contracts.absorbs_reason(fn),
        has_lru_cache=_has_lru_cache(fn),
        has_seam_call=bool(seam_calls(fn)),
    )


def summarize_class(cls: ast.ClassDef) -> ClassSummary:
    methods: Dict[str, FunctionSummary] = {}
    init_containers: Dict[str, int] = {}
    for stmt in cls.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        methods[stmt.name] = summarize_function(
            stmt, f"{cls.name}.{stmt.name}")
        if stmt.name == "__init__":
            for node in ast.walk(stmt):
                targets: List[ast.AST] = []
                value = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets, value = [node.target], node.value
                if value is None or not _container_ctor(value):
                    continue
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        init_containers.setdefault(t.attr, t.lineno)
    return ClassSummary(
        name=cls.name, node=cls, line=cls.lineno,
        bases=tuple(dotted(b) or "<expr>" for b in cls.bases),
        rings=contracts.ring_decls(cls),
        drain_map=contracts.class_drain_map(cls),
        methods=methods, init_container_attrs=init_containers)


def summarize_module(mod: ModuleInfo) -> ModuleSummary:
    classes: Dict[str, ClassSummary] = {}
    functions: Dict[str, FunctionSummary] = {}
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.ClassDef):
            classes[stmt.name] = summarize_class(stmt)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            functions[stmt.name] = summarize_function(stmt, stmt.name)
    return ModuleSummary(mod=mod, classes=classes, functions=functions)


# ----------------------------------------------------------------------
# the index: one summary set per module, plus composed queries
# ----------------------------------------------------------------------
class DataflowIndex:
    """Summaries for every module in a :class:`ModuleIndex`, computed
    lazily and cached, plus the interprocedural queries the EXON rules
    ask."""

    def __init__(self, index: ModuleIndex):
        self.index = index
        self._cache: Dict[str, ModuleSummary] = {}
        self._carrying: Optional[Set[str]] = None

    @classmethod
    def shared(cls, index: ModuleIndex) -> "DataflowIndex":
        """One DataflowIndex per ModuleIndex, cached on the index itself:
        the three EXON rules each need the same per-module summaries and
        the same fault-carrying fixpoint, and rebuilding them tripled the
        full-registry wall clock (the test_lint_full budget)."""
        dfi = getattr(index, "_dataflow_index", None)
        if dfi is None or dfi.index is not index:
            dfi = cls(index)
            index._dataflow_index = dfi
        return dfi

    def module(self, mod: ModuleInfo) -> ModuleSummary:
        ms = self._cache.get(mod.rel)
        if ms is None:
            ms = self._cache[mod.rel] = summarize_module(mod)
        return ms

    # -- EXON001: quiescence ------------------------------------------
    def drains_attr(self, cls: ClassSummary, method: str, attr: str,
                    depth: int = MAX_COMPOSE_DEPTH,
                    _visited: Optional[Set[str]] = None) -> bool:
        """True when calling ``method`` on an instance of ``cls``
        dominates a drain of ``attr``: the method is a declared drain, or
        its unconditional spine (allowing the pure ``if self.<attr>:``
        guard) calls one, transitively to ``depth`` hops."""
        if method in cls.drain_map.get(attr, ()):
            return True
        fs = cls.methods.get(method)
        if fs is None:
            return False
        if attr in fs.drains_decl:
            return True
        if depth <= 0:
            return False
        visited = _visited if _visited is not None else set()
        if method in visited:
            return False
        visited.add(method)
        for dc in fs.dominant_calls:
            if not dc.name.startswith("self."):
                continue
            if not dc.guard_attrs <= {attr}:
                continue          # guarded by something other than the ring
            callee = dc.name.split(".", 1)[1]
            if self.drains_attr(cls, callee, attr, depth - 1, visited):
                return True
        return False

    # -- EXON002: cache-key completeness ------------------------------
    def required_key_inputs(self, msum: ModuleSummary,
                            cls: Optional[ClassSummary],
                            fs: FunctionSummary,
                            depth: int = MAX_COMPOSE_DEPTH,
                            _visited: Optional[Set[str]] = None) -> Set[str]:
        """Dotted names (caller's frame) that flow into program options
        (device, dtype) reachable from ``fs`` — the set a memo key must
        cover.  ``self.X``
        inputs of same-class callees propagate unchanged (same instance);
        parameter inputs map through the call-site arguments."""
        required = set(fs.option_inputs)
        if depth <= 0:
            return required
        visited = _visited if _visited is not None else set()
        if fs.qualname in visited:
            return required
        visited.add(fs.qualname)
        for call in fs.call_nodes:
            d = dotted(call.func)
            if d is None:
                continue
            callee: Optional[FunctionSummary] = None
            if d.startswith("self.") and d.count(".") == 1 and \
                    cls is not None:
                callee = cls.methods.get(d.split(".", 1)[1])
            elif "." not in d:
                callee = msum.functions.get(d)
            if callee is None:
                continue
            sub = self.required_key_inputs(msum, cls, callee, depth - 1,
                                           visited)
            for name in sub:
                if name.startswith("self."):
                    if d.startswith("self."):
                        required.add(name)       # same instance
                elif name in callee.params:
                    mapped = self._map_param(callee, call, name,
                                             skip_self=d.startswith("self."))
                    if mapped:
                        required.add(mapped)
        return required

    @staticmethod
    def _map_param(callee: FunctionSummary, call: ast.Call, param: str,
                   *, skip_self: bool) -> Optional[str]:
        """Dotted name of the call-site argument bound to ``param``."""
        for kw in call.keywords:
            if kw.arg == param:
                names = dotted_names(kw.value)
                return next(iter(names)) if len(names) == 1 else None
        params = list(callee.params)
        if skip_self and params and params[0] in ("self", "cls"):
            params = params[1:]
        try:
            pos = params.index(param)
        except ValueError:
            return None
        if pos < len(call.args):
            names = dotted_names(call.args[pos])
            return next(iter(names)) if len(names) == 1 else None
        return None

    # -- EXON003: fault transparency ----------------------------------
    def fault_carrying_names(self) -> Set[str]:
        """Trailing names of functions through which an injected fault
        can propagate: functions containing a direct seam call, plus
        (fixpoint, :data:`MAX_COMPOSE_DEPTH` rounds) functions that call
        one by trailing name.  Name-based matching across modules is a
        deliberate over-approximation — dynamic dispatch (RPC proxies,
        thread targets) breaks the chain, which is the documented
        soundness limit."""
        if self._carrying is not None:
            return self._carrying
        summaries: List[FunctionSummary] = []
        for mod in self.index.modules:
            msum = self.module(mod)
            summaries.extend(msum.functions.values())
            for cls in msum.classes.values():
                summaries.extend(cls.methods.values())
        carrying: Set[str] = {fs.name for fs in summaries
                              if fs.has_seam_call}
        trailing = [(fs.name, {d.split(".")[-1] for d in fs.calls})
                    for fs in summaries]
        for _ in range(MAX_COMPOSE_DEPTH):
            added = False
            for name, called in trailing:
                if name not in carrying and called & carrying:
                    carrying.add(name)
                    added = True
            if not added:
                break
        self._carrying = carrying
        return carrying

    def try_body_carries_fault(self, try_node: ast.Try,
                               fn_node: Optional[ast.AST] = None) -> bool:
        """True when the try BODY (not the handlers) can raise an
        injected fault: it makes a seam call directly, or calls a
        fault-carrying function by trailing name.  ``fn_node`` supplies
        the alias scope for the ``hook = _chaos.HOOK`` idiom."""
        aliases = _alias_map(fn_node if fn_node is not None else try_node)
        carrying = self.fault_carrying_names()
        for stmt in try_node.body:
            if seam_calls(stmt, aliases):
                return True
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    d = dotted(node.func)
                    if d and d.split(".")[-1] in carrying:
                        return True
        return False

    def call_reraises(self, msum: ModuleSummary, cls: Optional[ClassSummary],
                      calls: Sequence[ast.Call], caught: str) -> bool:
        """True when one of ``calls`` (normally the calls inside an
        ``except`` body) passes the caught exception ``caught`` to a
        helper that re-raises the param alongside an injected-fault
        reference (``coordinator._failed(cid, exc)`` pattern)."""
        for call in calls:
            passes = any(isinstance(a, ast.Name) and a.id == caught
                         for a in call.args) or \
                any(isinstance(kw.value, ast.Name) and kw.value.id == caught
                    for kw in call.keywords)
            if not passes:
                continue
            d = dotted(call.func)
            if d is None:
                continue
            callee: Optional[FunctionSummary] = None
            skip_self = False
            if d.startswith("self.") and d.count(".") == 1 and \
                    cls is not None:
                callee = cls.methods.get(d.split(".", 1)[1])
                skip_self = True
            elif "." not in d:
                callee = msum.functions.get(d)
            if callee is None or not callee.reraise_params:
                continue
            # which callee param receives `caught`?
            for kw in call.keywords:
                if isinstance(kw.value, ast.Name) and kw.value.id == caught \
                        and kw.arg in callee.reraise_params:
                    return True
            params = list(callee.params)
            if skip_self and params and params[0] in ("self", "cls"):
                params = params[1:]
            for i, a in enumerate(call.args):
                if isinstance(a, ast.Name) and a.id == caught and \
                        i < len(params) and params[i] in callee.reraise_params:
                    return True
        return False


__all__ = [
    "MAX_COMPOSE_DEPTH", "OPTION_KWARGS", "CONSTANT_ROOTS", "OPAQUE_GUARD",
    "dotted", "dotted_names", "option_exprs",
    "DominantCall", "CacheKeySite", "HandlerInfo",
    "FunctionSummary", "ClassSummary", "ModuleSummary",
    "summarize_function", "summarize_class", "summarize_module",
    "DataflowIndex",
]
