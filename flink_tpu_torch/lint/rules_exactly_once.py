"""Exactly-once contract rule family (EXON): machine-check the invariants
that keep checkpoints exactly-once on the device path.

- EXON001 quiescence-before-capture — a snapshot that does not dominate a
  drain of every in-flight structure its class owns silently loses
  whatever was still in flight: the checkpoint claims a consistent cut it
  does not contain (the capture-overlap model of checkpointing).  Classes
  declare their rings with ``@inflight_ring`` (:mod:`lint.contracts`);
  the rule verifies every capture method reaches a drain through the
  call chain, and that no *undeclared* ``_inflight``/``_pending``
  container hides on a class that captures.
- EXON002 executable-cache-key-completeness — a memoized torch program
  (an ``lru_cache`` builder or a dict memo) whose cache key omits a value
  that fixes its device or dtype serves a program built for the old
  device or type when that value flips.
- EXON003 fault-transparency — an ``except`` wide enough to catch
  ``InjectedCrash`` that neither re-raises it nor carries an attributed
  allowlist reason silently eats chaos coverage: every fault the suite
  injects through that seam looks survived when it was swallowed.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Tuple

from flink_tpu_torch.lint import dataflow
from flink_tpu_torch.lint.contracts import absorbs_reason as _contracts_absorbs
from flink_tpu_torch.lint.index import ModuleIndex, ModuleInfo, enclosing_scope, \
    parent_map
from flink_tpu_torch.lint.rule import Rule, Violation, register

#: package-relative subtrees whose classes are on the capture path
CAPTURE_SUBTREES = ("runtime", "parallel", "joins")

#: method names that capture checkpoint state
CAPTURE_METHODS = ("snapshot", "capture", "checkpoint")

#: instance attributes that look like in-flight dispatch state; a class
#: with a capture method must declare these via @inflight_ring (held
#: record buffers that RIDE the snapshot should not use these names)
INFLIGHT_NAME_RE = re.compile(r"^_(inflight|pending)(_|$|[a-z0-9])")

#: exception types wide enough to catch InjectedCrash
#: (InjectedCrash < InjectedFault < ConnectionError < OSError < Exception)
WIDE_TYPES = frozenset({
    "BaseException", "Exception", "ConnectionError", "OSError",
    "IOError", "EnvironmentError", "InjectedFault",
})

_INJECTED = ("InjectedCrash", "InjectedFault")


@register
class QuiescenceBeforeCaptureRule(Rule):
    id = "EXON001"
    name = "quiescence-before-capture"
    family = "exactly_once"
    rationale = (
        "Anything still in flight at a capture point is part of the state "
        "the checkpoint claims to contain: a snapshot() that does not "
        "dominate a drain of every @inflight_ring its class declares "
        "produces a cut that silently drops un-resolved device "
        "dispatches, so replay after restore loses records — the "
        "exactly-once hole that is otherwise re-found by hand. Drains are "
        "verified through the call chain (snapshot -> flush_all -> "
        "_resolve_inflight) on the unconditional statement spine; a "
        "guard that tests only the ring itself (`if self._pending: "
        "self._resolve_pending()`) counts, any other condition does not."
    )
    hint = ("call the declared drain (or a @drains helper) "
            "unconditionally before capturing; declare new dispatch "
            "buffers with @inflight_ring so the analyzer sees them")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        dfi = dataflow.DataflowIndex.shared(index)
        for subtree in CAPTURE_SUBTREES:
            for mod in index.in_subtree(subtree):
                msum = dfi.module(mod)
                for cls in msum.classes.values():
                    yield from self._check_class(dfi, mod, cls)

    def _check_class(self, dfi: dataflow.DataflowIndex, mod: ModuleInfo,
                     cls: dataflow.ClassSummary) -> Iterator[Violation]:
        captures = [m for m in CAPTURE_METHODS if m in cls.methods]
        for decl in cls.rings:
            drainers = cls.drain_map.get(decl.attr, [])
            if decl.drained_by not in cls.methods and not cls.has_bases:
                yield self.violation(
                    mod, decl.line,
                    f"{cls.name} declares @inflight_ring({decl.attr!r}) "
                    f"drained by {decl.drained_by!r}, but no such method "
                    f"exists on the class",
                    scope=cls.name, symbol=f"missing-drain:{decl.attr}")
                continue
            touched = any(decl.attr in fs.attrs_written or
                          decl.attr in fs.attrs_read
                          for fs in cls.methods.values())
            if not touched and not cls.has_bases:
                yield self.violation(
                    mod, decl.line,
                    f"{cls.name} declares @inflight_ring({decl.attr!r}) "
                    f"but no method reads or writes self.{decl.attr} — "
                    f"stale declaration",
                    scope=cls.name, symbol=f"stale-ring:{decl.attr}")
                continue
            for capture in captures:
                if not dfi.drains_attr(cls, capture, decl.attr):
                    fs = cls.methods[capture]
                    yield self.violation(
                        mod, fs.line,
                        f"{cls.name}.{capture}() does not dominate a "
                        f"drain of in-flight ring self.{decl.attr} "
                        f"(declared drained by {decl.drained_by}()) — "
                        f"records in flight at capture are lost from the "
                        f"checkpoint",
                        scope=f"{cls.name}.{capture}",
                        symbol=f"undrained:{decl.attr}")
        if captures:
            declared = set(cls.drain_map)
            for attr, line in sorted(cls.init_container_attrs.items()):
                if attr in declared or not INFLIGHT_NAME_RE.match(attr):
                    continue
                yield self.violation(
                    mod, line,
                    f"{cls.name} captures checkpoint state "
                    f"({'/'.join(captures)}) but owns an undeclared "
                    f"in-flight container self.{attr} — declare it with "
                    f"@inflight_ring(..., drained_by=...) or rename it if "
                    f"it legitimately rides the snapshot",
                    scope=cls.name, symbol=f"undeclared:{attr}")


def _from_params(name: str, params) -> bool:
    """A parameter, or an attribute of one other than ``self``/``cls``
    (``agg.result_dtype``): the caller passes it on every call, so the
    memo function's own key holds it."""
    root = name.split(".")[0]
    return name in params or (root in params and root not in ("self", "cls"))


@register
class CacheKeyCompletenessRule(Rule):
    id = "EXON002"
    name = "executable-cache-key-completeness"
    family = "exactly_once"
    rationale = (
        "A memoized torch program is only as correct as its cache key: "
        "any value that fixes where or in what type it computes — the "
        "device= and dtype= of its tensor constructors and .to(...) "
        "calls, the device of a torch.cuda.device(...) guard — must be "
        "in the key, or a flip of that value is served a program that "
        "allocates on the old device (a cross-device error or a silent "
        "copy on every call) or computes in the old type. For "
        "functools caches the parameters are the key; for dict memos the "
        "analyzer follows the memo function into its builder (bounded "
        "depth) and requires every option input in the key tuple "
        "(one-hop local aliases resolve)."
    )
    hint = ("add the missing value to the cache-key tuple (or to the "
            "memoized function's parameters for functools caches)")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        dfi = dataflow.DataflowIndex.shared(index)
        for mod in index.modules:
            msum = dfi.module(mod)
            scopes: List[Tuple[Optional[dataflow.ClassSummary],
                               dataflow.FunctionSummary]] = \
                [(None, fs) for fs in msum.functions.values()]
            for cls in msum.classes.values():
                scopes.extend((cls, fs) for fs in cls.methods.values())
            for cls, fs in scopes:
                yield from self._check_function(dfi, msum, mod, cls, fs)

    def _check_function(self, dfi: dataflow.DataflowIndex,
                        msum: dataflow.ModuleSummary, mod: ModuleInfo,
                        cls: Optional[dataflow.ClassSummary],
                        fs: dataflow.FunctionSummary) -> Iterator[Violation]:
        # functools.lru_cache/cache builders: the parameters ARE the key
        if fs.has_lru_cache and fs.option_inputs:
            has_self = fs.params[:1] in (("self",), ("cls",))
            missing = sorted(
                name for name in fs.option_inputs
                if not _from_params(name, fs.params) and
                not (has_self and name.startswith("self.")))
            if missing:
                yield self.violation(
                    mod, fs.line,
                    f"functools-cached builder {fs.qualname}() fixes its "
                    f"device/dtype from {', '.join(missing)} which are not "
                    f"parameters — the cache key cannot see them",
                    scope=fs.qualname, symbol="lru-key-incomplete")
        # dict-memo sites: key tuple must cover every option input
        if not fs.cache_sites:
            return
        required = dfi.required_key_inputs(msum, cls, fs)
        required = {r for r in required if r != "self"}
        if not required:
            return
        for site in fs.cache_sites:
            missing = sorted(n for n in required - site.components
                             if not _from_params(n, fs.params))
            if missing:
                yield self.violation(
                    mod, site.line,
                    f"executable cache {site.cache_name} in "
                    f"{fs.qualname}() is keyed on {site.key_var!r} which "
                    f"omits device/dtype input(s) {', '.join(missing)} — "
                    f"a flip of any of these serves a stale program",
                    scope=fs.qualname,
                    symbol=f"key-incomplete:{site.cache_name}")


@register
class FaultTransparencyRule(Rule):
    id = "EXON003"
    name = "fault-transparency"
    family = "exactly_once"
    rationale = (
        "Chaos coverage is only real if injected faults actually "
        "propagate: on modules that import the chaos plane (the fault "
        "seams), an except clause wide enough to catch InjectedCrash "
        "(bare, BaseException, Exception, ConnectionError, OSError, or "
        "InjectedFault) that neither re-raises it nor carries an "
        "attributed @absorbs_faults reason silently converts an injected "
        "process death into business-as-usual — every chaos test behind "
        "that seam then passes vacuously. Recognized transparent shapes: "
        "an earlier `except InjectedCrash: raise` clause, a bare raise, "
        "re-raising the caught name, an isinstance(InjectedCrash) guard "
        "with a raise, or delegating the exception to a helper that "
        "re-raises it (coordinator._failed)."
    )
    hint = ("add `except _chaos.InjectedCrash: raise` above the broad "
            "handler, or decorate the function with "
            "@absorbs_faults(\"<why absorption is the contract here>\")")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        dfi = dataflow.DataflowIndex.shared(index)
        chaos_prefix = f"{index.package}.chaos"
        for mod in index.modules:
            if mod.rel.startswith("chaos/") or mod.rel == "chaos.py":
                continue
            imports = {name for name, _ in index.all_imports(mod)}
            if not any(i == chaos_prefix or i.startswith(chaos_prefix + ".")
                       for i in imports):
                continue
            yield from self._check_module(dfi, index, mod)

    def _check_module(self, dfi: dataflow.DataflowIndex, index: ModuleIndex,
                      mod: ModuleInfo) -> Iterator[Violation]:
        msum = dfi.module(mod)
        parents = parent_map(mod.tree)
        seen: Dict[str, int] = {}
        scopes: List[Tuple[Optional[dataflow.ClassSummary],
                           dataflow.FunctionSummary]] = \
            [(None, fs) for fs in msum.functions.values()]
        for cls in msum.classes.values():
            scopes.extend((cls, fs) for fs in cls.methods.values())
        for cls, fs in scopes:
            for h in fs.handlers:
                yield from self._check_handler(dfi, msum, mod, parents,
                                               cls, fs, h, seen)

    def _check_handler(self, dfi: dataflow.DataflowIndex,
                       msum: dataflow.ModuleSummary, mod: ModuleInfo,
                       parents, cls, fs: dataflow.FunctionSummary,
                       h: dataflow.HandlerInfo,
                       seen: Dict[str, int]) -> Iterator[Violation]:
        types = h.type_names
        if "InjectedCrash" in types:
            return                    # explicit chaos handler: deliberate
        wide = not types or any(t in WIDE_TYPES for t in types)
        if not wide:
            return
        # a handler can only eat a fault its try body can raise: the body
        # must reach a chaos seam (directly, or through fault-carrying
        # calls) — `except OSError` around sock.close() is mere cleanup
        if not dfi.try_body_carries_fault(h.try_node, fs.node):
            return
        # (a) an earlier clause in the same try intercepts the fault
        for other in h.try_node.handlers:
            if other is h.node:
                break
            if any(t in _INJECTED
                   for t in dataflow._handler_type_names(other)):
                return
        body_nodes = [n for s in h.node.body for n in ast.walk(s)]
        raises = [n for n in body_nodes if isinstance(n, ast.Raise)]
        # (b) bare raise
        if any(r.exc is None for r in raises):
            return
        # (c) re-raises the caught name, or wraps it loudly: `raise
        # Typed(...) from e` chains the injected fault as __cause__ — the
        # failure propagates attributed, nothing is silently eaten
        caught = h.node.name
        if caught and any(
                (isinstance(r.exc, ast.Name) and r.exc.id == caught) or
                (isinstance(r.cause, ast.Name) and r.cause.id == caught)
                for r in raises):
            return
        # (d) isinstance-guard: references the injected types AND raises
        mentions = any(
            isinstance(n, (ast.Name, ast.Attribute)) and
            (dataflow.dotted(n) or "").split(".")[-1] in _INJECTED
            for n in body_nodes)
        if mentions and raises:
            return
        # (e) delegates the caught exception to a re-raising helper
        if caught:
            calls = [n for n in body_nodes if isinstance(n, ast.Call)]
            if dfi.call_reraises(msum, cls, calls, caught):
                return
        # (f) attributed allowlist on ANY enclosing function (handlers in
        # nested defs honor the nearest decorated ancestor)
        reason = None
        cur = h.node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                r = _contracts_absorbs(cur)
                if r is not None:
                    reason = r
                    break
            cur = parents.get(cur)
        if reason is not None and reason.strip():
            return
        scope = enclosing_scope(parents, h.node)
        label = ",".join(types) if types else "bare"
        base = f"except:{label}"
        n = seen[(scope, base)] = seen.get((scope, base), 0) + 1
        extra = (" (@absorbs_faults has an empty reason — attribute it)"
                 if reason is not None else "")
        yield self.violation(
            mod, h.line,
            f"except {label or '<bare>'} on a chaos seam can absorb "
            f"InjectedCrash without re-raising it — injected process "
            f"death becomes business-as-usual and chaos coverage goes "
            f"vacuous{extra}",
            scope=scope, symbol=base if n == 1 else f"{base}#{n}")
