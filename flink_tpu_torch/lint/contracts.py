"""Exactly-once contract annotations.

Counterpart of the runtime decorators of `flink_tpu/lint/contracts.py`:
an operator declares its in-flight structures and the methods that drain
them on the class itself, so an analysis of the source can require every
checkpoint capture to reach a drain. The decorators only attach metadata;
they stay dependency-free.

The analyzer reads the declarations back from the AST (`ring_decls`,
`drain_decls`, `absorbs_reason`, `class_drain_map`) and never imports the
decorated module, so the same vocabulary works on packages that cannot be
imported (the seeded corpus of the rule tests).

``@inflight_ring("_inflight", drained_by="_resolve_inflight")``
    Class decorator: instances own in-flight state in ``attr``, which the
    named method empties.

``@drains("_inflight", ...)``
    Method decorator: the method drains the named attributes too.

``@absorbs_faults("reason")``
    Function decorator: the function's broad exception handlers absorb
    faults on purpose, for the reason given (refused when empty).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Tuple

#: metadata attribute names
RING_ATTR = "__lint_inflight_rings__"
DRAINS_ATTR = "__lint_drains__"
ABSORBS_ATTR = "__lint_absorbs_faults__"


# ----------------------------------------------------------------------
# runtime decorators (no-ops beyond metadata)
# ----------------------------------------------------------------------
def inflight_ring(attr: str, *, drained_by: str):
    """Declare that the decorated class owns in-flight state in ``attr``
    which ``drained_by`` (a method name) empties."""
    if not attr or not drained_by:
        raise ValueError("inflight_ring requires attr and drained_by")

    def deco(cls):
        rings = list(getattr(cls, RING_ATTR, ()))
        rings.append((attr, drained_by))
        setattr(cls, RING_ATTR, tuple(rings))
        return cls

    return deco


def drains(*attrs: str):
    """Mark the decorated method as a drain for the named attributes."""
    if not attrs:
        raise ValueError("drains requires at least one attribute name")

    def deco(fn):
        setattr(fn, DRAINS_ATTR, tuple(getattr(fn, DRAINS_ATTR, ()) + tuple(attrs)))
        return fn

    return deco


def absorbs_faults(reason: str):
    """Allowlist the decorated function's handlers for EXON003, with an
    attributed reason (refused when empty)."""
    if not reason or not reason.strip():
        raise ValueError("absorbs_faults requires a non-empty reason")

    def deco(fn):
        setattr(fn, ABSORBS_ATTR, reason)
        return fn

    return deco


# ----------------------------------------------------------------------
# AST extraction — what the analyzer actually consumes
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RingDecl:
    """One ``@inflight_ring`` declaration read off a ClassDef."""

    attr: str          # instance attribute holding in-flight state
    drained_by: str    # method that empties it
    line: int          # decorator line (violation anchor)


def _decorator_name(dec: ast.AST) -> Optional[str]:
    """Trailing name of a decorator expression: ``inflight_ring`` for
    ``@inflight_ring(...)``, ``@contracts.inflight_ring(...)`` and
    ``@_contracts.inflight_ring(...)`` alike."""
    target = dec.func if isinstance(dec, ast.Call) else dec
    if isinstance(target, ast.Attribute):
        return target.attr
    if isinstance(target, ast.Name):
        return target.id
    return None


def _const_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def ring_decls(cls: ast.ClassDef) -> List[RingDecl]:
    """``@inflight_ring`` declarations on a class, in source order.
    Malformed declarations (non-literal args) are skipped — the runtime
    decorator would have raised at import time anyway."""
    out: List[RingDecl] = []
    for dec in cls.decorator_list:
        if _decorator_name(dec) != "inflight_ring" or \
                not isinstance(dec, ast.Call):
            continue
        attr = _const_str(dec.args[0]) if dec.args else None
        drained_by = None
        for kw in dec.keywords:
            if kw.arg == "drained_by":
                drained_by = _const_str(kw.value)
        if len(dec.args) > 1 and drained_by is None:
            drained_by = _const_str(dec.args[1])
        if attr and drained_by:
            out.append(RingDecl(attr=attr, drained_by=drained_by,
                                line=dec.lineno))
    return out


def drain_decls(fn: ast.AST) -> Tuple[str, ...]:
    """Attributes a ``@drains(...)`` decorated method declares it empties
    (empty tuple when undecorated)."""
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return ()
    attrs: List[str] = []
    for dec in fn.decorator_list:
        if _decorator_name(dec) != "drains" or not isinstance(dec, ast.Call):
            continue
        for arg in dec.args:
            s = _const_str(arg)
            if s:
                attrs.append(s)
    return tuple(attrs)


def absorbs_reason(fn: ast.AST) -> Optional[str]:
    """The attributed reason of an ``@absorbs_faults`` decorator, or None.
    An empty/whitespace reason returns "" so the caller can reject it
    (distinct from "not decorated")."""
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    for dec in fn.decorator_list:
        if _decorator_name(dec) != "absorbs_faults":
            continue
        if isinstance(dec, ast.Call) and dec.args:
            return _const_str(dec.args[0]) or ""
        return ""          # @absorbs_faults bare / non-literal: reject
    return None


def class_drain_map(cls: ast.ClassDef) -> Dict[str, List[str]]:
    """attr -> method names that drain it, combining the canonical
    ``drained_by`` methods with every ``@drains`` declaration."""
    out: Dict[str, List[str]] = {}
    for decl in ring_decls(cls):
        out.setdefault(decl.attr, []).append(decl.drained_by)
    for stmt in cls.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for attr in drain_decls(stmt):
            methods = out.setdefault(attr, [])
            if stmt.name not in methods:
                methods.append(stmt.name)
    return out


__all__ = [
    "inflight_ring", "drains", "absorbs_faults",
    "RingDecl", "ring_decls", "drain_decls", "absorbs_reason",
    "class_drain_map",
    "RING_ATTR", "DRAINS_ATTR", "ABSORBS_ATTR",
]
