"""Concurrency rule family (CONC): lock discipline over the threaded runtime.

The runtime spawns 18+ threads across cluster/dataplane/rpc/heartbeat/
metrics; "Towards Concurrent Stateful Stream Processing on Multicore
Processors" (PAPERS.md) identifies shared-state races and lock-ordering
bugs as the dominant failure mode of multicore streaming engines. These
rules turn the informally-held invariants into CI:

- CONC001 inconsistent-guard — a field written both under its lock and
  bare is a race by construction.
- CONC002 lock-order-cycle — a cycle in the static acquisition graph is a
  deadlock waiting for the right interleaving.
- CONC003 blocking-under-lock — sleeping/accepting under a lock turns
  every contender into a convoy.
- CONC004 thread-hygiene — unnamed/non-daemon threads are invisible in
  the dashboard's thread attribution and can wedge interpreter shutdown.
- CONC005 no-silent-swallow — `except Exception: pass` in the runtime/
  checkpoint subtrees hides the exact transient faults the chaos plane
  exists to surface.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from flink_tpu_torch.lint.index import ModuleIndex, enclosing_scope, parent_map
from flink_tpu_torch.lint.locks import CONSTRUCTION_METHODS, build_lock_models
from flink_tpu_torch.lint.rule import Rule, Violation, register


@register
class InconsistentGuardRule(Rule):
    id = "CONC001"
    name = "inconsistent-guard"
    family = "concurrency"
    rationale = (
        "For each class owning a threading.Lock/RLock/Condition, the lock "
        "model infers which lock guards each mutable `self._*` attribute "
        "from the `with self._lock:` regions that write it. An attribute "
        "written both inside such a region and outside any (excluding "
        "__init__, whose writes happen before publication) has no "
        "consistent guard: one of the two writers races the other."
    )
    hint = ("move the bare write under the guarding lock, or extract a "
            "`_locked` helper called only while holding it (the model "
            "propagates caller-held locks one call hop)")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        for model in build_lock_models(index):
            per_attr: Dict[str, Dict[str, List]] = {}
            for w in model.writes:
                if w.attr in model.locks:
                    continue              # the lock attrs themselves
                slot = per_attr.setdefault(w.attr, {"locked": [], "bare": []})
                if w.held:
                    slot["locked"].append(w)
                elif not w.nested and w.method not in CONSTRUCTION_METHODS:
                    slot["bare"].append(w)
            for attr, slot in sorted(per_attr.items()):
                if not slot["locked"] or not slot["bare"]:
                    continue
                guards = sorted({lk for w in slot["locked"] for lk in w.held})
                first_bare = min(slot["bare"], key=lambda w: w.line)
                locked_lines = sorted({w.line for w in slot["locked"]})
                owner = model.qualname or "<module>"
                yield Violation(
                    rule_id=self.id, path=model.mod.rel_to_project,
                    line=first_bare.line,
                    message=(
                        f"{owner}.{attr} is written under "
                        f"{'/'.join(guards)} (line"
                        f"{'s' if len(locked_lines) > 1 else ''} "
                        f"{', '.join(map(str, locked_lines))}) but bare in "
                        f"{first_bare.method}() — inconsistent guard"
                    ),
                    scope=f"{owner}", symbol=attr, hint=self.hint)


@register
class LockOrderCycleRule(Rule):
    id = "CONC002"
    name = "lock-order-cycle"
    family = "concurrency"
    rationale = (
        "Nested `with` acquisitions define a static lock-order graph "
        "across all runtime modules (one self-call hop deep: a method "
        "called while holding A contributes A -> each lock it acquires). "
        "A cycle means two threads can interleave into a deadlock; a "
        "self-edge on a non-reentrant Lock/Condition deadlocks a single "
        "thread on its own."
    )
    hint = ("acquire the locks in one global order everywhere, or collapse "
            "the two locks into one; for an intentional re-entry use an "
            "RLock")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        graph: Dict[str, Set[str]] = {}
        edge_info: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        self_edge_kind: Dict[str, str] = {}
        for model in build_lock_models(index):
            for outer, inner, line, method in model.acquisition_edges:
                a, b = model.lock_node(outer), model.lock_node(inner)
                if a == b:
                    kind = model.locks[outer].kind
                    if kind == "RLock":
                        continue          # reentrant: legal by design
                    scope = f"{model.qualname or '<module>'}.{method}"
                    yield Violation(
                        rule_id=self.id, path=model.mod.rel_to_project,
                        line=line,
                        message=(f"{a.split(':', 1)[1]} ({kind}) is "
                                 f"re-acquired while already held in "
                                 f"{method}() — single-thread deadlock"),
                        scope=scope, symbol=f"{outer}->{outer}",
                        hint=self.hint)
                    continue
                graph.setdefault(a, set()).add(b)
                graph.setdefault(b, set())
                edge_info.setdefault(
                    (a, b),
                    (model.mod.rel_to_project, line,
                     f"{model.qualname or '<module>'}.{method}"))
        for cycle in _find_cycles(graph):
            a, b = cycle[0], cycle[1]
            path, line, scope = edge_info.get((a, b), ("", 0, ""))
            pretty = " -> ".join(n.split(":", 1)[1] for n in [*cycle, cycle[0]])
            yield Violation(
                rule_id=self.id, path=path or cycle[0].split(":", 1)[0],
                line=line,
                message=f"lock-order cycle: {pretty}",
                scope=scope, symbol="|".join(sorted(cycle)), hint=self.hint)


def _find_cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Simple cycles via DFS; each cycle reported once, rotated to start at
    its smallest node so the violation fingerprint is stable."""
    cycles: List[List[str]] = []
    seen_keys: Set[str] = set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    stack: List[str] = []

    def dfs(n: str) -> None:
        color[n] = GRAY
        stack.append(n)
        for m in sorted(graph.get(n, ())):
            if color.get(m, WHITE) == GRAY:
                i = stack.index(m)
                cyc = stack[i:]
                k = min(range(len(cyc)), key=lambda j: cyc[j])
                rot = cyc[k:] + cyc[:k]
                key = "|".join(rot)
                if key not in seen_keys:
                    seen_keys.add(key)
                    cycles.append(rot)
            elif color.get(m, WHITE) == WHITE:
                dfs(m)
        stack.pop()
        color[n] = BLACK

    for n in sorted(graph):
        if color[n] == WHITE:
            dfs(n)
    return cycles


#: dotted call targets that block the calling thread
BLOCKING_CALLS = {
    "time.sleep": "time.sleep()",
    "socket.create_connection": "socket.create_connection()",
    "subprocess.run": "subprocess.run()",
    "subprocess.call": "subprocess.call()",
    "subprocess.check_call": "subprocess.check_call()",
    "subprocess.check_output": "subprocess.check_output()",
}
#: attribute calls on an unknown receiver that are blocking socket ops
BLOCKING_ATTRS = {".accept", ".connect", ".recv", ".recv_into", ".sendall",
                  ".sendmsg", ".makefile"}


@register
class BlockingUnderLockRule(Rule):
    id = "CONC003"
    name = "blocking-under-lock"
    family = "concurrency"
    rationale = (
        "time.sleep, blocking socket calls, and subprocess waits inside a "
        "`with lock:` region hold every contending thread hostage for the "
        "full wait — on the control plane that turns one slow peer into a "
        "cluster-wide convoy (and, combined with CONC002 edges, into "
        "distributed deadlock)."
    )
    hint = ("move the wait outside the region (copy state under the lock, "
            "block after releasing it), or use Condition.wait with a "
            "timeout so the lock is released while waiting")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        for model in build_lock_models(index):
            seen_in_scope: Dict[Tuple[str, str], int] = {}
            for call in model.calls:
                if not call.held:
                    continue
                label = None
                if call.func_repr in BLOCKING_CALLS:
                    label = BLOCKING_CALLS[call.func_repr]
                elif "." in call.func_repr:
                    # match on the method name whatever the receiver
                    # spelling: `.accept` (unknown chain), `sock.accept`
                    # (local variable), `self._sock.accept` (collapsed to
                    # `._sock.accept` by _dotted)
                    suffix = "." + call.func_repr.rsplit(".", 1)[1]
                    if suffix in BLOCKING_ATTRS:
                        label = f"{call.func_repr}()"
                if label is None:
                    continue
                held = "/".join(sorted(call.held))
                scope = call.scope or call.method
                # occurrence-indexed symbol: the 2nd/3rd/... blocking call
                # in one scope must NOT share the 1st one's fingerprint, or
                # a single baseline entry silently suppresses all of them
                # (the index stays line-independent: it only shifts when
                # sites are added/removed within the same scope)
                base = f"{call.func_repr}@{call.method}"
                n = seen_in_scope[(scope, base)] = \
                    seen_in_scope.get((scope, base), 0) + 1
                yield Violation(
                    rule_id=self.id, path=model.mod.rel_to_project,
                    line=call.line,
                    message=(f"{label} while holding {held} in "
                             f"{scope}() — blocks every "
                             f"contender for the full wait"),
                    scope=scope,
                    symbol=base if n == 1 else f"{base}#{n}",
                    hint=self.hint)


#: package-relative subtrees where a silent broad swallow is a violation:
#: the runtime's control/data planes and the checkpoint layer — exactly
#: where a swallowed transient fault becomes an undiagnosable hang or a
#: silently-lost checkpoint (chaos-plane hardening)
SWALLOW_SCOPED_SUBTREES = ("runtime", "checkpoint")
_BROAD_EXC_NAMES = {"Exception", "BaseException"}


def _is_broad_handler(type_node) -> bool:
    """Bare `except:`, `except Exception/BaseException:`, or a tuple
    containing one of those. Narrow handlers (OSError, KeyError, ...) are
    deliberate per-fault decisions and stay legal."""
    if type_node is None:
        return True
    if isinstance(type_node, ast.Name):
        return type_node.id in _BROAD_EXC_NAMES
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad_handler(e) for e in type_node.elts)
    return False


@register
class NoSilentSwallowRule(Rule):
    id = "CONC005"
    name = "no-silent-swallow"
    family = "concurrency"
    rationale = (
        "An `except Exception: pass` (or bare `except: pass`) on the "
        "runtime/checkpoint planes erases the one signal that "
        "distinguishes a transient fault from a real failure: the "
        "heartbeat manager silently eating ping errors is exactly how a "
        "partitioned TM stays 'alive' until the timeout, and a swallowed "
        "checkpoint error is a lost recovery point nobody hears about. "
        "Best-effort calls may survive peer failures, but they must LOG "
        "or COUNT what they swallowed (missedPings, _swallow(site, e)) — "
        "or carry a written justification in lint_baseline_torch.json. Narrow "
        "except types (OSError on a socket close) remain legal: they are "
        "per-fault decisions, not blanket blindness."
    )
    hint = ("log/count the swallowed exception (see cluster._swallow, "
            "heartbeat.missed_pings), narrow the except type, or justify "
            "the entry in lint_baseline_torch.json")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        for layer in SWALLOW_SCOPED_SUBTREES:
            for mod in index.in_subtree(layer):
                parents = None
                seen_in_scope: Dict[str, int] = {}
                for node in ast.walk(mod.tree):
                    if not isinstance(node, ast.ExceptHandler):
                        continue
                    if not _is_broad_handler(node.type):
                        continue
                    if not all(isinstance(s, ast.Pass) for s in node.body):
                        continue
                    if parents is None:
                        parents = parent_map(mod.tree)
                    scope = enclosing_scope(parents, node)
                    # occurrence-indexed symbol (see CONC003): one baseline
                    # entry must not cover every swallow in the scope
                    n = seen_in_scope[scope] = seen_in_scope.get(scope, 0) + 1
                    caught = ("bare except" if node.type is None
                              else f"except {ast.unparse(node.type)}")
                    yield Violation(
                        rule_id=self.id, path=mod.rel_to_project,
                        line=node.lineno,
                        message=(f"{caught}: pass in "
                                 f"{scope or '<module>'} silently swallows "
                                 "every failure, transient or fatal"),
                        scope=scope,
                        symbol=(f"swallow@{scope}" if n == 1
                                else f"swallow@{scope}#{n}"),
                        hint=self.hint)


@register
class ThreadHygieneRule(Rule):
    id = "CONC004"
    name = "thread-hygiene"
    family = "concurrency"
    rationale = (
        "Every threading.Thread(...) must pass BOTH daemon= and name=: an "
        "unnamed thread is invisible in the dashboard's thread attribution "
        "and the flamegraph's per-thread folding, and an accidental "
        "non-daemon thread wedges interpreter shutdown (the reference "
        "names every executor thread for the same reason — "
        "ExecutorThreadFactory)."
    )
    hint = ("pass name=\"<subsystem>-<what>\" and an explicit daemon= to "
            "the Thread constructor")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        for mod in index.modules:
            parents = None
            seen_in_scope: Dict[str, int] = {}
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                is_thread = (
                    isinstance(fn, ast.Attribute) and fn.attr == "Thread"
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "threading"
                ) or (isinstance(fn, ast.Name) and fn.id == "Thread")
                if not is_thread:
                    continue
                kwargs = {k.arg for k in node.keywords if k.arg}
                missing = sorted({"daemon", "name"} - kwargs)
                if not missing:
                    continue
                if parents is None:
                    parents = parent_map(mod.tree)
                scope = enclosing_scope(parents, node)
                # occurrence-indexed symbol (see CONC003): one baseline
                # entry must not cover every unnamed Thread in the scope
                n = seen_in_scope[scope] = seen_in_scope.get(scope, 0) + 1
                symbol = f"Thread@{scope}" if n == 1 else \
                    f"Thread@{scope}#{n}"
                yield Violation(
                    rule_id=self.id, path=mod.rel_to_project,
                    line=node.lineno,
                    message=(f"threading.Thread(...) missing "
                             f"{' and '.join(f'{m}=' for m in missing)} "
                             f"in {scope or '<module>'}"),
                    scope=scope, symbol=symbol, hint=self.hint)
