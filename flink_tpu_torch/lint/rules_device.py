"""Device-discipline rule family (DEV): keep the CUDA hot path hot.

The JAX package's rules read ``jax.jit`` bodies; the port has none. Its
device work is hand-written kernels, built by nvcc into libraries that
``ops/cuda_superscan.py::_library`` binds with ctypes, so the rules read
the functions that launch them:

- DEV001 host-sync-in-dispatch — a function that launches a kernel
  through a ctypes entry point of a ``_library(...)`` library (or calls
  one that does, in the same module) runs on every dispatch; a
  ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, a synchronize, an
  ``np.asarray`` or a non-static ``int()``/``float()``/``bool()`` there
  waits for the card on every dispatch.
- DEV002 build-in-loop — building or loading a kernel library
  (``build``, ``_library``, ``ctypes.CDLL``,
  ``torch.utils.cpp_extension.load*``, ``torch.compile``) inside a loop
  body: at best a cache lookup a record batch, at worst an nvcc run.
- DEV003 torch-free-control-plane — the cluster control plane must not
  import torch (or triton) at module level: importing it (a REST reader,
  the CLI, a tool) must not pay torch's import. A process that needs
  torch imports it on purpose (the jobmanager's ``main`` does, before it
  unpickles job specs).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from flink_tpu_torch.lint.dataflow import MAX_COMPOSE_DEPTH, dotted
from flink_tpu_torch.lint.index import ModuleIndex, ModuleInfo, enclosing_scope, parent_map
from flink_tpu_torch.lint.rule import Rule, Violation, register

#: modules (package-relative) that form the cluster control plane
CONTROL_PLANE = (
    "runtime/cluster.py",
    "runtime/rpc.py",
    "runtime/blob.py",
    "runtime/heartbeat.py",
    "runtime/ha.py",
    "runtime/ha_kubernetes.py",
    "runtime/rest.py",
    "runtime/dataplane.py",
    "security/framing.py",
    "security/transport.py",
    # the history/doctor plane consumes plain-data snapshots and span
    # dicts handed to it — a torch import here would drag its import into
    # every REST reader and JM schedule tick
    "metrics/history.py",
    "metrics/doctor.py",
)

#: the call that binds a kernel library (``ops/cuda_superscan.py``)
LIBRARY_BINDER = "_library"

#: attribute calls that wait for the card
HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}

def _numpy_aliases(mod: ModuleInfo) -> Set[str]:
    aliases = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    aliases.add(a.asname or "numpy")
    return aliases


def _trailing(node: ast.AST) -> Optional[str]:
    d = dotted(node)
    return d.split(".")[-1] if d else None


def _library_receivers(mod: ModuleInfo) -> Set[str]:
    """Trailing names bound to a kernel library in the module:
    ``lib = _library(...)``, ``self.lib = cs._library(...)``."""
    names: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _trailing(node.value.func) == LIBRARY_BINDER:
            for t in node.targets:
                name = _trailing(t)
                if name:
                    names.add(name)
    return names


def _launches(fn: ast.AST, receivers: Set[str]) -> bool:
    """True when ``fn`` binds a library or calls an entry point on one:
    ``lib.k1_partials(...)``, ``h.lib.k4_session_merge(...)``,
    ``getattr(lib, entry)(...)``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if _trailing(f) == LIBRARY_BINDER:
            return True
        if isinstance(f, ast.Attribute) and _trailing(f.value) in receivers:
            return True
        if isinstance(f, ast.Call) and isinstance(f.func, ast.Name) and \
                f.func.id == "getattr" and f.args and \
                _trailing(f.args[0]) in receivers:
            return True
    return False


def _functions(mod: ModuleInfo) -> List[Tuple[str, ast.AST, Optional[str]]]:
    """(qualname, def, enclosing class) of every module-level function and
    method."""
    out: List[Tuple[str, ast.AST, Optional[str]]] = []
    for stmt in mod.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((stmt.name, stmt, None))
        elif isinstance(stmt, ast.ClassDef):
            for m in stmt.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append((f"{stmt.name}.{m.name}", m, stmt.name))
    return out


def dispatch_functions(mod: ModuleInfo) -> List[Tuple[str, ast.AST]]:
    """The module's device-dispatch functions: those that launch a kernel
    (:func:`_launches`), then, to :data:`MAX_COMPOSE_DEPTH` rounds, those
    that call one by bare name (module functions) or through ``self``
    (methods of the same class)."""
    receivers = _library_receivers(mod)
    funcs = _functions(mod)
    dispatch: Set[str] = {q for q, fn, _c in funcs if _launches(fn, receivers)}
    if not dispatch:
        return []
    calls: Dict[str, Set[str]] = {}
    for q, fn, cls in funcs:
        called: Set[str] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d is None:
                continue
            if "." not in d:
                called.add(d)
            elif cls is not None and d.startswith("self.") and d.count(".") == 1:
                called.add(f"{cls}.{d.split('.', 1)[1]}")
        calls[q] = called
    for _ in range(MAX_COMPOSE_DEPTH):
        added = {q for q, called in calls.items()
                 if q not in dispatch and called & dispatch}
        if not added:
            break
        dispatch |= added
    return [(q, fn) for q, fn, _c in funcs if q in dispatch]


def _contains_static_marker(expr: ast.AST) -> bool:
    """float()/int() on shapes and sizes is static metadata, not a host
    sync — skip literal args and args mentioning .shape/.ndim/.size/len().
    A nested literal (an index like x[-1]) does NOT make the arg static."""
    if isinstance(expr, ast.Constant):
        return True
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in ("shape", "ndim",
                                                             "size", "dtype"):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "len":
            return True
    return False


@register
class HostSyncInDispatchRule(Rule):
    id = "DEV001"
    name = "host-sync-in-dispatch"
    family = "device"
    rationale = (
        "A function that launches a hand-written kernel through a ctypes "
        "entry point of a _library(...) library, or calls one that does "
        "in the same module, runs on every dispatch. Calling .item(), "
        ".tolist(), .cpu(), .numpy(), torch.cuda.synchronize() or an "
        "event's/stream's .synchronize(), np.asarray/np.array, or "
        "int()/float()/bool() on a tensor there blocks the host until the "
        "card has drained its queue — the exact sync an asynchronous "
        "dispatch exists to avoid. Host conversions belong at the step "
        "boundary (the runner's readback section). Shapes, sizes and "
        "literals are not device values; a conversion of host data the "
        "rule cannot tell from a tensor is baselined with its reason."
    )
    hint = ("keep the dispatch free of readbacks: convert on the host plan "
            "before it, or read the result back at the step boundary")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        for mod in index.modules:
            funcs = dispatch_functions(mod)
            if not funcs:
                continue
            parents = parent_map(mod.tree)
            np_names = _numpy_aliases(mod) or {"np"}
            # occurrence-indexed symbols: the 2nd .item() in one function
            # must not share the 1st one's fingerprint, or a single
            # baseline entry suppresses every current and future host sync
            # of that label in the scope
            seen: Dict[Tuple[str, str], int] = {}
            for qualname, fn in funcs:
                fname = fn.name
                for stmt in fn.body:
                    yield from self._scan(stmt, mod, fname, qualname,
                                          np_names, parents, seen)

    def _scan(self, root: ast.AST, mod: ModuleInfo, fname: str,
              qualname: str, np_names: Set[str],
              parents: Dict[ast.AST, ast.AST],
              seen: Dict[Tuple[str, str], int]) -> Iterator[Violation]:
        for node in ast.walk(root):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            label = None
            if isinstance(fn, ast.Attribute):
                if fn.attr in HOST_SYNC_ATTRS:
                    label = (f"{dotted(fn)}()" if dotted(fn) ==
                             "torch.cuda.synchronize" else f".{fn.attr}()")
                elif fn.attr in ("asarray", "array") and \
                        isinstance(fn.value, ast.Name) and \
                        fn.value.id in np_names:
                    label = f"{fn.value.id}.{fn.attr}()"
            elif isinstance(fn, ast.Name) and fn.id in ("float", "int",
                                                        "bool"):
                arg = node.args[0] if node.args else None
                if arg is not None and not _contains_static_marker(arg):
                    label = f"{fn.id}()"
            if label is None:
                continue
            scope = enclosing_scope(parents, node) or qualname
            base = f"{label}@{fname}"
            n = seen[(scope, base)] = seen.get((scope, base), 0) + 1
            yield self.violation(
                mod, node.lineno,
                f"host-sync {label} inside device dispatch {fname}()",
                scope=scope, symbol=base if n == 1 else f"{base}#{n}")


def _is_build_call(fn: ast.AST) -> Optional[str]:
    """The label of a call that builds or loads a kernel library, else
    None."""
    d = dotted(fn)
    if d is None:
        return None
    last = d.split(".")[-1]
    if last in ("build", LIBRARY_BINDER, "CDLL"):
        return f"{last}(...)"
    if last.startswith("load") and "cpp_extension" in d.split("."):
        return f"cpp_extension.{last}(...)"
    if d == "torch.compile":
        return "torch.compile(...)"
    return None


@register
class BuildInLoopRule(Rule):
    id = "DEV002"
    name = "build-in-loop"
    family = "device"
    rationale = (
        "Building or loading a kernel library — cuda_superscan.build(...), "
        "_library(...), ctypes.CDLL(...), torch.utils.cpp_extension."
        "load*(...) or torch.compile(...) — inside a for/while body runs "
        "the build (an nvcc or a compile) or at best its cache lookup on "
        "every iteration, on the hot path. Every launcher binds its "
        "library once (the _library cache, keyed on the source hash) "
        "outside the loop; new code must do the same."
    )
    hint = ("hoist the build/load out of the loop (bind the library once; "
            "_library caches per process)")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        for mod in index.modules:
            parents = None
            seen: Dict[str, int] = {}
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                label = _is_build_call(node.func)
                if label is None:
                    continue
                if parents is None:
                    parents = parent_map(mod.tree)
                loop = self._enclosing_loop(node, parents)
                if loop is None:
                    continue
                scope = enclosing_scope(parents, node)
                n = seen[scope] = seen.get(scope, 0) + 1
                yield self.violation(
                    mod, node.lineno,
                    (f"{label} inside a "
                     f"{'for' if isinstance(loop, (ast.For, ast.AsyncFor)) else 'while'} "
                     f"loop body in {scope or '<module>'} — per-iteration "
                     f"kernel build hazard"),
                    scope=scope,
                    symbol=(f"build-in-loop@{scope}" if n == 1 else
                            f"build-in-loop@{scope}#{n}"))

    @staticmethod
    def _enclosing_loop(node: ast.AST,
                        parents: Dict[ast.AST, ast.AST]) -> Optional[ast.AST]:
        cur = parents.get(node)
        child = node
        while cur is not None:
            # stop at function boundaries: a def inside a loop runs later
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return None
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)) and \
                    child in getattr(cur, "body", []) + getattr(cur, "orelse", []):
                return cur
            child = cur
            cur = parents.get(cur)
        return None


#: modules whose import at module level the control plane must not make
DEVICE_MODULES = ("torch", "triton")


@register
class TorchFreeControlPlaneRule(Rule):
    id = "DEV003"
    name = "torch-free-control-plane"
    family = "device"
    rationale = (
        "The cluster control plane (JM/TM endpoints, RPC, blob, "
        "heartbeats, HA, REST, dataplane, security, the history/doctor "
        "plane) must not import torch or triton at module level: torch's "
        "import costs seconds, and every process that imports one of these "
        "modules (a REST reader, the CLI, a tool) would pay it. "
        "Device-path code imports torch inside the functions that run on "
        "the device (TaskExecutorEndpoint's resolve_device, the release's "
        "synchronize); a process that needs torch imports it on purpose "
        "(the jobmanager's main, before it unpickles job specs)."
    )
    hint = ("move the torch import inside the function that needs it "
            "(device path only)")

    def check(self, index: ModuleIndex) -> Iterator[Violation]:
        for rel in CONTROL_PLANE:
            mod = index.get(rel)
            if mod is None:
                continue
            for imp, line in index.module_level_imports(mod):
                root = imp.split(".")[0]
                if root in DEVICE_MODULES:
                    yield self.violation(
                        mod, line,
                        f"control-plane module imports {imp} at module "
                        f"level (torch import and CUDA init at start-up)",
                        scope="", symbol=f"import:{imp}")
