"""Heap keyed-state backend: the CPU/oracle state store.

Counterpart of `flink_tpu/state/heap.py`, copied, but for one repair: an
auto-registering backend takes a restored state at its first use, where
the JAX backend raises KeyError (ROADMAP.md Queue C, not reproduced).

Capability parity with HeapKeyedStateBackend
(flink-runtime .../state/heap/HeapKeyedStateBackend.java:85): named states of
kind Value/List/Map/Reducing/Aggregating, scoped by (current key, current
namespace), organized per key group for snapshot/rescale. Namespaces are the
window objects, exactly as in the reference (state per key×window).

Snapshots are deep-ish copies of the per-key-group tables (the reference uses
copy-on-write state maps for async snapshots, CopyOnWriteStateMap.java:108;
here snapshot cost is dominated by the device state anyway, and the heap
backend is the small/oracle path, so a plain copy keeps it simple and
correct).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from flink_tpu_torch.core.functions import AggregateFunction, ReduceFunction, as_reduce_function
from flink_tpu_torch.core.keygroups import KeyGroupRange, assign_to_key_group


@dataclasses.dataclass(frozen=True)
class StateTtlConfig:
    """State time-to-live (TtlStateFactory.java:54 analogue): processing-time
    TTL with NeverReturnExpired visibility. `update_on_read=True` matches
    UpdateType.OnReadAndWrite; default is OnCreateAndWrite. Expired entries
    are invisible immediately, dropped on access, and filtered from
    snapshots (the 'cleanup in full snapshot' strategy)."""

    ttl_ms: int
    update_on_read: bool = False


@dataclasses.dataclass(frozen=True)
class StateDescriptor:
    name: str
    kind: str  # 'value' | 'list' | 'map' | 'reducing' | 'aggregating'
    default: Any = None
    reduce_fn: Optional[ReduceFunction] = None
    agg_fn: Optional[AggregateFunction] = None
    ttl: Optional[StateTtlConfig] = None


def value_state(name: str, default=None, ttl: Optional[StateTtlConfig] = None) -> StateDescriptor:
    return StateDescriptor(name, "value", default, ttl=ttl)


def list_state(name: str, ttl: Optional[StateTtlConfig] = None) -> StateDescriptor:
    return StateDescriptor(name, "list", ttl=ttl)


def map_state(name: str, ttl: Optional[StateTtlConfig] = None) -> StateDescriptor:
    return StateDescriptor(name, "map", ttl=ttl)


def reducing_state(name: str, reduce_fn, ttl: Optional[StateTtlConfig] = None) -> StateDescriptor:
    return StateDescriptor(name, "reducing", reduce_fn=as_reduce_function(reduce_fn), ttl=ttl)


def aggregating_state(name: str, agg_fn: AggregateFunction,
                      ttl: Optional[StateTtlConfig] = None) -> StateDescriptor:
    return StateDescriptor(name, "aggregating", agg_fn=agg_fn, ttl=ttl)


class HeapKeyedStateBackend:
    """State tables: {state_name: {key_group: {(key, namespace): value}}}.

    The (current_key, current_namespace) context is set by the operator
    before state access, mirroring AbstractKeyedStateBackend.setCurrentKey /
    InternalKvState.setCurrentNamespace.
    """

    def __init__(self, key_group_range: KeyGroupRange, max_parallelism: int,
                 auto_register: bool = False,
                 clock: Optional[Callable[[], int]] = None):
        self.key_group_range = key_group_range
        self.max_parallelism = max_parallelism
        self.auto_register = auto_register
        # processing-time source for state TTL (injectable for tests)
        self.clock = clock or (lambda: int(time.time() * 1000))
        self._tables: Dict[str, Dict[int, Dict[Tuple, Any]]] = {}
        self._auto_names: set = set()   # auto-registered placeholder states
        self._ttl_ts: Dict[str, Dict[int, Dict[Tuple, int]]] = {}
        self._descriptors: Dict[str, StateDescriptor] = {}
        self._current_key: Any = None
        self._current_key_group: int = -1

    # -- context ----------------------------------------------------------
    def set_current_key(self, key) -> None:
        self._current_key = key
        self._current_key_group = assign_to_key_group(key, self.max_parallelism)

    @property
    def current_key(self):
        return self._current_key

    def register(self, descriptor: StateDescriptor) -> None:
        existing = self._descriptors.get(descriptor.name)
        if existing is not None and descriptor.name in self._auto_names:
            # an explicit descriptor supersedes an auto-registered
            # placeholder (get()-before-register with auto_register=True),
            # so late TTL/kind declarations are honored, not discarded
            self._descriptors[descriptor.name] = descriptor
            self._auto_names.discard(descriptor.name)
        else:
            self._descriptors.setdefault(descriptor.name, descriptor)
        self._tables.setdefault(descriptor.name, {})
        if descriptor.ttl is not None:
            # a TTL descriptor registered over already-restored entries (the
            # auto_register/late-registration path) must stamp them now, or
            # they would never expire
            now = self.clock()
            for kg, entries in self._tables[descriptor.name].items():
                stamps = self._ttl_ts.setdefault(descriptor.name, {}).setdefault(kg, {})
                for k in entries:
                    stamps.setdefault(k, now)

    # -- access (key from context, namespace explicit) --------------------
    def _slot(self, name: str) -> Dict[Tuple, Any]:
        table = self._tables.get(name)
        if table is None or (self.auto_register and name not in self._descriptors):
            if not self.auto_register:
                raise KeyError(
                    f"state {name!r} not registered (register a descriptor "
                    "first, or construct the backend with auto_register=True)"
                )
            # dynamic registration: ProcessFunctions may declare state at
            # first use (getState(descriptor) mid-stream in the reference);
            # mark it auto so an explicit register() can supersede it. A
            # table restored from a snapshot (which holds no descriptors)
            # registers the same way at its first use, its entries kept:
            # the JAX backend raises KeyError there (ROADMAP.md Queue C)
            self.register(value_state(name))
            self._auto_names.add(name)
            table = self._tables[name]
        return table.setdefault(self._current_key_group, {})

    def _ttl_slot(self, name: str) -> Dict[Tuple, int]:
        return self._ttl_ts.setdefault(name, {}).setdefault(
            self._current_key_group, {})

    def _ttl_live(self, name: str, desc: StateDescriptor, k: Tuple) -> bool:
        """NeverReturnExpired: drop + report dead when past the TTL."""
        ts = self._ttl_slot(name).get(k)
        if ts is not None and self.clock() - ts > desc.ttl.ttl_ms:
            self._slot(name).pop(k, None)
            self._ttl_slot(name).pop(k, None)
            return False
        return True

    def get(self, name: str, namespace=None):
        slot = self._slot(name)  # may dynamically register (auto_register)
        desc = self._descriptors[name]
        k = (self._current_key, namespace)
        val = slot.get(k, _MISSING)
        if val is not _MISSING and desc.ttl is not None:
            if not self._ttl_live(name, desc, k):
                val = _MISSING
            elif desc.ttl.update_on_read:
                self._ttl_slot(name)[k] = self.clock()
        if val is _MISSING:
            return copy.copy(desc.default) if desc.kind == "value" else None
        return val

    def put(self, name: str, value, namespace=None) -> None:
        k = (self._current_key, namespace)
        self._slot(name)[k] = value
        if self._descriptors[name].ttl is not None:
            self._ttl_slot(name)[k] = self.clock()

    def add(self, name: str, value, namespace=None) -> None:
        """Reducing/Aggregating/List add (HeapAggregatingState.add:94)."""
        if name not in self._descriptors and self.auto_register:
            # dynamic first-use via add() implies append semantics
            self.register(list_state(name))
            self._auto_names.add(name)
        desc = self._descriptors[name]
        slot = self._slot(name)
        k = (self._current_key, namespace)
        if desc.ttl is not None:
            self._ttl_live(name, desc, k)  # evicts an expired accumulator
        cur = slot.get(k, _MISSING)
        if desc.ttl is not None:
            self._ttl_slot(name)[k] = self.clock()
        if desc.kind == "list":
            if cur is _MISSING:
                slot[k] = [value]
            else:
                cur.append(value)
        elif desc.kind == "reducing":
            slot[k] = value if cur is _MISSING else desc.reduce_fn.reduce(cur, value)
        elif desc.kind == "aggregating":
            acc = desc.agg_fn.create_accumulator() if cur is _MISSING else cur
            slot[k] = desc.agg_fn.add(value, acc)
        else:
            raise TypeError(f"add() not supported for state kind {desc.kind}")

    def clear(self, name: str, namespace=None) -> None:
        self._slot(name).pop((self._current_key, namespace), None)
        if self._descriptors.get(name) is not None and \
                self._descriptors[name].ttl is not None:
            self._ttl_slot(name).pop((self._current_key, namespace), None)

    def merge_namespaces(self, name: str, target, sources: Iterable) -> None:
        """Merge state of `sources` namespaces into `target` for the current
        key (used by session-window merge; InternalMergingState)."""
        desc = self._descriptors[name]
        slot = self._slot(name)
        ttl_slot = self._ttl_slot(name) if desc.ttl is not None else None
        merged = slot.pop((self._current_key, target), _MISSING)
        for ns in sources:
            v = slot.pop((self._current_key, ns), _MISSING)
            if ttl_slot is not None:
                ttl_slot.pop((self._current_key, ns), None)
            if v is _MISSING:
                continue
            if merged is _MISSING:
                merged = v
            elif desc.kind == "list":
                merged = merged + v
            elif desc.kind == "reducing":
                merged = desc.reduce_fn.reduce(merged, v)
            elif desc.kind == "aggregating":
                merged = desc.agg_fn.merge(merged, v)
            else:
                raise TypeError(f"merge not supported for kind {desc.kind}")
        if merged is not _MISSING:
            slot[(self._current_key, target)] = merged
            if ttl_slot is not None:
                ttl_slot[(self._current_key, target)] = self.clock()

    # -- introspection / snapshot ----------------------------------------
    def namespaces_for_key(self, name: str, key) -> List:
        kg = assign_to_key_group(key, self.max_parallelism)
        table = self._tables.get(name, {}).get(kg, {})
        return [ns for (k, ns) in table.keys() if k == key]

    def keys(self, name: str) -> List:
        out = set()
        for kg_table in self._tables.get(name, {}).values():
            out.update(k for (k, _ns) in kg_table.keys())
        return list(out)

    def is_empty(self) -> bool:
        return all(not kg for t in self._tables.values() for kg in t.values())

    def snapshot(self) -> Dict:
        """Per-key-group snapshot: {state_name: {kg: {(key, ns): value}}}.
        Expired TTL entries are filtered out (the reference's
        'cleanup in full snapshot' strategy); surviving entries restore with
        a fresh TTL stamp."""
        now = self.clock()
        out = {}
        for name, table in self._tables.items():
            desc = self._descriptors.get(name)
            if desc is None or desc.ttl is None:
                out[name] = copy.deepcopy(table)
                continue
            ttl = desc.ttl.ttl_ms
            out[name] = {
                kg: {
                    k: copy.deepcopy(v)
                    for k, v in entries.items()
                    if now - self._ttl_ts.get(name, {}).get(kg, {}).get(k, now) <= ttl
                }
                for kg, entries in table.items()
            }
        return out

    def restore(self, snap: Dict, descriptors: Optional[Dict[str, StateDescriptor]] = None) -> None:
        if descriptors:
            for d in descriptors.values():
                self.register(d)
        # keep only key groups in our range (rescale-aware restore, S1)
        self._tables = {
            name: {
                kg: dict(entries)
                for kg, entries in table.items()
                if self.key_group_range.contains(kg)
            }
            for name, table in copy.deepcopy(snap).items()
        }
        for name in self._descriptors:
            self._tables.setdefault(name, {})
        # restored TTL entries restart their clock at restore time
        now = self.clock()
        self._ttl_ts = {}
        for name, desc in self._descriptors.items():
            if desc.ttl is None:
                continue
            for kg, entries in self._tables.get(name, {}).items():
                self._ttl_ts.setdefault(name, {})[kg] = {
                    k: now for k in entries
                }

    @property
    def descriptors(self) -> Dict[str, StateDescriptor]:
        return dict(self._descriptors)


_MISSING = object()
