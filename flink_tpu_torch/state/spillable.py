"""Spillable heap backend: cold key-groups move to disk under pressure.

Counterpart of `flink_tpu/state/spillable.py`, copied. Analogue of
flink-statebackend-heap-spillable (S6): wraps the heap backend (whose
tables are already key-group organized, state/heap.py
`_tables[name][key_group][(key, ns)]` — mirroring the reference's
per-key-group StateTables), tracks key-group heat, and when the in-memory
entry count exceeds the budget, pickles the coldest key-groups to disk;
touching a spilled key-group faults it back in transparently. Key-group
granularity matches the rescaling unit (KeyGroupRange, S1), so spilled
units remain valid snapshot/restore units.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Dict, List, Optional

from flink_tpu_torch.state.heap import HeapKeyedStateBackend, StateDescriptor


class SpillReadError(RuntimeError):
    """A spilled key-group artifact is missing or unreadable. Typed (vs a
    raw FileNotFoundError/UnpicklingError) so callers can distinguish
    "the spill tier lost data" from an ordinary state-access bug and take
    the restore-from-checkpoint path."""


class SpillableKeyedStateBackend:
    """Heap backend + key-group spill tier."""

    def __init__(
        self,
        inner: HeapKeyedStateBackend,
        *,
        max_entries_in_memory: int = 100_000,
        spill_dir: Optional[str] = None,
    ):
        self.inner = inner
        self.max_entries = max_entries_in_memory
        self.dir = spill_dir or tempfile.mkdtemp(prefix="flink_tpu_torch_spill_kg_")
        os.makedirs(self.dir, exist_ok=True)
        self._heat: Dict[int, float] = {}           # key_group -> last access
        self._spilled: Dict[int, str] = {}          # key_group -> file
        self.num_spills = 0
        self.num_faults = 0
        # writes since the last exact count: the exact scan is O(state), so
        # it only runs after enough writes could have crossed the budget
        self._writes_since_check = 0
        self._entries_at_check = 0

    # -- context ------------------------------------------------------------
    def set_current_key(self, key) -> None:
        self.inner.set_current_key(key)
        kg = self.inner._current_key_group
        self._fault_in(kg)
        self._heat[kg] = time.monotonic()
        self._maybe_spill()

    @property
    def current_key(self):
        return self.inner.current_key

    # -- delegation ----------------------------------------------------------
    def register(self, descriptor: StateDescriptor) -> None:
        self.inner.register(descriptor)

    def get(self, name: str, namespace=None):
        return self.inner.get(name, namespace)

    def put(self, name: str, value, namespace=None) -> None:
        self.inner.put(name, value, namespace)
        self._writes_since_check += 1

    def add(self, name: str, value, namespace=None) -> None:
        self.inner.add(name, value, namespace)
        self._writes_since_check += 1

    def clear(self, name: str, namespace=None) -> None:
        self.inner.clear(name, namespace)

    def merge_namespaces(self, name: str, target, sources) -> None:
        self.inner.merge_namespaces(name, target, sources)

    def keys(self, name: str) -> List:
        self._fault_all()
        return self.inner.keys(name)

    def __getattr__(self, item):
        return getattr(self.inner, item)

    # -- spilling -------------------------------------------------------------
    def _mem_entries(self) -> int:
        return sum(
            len(slot)
            for table in self.inner._tables.values()
            for slot in table.values()
        )

    def _maybe_spill(self) -> None:
        if self._entries_at_check + self._writes_since_check <= self.max_entries:
            return  # cannot have crossed the budget yet: skip the exact scan
        self._entries_at_check = self._mem_entries()
        self._writes_since_check = 0
        if self._entries_at_check <= self.max_entries:
            return
        current_kg = self.inner._current_key_group
        live_kgs = {
            kg
            for table in self.inner._tables.values()
            for kg, slot in table.items()
            if slot
        }
        for kg in sorted(live_kgs, key=lambda g: self._heat.get(g, 0.0)):  # coldest first
            if kg == current_kg:
                continue
            if self._mem_entries() <= self.max_entries:
                break
            payload = {
                name: table.pop(kg)
                for name, table in self.inner._tables.items()
                if kg in table
            }
            path = os.path.join(self.dir, f"kg-{kg}.spill")
            with open(path, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            self._spilled[kg] = path
            self.num_spills += 1
        self._entries_at_check = self._mem_entries()

    def _fault_in(self, kg: int) -> None:
        path = self._spilled.pop(kg, None)
        if path is None:
            return
        try:
            with open(path, "rb") as f:
                payload = pickle.load(f)
        except Exception as e:  # noqa: BLE001 — unpickling garbage raises
            # anything (UnpicklingError, EOFError, ValueError, ...);
            # re-raised typed below, never swallowed
            # the artifact stays registered so a retry/restore sees the
            # same state it faulted on (popping it would silently turn a
            # lost key-group into an empty one)
            self._spilled[kg] = path
            raise SpillReadError(
                f"spilled key-group {kg} unreadable at {path}: {e!r}"
            ) from e
        for name, slot in payload.items():
            self.inner._tables.setdefault(name, {})[kg] = slot
            self._entries_at_check += len(slot)
        os.unlink(path)
        self.num_faults += 1

    def _fault_all(self) -> None:
        for kg in list(self._spilled):
            self._fault_in(kg)

    # -- snapshot -------------------------------------------------------------
    def snapshot(self) -> Dict:
        self._fault_all()
        return self.inner.snapshot()

    def restore(self, snap: Dict,
                descriptors: Optional[Dict[str, StateDescriptor]] = None) -> None:
        self._spilled.clear()
        self._heat.clear()
        self.inner.restore(snap, descriptors)

    def is_empty(self) -> bool:
        return not self._spilled and self.inner.is_empty()
