"""Managed memory: budgeted reservations for device and host state.

Counterpart of `flink_tpu/runtime/memory.py`. Analogue of
runtime/memory/MemoryManager.java:60: consumers lease slices of a fixed
budget by weight (device ring state, host spill memtables, exchange
buffers); reservations are bookkeeping that turns an opaque out-of-memory
error into an early, attributable one. The device budget is the CUDA
device's total memory as `torch.cuda.mem_get_info` reports it, less a
headroom fraction for PyTorch's caching allocator and temporaries; where
the device reports none (the CPU) it is 8 GiB, as in the JAX package.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch


class MemoryReservationError(MemoryError):
    pass


class MemoryManager:
    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._used: Dict[str, int] = {}
        self._lock = threading.Lock()

    @staticmethod
    def for_device(device=None, headroom: float = 0.1) -> "MemoryManager":
        """Budget from the CUDA device's total memory (`device`, default the
        current one), less `headroom`; 8 GiB when no CUDA device reports
        its memory."""
        total = None
        try:
            dev = torch.device(device) if device is not None else None
            if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
                _free, total = torch.cuda.mem_get_info(dev)
        except (RuntimeError, AssertionError, ValueError):
            total = None
        if not total:
            total = 8 << 30
        return MemoryManager(int(total * (1.0 - headroom)))

    def reserve(self, owner: str, nbytes: int) -> None:
        with self._lock:
            used = sum(self._used.values())
            if used + nbytes > self.budget:
                raise MemoryReservationError(
                    f"{owner} wants {nbytes >> 20} MiB but only "
                    f"{(self.budget - used) >> 20} MiB of the "
                    f"{self.budget >> 20} MiB managed budget is free "
                    f"(holders: { {k: v >> 20 for k, v in self._used.items()} })"
                )
            self._used[owner] = self._used.get(owner, 0) + nbytes

    def release(self, owner: str, nbytes: Optional[int] = None) -> None:
        with self._lock:
            if owner not in self._used:
                return
            if nbytes is None or nbytes >= self._used[owner]:
                del self._used[owner]
            else:
                self._used[owner] -= nbytes

    def available(self) -> int:
        with self._lock:
            return self.budget - sum(self._used.values())

    def used_by(self, owner: str) -> int:
        with self._lock:
            return self._used.get(owner, 0)

    def split_by_weights(self, weights: Dict[str, float]) -> Dict[str, int]:
        """Divide the budget by consumer weights (the
        taskmanager.memory.managed.consumer-weights scheme)."""
        total = sum(weights.values())
        return {k: int(self.budget * w / total) for k, w in weights.items()}
