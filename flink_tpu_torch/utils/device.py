"""Device selection for the port's entry points, and host<->device copies."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else `cuda`.

    With no explicit device and no GPU this raises — the port never falls
    back to the CPU on its own; CPU runs (the tests) ask for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "flink_tpu_torch runs on CUDA and no GPU is available; pass "
            "device='cpu' explicitly to run the plain PyTorch path"
        )
    return torch.device("cuda")


def staging_buffer(shape, dtype, device: torch.device):
    """An uninitialized host buffer to stage inputs of `device` in, as
    (numpy view, tensor): pinned when `device` is CUDA, so `upload` copies
    it without blocking the host on queued device work (a dispatch can be
    staged while the previous one still runs) and without a second host
    copy."""
    t = torch.empty(tuple(shape), dtype=torch.from_numpy(np.zeros(0, dtype)).dtype,
                    pin_memory=device.type == "cuda")
    return t.numpy(), t


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A tensor from `staging_buffer` on `device` (non-blocking on CUDA; the
    caching host allocator holds the pinned buffer until the copy has run)."""
    if device.type != "cuda":
        return t
    return t.to(device, non_blocking=True)


class HostCopy:
    """Tensors on their way to the host (None entries pass through): on
    CUDA, pinned non_blocking copies started at construction and ordered by
    one CUDA event recorded after them; `wait` blocks on that event only."""

    def __init__(self, tensors):
        self._host = list(tensors)
        self._event = None
        cuda = [t for t in self._host if t is not None and t.is_cuda]
        if cuda:
            self._host = [None if t is None else _pinned_copy(t) for t in self._host]
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(cuda[0].device))

    def wait(self) -> list:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host
