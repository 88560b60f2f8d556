"""The mesh of shards: a list of torch devices and an axis name.

Counterpart of `flink_tpu/parallel/mesh.py`. The JAX mesh has one
controller: one process holds every device and runs one program over
them. The port keeps that architecture. A `Mesh` is N shards, each a
`torch.device`; the process launches each shard's work on that shard's
device, and the keyBy exchange moves blocks between the shards' devices
(ops/exchange.py). A device may repeat in the list: four shards over one
GPU run every shard's exchange and kernels on that card, time-sharing it
(the counterpart of the JAX tests' virtual 8-device CPU mesh); on a host
with several GPUs the same code places each shard on its own card.

`visible_devices(device)` is the one place that says which devices a job
may use: `[cuda:i for each GPU]` for CUDA and `[cpu]` for the CPU. Tests
and the smoke test replace it to get N virtual shards; there is no
configuration key or environment variable for that.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from flink_tpu_torch.core.keygroups import KeyGroupRange, key_group_range_for_operator

SHARD_AXIS = "shards"


class Mesh:
    """N shards over a list of torch devices (repeats allowed)."""

    def __init__(self, devices: Sequence, axis_name: str = SHARD_AXIS):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.axis_name = axis_name

    @property
    def shape(self) -> dict:
        """{axis name: shard count}, as a JAX mesh's `shape`."""
        return {self.axis_name: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis_name!r})"


def visible_devices(device) -> List[torch.device]:
    """The devices a job on `device`'s type may place shards on."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def build_mesh(num_shards: Optional[int] = None, devices: Optional[Sequence] = None,
               axis_name: str = SHARD_AXIS) -> Mesh:
    """A mesh over the first `num_shards` of `devices` (default: every
    visible CUDA device)."""
    if devices is None:
        devices = visible_devices("cuda")
    devices = list(devices)
    n = num_shards or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} shards but only {len(devices)} devices")
    return Mesh(devices[:n], axis_name)


def usable_mesh_size(want: int, available: int, key_capacity: int) -> int:
    """THE mesh-size clamp, single-sourced: `want` devices (0 = all
    available) clamped to the visible device count, then rounded DOWN to
    the largest divisor of `key_capacity` so contiguous key ranges divide
    evenly across shards. 1 means no multi-device mesh applies. Every
    consumer of the clamp (runner construction, the rescale pre-check, the
    smoke test) must call this — a privately re-derived copy can silently
    diverge and turn accepted rescale targets into no-op churn."""
    n = max(1, min(int(want) or int(available), int(available)))
    while n > 1 and key_capacity % n != 0:
        n -= 1
    return n


def shard_ranges(mesh: Mesh, max_parallelism: int,
                 axis_name: str = SHARD_AXIS) -> List[KeyGroupRange]:
    """Key-group range per shard (the reference's operator-index ranges)."""
    n = mesh.shape[axis_name]
    return [key_group_range_for_operator(max_parallelism, n, i) for i in range(n)]
