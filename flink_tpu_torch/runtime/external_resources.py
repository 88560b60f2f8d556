"""External resource framework: accelerator discovery.

Counterpart of `flink_tpu/runtime/external_resources.py`. Analogue of
flink-core/.../externalresource/ExternalResourceDriver.java and the GPU
driver (flink-external-resources/flink-external-resource-gpu/...
GPUDriver.java), surfaced to operators through
`get_external_resource_infos` (RuntimeContext.getExternalResourceInfos).
The port's first-class driver is the CUDA one: it reports the devices
torch sees (index, name, compute capability, memory), the information a
task needs to pin itself to a card, where the JAX package's "tpu" driver
reports the chips jax sees. The "gpu" driver reads CUDA_VISIBLE_DEVICES,
as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import torch


class ExternalResourceInfo:
    def __init__(self, properties: Dict[str, Any]):
        self._props = dict(properties)

    def get_property(self, key: str, default=None):
        return self._props.get(key, default)

    @property
    def properties(self) -> Dict[str, Any]:
        return dict(self._props)

    def __repr__(self):
        return f"ExternalResourceInfo({self._props})"


class ExternalResourceDriver:
    name: str = ""

    def retrieve_resource_info(self, amount: int) -> List[ExternalResourceInfo]:
        raise NotImplementedError


class CudaDriver(ExternalResourceDriver):
    """Discovers the CUDA devices torch sees (none without a GPU)."""

    name = "cuda"

    def retrieve_resource_info(self, amount: int) -> List[ExternalResourceInfo]:
        if not torch.cuda.is_available():
            return []
        n = torch.cuda.device_count()
        out = []
        for i in range(n if amount <= 0 else min(amount, n)):
            p = torch.cuda.get_device_properties(i)
            out.append(ExternalResourceInfo({
                "id": i,
                "platform": "gpu",
                "device_kind": p.name,
                "compute_capability": f"{p.major}.{p.minor}",
                "memory_bytes": int(p.total_memory),
                "multiprocessor_count": int(p.multi_processor_count),
                "process_index": 0,
            }))
        return out


class GpuDriver(ExternalResourceDriver):
    """GPU discovery by index (GPUDriver.java analogue): reads the indices
    from CUDA_VISIBLE_DEVICES when set."""

    name = "gpu"

    def retrieve_resource_info(self, amount: int) -> List[ExternalResourceInfo]:
        visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
        ids = [v for v in visible.split(",") if v.strip()]
        return [ExternalResourceInfo({"index": v}) for v in ids[:amount or None]]


_DRIVERS: Dict[str, ExternalResourceDriver] = {}


def register_driver(driver: ExternalResourceDriver) -> None:
    _DRIVERS[driver.name] = driver


def get_external_resource_infos(name: str, amount: int = 0) -> List[ExternalResourceInfo]:
    """RuntimeContext.getExternalResourceInfos analogue."""
    driver = _DRIVERS.get(name)
    if driver is None:
        raise KeyError(f"no external resource driver {name!r} (have {sorted(_DRIVERS)})")
    return driver.retrieve_resource_info(amount)


register_driver(CudaDriver())
register_driver(GpuDriver())
