"""The benchmark measures the PyTorch port alone: no module of JAX, Flax or
the JAX package may be loaded in its process. Names are compared by their
top level whole (`flink_tpu_torch` is not `flink_tpu`)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "flink_tpu"})


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})
