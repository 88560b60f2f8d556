"""Finding a cell's pieces by name.

BENCHMARK.json (at the checkout's root) names each cell's configuration and
traffic mix and each metric; the files are
`configs/<config>.json`, `jobs/<config>.py`, `gens/<config>.py`,
`reference/<config>.py`, `roofline/<config>.py`, `cells/<traffic>.json` and
`metrics/<metric>.py`, all under streambench/. A later cell, configuration
or metric is added as files and BENCHMARK.json entries alone.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict[str, Any]        # configs/<config>.json
    traffic: Dict[str, Any]       # cells/<traffic>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """streambench/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = f"streambench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: Dict[str, Any], workload: str) -> bool:
    cells = metric.get("workloads")
    return cells is None or workload in cells


def load_cell(workload: str, benchmark: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell `workload` of BENCHMARK.json (or of `benchmark`, a parsed
    file of the same form), with its configuration, traffic and the
    metrics it reports."""
    bench = benchmark if benchmark is not None else read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"],
        config=read_json(BENCH_DIR / "configs" / f"{w['config']}.json"),
        traffic=read_json(BENCH_DIR / "cells" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])
