"""On-demand flame graphs from thread stack sampling (O4 analogue).

The reference samples task-thread stacks JM-side on request
(runtime/webmonitor/threadinfo/ThreadInfoRequestCoordinator.java,
taskexecutor/ThreadInfoSampleService.java) and folds them into a per-vertex
flame graph (VertexFlameGraphFactory.java) served over REST
(JobVertexFlameGraphHandler.java). Here the sampler walks
`sys._current_frames()` — every live thread of the process, including task
step loops and RPC mains — at a fixed rate and folds the samples into the
same collapsed-stack tree the web UI renders.

Counterpart of `flink_tpu/metrics/flamegraph.py`, copied: host stacks only
(a kernel's time shows as the launching frame's).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional


def sample_stacks(duration_s: float = 0.5, hz: float = 50.0,
                  thread_filter: Optional[str] = None) -> Dict[str, int]:
    """Collect folded stacks: {'frameA;frameB;frameC': count}."""
    folded: Dict[str, int] = {}
    names = {t.ident: t.name for t in threading.enumerate()}
    deadline = time.monotonic() + duration_s
    interval = 1.0 / hz
    me = threading.get_ident()
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            name = names.get(ident, str(ident))
            if thread_filter and thread_filter not in name:
                continue
            stack: List[str] = []
            f = frame
            while f is not None:
                code = f.f_code
                stack.append(f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
                f = f.f_back
            key = name + ";" + ";".join(reversed(stack))
            folded[key] = folded.get(key, 0) + 1
        time.sleep(interval)
    return folded


def fold_to_tree(folded: Dict[str, int]) -> dict:
    """Collapsed stacks -> the nested {name, value, children} flame-graph
    tree shape the dashboard consumes (VertexFlameGraphFactory output)."""
    root = {"name": "root", "value": 0, "children": {}}
    for stack, count in folded.items():
        root["value"] += count
        node = root
        for frame in stack.split(";"):
            child = node["children"].get(frame)
            if child is None:
                child = {"name": frame, "value": 0, "children": {}}
                node["children"][frame] = child
            child["value"] += count
            node = child

    def finish(node: dict) -> dict:
        return {
            "name": node["name"],
            "value": node["value"],
            "children": [finish(c) for c in node["children"].values()],
        }

    return finish(root)


def flame_graph(duration_s: float = 0.5, hz: float = 50.0,
                thread_filter: Optional[str] = None) -> dict:
    """One-call REST payload: {samples, tree, folded}."""
    folded = sample_stacks(duration_s, hz, thread_filter)
    return {
        "samples": sum(folded.values()),
        "duration_s": duration_s,
        "tree": fold_to_tree(folded),
        "folded": folded,
    }
