#!/usr/bin/env python3
"""How many of its device records torch.profiler keeps as a process ages,
on one NVIDIA GPU.

    python3 flink_tpu_torch/tools/profiler_drift.py [--seconds S] [--every E]
        [--late]

A probe is one profiler session over two calls of seven `add_` kernels:
it prints the kernels the session kept against the host's launch calls,
and what `testing/timing.py::device_profile` (which runs a short session
again) returns for the same calls. The process opens its first session at
once and probes every E seconds until S have passed, idle in between; with
`--late` it opens its first session only at S. One JSON line a probe.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def _calls(x):
    def fn():
        for _ in range(7):
            x.add_(1)
    return fn


def probe(fn) -> dict:
    """One session over two calls: device records kept and the host's
    launch calls, then device_profile's launches a call (and whether it
    warned that no session was complete)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch.testing.timing import LAUNCH_CALLS, device_profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kept = sum(e.device_type == DeviceType.CUDA for e in events)
    calls = sum(e.name in LAUNCH_CALLS for e in events)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        _split, per_call = device_profile(fn, reps=2)
    return {"kernels_kept": kept, "launch_calls": calls,
            "device_profile_launches_a_call": per_call, "device_profile_warned": bool(warned)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--every", type=float, default=25.0)
    ap.add_argument("--late", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_drift.py needs a CUDA device", file=sys.stderr)
        return 1
    fn = _calls(torch.zeros(1 << 12, device="cuda"))
    t0 = time.perf_counter()

    def line(**kw):
        print(json.dumps(dict(late=a.late, s=round(time.perf_counter() - t0, 1), **kw)),
              flush=True)

    if not a.late:
        line(**probe(fn))
    while time.perf_counter() - t0 < a.seconds:
        time.sleep(a.every)
        if not a.late:
            line(**probe(fn))
    if a.late:
        line(**probe(fn))
    return 0


if __name__ == "__main__":
    sys.exit(main())
