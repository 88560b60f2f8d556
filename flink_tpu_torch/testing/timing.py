"""Device timing helpers for the port's measurement scripts (`chip_smoke.py`,
`flink_tpu_torch/tools/k1_ab.py`); they need a CUDA device."""

from __future__ import annotations

import warnings

import numpy as np
import torch


def cuda_ms(fn, reps: int, rounds: int = 5) -> float:
    """Device time of one fn() call: the median over `rounds` of the mean
    over `reps` back-to-back runs, timed with CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return float(np.median(means))


def device_split_us(fn, reps: int = 5) -> dict:
    """Device time per call of each CUDA kernel fn() launches: `reps` calls
    under torch.profiler after a warm-up, kernel rows only."""
    return device_profile(fn, reps)[0]


def device_profile(fn, reps: int = 5, tries: int = 5):
    """(device us per call by kernel name, CUDA kernel launches per call)
    of fn(): `reps` calls under torch.profiler after a warm-up, kernel rows
    only. A session must hold a device record for each kernel launch call
    it saw on the host: on the H100's machine the profiler drops device
    records, more of them the longer the process has run since its first
    session (none, or all, at times). A short session is run again, up to
    `tries` times, and the fullest one is returned, with a warning when none
    was complete."""
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(tries):
        split, launches, calls = _profile_once(fn, reps)
        if best is None or launches > best[1]:
            best = (split, launches, calls)
        if split and launches >= calls:
            return split, launches
    warnings.warn(f"torch.profiler kept {best[1]} of {best[2]} kernel launches a call in "
                  f"each of {tries} sessions: device times are short", RuntimeWarning)
    return best[0], best[1]


#: host records of a kernel launch call (the `cudaLaunch*` and `cuLaunch*` entry points)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel")


def _profile_once(fn, reps: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # host activity too: CUDA-only sessions came back short on the H100
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split, launches, calls = {}, 0, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            calls += e.count if e.key in LAUNCH_CALLS else 0
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            name = e.key.split("(")[0].split("<")[0].replace("void ", "")[:40]
            split[name] = split.get(name, 0.0) + us / reps
            launches += e.count
    return split, launches / reps, calls / reps
