"""Device timing helpers for the port's measurement scripts (`chip_smoke.py`,
`flink_tpu_torch/tools/k1_ab.py`); they need a CUDA device."""

from __future__ import annotations

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


def device_profile(fn, reps: int = 5, tries: int = 3):
    """(device us per call by kernel name, CUDA kernel launches per call)
    of fn(): `reps` calls under torch.profiler after a warm-up, kernel rows
    only. A profiling session that comes back without device rows (seen on
    the H100 now and then, for calls that launch kernels) is run again, up
    to `tries` times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        split, launches = _profile_once(fn, reps)
        if split:
            break
    return split, launches


def _profile_once(fn, reps: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # host activity too: CUDA-only sessions came back short on the H100
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split, launches = {}, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            name = e.key.split("(")[0].split("<")[0].replace("void ", "")[:40]
            split[name] = split.get(name, 0.0) + us / reps
            launches += e.count
    return split, launches / reps
