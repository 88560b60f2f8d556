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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            name = e.key.split("(")[0].split("<")[0].replace("void ", "")[:40]
            split[name] = split.get(name, 0.0) + us / reps
    return split
