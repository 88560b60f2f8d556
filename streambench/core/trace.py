"""The traced run's profile and its reduction.

One `torch.profiler` capture (CPU and CUDA activity) spans a late, short
part of the window, where the job is steady (the profiler thins its
records in a long capture). It starts and stops on the job's thread,
whose CPU operations the profiler records, and each end waits for the
card first, so the capture holds exactly the device work launched inside
it. The traced part is found in the trace by the benchmark's own spans
(`streambench.trace.open` after the start, `streambench.trace.close`
around the wait before the stop); the device's busy time is the union of
its operations' intervals between them.
"""

from __future__ import annotations

import re
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

TRACE_OPEN = "streambench.trace.open"
TRACE_CLOSE = "streambench.trace.close"


def start_profile():
    """A running capture of CPU and CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def span(name: str):
    """A span of the benchmark's own in the capture."""
    from torch.profiler import record_function

    return record_function(name)


def _is_device(ev) -> bool:
    """A kernel, copy or fill on the card: a CUDA event that is not a
    synchronisation (torch 2.11's events carry no activity type, so the
    name decides)."""
    return str(ev.device_type()).endswith("CUDA") and "sync" not in ev.name().lower()


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of [start, end) intervals, [n, 2] sorted and disjoint."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            out.append((s, e))
            s, e = a, b
        elif b > e:
            e = b
    out.append((s, e))
    return np.asarray(out, dtype=np.float64)


def short_name(name: str, width: int = 96) -> str:
    name = re.sub(r"^void ", "", name)
    return name if len(name) <= width else name[:width - 3] + "..."


class StackSampler:
    """What the job's thread runs, every `period` seconds: the innermost
    frame of the port or the benchmark on its stack, as `file.py:function`.
    Taken beside the profile to say what the host did while the device
    idled (the port's host work runs no profiled operation)."""

    def __init__(self, thread_id: int, period: float = 0.01):
        self.thread_id, self.period = thread_id, period
        self.samples: List[Tuple[float, str]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="streambench-sampler",
                                        daemon=True)
        self._thread.start()

    @staticmethod
    def label(frame) -> str:
        inner = frame
        while frame is not None:
            path = frame.f_code.co_filename
            if "flink_tpu_torch" in path or "streambench" in path:
                inner = frame
                break
            frame = frame.f_back
        return f"{inner.f_code.co_filename.rsplit('/', 1)[-1]}:{inner.f_code.co_name}"

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            frame = sys._current_frames().get(self.thread_id)
            if frame is not None:
                self.samples.append((time.perf_counter(), self.label(frame)))

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(5.0)


def stop_profile(prof) -> None:
    prof.__exit__(None, None, None)


def reduce_profile(prof, samples: List[Tuple[float, str]], t_open: float,
                   top: int = 10) -> Optional[dict]:
    """Reduce the stopped capture `prof`: device busy seconds and the traced
    part's length (from its spans), device seconds and event counts by
    kernel name over the capture, the top device operations, and the idle
    time by what the host was doing: the stack samples (perf_counter
    seconds; `t_open` is the traced part's opening on that clock) that
    fall in its idle gaps, each label's share of them times the idle
    time. None when the spans are missing."""
    dev: List[Tuple[float, float, str]] = []
    marks: Dict[str, float] = {}
    for ev in prof.profiler.kineto_results.events():
        t0 = ev.start_ns() / 1e9
        t1 = t0 + ev.duration_ns() / 1e9
        name = ev.name()
        if _is_device(ev):
            dev.append((t0, t1, name))
        elif name in (TRACE_OPEN, TRACE_CLOSE) and name not in marks:
            marks[name] = t0 if name == TRACE_OPEN else t1
    if TRACE_OPEN not in marks or TRACE_CLOSE not in marks:
        return None
    w0, w1 = marks[TRACE_OPEN], marks[TRACE_CLOSE]
    kernel_s: Dict[str, float] = {}
    kernel_n: Dict[str, int] = {}
    for t0, t1, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (t1 - t0)
        kernel_n[name] = kernel_n.get(name, 0) + 1
    in_win = [(max(t0, w0), min(t1, w1), n) for t0, t1, n in dev if t1 > w0 and t0 < w1]
    busy = _merge(np.asarray([(a, b) for a, b, _n in in_win], np.float64).reshape(-1, 2))
    busy_s = float(np.sum(busy[:, 1] - busy[:, 0])) if len(busy) else 0.0
    ops: Dict[str, float] = {}
    for a, b, n in in_win:
        ops[short_name(n)] = ops.get(short_name(n), 0.0) + (b - a)
    # idle gaps: between the busy intervals, and at the window's two ends
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]) if len(busy) else np.asarray([w0, w1])
    gaps = edges.reshape(-1, 2)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    idle_s = float(np.sum(gaps[:, 1] - gaps[:, 0]))
    shift = w0 - t_open                      # perf_counter to the capture's clock
    at = np.asarray([t + shift for t, _l in samples], np.float64)
    i = np.searchsorted(gaps[:, 0], at, side="right") - 1
    in_gap = (i >= 0) & (at < gaps[np.maximum(i, 0), 1]) & (at >= w0) & (at <= w1)
    labels = [samples[k][1] for k in np.flatnonzero(in_gap)]
    idle: Dict[str, float] = {}
    for label in labels:
        idle[label] = idle.get(label, 0.0) + idle_s / len(labels)
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"busy_s": busy_s, "window_s": float(w1 - w0), "kernel_s": kernel_s,
            "kernel_n": kernel_n, "device_ops": rank(ops), "idle_gaps": rank(idle),
            "device_events": len(dev), "idle_samples": len(labels)}


def kernel_seconds(trace: Optional[dict], prefix: str) -> Tuple[float, int]:
    """Device seconds and events of the kernels whose name starts with
    `prefix` (a leading `void ` aside), over the capture."""
    if not trace:
        return 0.0, 0
    pat = re.compile(r"^(void\s+)?" + re.escape(prefix))
    s = n = 0
    for name, secs in trace["kernel_s"].items():
        if pat.match(name):
            s += secs
            n += trace["kernel_n"][name]
    return s, n
