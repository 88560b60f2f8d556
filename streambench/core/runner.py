"""One run of one cell: set-up, the window, the drain, the check and the
metrics.

Set-up (`setup_s`, from the process's start to the window's first batch):
imports and CUDA, the configuration's record pool from the seed
(`gens/<config>.py`), the job through the port's DataStream API
(`jobs/<config>.py`), `execute_async()`, and the warm-up batches, which
run through the same job and so build every kernel and buffer the window
uses. The window is the time from its first batch to the job closing its
sink: the source ends the input `seconds` after the window opened, and
the job drains. The window runs in one job with nothing else in the
process but the main thread waiting on it. A traced run profiles a late
part of the window (`TRACE_SPAN`), where the job is steady.

Once the job has ended and its device state is freed, every row the sink
received is judged against `reference/<config>.py`, computed from the same
seed and the same count of records handed over.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from streambench.core import check, guard
from streambench.core.feed import FeedSource, TimedSink, warmup_records
from streambench.core.spec import Cell, load_module

#: how long past the window a job may take to drain
DRAIN_TIMEOUT_S = 240.0
#: the traced part of the window, as shares of its length: late, so the job
#: is steady, and short, so the profiler keeps every event
TRACE_SPAN = (0.6, 0.8)


class NoDevice(RuntimeError):
    """No CUDA card, or fewer than the cell asks for."""


class WrongRoute(RuntimeError):
    """The planner did not choose the cell's device route."""


class ForbiddenModules(RuntimeError):
    """A module of JAX, Flax or the JAX package was loaded."""


@dataclasses.dataclass
class Run:
    result: Dict[str, Any]                 # the line's keys, `check` last
    check: List[Tuple[str, int, int]]      # (name, number, limit)
    record: Dict[str, Any]                 # what the metric readers read
    gen: Any                               # the configuration's generator
    want: Tuple[Any, Any, Any]             # the reference's rows


def _launches() -> Dict[str, int]:
    from flink_tpu_torch.ops import cuda_session, cuda_superscan

    return {**cuda_superscan.LAUNCHES, **cuda_session.LAUNCHES}


def _cuda_launches() -> Dict[str, int]:
    """CUDA kernels launched, by entry, where the port counts them."""
    from flink_tpu_torch.ops import cuda_session, cuda_superscan

    return {**getattr(cuda_superscan, "CUDA_LAUNCHES", {}),
            **getattr(cuda_session, "CUDA_LAUNCHES", {})}


def _delta(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: v - a.get(k, 0) for k, v in b.items()}


def route_taken(runtime, route: str) -> bool:
    """Whether a runner of the job, or the operator it holds, is of the
    class named `route`."""
    return any(type(r).__name__ == route or type(getattr(r, "op", None)).__name__ == route
               for r in runtime.runners)


def _free(client) -> None:
    from flink_tpu_torch.runtime.minicluster import MiniCluster

    client._runtime = None
    MiniCluster.get_shared().jobs.pop(client.job_id, None)
    gc.collect()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool = False, *,
             device: Optional[str] = None, t_start: Optional[float] = None,
             traffic: Optional[Dict[str, Any]] = None) -> Run:
    """Run `cell` once. `device` None takes the CUDA card and raises
    NoDevice without one (the benchmark's runs); the tests pass "cpu".
    `traffic` replaces the cell's traffic mix (the tests' tiny sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"the cell needs {cell.chips} CUDA card(s); "
                           f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                           f"device_count={torch.cuda.device_count()}")
        device = "cuda"
    on_cuda = torch.device(device).type == "cuda"
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.runtime.minicluster import JobStatus
    from streambench.core import trace as tr

    parts = {"imports": time.perf_counter()}

    cfg = cell.config
    traffic = cell.traffic if traffic is None else traffic
    job = cfg["job"]
    batch = int(traffic["batch_size"])
    rate = int(cfg["event_rate_per_s"])
    gen = load_module("gens", cell.config_name).make(seed, cfg, traffic)
    from flink_tpu_torch.ops import cuda_session, cuda_superscan

    cuda_superscan.reset_launch_counts()
    cuda_session.reset_launch_counts()
    parts["pool"] = time.perf_counter()

    marks: Dict[str, Any] = {}

    def on_open():
        marks["cpu_open"] = time.process_time()
        marks["launches_open"] = _launches()

    def first_poll():
        if trace:
            # the profiler's first start loads and sets up CUPTI, seconds of
            # work: done here, in set-up, on the job's thread
            tr.stop_profile(tr.start_profile())
        parts["first_poll"] = time.perf_counter()

    prof: Dict[str, Any] = {}

    # the traced part runs on the job's thread, whose CPU operations the
    # profiler records; both ends wait for the card, so the capture holds
    # exactly the device work launched between them
    def trace_start():
        t_hook = time.perf_counter()
        if on_cuda:
            torch.cuda.synchronize()
        prof["launches"], prof["cuda_launches"] = _launches(), _cuda_launches()
        prof["capture"] = tr.start_profile()
        prof["sampler"] = tr.StackSampler(threading.get_ident())
        prof["t0"] = time.perf_counter()
        prof["start_s"] = prof["t0"] - t_hook
        with tr.span(tr.TRACE_OPEN):
            pass
        # the traced part lasts its share of the window from here
        source.at.append((prof["t0"] - source.state.t_open + (b - a) * seconds, trace_stop))

    def trace_stop():
        if "capture" not in prof or "stopped" in prof:
            return
        with tr.span(tr.TRACE_CLOSE):
            if on_cuda:
                torch.cuda.synchronize()
        prof["launches"] = _delta(prof["launches"], _launches())
        prof["cuda_launches"] = _delta(prof["cuda_launches"], _cuda_launches())
        tr.stop_profile(prof["capture"])
        prof["sampler"].stop()
        prof["stopped"] = True

    a, b = TRACE_SPAN
    at = [(a * seconds, trace_start)] if trace else []
    source = FeedSource(gen, batch=batch, event_rate=rate, t0_ms=job["t0_ms"],
                        bound_ms=job["watermark_bound_ms"],
                        warm_records=warmup_records(traffic, batch, rate), seconds=seconds,
                        on_open=on_open, on_first_poll=first_poll, at=at)
    # a window too short for the traced part's end to come before the
    # input ends: the capture stops when the job closes the sink
    sink = TimedSink(on_close=trace_stop if trace else None)
    opts = dict(cfg.get("options", {}))
    opts.update(traffic.get("options", {}))
    opts["execution.step.batch-size"] = batch
    env = StreamExecutionEnvironment(Configuration(opts), device=device)
    load_module("jobs", cell.config_name).build(env, source, sink, cfg, gen)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    parts["built"] = time.perf_counter()
    client = env.execute_async(f"streambench-{cell.name}")
    st = source.state
    while not st.opened.wait(0.2):
        if client.status() in (JobStatus.FINISHED, JobStatus.FAILED, JobStatus.CANCELED):
            break
    runtime = client._runtime
    if runtime is None or not route_taken(runtime, cfg["device_route"]):
        taken = ([f"{type(r).__name__}({type(getattr(r, 'op', None)).__name__})"
                  for r in runtime.runners] if runtime is not None else [])
        client.cancel()
        client.wait(DRAIN_TIMEOUT_S)
        raise WrongRoute(f"the planner did not choose {cfg['device_route']}: {taken}")
    client.wait(seconds + DRAIN_TIMEOUT_S)
    cpu_end = time.process_time()
    summary = (tr.reduce_profile(prof["capture"], prof["sampler"].samples, prof["t0"])
               if "capture" in prof else None)
    launches_end = _launches()
    memory_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    del env, runtime
    _free(client)
    if on_cuda:
        torch.cuda.empty_cache()

    if st.t_open is None or sink.t_end is None:
        raise RuntimeError("the job ended before the window opened")
    t_check = time.perf_counter()
    ref = load_module("reference", cell.config_name)
    want, data = ref.expected(gen, cfg, st.handed)
    keys, res, ts, arrival = sink.rows()
    numbers = check.compare_rows((keys, ts, res), want)
    correct, rows = check.verdict(numbers)
    check_s = time.perf_counter() - t_check

    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
           "count": cell.chips if on_cuda else 1, "memory_peak_bytes": int(memory_peak)}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    record = {
        "cell": cell.name, "config": cell.config_name, "seed": seed, "seconds": seconds,
        "setup_s": st.t_open - t_start,
        # set-up's parts, each from the end of the one before (s)
        "setup_parts": {k: b - a for k, a, b in zip(
            ("imports", "pool", "build", "start", "warmup"),
            [t_start] + [parts[k] for k in ("imports", "pool", "built", "first_poll")],
            [parts[k] for k in ("imports", "pool", "built", "first_poll")] + [st.t_open])},
        "window_s": sink.t_end - st.t_open,
        "window_records": st.window_records, "records": st.handed,
        "source_wall_s": st.poll_wall_s, "source_cpu_s": st.poll_cpu_s,
        "proc_cpu_s": cpu_end - marks["cpu_open"],
        "launches": {k: v - marks["launches_open"].get(k, 0) for k, v in launches_end.items()},
        "launches_run": launches_end,
        "t_open": st.t_open, "t_close": st.t_close, "t_end": sink.t_end,
        "hand_t": st.hand_t, "hand_wm": st.hand_wm,
        "rows": {"keys": keys, "results": res, "ts": ts, "arrival": arrival},
        "trace": summary, "data": data,
        "trace_launches": prof.get("launches") if summary else None,
        "trace_start_s": prof.get("start_s"),
        "trace_cuda_launches": prof.get("cuda_launches") if summary else None, "device": dev, "check_s": check_s,
        "peak": load_module("roofline", "peaks").PEAKS,
    }
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = sum(v for _k, v, _lim in rows)
    result = {"correct": bool(correct), "attempted": int(len(want[0])), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    # last, once the reference, the readers and the tables have loaded too
    found = guard.forbidden_loaded()
    if found:
        raise ForbiddenModules(f"loaded once the window closed: {found}")
    return Run(result, rows, record, gen, want)
