#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `flink_tpu_torch` (never jax, never `flink_tpu`) through the entry
points a user calls, at the geometries of the repo's YSB benchmark, and
exits non-zero on the first failure. Phases, one JSON line each:

1. device: the card (name and power limit as nvidia-smi gives them) and the
   build of both Hopper kernels from `flink_tpu_torch/csrc/`;
2. kernel K1 (keyed superscan) against its plain PyTorch version on the
   card at the YSB geometry (K=8192, S=32, NSB=4, F=4, R=64, T=48, B=2^20)
   with plans from the port's planner, for count, sum and max8: bit-equal;
3. kernel K2 (global superscan) against its plain version at the Nexmark
   Q7 geometry (S=8, NSB=2, F=4, R=16, T=96, B=2^18) for add, min and max:
   bit-equal;
4. main path: YSB sliding count (10 s windows sliding by 1 s) through
   FusedWindowPipeline on the on-card generator, 8 spans pipelined 3 deep,
   checked window by window against the numpy oracle's replay;
5. WordCount tumbling count and the Q7 global max, each with its parity
   check and launch count;
6. kernel times at the main paths' shapes beside their bounds, the plain
   versions' times, the device time of each CUDA kernel of a dispatch
   (torch.profiler) and one PyTorch call as a yardstick (for K1 the
   dispatch's ingest as one atomic `index_add_`, with the sort-based
   `index_put_(accumulate=True)` of earlier runs beside it);
7. device time by kernel for each path, from one more run of it under
   torch.profiler, and the share of its wall time the device was busy;
8. api_ysb, this slice's main path: YSB written as a DataStream job
   (`bench.py::api_path_microbench`'s program: a traceable filter keeping
   one record in three, a traceable key, 10 s windows sliding by 1 s,
   `count`, 8192 keys, batch 65536, 32 steps a superbatch) run through the
   port's API, planner, runners and operator on both routes — the fused
   device chain (torch prologue + K1) and the host chain (host key
   dictionary + K1). Parity in row mode at 2^21 records, three ways (both
   routes and the numpy oracle over the same columns), plus a tumbling sum
   whose traceable value_fn feeds K1's add field; then tuples/s at 2^24
   records (fused) and 2^22 (host chain) with columnar output, the K1
   dispatches of each run, one run of each route under torch.profiler
   and one under cProfile (host time by function), and K1 against its
   plain version at this path's shapes (the job's first full fused
   dispatch, count and the prologue-fed sum: T=32, B=65536, K=8192,
   R=256) with its times. The kernels line reports K1 at these shapes
   (and at phase 6's under "ysb_generator"); each entry names its shape.
   A bound counts as output the fire rows the dispatch writes, not all R.
9. session_sum: `bench.py::secondary_sessions` on the port's session
   operator (kernels K3 and K4): gap 2000 ms, 64 gap-slices, 2^14 keys in
   four rotating blocks, 2^20 records a step made on the card, 16 steps a
   superspan merging after steps 7 and 15, a final watermark 2^60. One
   superspan (2^24 records) is held against `numpy_sessionize` over the
   host replay and against the per-step route; 4 superspans (2^26
   records) are timed after a warm run; the operator's exact fallbacks
   (host merges, superspan replays) must stay 0;
10. api_sessions: a session DataStream job (`key_by(traceable key)
   .window(EventTimeSessionWindows.with_gap(2000)).aggregate("sum")`) over
   2^22 records of the same stream made on the host, batch 65536, held
   against `numpy_sessionize`;
11. K3 and K4 against their plain versions at these shapes (bit-equal),
   with times, bounds and, for K3, the PyTorch scatter calls its plain
   version makes as the yardstick. The profiles of phase 7 include
   session_sum (by kernel: generator, K3, K4, copies) and the host profile
   of api_sessions.

Then a {"kernels": [...]} line, the nvidia-smi line again, and last
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12         # H100 SXM float32/int32 outside the tensor cores

YSB = dict(K=8192, S=32, NSB=4, F=4, R=64, T=48, B=1 << 20, spans=8, depth=3)
WORDCOUNT = dict(T=24, B=1 << 20, spans=2, depth=2)
Q7 = dict(S=8, NSB=2, F=4, R=16, T=96, B=1 << 18, spans=5, depth=3)
# the DataStream job (bench.py::api_path_microbench's program): the
# default batch 65536 and 32 steps a superbatch, so the ring is [32, 8192]
API = dict(keys=8192, window=10_000, slide=1_000, sum_window=2_000, batch=65536,
           fused_events=1 << 24, chain_events=1 << 22, parity_events=1 << 21,
           warmup_events=1 << 19, runs=2)
# bench.py::secondary_sessions: gap 2000 ms, 64 gap-slices, 2^14 keys in four
# rotating blocks, 2^20 records a step, 16 steps a superspan merging after
# steps 7 and 15; parity over one superspan, 4 timed
SESSIONS = dict(gap=2000, S=64, K=1 << 14, B=1 << 20, T=16, merge_every=8, spans=4)
# the session DataStream job: 2^22 records at batch 65536, one batch a step
API_SESSIONS = dict(events=1 << 22, batch=65536, runs=2)
# the per-batch operator with allowed lateness at real state size: 2^20
# keys, 2^20 records a batch (~1 s of event time), 2 warm-up batches and 16
# timed; its DataStream job; the count window; the continuous aggregate
LATENESS = dict(K=1 << 20, B=1 << 20, warm=2, timed=16, lateness=2000)
API_LATENESS = dict(keys=8192, batch=65536, events=1 << 22, lateness=2000)
API_COUNT = dict(keys=1 << 16, hot_keys=1024, n=64, batch=65536, events=1 << 22,
                 nonpurging_events=1 << 20)
API_GROUP_AGG = dict(keys=1 << 16, rows=1 << 20, retract=0.1, batch=65536)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the scalar peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2/3 helpers: kernel against plain version on the same inputs
# ---------------------------------------------------------------------------

def _fresh_rings(agg, shape, dev, global_scope):
    from flink_tpu_torch.ops.aggregators import scan_identity, torch_dtype
    from flink_tpu_torch.ops.superscan import value_fields

    count = torch.zeros(shape, dtype=torch.int32, device=dev)
    states = []
    for f in value_fields(agg):
        ident = scan_identity(np.dtype(f.dtype), f.scatter) if global_scope else f.identity
        states.append(torch.full(shape, ident, dtype=torch_dtype(f.dtype), device=dev))
    return count, states


def _max_abs_err(a, b) -> float:
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max().item())


def compare_kernel(kernel, plain, agg, spans, shape, global_scope, **kw):
    """Run kernel and plain version over the same chained dispatches from
    the same initial rings; return the largest absolute difference of any
    ring or fire row (requires bit equality)."""
    kc, ks = _fresh_rings(agg, shape, DEV, global_scope)
    pc, pst = _fresh_rings(agg, shape, DEV, global_scope)
    err = 0.0
    for idx, vals, plan in spans:
        kout = kernel(agg, kc, ks, idx, vals, plan[:5], **kw)
        pout = plain(agg, pc, pst, idx, vals, plan[:5], **kw)
        torch.cuda.synchronize()
        pairs = [(kc, pc), (kout[0], pout[0])] + list(zip(ks, pst)) + list(zip(kout[1], pout[1]))
        for a, b in pairs:
            err = max(err, _max_abs_err(a, b))
            if not torch.equal(a, b):
                raise AssertionError(f"{kernel.__name__} differs from its plain "
                                     f"version for {agg.name}: max |diff| {err}")
    return err


def stage(pipe, gen, lo, T, B, slide_ms):
    """Plan the span of steps [lo, lo+T) with the port's planner and
    generate its records on the card: a `staged` tuple."""
    from flink_tpu_torch.testing.stream import step_bounds, watermark_after

    bounds = [step_bounds(lo + r, B, slide_ms) for r in range(T)]
    wms = [watermark_after(lo + r) for r in range(T)]
    plan, smin_abs = pipe.plan_superbatch(bounds, wms)
    g = gen(lo, smin_abs)
    idx, vals = g if isinstance(g, tuple) else (g, None)
    return idx, vals, plan


def plan_spans(pipe, gen, T, B, slide_ms, n):
    """The first n spans of the stream, staged."""
    return [stage(pipe, gen, i * T, T, B, slide_ms) for i in range(n)]


# ---------------------------------------------------------------------------
# phases 4/5: a pipelined stream through a pipeline, checked by replay
# ---------------------------------------------------------------------------

def run_stream(pipe, gen, T, B, spans, depth, slide_ms, row_of):
    """plan_superbatch + on-card generator + process_superbatch(defer=True),
    `depth` dispatches in flight; returns (fired {j: row}, seconds)."""
    def enqueue(i):
        staged = stage(pipe, gen, i * T, T, B, slide_ms)
        return pipe.process_superbatch(None, None, staged=staged, defer=True)

    fired = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inflight = [enqueue(i) for i in range(min(depth, spans))]
    nxt = len(inflight)
    while inflight:
        d = inflight.pop(0)
        for window, counts, fields in d.resolve():
            fired[window.start // slide_ms] = row_of(counts, fields)
        if nxt < spans:
            inflight.append(enqueue(nxt))
            nxt += 1
    torch.cuda.synchronize()
    return fired, time.perf_counter() - t0


def drive(p, spans=None, depth=None):
    """One pipelined run of path p (see main) from a fresh pipeline."""
    row_of = ((lambda c, f: np.array([f["max"]])) if p["agg"] == "max"
              else (lambda c, f: c))
    return run_stream(p["make"](), p["gen"], p["T"], p["B"], spans or p["spans"],
                      depth or p["depth"], p["slide"], row_of)


def profile_run(name: str, run, groups=(("k1", "k1_"),)) -> dict:
    """Device time by kernel for one run() (which returns its wall seconds)
    under torch.profiler, the share of the run's wall time the device was
    busy, and each group's (label, kernel-name substring) device time and
    share of that busy time (by default K1's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs = run()
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.key[:70], e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    out = {"phase": "profile", "path": name, "wall_s": secs,
           "device_busy_us": busy_us, "device_busy_share": busy_us / 1e6 / secs}
    rest = busy_us
    for label, sub in groups:
        us = sum(us for us, n, _c in rows if sub in n)
        out[f"{label}_device_us"] = us
        out[f"{label}_share_of_busy"] = us / max(busy_us, 1e-9)
        rest -= us
    # everything else: the on-card generator and torch's own kernels
    out["rest_device_us"] = rest
    out["top"] = [{"name": n, "device_us": us, "calls": c} for us, n, c in rows[:10]]
    return out


def profile_path(p) -> dict:
    return profile_run(p["name"], lambda: drive(p)[1])


def host_profile(name: str, run, top: int = 12) -> dict:
    """Host time by function for one run() under cProfile (a separate run:
    the host-bound paths' wall is Python and numpy): each function's own
    time, largest first."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    secs = run()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, f"{fn[2]} ({fn[0].split('/')[-1]}:{fn[1]})", nc)
                   for fn, (_cc, nc, tt, _ct, _callers) in stats.items()), reverse=True)
    return {"phase": "host_profile", "path": name, "wall_s": secs,
            "top": [{"name": n, "own_s": tt, "calls": c} for tt, n, c in rows[:top]]}


# ---------------------------------------------------------------------------
# the api_ysb phase: YSB written as a DataStream job, through the port's
# API, planner, runners and operator, on both routes
# ---------------------------------------------------------------------------

def _t_filter(col):
    return col[:, 1] < 0.5                 # event_type 0: one record in three


def _t_key(col):
    return col[:, 0].to(torch.int32)


def _t_value(col):
    return col[:, 2]


def rows_sink():
    """A sink that keeps each batch it is given, with its timestamps (a
    window's max timestamp): `.batches`."""
    from flink_tpu_torch.connectors.sink import Sink, SinkWriter

    class Writer(SinkWriter):
        def __init__(self, batches):
            self.batches = batches

        def write_batch(self, values, timestamps=None):
            self.batches.append((values, timestamps))

    class RowsSink(Sink):
        def __init__(self):
            self.batches = []

        def create_writer(self):
            return Writer(self.batches)

    return RowsSink()


def api_job(n: int, fused: bool, *, columnar: bool, sum_job: bool = False, dev=DEV):
    """(env, sink) of the YSB DataStream program over n records: a
    traceable filter and key (one UDF object for both routes), a 10 s
    window sliding by 1 s and `count` — or, with sum_job, a tumbling sum
    whose traceable value_fn feeds K1's add field. The sink keeps each
    batch's records with their timestamps (a window's max timestamp)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import (
        SlidingEventTimeWindows,
        TumblingEventTimeWindows,
    )
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    def gen(idx):
        return Batch(*st.api_columns(idx, n, API["keys"], payload=sum_job))

    cfg = Configuration()
    cfg.set(ExecutionOptions.CHAIN_FUSION, fused)
    cfg.set(ExecutionOptions.BATCH_SIZE, API["batch"])
    cfg.set(ExecutionOptions.KEY_CAPACITY, API["keys"])
    cfg.set(ExecutionOptions.COLUMNAR_OUTPUT, columnar)
    env = StreamExecutionEnvironment(cfg, device=dev)
    keyed = (env.from_source(DataGeneratorSource(gen, n),
                             WatermarkStrategy.for_bounded_out_of_orderness(0))
             .filter(_t_filter, traceable=True).key_by(_t_key, traceable=True))
    sink = rows_sink()
    if sum_job:
        win = keyed.window(TumblingEventTimeWindows.of(API["sum_window"]))
        win.aggregate("sum", value_fn=_t_value, value_traceable=True).sink_to(sink)
    else:
        win = keyed.window(SlidingEventTimeWindows.of(API["window"], API["slide"]))
        win.aggregate("count").sink_to(sink)
    return env, sink


def api_k1_inputs(sum_job: bool, dev=DEV):
    """K1's inputs of the job's first full dispatch on the fused route (32
    steps of 65536 records of a 2^24-record stream), made by the pipeline's
    own staging and prologue: (pipe, agg, idx, vals, plan)."""
    from flink_tpu_torch.api.windowing.assigners import (
        SlidingEventTimeWindows,
        TumblingEventTimeWindows,
    )
    from flink_tpu_torch.ops.aggregators import resolve
    from flink_tpu_torch.runtime.fused_window_pipeline import (
        FusedWindowPipeline,
        TracedPrologue,
    )
    from flink_tpu_torch.testing import stream as st

    n, B, T = API["fused_events"], API["batch"], 32
    if sum_job:
        window = TumblingEventTimeWindows.of(API["sum_window"])
        prologue = TracedPrologue((("filter", _t_filter),), _t_key, _t_value)
    else:
        window = SlidingEventTimeWindows.of(API["window"], API["slide"])
        prologue = TracedPrologue((("filter", _t_filter),), _t_key)
    agg = resolve("sum" if sum_job else "count")
    # the operator's geometry (FusedWindowOperator's defaults, chunk 4096)
    pipe = FusedWindowPipeline(window, agg, key_capacity=API["keys"], nsb=4,
                               fires_per_step=4, out_rows=256, chunk=4096,
                               prologue=prologue, device=dev)
    steps, wms = [], []
    for t in range(T):
        col, ts = st.api_columns(np.arange(t * B, (t + 1) * B, dtype=np.int64), n,
                                 API["keys"], payload=sum_job)
        steps.append((col, ts))
        wms.append(int(ts.max()) - 1)
    raw, srel, ts, plan = pipe.stage_superbatch_raw(steps, wms)
    idx, vals, _bounds = pipe._run_prologue(raw, srel, ts)
    return pipe, agg, idx, vals, plan


def api_run(n: int, fused: bool, *, columnar: bool, sum_job: bool = False, dev=DEV):
    """One execute() with the launch counts at 0 just before it: (sink,
    seconds, K1 dispatches it made)."""
    from flink_tpu_torch.ops import cuda_superscan as cs

    env, sink = api_job(n, fused, columnar=columnar, sum_job=sum_job, dev=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    env.execute()
    if dev == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return sink, secs, cs.LAUNCHES["k1_superscan"]


def api_fired(sink, window_ms: int, slide_ms: int) -> dict:
    """Row-mode sink records as {window index: row over the keys}."""
    fired = {}
    for values, ts in sink.batches:
        for (k, v), t in zip(values, ts):
            j = (int(t) + 1 - window_ms) // slide_ms
            row = fired.get(j)
            if row is None:
                row = fired[j] = np.zeros(API["keys"])
            row[k] = v
    return fired


def api_parity(n: int, *, sum_job: bool, dev=DEV) -> dict:
    """The job in row mode on both routes and the numpy oracle over the same
    columns: window-by-window equality, three ways."""
    from flink_tpu_torch.testing import stream as st

    window_ms = API["sum_window"] if sum_job else API["window"]
    slide_ms = API["sum_window"] if sum_job else API["slide"]
    ref = st.api_replay(n, API["batch"], window_ms=window_ms, slide_ms=slide_ms,
                        agg="sum" if sum_job else "count", num_keys=API["keys"])
    out = {"events": n, "job": "tumbling_sum" if sum_job else "sliding_count"}
    ok = True
    for route, fused in (("fused", True), ("chain", False)):
        sink, secs, launches = api_run(n, fused, columnar=False, sum_job=sum_job, dev=dev)
        fired = api_fired(sink, window_ms, slide_ms)
        route_ok, checked = st.parity(ref.fired, fired, require_all=True)
        route_ok = route_ok and set(fired) <= set(ref.fired)
        out[route] = {"parity": route_ok, "windows_checked": checked,
                      "k1_dispatches": launches, "seconds": secs}
        ok = ok and route_ok
    out["parity"] = ok
    return out


def _dispatched(result: dict) -> bool:
    """Every route of a parity or timed result made K1 dispatches."""
    return all(result[route]["k1_dispatches"] > 0 for route in ("fused", "chain"))


def api_ysb_phase(dev=DEV, sizes=API) -> dict:
    """Parity at sizes["parity_events"] (sliding count and tumbling sum),
    then the timed columnar runs: sizes["fused_events"] records through the
    fused device chain and sizes["chain_events"] through the host chain,
    best of sizes["runs"] each after a warm-up."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.executor import build_runners

    env, _sink = api_job(sizes["warmup_events"], True, columnar=True, dev=dev)
    runners, _feeds = build_runners(plan(env._sinks), env.config, dev)
    fused_selected = any(type(r).__name__ == "DeviceChainRunner" for r in runners)

    count_parity = api_parity(sizes["parity_events"], sum_job=False, dev=dev)
    sum_parity = api_parity(sizes["parity_events"], sum_job=True, dev=dev)
    timed = {}
    for route, fused, n in (("fused", True, sizes["fused_events"]),
                            ("chain", False, sizes["chain_events"])):
        api_run(sizes["warmup_events"], fused, columnar=True, dev=dev)
        runs = [api_run(n, fused, columnar=True, dev=dev) for _ in range(sizes["runs"])]
        secs = min(r[1] for r in runs)
        timed[route] = {"events": n, "tuples_per_s": n / secs, "seconds": secs,
                        "all_seconds": [r[1] for r in runs],
                        "k1_dispatches": runs[0][2],
                        "windows_emitted": sum(len(v) for v, _t in runs[0][0].batches)}
    parity = count_parity["parity"] and sum_parity["parity"]
    dispatched = all(_dispatched(r) for r in (count_parity, sum_parity, timed))
    return {"phase": "api_ysb", "ok": fused_selected and parity and dispatched,
            "k1_dispatched_on_every_route": dispatched, "fused_selected": fused_selected,
            "fused_tuples_per_s": timed["fused"]["tuples_per_s"],
            "chain_tuples_per_s": timed["chain"]["tuples_per_s"],
            "timed": timed, "parity": parity,
            "windows_checked": count_parity["fused"]["windows_checked"],
            "sliding_count": count_parity, "tumbling_sum": sum_parity}


# ---------------------------------------------------------------------------
# the session phases: bench.py::secondary_sessions' stream through the
# session operator (kernels K3 and K4), and a session DataStream job
# ---------------------------------------------------------------------------

def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def session_op(dev, sizes, defer=True):
    from flink_tpu_torch.api.windowing.assigners import EventTimeSessionWindows
    from flink_tpu_torch.runtime.tpu_session_operator import TpuSessionWindowOperator

    return TpuSessionWindowOperator(EventTimeSessionWindows.with_gap(sizes["gap"]), "sum",
                                    key_capacity=sizes["K"], num_slices=sizes["S"],
                                    defer_emissions=defer, device=dev)


def session_plan(lo: int, sizes):
    """Step bounds and merge watermarks of the superspan at step lo: a merge
    every merge_every steps at (t+1)*655 - 1000."""
    from flink_tpu_torch.testing import stream as st

    T = sizes["T"]
    bounds = [st.session_step_bounds(lo + r, sizes["B"], sizes["gap"]) for r in range(T)]
    wms = [st.watermark_after(lo + r) if (r + 1) % sizes["merge_every"] == 0 else None
           for r in range(T)]
    return bounds, wms


def run_sessions(gen, dev, sizes, spans: int, per_step: bool = False):
    """`spans` superspans of the session stream (made on `dev` by gen) through
    a fresh operator, fused (process_superspan_staged, deferred) or per step
    (process_batch_staged + process_watermark, the replay route), then the
    final watermark 2^60 and the drain: ({(key, start, end): sum}, seconds,
    operator)."""
    op = session_op(dev, sizes, defer=not per_step)
    T = sizes["T"]
    _sync(dev)
    t0 = time.perf_counter()
    for lo in range(0, spans * T, T):
        staged = gen(lo)
        bounds, wms = session_plan(lo, sizes)
        if per_step:
            for t in range(T):
                op.process_batch_staged(*(x[t] for x in staged), *bounds[t])
                if wms[t] is not None:
                    op.process_watermark(wms[t])
        else:
            op.process_superspan_staged(*staged, bounds, wms)
    op.process_watermark(1 << 60)
    out = op.drain_output()          # the operator's rows, as the bench takes them
    _sync(dev)
    secs = time.perf_counter() - t0
    return {(int(k), w.start, w.end): float(r) for k, w, r, _t in out}, secs, op


def sessions_match(got: dict, expect: dict) -> bool:
    """The same (key, start, end) set, sums within the bench's 1e-3 relative
    tolerance."""
    return (len(got) > 0 and got.keys() == expect.keys()
            and all(abs(got[k] - expect[k]) <= 1e-3 * max(1.0, abs(expect[k])) for k in got))


def session_sum_phase(dev=DEV, sizes=None) -> dict:
    """bench.py::secondary_sessions on the port: parity of one superspan (the
    bench's T steps) against numpy_sessionize over the replayed records and
    against the per-step route, then a warm run and the timed run of
    sizes["spans"] superspans with the launch counts at 0 just before it."""
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.testing import stream as st

    sizes = sizes or SESSIONS
    T, B = sizes["T"], sizes["B"]
    gen = st.make_session_gen(T, B, device=dev, gap_ms=sizes["gap"], num_slices=sizes["S"])
    cuda_session.reset_launch_counts()
    got, _secs, op = run_sessions(gen, dev, sizes, 1)
    parity_launches = dict(cuda_session.LAUNCHES)
    t_rep = time.perf_counter()
    recs = [np.concatenate(a) for a in zip(*(st.host_session_step(t, B) for t in range(T)))]
    expect = st.numpy_sessionize(*recs, sizes["gap"])
    replay_s = time.perf_counter() - t_rep
    per_step, _s, step_op = run_sessions(gen, dev, sizes, 1, per_step=True)
    parity = sessions_match(got, expect)
    route_parity = per_step == got

    run_sessions(gen, dev, sizes, sizes["spans"])                      # warm
    cuda_session.reset_launch_counts()
    out, secs, op_t = run_sessions(gen, dev, sizes, sizes["spans"])
    launches = dict(cuda_session.LAUNCHES)
    events = sizes["spans"] * T * B
    replays = op.superspan_replays + op_t.superspan_replays + step_op.superspan_replays
    ok = parity and route_parity and replays == 0 and all(v > 0 for v in launches.values())
    return {"phase": "session_sum", "ok": ok, "parity": parity,
            "exact": got == expect, "route_parity": route_parity,
            "sessions_checked": len(expect), "tuples_per_s": events / secs, "events": events,
            "seconds": secs, "sessions_emitted": len(out), "dispatches": sizes["spans"],
            "k3_launches": launches["k3_session_ingest"],
            "k4_launches": launches["k4_session_merge"],
            "k3_per_dispatch": launches["k3_session_ingest"] / sizes["spans"],
            # two merges a superspan, plus the final watermark's merge
            "k4_per_dispatch": (launches["k4_session_merge"] - 1) / sizes["spans"],
            "parity_run_launches": parity_launches, "superspan_replays": replays,
            "replay_s": replay_s}


def session_api_job(n: int, sizes, dev=DEV):
    """(env, sink) of the session DataStream job over n records of the
    session stream at sizes["batch"] records a step (one source batch a
    step): columns (user, value) made on the host, watermarks bounded by
    the stream's 500 ms jitter (below the 2000 ms gap, so the session
    operator runs and no record is late), a traceable int32 key and
    `sum` of a traceable value_fn."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import EventTimeSessionWindows
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    batch = sizes["batch"]

    def gen(idx):
        keys, ts, vals = st.session_records(idx, batch)
        return Batch(np.stack([keys, vals], axis=1).astype(np.float32), ts)

    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, batch)
    cfg.set(ExecutionOptions.KEY_CAPACITY, SESSIONS["K"])
    env = StreamExecutionEnvironment(cfg, device=dev)
    sink = rows_sink()
    (env.from_source(DataGeneratorSource(gen, n),
                     WatermarkStrategy.for_bounded_out_of_orderness(st.OOO_MS))
     .key_by(_t_key, traceable=True)
     .window(EventTimeSessionWindows.with_gap(st.SESSION_GAP_MS))
     .aggregate("sum", value_fn=_t_sval, value_traceable=True).sink_to(sink))
    return env, sink


def _t_sval(col):
    return col[:, 1]


def session_api_run(n: int, sizes, dev=DEV):
    """One execute() with the session launch counts at 0 just before it:
    (sink, seconds, launches, the session operators the job made)."""
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.runtime import tpu_session_operator as tso

    made = []
    init = tso.TpuSessionWindowOperator.__init__

    def recording(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    env, sink = session_api_job(n, sizes, dev)
    _sync(dev)
    cuda_session.reset_launch_counts()
    tso.TpuSessionWindowOperator.__init__ = recording
    try:
        t0 = time.perf_counter()
        env.execute()
        _sync(dev)
        secs = time.perf_counter() - t0
    finally:
        tso.TpuSessionWindowOperator.__init__ = init
    return sink, secs, dict(cuda_session.LAUNCHES), made


def api_sessions_phase(dev=DEV, sizes=None) -> dict:
    """The session DataStream job: parity of its rows against
    numpy_sessionize over the same records (as (key, end): sum, the rows'
    timestamps being each session's end - 1), tuples/s best of
    sizes["runs"] after a warm-up, launches, and the host profile."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.executor import build_runners
    from flink_tpu_torch.testing import stream as st

    sizes = sizes or API_SESSIONS
    n = sizes["events"]
    env, _sink = session_api_job(1024, sizes, dev)
    selected = [type(getattr(r, "op", None)).__name__
                for r in build_runners(plan(env._sinks), env.config, dev)[0]]
    session_api_run(sizes["batch"] * 8, sizes, dev)                   # warm
    runs = [session_api_run(n, sizes, dev) for _ in range(sizes["runs"])]
    sink, _secs, launches, ops = runs[0]
    replays = sum(o.superspan_replays for r in runs for o in r[3])
    got = {(int(k), int(t) + 1): float(v) for values, ts in sink.batches
           for (k, v), t in zip(values, ts)}
    keys, ts, vals = st.session_records(np.arange(n, dtype=np.int64), sizes["batch"])
    expect = {(k, e): v for (k, _s, e), v in
              st.numpy_sessionize(keys, ts, vals, st.SESSION_GAP_MS).items()}
    rows = sum(len(v) for v, _t in sink.batches)
    parity = sessions_match(got, expect) and rows == len(expect)
    secs = min(r[1] for r in runs)
    ok = (parity and "TpuSessionWindowOperator" in selected and len(ops) == 1
          and replays == 0 and all(v > 0 for v in launches.values()))
    return {"phase": "api_sessions", "ok": ok, "parity": parity, "sessions_checked": len(expect),
            "operator_selected": "TpuSessionWindowOperator" in selected, "events": n,
            "tuples_per_s": n / secs, "seconds": secs, "all_seconds": [r[1] for r in runs],
            "k3_launches": launches["k3_session_ingest"],
            "k4_launches": launches["k4_session_merge"], "superspan_replays": replays}


def session_kernel_times(card: str, dev=DEV) -> dict:
    """K3 and K4 against their plain versions at the session_sum shapes
    (bit-equal required), with their times (CUDA events; K4's with the
    ring restored before each call, less the restore alone), device time
    from the profiler, bytes bounds from this run's data, and for K3 the
    yardstick of the PyTorch scatter calls its plain version makes."""
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.ops import superscan as ps
    from flink_tpu_torch.testing import stream as st
    from flink_tpu_torch.testing.timing import cuda_ms, device_split_us

    z = SESSIONS
    K, S, T, B, g = z["K"], z["S"], z["T"], z["B"], z["gap"]
    op = session_op(dev, z)
    vf, idents = op._vfields, op._idents
    kid, spos, rel, vals = st.make_session_gen(T, B, device=dev)(0)
    run = z["merge_every"]

    def fresh():
        o = session_op(dev, z)
        return [o._cnt, o._mn, o._mx, list(o._fields)]

    def flat(r):
        return r[:3] + r[3]

    def err_of(a, b, extra=()):
        err = 0.0
        for x, y in list(zip(flat(a), flat(b))) + list(extra):
            err = max(err, _max_abs_err(x, y))
            if not torch.equal(x, y):
                raise AssertionError(f"a session kernel differs from its plain version: {err}")
        return err

    out = {"phase": "session_kernel_times", "card": card}
    # K3: one step, and one run of `run` steps (one launch each)
    for name, sl in (("k3_step", slice(0, 1)), ("k3_run", slice(0, run))):
        args = (kid[sl], spos[sl], rel[sl], vals[sl])
        a, b = fresh(), fresh()
        cuda_session.session_ingest(*a, *args, vf)
        ps.session_ingest_plain(*b, *args, vf)
        _sync(dev)
        err = err_of(a, b)
        ring = fresh()
        ms = cuda_ms(lambda: cuda_session.session_ingest(*ring, *args, vf), 10)
        plain_ms = cuda_ms(lambda: ps.session_ingest_plain(*ring, *args, vf), 2, 3)
        cell = (args[1].long() * K + args[0].long()).reshape(-1)
        r, v = args[2].reshape(-1), args[3].reshape(-1)
        ones = torch.ones_like(cell, dtype=torch.int32)
        lib_ms = cuda_ms(lambda: (ring[0].view(-1).index_add_(0, cell, ones),
                                  ring[1].view(-1).scatter_reduce_(0, cell, r, "amin"),
                                  ring[2].view(-1).scatter_reduce_(0, cell, r, "amax"),
                                  ring[3][0].view(-1).index_add_(0, cell, v)), 10)
        n = cell.numel()
        touched = int(torch.unique(cell).numel())
        # records read once (16 B each), each touched cell of the four rings
        # read and written once
        b_ms, b_by = bound(n * 16 + touched * 4 * 4 * 2, n * 4)
        out[name] = {"shape": f"{sl.stop - sl.start} step(s) of 2^20 records into "
                              f"[{S}, {K}] (sum)",
                     "records": n, "cells_touched": touched, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": err,
                     "device_us": device_split_us(
                         lambda: cuda_session.session_ingest(*ring, *args, vf))}
        del cell, ones
    # K4 on the ring as the operator holds it at the superspan's second
    # merge (after step T-1; the first closes no session of this stream):
    # superspan mode over the full ring, and per-watermark mode over the
    # resident slice span
    base = fresh()
    cuda_session.session_ingest(*base, kid, spos, rel, vals, vf)
    lo = min(st.session_step_bounds(t, B)[0] for t in range(T))
    hi = max(st.session_step_bounds(t, B)[1] for t in range(T))
    span = hi - lo + 1
    pos_d = torch.from_numpy((np.arange(lo, hi + 1) % S).astype(np.int32)).to(dev)
    wm_rel = st.watermark_after(T - 1) - lo * g
    M_ss = -(-(span + 2 + 2) // 8) * 8           # the operator's rules for M
    M_pw = span + 1
    none = torch.empty((1, 0), dtype=torch.int32, device=dev)
    modes = {
        "k4_superspan": (lambda r: cuda_session.session_superscan(
            *r, none, none, none, none.float(), [1], [lo % S], [0], [wm_rel], g=g, M=M_ss,
            vfields=vf, idents=idents),
                         lambda r: ps.session_superscan_plain(
            *r, none, none, none, none.float(), [1], [lo % S], [0], [wm_rel], g=g, M=M_ss,
            vfields=vf, idents=idents), torch.arange(S, device=dev), M_ss),
        "k4_per_watermark": (lambda r: cuda_session.session_merge(
            *r, pos_d, wm_rel, g=g, M=M_pw, vfields=vf, idents=idents),
                             lambda r: ps.session_merge_plain(
            *r, pos_d, None, wm_rel, g=g, M=M_pw, vfields=vf, idents=idents), pos_d.long(),
                             M_pw),
    }
    for name, (kern, plain, scanned, M) in modes.items():
        a, b = fresh(), fresh()
        for x, y, src in zip(flat(a), flat(b), flat(base)):
            x.copy_(src)
            y.copy_(src)
        pa, pb = kern(a), plain(b)
        _sync(dev)
        err = err_of(a, b, [(pa, pb)])
        _times, _blocks, slots, _scal = ps.unpack_sessions(pb, K, M, len(vf))
        sessions = int(slots.sum())
        purged = int((flat(base)[0] > 0).sum() - (b[0] > 0).sum())
        occupied = int((flat(base)[0][scanned] > 0).sum())
        ring = fresh()

        def restore():
            for x, src in zip(flat(ring), flat(base)):
                x.copy_(src)

        restore_ms = cuda_ms(restore, 10)
        ms = cuda_ms(lambda: (restore(), kern(ring)), 10) - restore_ms
        plain_ms = cuda_ms(lambda: (restore(), plain(ring)), 2, 3) - restore_ms
        nf = len(vf)
        cols = int(scanned.numel())
        # what the merge must move, from this run's ring: the count ring over
        # the scanned columns; min, max and the fields at the occupied cells
        # there; the purged cells written back; each closed session's slot
        # (int64 start and end, count, fields); each key's slot count
        # (carried across a superspan's merges: read and written)
        slot_count_bytes = K * 4 * (2 if name == "k4_superspan" else 1)
        nbytes = (cols * K * 4 + occupied * 4 * (2 + nf) + purged * 4 * (3 + nf)
                  + sessions * (16 + 4 * (1 + nf)) + slot_count_bytes)
        b_ms, b_by = bound(nbytes, cols * K * 8)
        out[name] = {"shape": f"{name.split('_', 1)[1]} merge of {cols} columns of [{S}, {K}] "
                              f"(sum), M={M}",
                     "sessions": sessions, "cells_occupied": occupied, "cells_purged": purged,
                     "bound_bytes": nbytes, "ms": ms,
                     "plain_ms": plain_ms, "restore_ms": restore_ms, "library_ms": None,
                     "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                     "device_us": device_split_us(lambda: (restore(), kern(ring)))}
    return out


# ---------------------------------------------------------------------------
# the per-batch phases (phases 12-16): the per-batch window operator with
# allowed lateness and a late side output, its DataStream job, the
# count-triggered global window and the continuous aggregate. Their device
# programs are torch programs, not kernels: they go on their own line.
# ---------------------------------------------------------------------------

def lateness_op(dev, sizes, kernel="scatter"):
    """TpuWindowOperator as the lateness_operator phase drives it: 10 s
    windows sliding by 1 s, `sum`, columnar output, dense int keys below K,
    and the operator's own ring rule (S = 64 at 2 s of lateness)."""
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator
    from flink_tpu_torch.testing import stream as st

    return TpuWindowOperator(SlidingEventTimeWindows.of(st.WINDOW_MS, st.SLIDE_MS), "sum",
                             allowed_lateness=sizes["lateness"], emit_late_to_side_output=True,
                             columnar_output=True, dense_int_keys=True,
                             key_capacity=sizes["K"], ingest_kernel=kernel, device=dev)


def lateness_batches(sizes):
    """The lateness stream's batches, made on the host (set-up): (keys,
    values, timestamps, the watermark after the batch), the watermark
    trailing the largest timestamp so far by LATE_WM_LAG_MS."""
    from flink_tpu_torch.testing import stream as st

    K, B = sizes["K"], sizes["B"]
    out, top = [], None
    for b in range(sizes["warm"] + sizes["timed"]):
        keys, ts, vals = st.late_records(np.arange(b * B, (b + 1) * B, dtype=np.int64), B, K)
        top = int(ts.max()) if top is None else max(top, int(ts.max()))
        out.append((keys, vals, ts, top - st.LATE_WM_LAG_MS))
    return out


def run_lateness(op, batches, dev):
    """Each batch through the operator: ingest, watermark, drain. Returns
    ([(window start, key ids, values)] a fire or re-fire, seconds)."""
    events = []
    _sync(dev)
    t0 = time.perf_counter()
    for keys, vals, ts, wm in batches:
        op.process_batch(keys, vals, ts)
        op.process_watermark(wm)
        events += [(w.start, ids, v) for _k, w, (ids, v), _t in op.drain_output()]
    _sync(dev)
    return events, time.perf_counter() - t0


def lateness_matches(events, op, want, side) -> bool:
    """Every emission equals the oracle's, in order (window, ascending key
    ids, values), and the side output is the oracle's too-late set."""
    from flink_tpu_torch.testing import stream as st

    same = len(events) == len(want) and all(
        ws == j * st.SLIDE_MS and np.array_equal(ids, ks)
        and np.array_equal(np.asarray(v, np.float64), vs)
        for (ws, ids, v), (_kind, j, ks, vs) in zip(events, want))
    got = sorted((int(k), float(v), int(t)) for k, v, t in op.side_output.get("late-data", []))
    expect = sorted(zip(np.concatenate([s[0] for s in side]).tolist(),
                        np.concatenate([s[1] for s in side]).tolist(),
                        np.concatenate([s[2] for s in side]).tolist()))
    return same and got == expect and len(expect) > 0


def lateness_operator_phase(dev=DEV, sizes=None) -> dict:
    """TpuWindowOperator driven directly at 2^20 keys (a count and a sum ring
    of [64, 2^20] on the card, 256 MiB each): 2 warm-up batches, then 16
    timed, 2^20 records each, with the program calls at 0 just before the
    timed batches; then the same with the sort-based ingest. Every emission
    and the side output are held against LatenessOracle."""
    from flink_tpu_torch.ops import segment_ops as so
    from flink_tpu_torch.testing import stream as st

    sizes = sizes or LATENESS
    batches = lateness_batches(sizes)
    t_or = time.perf_counter()
    orc = st.LatenessOracle(st.WINDOW_MS, st.SLIDE_MS, sizes["lateness"], sizes["K"])
    want, side = [], []
    for keys, vals, ts, wm in batches:
        events, late = orc.step(keys, ts, vals, wm)
        want += events
        side.append(late)
    oracle_s = time.perf_counter() - t_or
    out = {"phase": "lateness_operator", "keys": sizes["K"], "batch": sizes["B"],
           "timed_batches": sizes["timed"], "oracle_s": oracle_s,
           "windows_checked": sum(e[0] == "fire" for e in want),
           "refires_checked": sum(e[0] == "refire" for e in want),
           "side_output_checked": int(sum(len(s[0]) for s in side))}
    ok = True
    runs = {}
    for kernel in ("scatter", "sort"):
        op = lateness_op(dev, sizes, kernel)
        events, _s = run_lateness(op, batches[:sizes["warm"]], dev)
        so.reset_call_counts()
        timed, secs = run_lateness(op, batches[sizes["warm"]:], dev)
        calls = {k: v for k, v in so.CALLS.items() if v}
        events += timed
        parity = lateness_matches(events, op, want, side)
        runs[kernel] = events
        ring_mib = {name: t.numel() * t.element_size() / 2**20
                    for name, t in [("count", op.state.count)] + list(op.state.acc.items())}
        out[kernel] = {"parity": parity, "tuples_per_s": sizes["timed"] * sizes["B"] / secs,
                       "seconds": secs, "S": op.S, "ring_mib": ring_mib, "program_calls": calls,
                       "emissions": len(events)}
        ok = ok and parity and op.S == 64 and (calls.get("ingest", 0) or calls.get("ingest_sort", 0))
        del op
    same = len(runs["scatter"]) == len(runs["sort"]) and all(
        a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
        for a, b in zip(runs["scatter"], runs["sort"]))
    out["ingest_forms_agree"] = same
    out["tuples_per_s"] = out["scatter"]["tuples_per_s"]
    if torch.device(dev).type == "cuda":
        prof = profile_run("lateness_operator", lambda: run_lateness(
            lateness_op(dev, sizes), batches, dev)[1], groups=())
        out["device_busy_share"] = prof["device_busy_share"]
        out["profile"] = prof
    out["ok"] = bool(ok and same)
    return out


def by_window(rows):
    """(timestamp, key, value) rows cut into fire events (runs of one
    window timestamp), each sorted: within a fire the operator emits in
    key-dictionary order."""
    out, run = [], []
    for r in rows:
        if run and r[0] != run[-1][0]:
            out.append(sorted(run))
            run = []
        run.append(r)
    return out + ([sorted(run)] if run else [])


def api_lateness_job(n: int, sizes, dev=DEV):
    """(env, sink, late sink) of the api_ysb program with
    allowed_lateness(2000).side_output_late_data() over the lateness
    stream's columns, for_bounded_out_of_orderness(500), and a
    get_side_output(LATE_DATA_TAG) sink."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.functions import LATE_DATA_TAG
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    batch, keys = sizes["batch"], sizes["keys"]
    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, batch)
    cfg.set(ExecutionOptions.KEY_CAPACITY, keys)
    env = StreamExecutionEnvironment(cfg, device=dev)
    counted = (env.from_source(
        DataGeneratorSource(lambda idx: Batch(*st.late_columns(idx, batch, keys)), n),
        WatermarkStrategy.for_bounded_out_of_orderness(st.LATE_WM_LAG_MS))
        .filter(_t_filter, traceable=True).key_by(_t_key, traceable=True)
        .window(SlidingEventTimeWindows.of(st.WINDOW_MS, st.SLIDE_MS))
        .allowed_lateness(sizes["lateness"]).side_output_late_data().count())
    sink, late = rows_sink(), rows_sink()
    counted.sink_to(sink)
    counted.get_side_output(LATE_DATA_TAG).sink_to(late)
    return env, sink, late


def api_lateness_oracle(n: int, sizes):
    """The oracle over the job's filtered records, batch by batch with the
    source's watermarks: (rows (window max timestamp, key, count) in
    emission order, too-late (key, ts) sorted)."""
    from flink_tpu_torch.testing import stream as st

    batch, keys = sizes["batch"], sizes["keys"]
    orc = st.LatenessOracle(st.WINDOW_MS, st.SLIDE_MS, sizes["lateness"], keys, agg="count")
    rows, side, wm = [], [], None

    def add(events):
        rows.extend((j * st.SLIDE_MS + st.WINDOW_MS - 1, int(k), int(v))
                    for _kind, j, ks, vs in events for k, v in zip(ks, vs))

    for lo in range(0, n, batch):
        col, ts = st.late_columns(np.arange(lo, min(lo + batch, n), dtype=np.int64), batch, keys)
        top = int(ts.max()) - st.LATE_WM_LAG_MS - 1
        wm = top if wm is None else max(wm, top)
        keep = col[:, 1] == 0
        events, late = orc.step(col[keep, 0].astype(np.int64), ts[keep], col[keep, 2], wm)
        add(events)
        side += zip(late[0].tolist(), late[2].tolist())
    add(orc.advance(2**62))
    return rows, sorted(side)


def timed_execute(env, dev) -> float:
    """Seconds of one env.execute(), the device drained on both sides."""
    _sync(dev)
    t0 = time.perf_counter()
    env.execute()
    _sync(dev)
    return time.perf_counter() - t0


def api_lateness_run(sizes, dev=DEV) -> float:
    """One execute() of the job at sizes["events"] records: seconds."""
    return timed_execute(api_lateness_job(sizes["events"], sizes, dev)[0], dev)


def api_lateness_phase(dev=DEV, sizes=None) -> dict:
    """The job at sizes["events"] records in row mode: TpuWindowOperator
    selected, every fire (re-fires included) and the side output equal the
    oracle's; tuples/s of the checked run after a warm-up run."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.ops import segment_ops as so
    from flink_tpu_torch.runtime.executor import build_runners

    sizes = sizes or API_LATENESS
    n = sizes["events"]
    env, _s, _l = api_lateness_job(1024, sizes, dev)
    selected = [type(getattr(r, "op", r)).__name__
                for r in build_runners(plan(env._sinks), env.config, dev)[0]]
    env, _s, _l = api_lateness_job(sizes["batch"] * 16, sizes, dev)
    env.execute()                                                      # warm
    env, sink, late = api_lateness_job(n, sizes, dev)
    so.reset_call_counts()
    secs = timed_execute(env, dev)
    calls = {k: v for k, v in so.CALLS.items() if v}
    got = [(int(t), int(k), int(v)) for values, ts in sink.batches
           for (k, v), t in zip(values, ts)]
    got_late = sorted((int(k), int(t)) for values, ts in late.batches
                      for (k, _v), t in zip(values, ts))
    t_or = time.perf_counter()
    want, want_late = api_lateness_oracle(n, sizes)
    oracle_s = time.perf_counter() - t_or
    parity = by_window(got) == by_window(want) and len(got) > 0
    side_parity = got_late == want_late and len(want_late) > 0
    refires = len(want) - len({(t, k) for t, k, _v in want})
    ok = parity and side_parity and "TpuWindowOperator" in selected and calls.get("ingest", 0) > 0
    return {"phase": "api_lateness", "ok": ok, "parity": parity, "side_output_parity": side_parity,
            "operator_selected": "TpuWindowOperator" in selected, "runners": selected,
            "events": n, "tuples_per_s": n / secs, "seconds": secs, "rows_checked": len(want),
            "refired_rows": refires, "side_output_checked": len(want_late),
            "program_calls": calls, "oracle_s": oracle_s}


def count_columns(idx: np.ndarray, sizes):
    """(key, value) float32 columns and in-order timestamps of records idx:
    30% of records on `hot_keys` keys, the rest over all keys; values are
    integers below 8."""
    from flink_tpu_torch.testing import stream as st

    bits = st.hash_bits(st.step_key(st.SEED + 13, 0), idx)
    hot = (bits >> 20) % 10 < 3
    keys = np.where(hot, bits % sizes["hot_keys"], (bits >> 4) % sizes["keys"])
    return np.stack([keys, (bits >> 24) & 7], axis=1).astype(np.float32), idx.astype(np.int64)


def _t_col1(col):
    return col[:, 1]


def api_count_job(n: int, purging: bool, sizes, dev=DEV):
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import GlobalWindows
    from flink_tpu_torch.api.windowing.triggers import CountTrigger, PurgingTrigger
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy

    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, sizes["batch"])
    cfg.set(ExecutionOptions.KEY_CAPACITY, sizes["keys"])
    env = StreamExecutionEnvironment(cfg, device=dev)
    trigger = CountTrigger.of(sizes["n"])
    sink = rows_sink()
    (env.from_source(DataGeneratorSource(lambda idx: Batch(*count_columns(idx, sizes)), n),
                     WatermarkStrategy.for_monotonous_timestamps())
     .key_by(_t_key, traceable=True).window(GlobalWindows.create())
     .trigger(PurgingTrigger.of(trigger) if purging else trigger)
     .aggregate("sum", value_fn=_t_col1, value_traceable=True).sink_to(sink))
    return env, sink


def count_model(n: int, purging: bool, sizes):
    """Numpy model of the per-batch coalesced count rule: after each
    batch's ingest a key fires once if its count reached N (purging: then
    resets) or crossed a new multiple of N (non-purging). Returns each
    firing batch's sorted (key, sum) rows."""
    keys_n, n_fire = sizes["keys"], sizes["n"]
    acc = np.zeros(keys_n)
    cnt = np.zeros(keys_n, np.int64)
    fired = np.zeros(keys_n, np.int64)
    out = []
    for lo in range(0, n, sizes["batch"]):
        col, _ts = count_columns(np.arange(lo, min(lo + sizes["batch"], n), dtype=np.int64), sizes)
        k = col[:, 0].astype(np.int64)
        acc += np.bincount(k, weights=col[:, 1], minlength=keys_n)
        cnt += np.bincount(k, minlength=keys_n)
        fire = cnt >= n_fire if purging else cnt // n_fire > fired // n_fire
        hit = np.flatnonzero(fire)
        if hit.size:
            out.append(sorted(zip(hit.tolist(), acc[hit].tolist())))
        if purging:
            acc[fire], cnt[fire] = 0.0, 0
        else:
            fired[fire] = cnt[fire]
    return out


def api_count_window_phase(dev=DEV, sizes=None) -> dict:
    """GlobalWindows with PurgingTrigger.of(CountTrigger.of(64)) at
    sizes["events"] records, then a non-purging CountTrigger at
    sizes["nonpurging_events"]: TpuGlobalWindowOperator selected, its step
    called once a batch, every firing batch equal to the model's."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime import tpu_global_window_operator as gw
    from flink_tpu_torch.runtime.executor import build_runners

    sizes = sizes or API_COUNT
    env, _sink = api_count_job(1024, True, sizes, dev)
    selected = [type(getattr(r, "op", r)).__name__
                for r in build_runners(plan(env._sinks), env.config, dev)[0]]
    out = {"phase": "api_count_window", "operator_selected": "TpuGlobalWindowOperator" in selected,
           "count_n": sizes["n"], "keys": sizes["keys"]}
    ok = out["operator_selected"]
    for name, purging, n in (("purging", True, sizes["events"]),
                             ("nonpurging", False, sizes["nonpurging_events"])):
        env, sink = api_count_job(n, purging, sizes, dev)
        gw.CALLS["global_count_step"] = 0
        secs = timed_execute(env, dev)
        steps = gw.CALLS["global_count_step"]
        got = [sorted((int(k), float(v)) for k, v in values) for values, _ts in sink.batches]
        want = count_model(n, purging, sizes)
        parity = got == want and len(want) > 0
        out[name] = {"parity": parity, "events": n, "tuples_per_s": n / secs, "seconds": secs,
                     "fires": sum(len(w) for w in want), "firing_batches": len(want),
                     "steps": steps}
        ok = ok and parity and steps == -(-n // sizes["batch"])
    out["ok"] = ok
    return out


def api_group_agg_run(rows, device: bool, sizes, dev=DEV):
    """continuous_aggregate of COUNT(*), SUM(v) and AVG(v) by key over
    `rows`, mini-batch on: (changelog, seconds, runner kinds)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.executor import build_runners

    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, sizes["batch"])
    cfg.set(ExecutionOptions.DEVICE_GROUP_AGG, device)
    cfg.set(ExecutionOptions.MINI_BATCH_GROUP_AGG, True)
    env = StreamExecutionEnvironment(cfg, device=dev)
    sink = (env.from_collection(rows).key_by(lambda r: r["k"])
            .continuous_aggregate([("COUNT", None), ("SUM", "v"), ("AVG", "v")], ["k"],
                                  ["c", "s", "a"]).collect())
    runners = build_runners(plan(env._sinks), env.config, dev)[0]
    kinds = [(type(r).__name__, getattr(r, "device", None)) for r in runners]
    return sink.results, timed_execute(env, dev), kinds


def api_group_agg_phase(dev=DEV, sizes=None) -> dict:
    """The continuous aggregate with execution.group-agg.device=true over
    sizes["rows"] changelog rows (10% retractions, made on the host):
    GroupAggRunner on its device path, one step a batch, the changelog equal
    to the host path's on the same rows (kinds, keys, COUNT and SUM exact,
    AVG to rtol 1e-6)."""
    from flink_tpu_torch.runtime import group_agg_operator as ga
    from flink_tpu_torch.table.changelog import ROW_KIND_FIELD
    from flink_tpu_torch.testing import stream as st

    sizes = sizes or API_GROUP_AGG
    rows = st.changelog_rows(sizes["rows"], sizes["keys"], sizes["retract"])
    api_group_agg_run(rows[:sizes["batch"]], True, sizes, dev)          # warm
    ga.CALLS["group_agg_step"] = 0
    got, secs, kinds = api_group_agg_run(rows, True, sizes, dev)
    steps = ga.CALLS["group_agg_step"]
    host, host_s, _k = api_group_agg_run(rows, False, sizes, dev)
    parity = len(got) == len(host) > 0 and all(
        (a[ROW_KIND_FIELD], a["k"], a["c"], a["s"]) == (b[ROW_KIND_FIELD], b["k"], b["c"], b["s"])
        and abs(a["a"] - b["a"]) <= 1e-6 * abs(b["a"]) for a, b in zip(got, host))
    device_path = ("GroupAggRunner", True) in kinds
    ok = parity and device_path and steps == -(-len(rows) // sizes["batch"])
    return {"phase": "api_group_agg", "ok": ok, "parity": parity, "device_path": device_path,
            "rows": len(rows), "changelog_rows": len(got), "tuples_per_s": len(rows) / secs,
            "seconds": secs, "host_path_seconds": host_s, "steps": steps}


def per_batch_programs(card: str, calls_per_batch: dict, dev=DEV) -> dict:
    """Each torch program of the per-batch operators at lateness_operator's
    shapes (the global count step at api_count_window's, the group-agg step
    at api_group_agg's): ms a call (CUDA events), device us a call by kernel
    (profiler), CUDA launches a call and a batch, and a bytes bound from
    this run's data."""
    from flink_tpu_torch.ops import segment_ops as so
    from flink_tpu_torch.ops.aggregators import sum_agg
    from flink_tpu_torch.ops.sorted_ingest import sorted_ingest
    from flink_tpu_torch.runtime import group_agg_operator as ga
    from flink_tpu_torch.runtime import tpu_global_window_operator as gw
    from flink_tpu_torch.testing import stream as st
    from flink_tpu_torch.testing.timing import cuda_ms, device_profile

    z = LATENESS
    K, B = z["K"], z["B"]
    op = lateness_op(dev, z)
    S, spw = op.S, op.spw
    agg = sum_agg()
    acc, cnt = so.init_state_arrays(agg, K, S, torch.device(dev))
    keys, ts, vals = st.late_records(np.arange(B, 2 * B, dtype=np.int64), B, K)
    lanes = so.stage_lanes(keys.astype(np.int32), ((ts // st.SLIDE_MS) % S).astype(np.int32),
                           vals, K, S, torch.device(dev))
    so.ingest(agg, acc, cnt, lanes)
    cells = int(torch.unique(lanes.cells(K)).numel())
    rings = 2                                             # count and sum, 4 B each
    # the window ending at the batch's newest slice; the purge takes the
    # row before it
    last = int(((ts // st.SLIDE_MS) % S).max())
    window = [(last - spw + 1 + i) % S for i in range(spw)]
    stale = (last - spw) % S
    programs = {
        # lanes read once (kid, spos, value); each touched cell of both rings
        # read and written once
        "ingest_scatter": ("flink_tpu/ops/segment_ops.py:60",
                           lambda: so.ingest(agg, acc, cnt, lanes),
                           B * 12 + cells * rings * 4 * 2, B * rings, "ingest"),
        "ingest_sort": ("flink_tpu/ops/sorted_ingest.py:54",
                        lambda: sorted_ingest(agg, acc, cnt, lanes),
                        B * 12 + cells * rings * 4 * 2, B * rings, "ingest_sort"),
        # the window's rows of both rings read; result, count and mask written
        "fire": ("flink_tpu/ops/segment_ops.py:97",
                 lambda: so.fire(agg, acc, cnt, window),
                 spw * K * rings * 4 + K * (4 + 4 + 1), spw * K * rings, "fire"),
        "fire_masked": ("flink_tpu/ops/segment_ops.py:97",
                        lambda: so.fire(agg, acc, cnt, window, lanes),
                        spw * K * rings * 4 + K * (4 + 4 + 1) + B * 8, spw * K * rings + B,
                        "fire_masked"),
        # one row of both rings written
        "purge": ("flink_tpu/ops/segment_ops.py:132",
                  lambda: so.purge(agg, acc, cnt, [stale]), K * rings * 4, 0, "purge"),
    }
    # the global count step at api_count_window's shapes: one batch's lanes
    zc = API_COUNT
    col, _t = count_columns(np.arange(zc["batch"], dtype=np.int64), zc)
    gk = torch.from_numpy(col[:, 0].astype(np.int32)).to(dev)
    gv = torch.from_numpy(col[:, 1]).to(dev)
    gacc = {"sum": torch.zeros(zc["keys"], device=dev)}
    gcnt = torch.zeros(zc["keys"], dtype=torch.int32, device=dev)
    gfired = torch.zeros(zc["keys"], dtype=torch.int32, device=dev)
    gkeys = int(torch.unique(gk).numel())
    programs["global_count_step"] = (
        "flink_tpu/runtime/tpu_global_window_operator.py:35",
        lambda: gw.step(agg, gacc, gcnt, gfired, gk, gv, zc["n"], True),
        # lanes read; touched keys' acc and count read and written; the
        # extract and the mask over K written, acc and count over K rewritten
        zc["batch"] * 8 + gkeys * 2 * 4 * 2 + zc["keys"] * (4 + 1 + 2 * 4), zc["batch"] * 2,
        "global_count_step")
    # the group-agg step at api_group_agg's shapes: a batch of 65536 rows
    # over 2^16 keys, three linear columns
    zg = API_GROUP_AGG
    rng = np.random.default_rng(0)
    L, b, cap = 3, zg["batch"], 2 * zg["keys"]
    slots = torch.from_numpy(rng.integers(0, zg["keys"], b).astype(np.int32)).to(dev)
    signs = torch.from_numpy(np.where(rng.random(b) < zg["retract"], -1, 1).astype(np.int32)).to(dev)
    gvals = torch.from_numpy(rng.integers(0, 100, (L, b)).astype(np.float32)).to(dev)
    nn = torch.ones((L, b), dtype=torch.int32, device=dev)
    uniq = torch.unique(slots).long()
    u = int(uniq.numel())
    gcols = (torch.zeros(cap, dtype=torch.int32, device=dev),
             torch.zeros((L, cap), device=dev), torch.zeros((L, cap), dtype=torch.int32, device=dev))
    programs["group_agg_step"] = (
        "flink_tpu/runtime/group_agg_operator.py:100",
        lambda: ga.device_step(*gcols, slots, signs, gvals, nn, uniq),
        # rows read (slot, sign, L values, L non-null counts); the distinct
        # keys' columns read before and after, and read and written by the
        # scatter
        b * (8 + 8 * L) + u * (4 + 8 * L) * 4, b * (1 + 2 * L), "group_agg_step")
    out = {"phase": "per_batch_programs", "card": card,
           "shape": f"K={K} S={S} B={B} spw={spw} (sum); global step K={zc['keys']} "
                    f"B={zc['batch']}; group-agg cap={cap} B={b} L={L}",
           "cells_touched": cells}
    for name, (replaces, fn, nbytes, nops, calls_key) in programs.items():
        b_ms, b_by = bound(nbytes, nops)
        split, per_call = device_profile(fn)
        out[name] = {"replaces": replaces, "ms": cuda_ms(fn, 5), "device_us": sum(split.values()),
                     "device_us_by_kernel": split, "launches_per_call": per_call,
                     "calls_per_batch": calls_per_batch.get(calls_key, 1.0),
                     "launches_per_batch": per_call * calls_per_batch.get(calls_key, 1.0),
                     "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes}
    # the host side of a fire: nonzero of the mask (a sync) and the copy of
    # the fired keys and values, the operator's _emit_window on a full ring
    op.state.acc, op.state.count = acc, cnt
    reps = []
    for _ in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        op._emit_window(window[0] // op.sl, touch_mask=False)
        _sync(dev)
        reps.append((time.perf_counter() - t0) * 1e3)
        emitted = op.drain_output()
    out["emit_window_host_ms"] = float(np.median(reps))
    out["emit_window_keys"] = int(len(emitted[0][2][0])) if emitted else 0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's kernels need one",
              file=sys.stderr)
        return 2

    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.ops.aggregators import count_agg, max_agg, min_agg, sum_agg
    from flink_tpu_torch.ops.superscan import global_superscan_plain, keyed_superscan_plain
    from flink_tpu_torch.runtime.fused_window_pipeline import (
        FusedGlobalWindowPipeline,
        FusedWindowPipeline,
    )
    from flink_tpu_torch.testing import stream as st
    from flink_tpu_torch.testing.timing import cuda_ms, device_split_us

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)

    # ---- 1. device + build ----
    t0 = time.perf_counter()
    libs = cs.build()
    build_s = time.perf_counter() - t0
    ptxas = []
    for path in libs.values():
        log = path.with_suffix(".log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "card": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas})

    # ---- 2. K1 against its plain version at the YSB geometry ----
    K, S, NSB, F, R, T, B = (YSB[k] for k in ("K", "S", "NSB", "F", "R", "T", "B"))
    ysb_window = SlidingEventTimeWindows.of(st.WINDOW_MS, st.SLIDE_MS)
    k1_err = 0.0
    for name, agg in (("count", count_agg()), ("sum", sum_agg()),
                      ("max8", max_agg(domain_bits=8))):
        planner = FusedWindowPipeline(ysb_window, agg, key_capacity=K, num_slices=S,
                                      nsb=NSB, fires_per_step=F, out_rows=R,
                                      plan_only=True, device=DEV)
        gen = st.make_device_gen(T, B, device=DEV, with_vals=name != "count", nsb=NSB)
        spans = plan_spans(planner, gen, T, B, st.SLIDE_MS, 2)
        fires = sum(len(p[5]) for _i, _v, p in spans)
        err = compare_kernel(cs.keyed_superscan, keyed_superscan_plain, agg, spans,
                             (S, K), False, NSB=NSB, R=R, spws=(planner.spw,) * F,
                             exact=True)
        k1_err = max(k1_err, err)
        emit({"phase": "k1_vs_plain", "agg": name, "dispatches": len(spans),
              "fires": fires, "max_abs_err": err, "bit_equal": True})
        del spans

    # ---- 3. K2 against its plain version at the Q7 geometry ----
    q7_window = SlidingEventTimeWindows.of(10_000, 10_000)
    k2_err = 0.0
    for name, agg in (("add", sum_agg()), ("min", min_agg()), ("max", max_agg())):
        gpipe = FusedGlobalWindowPipeline(q7_window, agg, num_slices=Q7["S"],
                                          nsb=Q7["NSB"], fires_per_step=Q7["F"],
                                          out_rows=Q7["R"], device=DEV)
        gen = st.make_device_gen(Q7["T"], Q7["B"], device=DEV, slide_ms=10_000,
                                 with_vals=True, nsb=Q7["NSB"])
        spans = plan_spans(gpipe, gen, Q7["T"], Q7["B"], 10_000, 2)
        if name == "add":
            # 0/1 payloads keep every float32 partial sum an exact integer
            spans = [(i, torch.remainder(v, 2), p) for i, v, p in spans]
        err = compare_kernel(cs.global_superscan, global_superscan_plain, agg, spans,
                             (Q7["S"],), True, NSB=Q7["NSB"], R=Q7["R"],
                             spws=(gpipe.planner.spw,) * Q7["F"])
        k2_err = max(k2_err, err)
        emit({"phase": "k2_vs_plain", "agg": name, "dispatches": len(spans),
              "fires": sum(len(p[5]) for _i, _v, p in spans), "max_abs_err": err,
              "bit_equal": True})
        del spans

    # ---- 4/5. the main path (YSB) and the secondary paths, each driven
    # with the launch counts at 0 and checked window by window by replay ----
    wc = WORDCOUNT
    paths = [
        dict(name="ysb_sliding_count", kernel="k1_superscan", agg="count",
             window=st.WINDOW_MS, slide=st.SLIDE_MS, T=T, B=B, spans=YSB["spans"],
             depth=YSB["depth"],
             make=lambda: FusedWindowPipeline(
                 ysb_window, "count", key_capacity=K, num_slices=S, nsb=NSB,
                 fires_per_step=F, out_rows=R, device=DEV),
             gen=st.make_device_gen(T, B, device=DEV, nsb=NSB)),
        dict(name="wordcount_tumbling_count", kernel="k1_superscan", agg="count",
             window=1000, slide=1000, T=wc["T"], B=wc["B"], spans=wc["spans"],
             depth=wc["depth"],
             make=lambda: FusedWindowPipeline(
                 SlidingEventTimeWindows.of(1000, 1000), "count", key_capacity=K,
                 num_slices=S, nsb=NSB, fires_per_step=F, out_rows=R, device=DEV),
             gen=st.make_device_gen(wc["T"], wc["B"], device=DEV, slide_ms=1000,
                                    nsb=NSB)),
        dict(name="q7_global_max", kernel="k2_global_superscan", agg="max",
             window=10_000, slide=10_000, T=Q7["T"], B=Q7["B"], spans=Q7["spans"],
             depth=Q7["depth"],
             make=lambda: FusedGlobalWindowPipeline(
                 q7_window, "max", num_slices=Q7["S"], nsb=Q7["NSB"],
                 fires_per_step=Q7["F"], out_rows=Q7["R"], device=DEV),
             gen=st.make_device_gen(Q7["T"], Q7["B"], device=DEV, slide_ms=10_000,
                                    with_vals=True, nsb=Q7["NSB"])),
    ]
    main_launches, cuda_launches, path_launches = {}, {}, {}
    for p in paths:
        drive(p, spans=1, depth=1)                      # warm-up, uncounted
        cs.reset_launch_counts()
        fired, secs = drive(p)
        launches = cs.LAUNCHES[p["kernel"]]
        per_dispatch = cs.CUDA_LAUNCHES[p["kernel"]] / max(launches, 1)
        main_launches.setdefault(p["kernel"], launches)  # the first path of each kernel
        cuda_launches.setdefault(p["kernel"], per_dispatch)
        path_launches.setdefault(p["kernel"], {})[p["name"]] = launches
        t_rep = time.perf_counter()
        ref = st.replay(p["T"] * p["spans"], p["B"], window_ms=p["window"],
                        slide_ms=p["slide"], agg=p["agg"])
        if p["agg"] == "max":
            # the global max of every non-empty window (an empty one has none)
            expect = {j: np.array([row.max()]) for j, row in ref.fired.items()
                      if np.isfinite(row.max())}
        else:
            expect = ref.fired
        ok, checked = st.parity(expect, fired, require_all=True)
        ok = ok and set(fired) <= set(expect)
        events = p["T"] * p["B"] * p["spans"]
        emit({"phase": p["name"], "tuples_per_s": events / secs, "events": events,
              "seconds": secs, "parity": ok, "windows_checked": checked,
              "kernel": p["kernel"], "launches": launches,
              "cuda_launches_per_dispatch": per_dispatch,
              "replay_s": time.perf_counter() - t_rep})
        if not ok or launches == 0:
            raise AssertionError(f"{p['name']}: parity failed or {p['kernel']} never launched")

    # ---- 6. kernel times at the main paths' shapes ----
    agg = count_agg()
    planner = FusedWindowPipeline(ysb_window, agg, key_capacity=K, num_slices=S, nsb=NSB,
                                  fires_per_step=F, out_rows=R, plan_only=True,
                                  device=DEV)
    idx, _v, plan = plan_spans(planner, paths[0]["gen"], T, B, st.SLIDE_MS, 1)[0]
    count, _ = _fresh_rings(agg, (S, K), DEV, False)
    kw = dict(NSB=NSB, R=R, spws=(planner.spw,) * F, exact=True)
    k1_ms = cuda_ms(lambda: cs.keyed_superscan(agg, count, [], idx, None, plan[:5], **kw), 10)
    k1_plain_ms = cuda_ms(lambda: keyed_superscan_plain(agg, count, [], idx, None, plan[:5], **kw), 2, 3)
    k1_split = device_split_us(
        lambda: cs.keyed_superscan(agg, count, [], idx, None, plan[:5], **kw))
    # the other stages of one YSB span: host planning (host clock) and the
    # on-card generator (CUDA events)
    plan_host_ms = []
    for i in range(1, 6):
        t_plan = time.perf_counter()
        planner.plan_superbatch([st.step_bounds(i * T + r, B) for r in range(T)],
                                [st.watermark_after(i * T + r) for r in range(T)])
        plan_host_ms.append((time.perf_counter() - t_plan) * 1e3)
    smin_abs = np.array([st.step_bounds(r, B)[0] for r in range(T)], np.int32)
    ysb_gen_ms = cuda_ms(lambda: paths[0]["gen"](0, smin_abs), 3)
    # yardstick: the ingest alone as one atomic index_add_ of the dispatch's
    # records (what the plain version calls per step); the sort-based
    # index_put_ of earlier runs beside it
    ii = idx.view(T, B).long()
    smin_pos = plan[0].long()[:, None]
    cells = (((smin_pos + ii % NSB) % S) * K + ii // NSB)[ii >= 0]
    ones = torch.ones_like(cells, dtype=torch.int32)
    flat = count.view(-1)
    k1_lib_ms = cuda_ms(lambda: flat.index_add_(0, cells, ones), 10)
    k1_index_put_ms = cuda_ms(lambda: flat.index_put_((cells,), ones, accumulate=True), 10)
    plan_bytes = sum(p.numel() * 4 for p in plan[:5])
    # outputs: the fire rows this dispatch writes (the wrapper's zero fill of
    # the other rows of [R, K] is work the function does not need)
    k1_fires = len(plan[5])
    k1_bound = bound(T * B * 4 + 2 * S * K * 4 + k1_fires * K * 4 + plan_bytes, T * B)
    del ii, cells, ones

    gagg = max_agg()
    gplan_pipe = FusedGlobalWindowPipeline(q7_window, gagg, num_slices=Q7["S"],
                                           nsb=Q7["NSB"], fires_per_step=Q7["F"],
                                           out_rows=Q7["R"], device=DEV)
    gidx, gvals, gplan = plan_spans(gplan_pipe, paths[2]["gen"], Q7["T"], Q7["B"], 10_000, 1)[0]
    gcount, gstates = _fresh_rings(gagg, (Q7["S"],), DEV, True)
    gkw = dict(NSB=Q7["NSB"], R=Q7["R"], spws=(gplan_pipe.planner.spw,) * Q7["F"])
    k2_ms = cuda_ms(lambda: cs.global_superscan(gagg, gcount, gstates, gidx, gvals,
                                                gplan[:5], **gkw), 10)
    k2_plain_ms = cuda_ms(lambda: global_superscan_plain(gagg, gcount, gstates, gidx,
                                                         gvals, gplan[:5], **gkw), 2, 3)
    k2_split = device_split_us(
        lambda: cs.global_superscan(gagg, gcount, gstates, gidx, gvals, gplan[:5], **gkw))
    gsmin_abs = np.array([st.step_bounds(r, Q7["B"], 10_000)[0] for r in range(Q7["T"])],
                         np.int32)
    q7_gen_ms = cuda_ms(lambda: paths[2]["gen"](0, gsmin_abs), 3)
    gi = gidx.view(Q7["T"], Q7["B"]).long()
    gcols = ((gplan[0].long()[:, None] + gi % Q7["NSB"]) % Q7["S"])[gi >= 0]
    gv = gvals.view(Q7["T"], Q7["B"])[gi >= 0]
    gring = gstates[0]
    k2_lib_ms = cuda_ms(lambda: gring.scatter_reduce_(0, gcols, gv, "amax"), 10)
    gplan_bytes = sum(p.numel() * 4 for p in gplan[:5])
    k2_bound = bound(Q7["T"] * Q7["B"] * 8 + 4 * Q7["S"] * 4 + 2 * len(gplan[5]) * 4
                     + gplan_bytes, 2 * Q7["T"] * Q7["B"])
    emit({"phase": "kernel_times", "card": card,
          "k1_ms": k1_ms, "k1_plain_ms": k1_plain_ms, "k1_library_ms": k1_lib_ms,
          "k1_index_put_ms": k1_index_put_ms, "k1_device_us": k1_split,
          "k2_ms": k2_ms, "k2_plain_ms": k2_plain_ms, "k2_library_ms": k2_lib_ms,
          "k2_device_us": k2_split,
          "ysb_span_gen_ms": ysb_gen_ms, "ysb_span_plan_host_ms": float(np.median(plan_host_ms)),
          "q7_span_gen_ms": q7_gen_ms})

    # ---- 8. the DataStream job (this slice's main path), both routes ----
    api = api_ysb_phase()
    emit(api)
    if not api["ok"]:
        raise AssertionError("api_ysb: parity failed, the fused runner was not "
                             "selected, or a route made no K1 dispatch")
    for route in ("fused", "chain"):
        path_launches["k1_superscan"][f"api_ysb_{route}"] = api["timed"][route]["k1_dispatches"]

    # K1 at the main path's shapes: the job's first full fused dispatch
    # (T=32, B=65536, K=8192, R=256), inputs made by the pipeline's staging
    # and prologue; count and the prologue-fed sum
    api_k1 = {}
    for name, sum_job in (("count", False), ("sum", True)):
        pipe, agg, idx, vals, plan = api_k1_inputs(sum_job)
        S_, K_, T_ = pipe.S, pipe.K, int(plan[0].shape[0])
        kw = dict(NSB=pipe.NSB, R=pipe.R, spws=(pipe.spw,) * pipe.F, exact=True)
        err = compare_kernel(cs.keyed_superscan, keyed_superscan_plain, agg,
                             [(idx, vals, plan)], (S_, K_), False, **kw)
        count, states = _fresh_rings(agg, (S_, K_), DEV, False)
        ms = cuda_ms(lambda: cs.keyed_superscan(agg, count, states, idx, vals, plan[:5], **kw), 10)
        plain_ms = cuda_ms(lambda: keyed_superscan_plain(agg, count, states, idx, vals,
                                                         plan[:5], **kw), 2, 3)
        # yardstick: the dispatch's ingest as one index_add_
        ii = idx.view(T_, -1).long()
        live = ii >= 0
        cells = (((plan[0].long()[:, None] + ii % pipe.NSB) % S_) * K_ + ii // pipe.NSB)[live]
        target = (states[0] if states else count).view(-1)
        src = (vals.view(T_, -1)[live] if vals is not None
               else torch.ones_like(cells, dtype=torch.int32))
        lib_ms = cuda_ms(lambda: target.index_add_(0, cells, src), 10)
        rings = 1 + len(states)
        # outputs: the rows the dispatch fires, one per fire (not all R)
        nbytes = (idx.numel() * 4 + (vals.numel() * 4 if vals is not None else 0)
                  + 2 * rings * S_ * K_ * 4 + rings * len(plan[5]) * K_ * 4
                  + sum(p.numel() * 4 for p in plan[:5]))
        b_ms, b_by = bound(nbytes, int(live.sum()) * rings)
        api_k1[name] = {"shape": f"api_ysb {name}: the DataStream job's first full fused "
                                 f"dispatch, T={T_} B={idx.numel() // T_} K={K_} S={S_} "
                                 f"R={pipe.R}",
                        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                        "fires": len(plan[5]), "device_us": device_split_us(
                            lambda: cs.keyed_superscan(agg, count, states, idx, vals,
                                                       plan[:5], **kw))}
        del idx, vals, cells, src
    emit({"phase": "k1_api_shapes", "card": card, **api_k1})

    # ---- 9/10. the session paths (this slice's), each driven with the
    # launch counts at 0 just before it ----
    sess = session_sum_phase()
    emit(sess)
    if not sess["ok"]:
        raise AssertionError("session_sum: parity failed against numpy_sessionize or the "
                             "per-step route, a superspan replayed, or K3/K4 never launched")
    api_s = api_sessions_phase()
    emit(api_s)
    if not api_s["ok"]:
        raise AssertionError("api_sessions: parity failed, the session operator was not "
                             "selected, a superspan replayed, or K3/K4 never launched")
    # ---- 11. K3 and K4 against their plain versions, with their times ----
    skt = session_kernel_times(card)
    emit(skt)

    # ---- 12-15. the per-batch paths, each with its program calls at 0
    # just before it ----
    late_op = lateness_operator_phase()
    emit(late_op)
    if not late_op["ok"]:
        raise AssertionError("lateness_operator: an emission or the side output differs from "
                             "the oracle, the ingest forms disagree, or the ring is not 64 slices")
    api_late = api_lateness_phase()
    emit(api_late)
    if not api_late["ok"]:
        raise AssertionError("api_lateness: parity failed or TpuWindowOperator was not selected")
    api_count = api_count_window_phase()
    emit(api_count)
    if not api_count["ok"]:
        raise AssertionError("api_count_window: parity failed, TpuGlobalWindowOperator was not "
                             "selected, or its step did not run once a batch")
    api_ga = api_group_agg_phase()
    emit(api_ga)
    if not api_ga["ok"]:
        raise AssertionError("api_group_agg: the device changelog differs from the host path's "
                             "or the device path did not run")
    # ---- 16. the per-batch torch programs at these shapes ----
    timed = LATENESS["timed"]
    per_batch = {k: v / timed for k, v in late_op["scatter"]["program_calls"].items()}
    per_batch["ingest_sort"] = late_op["sort"]["program_calls"].get("ingest_sort", 0) / timed
    emit(per_batch_programs(card, per_batch))

    kernels = [
        {"name": "k1_superscan", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": api_k1["count"]["shape"],
         "launches": api["timed"]["fused"]["k1_dispatches"],
         "launches_by_path": path_launches["k1_superscan"],
         "cuda_launches_per_dispatch": cuda_launches["k1_superscan"],
         "max_abs_err": max([k1_err] + [r["max_abs_err"] for r in api_k1.values()]),
         "ms": api_k1["count"]["ms"], "plain_ms": api_k1["count"]["plain_ms"],
         "bound_ms": api_k1["count"]["bound_ms"], "bound_by": api_k1["count"]["bound_by"],
         "library_ms": api_k1["count"]["library_ms"],
         "api_sum": api_k1["sum"],
         "ysb_generator": {"shape": f"YSB generator: T={T} B={B} K={K} S={S} R={R}",
                           "fires": k1_fires, "ms": k1_ms, "plain_ms": k1_plain_ms,
                           "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
                           "library_ms": k1_lib_ms,
                           "index_put_ms": k1_index_put_ms}},
        {"name": "k2_global_superscan", "route": "cuda",
         "source": "flink_tpu_torch/csrc/global_superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:403",
         "shape": f"Q7: T={Q7['T']} B={Q7['B']} S={Q7['S']} R={Q7['R']}",
         "launches": main_launches["k2_global_superscan"],
         "launches_by_path": path_launches["k2_global_superscan"],
         "cuda_launches_per_dispatch": cuda_launches["k2_global_superscan"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": k2_lib_ms},
        {"name": "k3_session_ingest", "route": "cuda",
         "source": "flink_tpu_torch/csrc/session_superscan.cu",
         "replaces": "flink_tpu/ops/superscan.py:510",
         "shape": skt["k3_step"]["shape"], "launches": sess["k3_launches"],
         "launches_by_path": {"session_sum": sess["k3_launches"],
                              "api_sessions": api_s["k3_launches"]},
         "max_abs_err": max(skt["k3_step"]["max_abs_err"], skt["k3_run"]["max_abs_err"]),
         **{k: skt["k3_step"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")},
         "library": "index_add_ x2 + scatter_reduce_ x2 (count, min, max, sum)",
         "run": skt["k3_run"]},
        {"name": "k4_session_merge", "route": "cuda",
         "source": "flink_tpu_torch/csrc/session_superscan.cu",
         "replaces": "flink_tpu/ops/superscan.py:433",
         "shape": skt["k4_superspan"]["shape"], "launches": sess["k4_launches"],
         "launches_by_path": {"session_sum": sess["k4_launches"],
                              "api_sessions": api_s["k4_launches"]},
         "max_abs_err": max(skt["k4_superspan"]["max_abs_err"],
                            skt["k4_per_watermark"]["max_abs_err"]),
         **{k: skt["k4_superspan"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")},
         "library": "no single PyTorch call", "per_watermark": skt["k4_per_watermark"]},
    ]
    # ---- 7. where the time goes: each path once more under the profiler ----
    for p in paths:
        emit(profile_path(p))
    emit(profile_run("api_ysb_fused", lambda: api_run(API["fused_events"], True,
                                                      columnar=True)[1]))
    emit(profile_run("api_ysb_chain", lambda: api_run(API["chain_events"], False,
                                                      columnar=True)[1]))
    for route, fused in (("fused", True), ("chain", False)):
        emit(host_profile(f"api_ysb_{route}", lambda f=fused: api_run(
            API["chain_events"], f, columnar=True)[1]))
    sgen = st.make_session_gen(SESSIONS["T"], SESSIONS["B"], device=DEV)
    emit(profile_run("session_sum", lambda: run_sessions(sgen, DEV, SESSIONS,
                                                         SESSIONS["spans"])[1],
                     groups=(("k3", "k3_"), ("k4", "k4_"), ("copies", "Memcpy"))))
    emit(host_profile("api_sessions", lambda: session_api_run(
        API_SESSIONS["events"], API_SESSIONS)[1]))
    # the per-batch paths (lateness_operator's device profile is in its line)
    late_batches = lateness_batches(LATENESS)
    emit(host_profile("lateness_operator", lambda: run_lateness(
        lateness_op(DEV, LATENESS), late_batches, DEV)[1]))
    del late_batches
    emit(profile_run("api_lateness", lambda: api_lateness_run(API_LATENESS), groups=()))
    emit(host_profile("api_lateness", lambda: api_lateness_run(API_LATENESS)))
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
