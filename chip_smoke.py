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
   torch.profiler, and the share of its wall time the device was busy.

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


def profile_path(p) -> dict:
    """Device time by kernel for one run of path p under torch.profiler, and
    the share of the run's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _fired, secs = drive(p)
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
    return {"phase": "profile", "path": p["name"], "wall_s": secs,
            "device_busy_us": busy_us, "device_busy_share": busy_us / 1e6 / secs,
            "top": [{"name": n, "device_us": us, "calls": c} for us, n, c in rows[:10]]}


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
    main_launches, cuda_launches = {}, {}
    for p in paths:
        drive(p, spans=1, depth=1)                      # warm-up, uncounted
        cs.reset_launch_counts()
        fired, secs = drive(p)
        launches = cs.LAUNCHES[p["kernel"]]
        per_dispatch = cs.CUDA_LAUNCHES[p["kernel"]] / max(launches, 1)
        main_launches.setdefault(p["kernel"], launches)  # the first path of each kernel
        cuda_launches.setdefault(p["kernel"], per_dispatch)
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
    k1_bound = bound(T * B * 4 + 2 * S * K * 4 + R * K * 4 + plan_bytes, T * B)
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
    k2_bound = bound(Q7["T"] * Q7["B"] * 8 + 4 * Q7["S"] * 4 + 2 * Q7["R"] * 4 + gplan_bytes,
                     2 * Q7["T"] * Q7["B"])
    emit({"phase": "kernel_times", "card": card,
          "k1_ms": k1_ms, "k1_plain_ms": k1_plain_ms, "k1_library_ms": k1_lib_ms,
          "k1_index_put_ms": k1_index_put_ms, "k1_device_us": k1_split,
          "k2_ms": k2_ms, "k2_plain_ms": k2_plain_ms, "k2_library_ms": k2_lib_ms,
          "k2_device_us": k2_split,
          "ysb_span_gen_ms": ysb_gen_ms, "ysb_span_plan_host_ms": float(np.median(plan_host_ms)),
          "q7_span_gen_ms": q7_gen_ms})

    kernels = [
        {"name": "k1_superscan", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "launches": main_launches["k1_superscan"],
         "cuda_launches_per_dispatch": cuda_launches["k1_superscan"],
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": k1_lib_ms,
         "index_put_ms": k1_index_put_ms},
        {"name": "k2_global_superscan", "route": "cuda",
         "source": "flink_tpu_torch/csrc/global_superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:403",
         "launches": main_launches["k2_global_superscan"],
         "cuda_launches_per_dispatch": cuda_launches["k2_global_superscan"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": k2_lib_ms},
    ]
    # ---- 7. where the time goes: each path once more under the profiler ----
    for p in paths:
        emit(profile_path(p))
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
