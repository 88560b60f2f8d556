#!/usr/bin/env python3
"""Timings of kernel K1 (the keyed superscan dispatch) on one NVIDIA GPU.

    python3 flink_tpu_torch/tools/k1_ab.py geometries [--root DIR]
    python3 flink_tpu_torch/tools/k1_ab.py variants [--rounds N]

`geometries` times one keyed dispatch at the YSB geometry (K=8192, S=32,
NSB=4, F=4, R=64, T=48, B=2^20, plans from the port's planner, records
from the on-card generator) for count, sum, max8 and four mixed fields,
and at 2^16 to 2^20 keys. Per geometry: ms per dispatch (CUDA events,
wrapper included), each CUDA kernel's device µs (torch.profiler), and two
one-call PyTorch yardsticks on the same records: `index_add_` (and
`scatter_reduce_` for min/max fields) of the whole dispatch into the
rings, and the same into [T, K*NSB] step partials filled with the
identities, which is what an ingest by device-memory atomics does. `--root DIR` imports
`flink_tpu_torch` from another checkout (an earlier commit unpacked with
`git archive`), so two commits run the same measurement in one call.

`variants` builds copies of `csrc/superscan.cu`, each with one change
(VARIANTS), and times them against the source as it stands, by default at
the YSB geometry for count and sum (`--geometries`). Round r runs the
variants in an order rotated by r, so no variant always runs first. Each
variant's rows must equal the source's. The summary gives, per variant
and kernel, the median, least and largest device µs over the rounds.

PERF.md's K1 tables come from, in one call:

    for r in build/parent . . build/parent; do k1_ab.py geometries --root $r; done
    k1_ab.py variants --rounds 5 --only no_swizzle batch8 batch16 \
        scalar_loads general_merge cas_min_max \
        --geometries ysb_count ysb_sum ysb_four_fields
    k1_ab.py variants --rounds 3 --only always_tiled always_atomic \
        --geometries ysb_four_fields keys_2e17_count keys_2e18_count \
        keys_2e16_four_fields keys_2e20_count

with build/parent the parent commit unpacked by `git archive`.

One JSON line per measurement, a summary line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
S, NSB, F, R, T, B = 32, 4, 4, 64, 48, 1 << 20

#: name -> (aggregate, keys)
GEOMETRIES = {
    "ysb_count": ("count", 8192),
    "ysb_sum": ("sum", 8192),
    "ysb_max8": ("max8", 8192),
    "ysb_four_fields": ("four_fields", 8192),
    "keys_2e16_count": ("count", 1 << 16),
    "keys_2e17_count": ("count", 1 << 17),
    "keys_2e18_count": ("count", 1 << 18),
    "keys_2e16_four_fields": ("four_fields", 1 << 16),
    "keys_2e20_count": ("count", 1 << 20),
}

#: name -> the (text, replacement) edits of csrc/superscan.cu that make it
VARIANTS = {
    "no_swizzle": [("return c ^ ((c >> 5) & 31u);", "return c;")],
    "batch8": [("return FIELDS ? 8 : 16;", "return 8;")],
    "batch16": [("return FIELDS ? 8 : 16;", "return 16;")],
    "scalar_loads": [("const int vec = B % 4 == 0", "const int vec = 0 && B % 4 == 0")],
    "general_merge": [("const bool fast = pb > 0 && NSB == 4 && S >= 4;",
                       "const bool fast = false;")],
    # float min/max through compare-and-swap loops on the order keys
    "cas_min_max": [(f"case {k}: if (v == v) atomic{op}((unsigned int*)c, f32_key(v)); break;",
                     f"case {k}: if (v == v) {{ unsigned int* u = (unsigned int*)c; "
                     f"unsigned int x = f32_key(v), o = *u; while (x {cmp} o) {{ "
                     "const unsigned int p = atomicCAS(u, o, x); if (p == o) break; o = p; } } break;")
                    for k, op, cmp in (("MIN_F32", "Min", "<"), ("MAX_F32", "Max", ">"))],
    "always_tiled": [("#define K1_MAX_TILES 16 ", "#define K1_MAX_TILES 1000000 ")],
    "always_atomic": [("#define K1_MAX_TILES 16 ", "#define K1_MAX_TILES 0 ")],
}


def _timing():
    """This checkout's testing/timing.py, whichever checkout --root names."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "k1_ab_timing", REPO / "flink_tpu_torch" / "testing" / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(obj):
    print(json.dumps(obj), flush=True)


def make_agg(name):
    from flink_tpu_torch.ops import aggregators as a

    if name == "four_fields":
        fmax = float(np.finfo(np.float32).max)
        return a.DeviceAggregator("four_fields", (
            a.AccField("s", np.float32, 0, "add"),
            a.AccField("lo", np.float32, fmax, "min"),
            a.AccField("hi", np.float32, -fmax, "max"),
            a.AccField("m8", np.int32, -1, "max", domain_bits=8)), lambda f: f["s"])
    return {"count": a.count_agg, "sum": a.sum_agg,
            "max8": lambda: a.max_agg(domain_bits=8)}[name]()


def rings(agg, K):
    import torch
    from flink_tpu_torch.ops.aggregators import torch_dtype
    from flink_tpu_torch.ops.superscan import value_fields

    count = torch.zeros((S, K), dtype=torch.int32, device="cuda")
    return count, [torch.full((S, K), f.identity, dtype=torch_dtype(f.dtype), device="cuda")
                   for f in value_fields(agg)]


def dispatch_inputs(agg_name, K):
    """The first YSB span at K keys: (agg, idx, vals, plan, keyword args)."""
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.runtime.fused_window_pipeline import FusedWindowPipeline
    from flink_tpu_torch.testing import stream as st

    agg = make_agg(agg_name)
    planner = FusedWindowPipeline(
        SlidingEventTimeWindows.of(st.WINDOW_MS, st.SLIDE_MS), agg, key_capacity=K,
        num_slices=S, nsb=NSB, fires_per_step=F, out_rows=R, plan_only=True, device="cuda")
    plan, smin_abs = planner.plan_superbatch(
        [st.step_bounds(r, B, st.SLIDE_MS) for r in range(T)],
        [st.watermark_after(r) for r in range(T)])
    gen = st.make_device_gen(T, B, device="cuda", with_vals=agg_name != "count", nsb=NSB,
                             num_keys=K)
    g = gen(0, smin_abs)
    idx, vals = g if isinstance(g, tuple) else (g, None)
    kw = dict(NSB=NSB, R=R, spws=(planner.spw,) * F, exact=True)
    return agg, idx, vals, tuple(plan[:5]), kw


def yardsticks(agg, K, idx, vals, plan):
    """(into the rings, into step partials): ms of one PyTorch call per
    array that lands the dispatch's records as atomics would."""
    import torch
    from flink_tpu_torch.ops.aggregators import torch_dtype
    from flink_tpu_torch.ops.superscan import field_kind, value_fields

    cuda_ms = _timing().cuda_ms

    ii = idx.view(T, B).long()
    keep = (ii >= 0) & (ii < K * NSB)
    ring_cells = (((plan[0].long()[:, None] + ii % NSB) % S) * K + ii // NSB)[keep]
    part_cells = (torch.arange(T, device="cuda")[:, None] * (K * NSB) + ii)[keep]
    v = vals.view(T, B)[keep] if vals is not None else None
    arrays = [(torch.int32, 0, "add", torch.ones_like(ring_cells, dtype=torch.int32))]
    for f in value_fields(agg):
        kind = field_kind(f)
        x = v.clamp(0, 255).int() if kind == "max8" else v.to(torch_dtype(f.dtype))
        arrays.append((x.dtype, f.identity, "max" if kind == "max8" else kind, x))
    count, states = rings(agg, K)
    flat = [count.view(-1)] + [s.view(-1) for s in states]
    parts = [torch.empty(T * K * NSB, dtype=dt, device="cuda") for dt, *_ in arrays]

    def land(dst, cells, kind, x):
        if kind == "add":
            dst.index_add_(0, cells, x)
        else:
            dst.scatter_reduce_(0, cells, x, "a" + kind)

    def into_rings():
        for dst, (_dt, _i, kind, x) in zip(flat, arrays):
            land(dst, ring_cells, kind, x)

    def into_partials():
        for dst, (_dt, ident, kind, x) in zip(parts, arrays):
            dst.fill_(ident)
            land(dst, part_cells, kind, x)

    out = cuda_ms(into_rings, 5), cuda_ms(into_partials, 5)
    del parts, ring_cells, part_cells
    return out


def geometries(args):
    import torch
    from flink_tpu_torch.ops import cuda_superscan as cs

    cuda_ms, device_split_us = _timing().cuda_ms, _timing().device_split_us
    cs.build()
    for name in args.only or GEOMETRIES:
        agg_name, K = GEOMETRIES[name]
        agg, idx, vals, plan, kw = dispatch_inputs(agg_name, K)
        count, states = rings(agg, K)
        call = lambda: cs.keyed_superscan(agg, count, states, idx, vals, plan, **kw)  # noqa: E731
        ms = cuda_ms(call, 10)
        split = device_split_us(call)
        ring_ms, part_ms = yardsticks(agg, K, idx, vals, plan)
        emit({"geometry": name, "root": str(args.root), "agg": agg_name, "K": K,
              "ms": ms, "device_us": split, "index_add_rings_ms": ring_ms,
              "index_add_partials_ms": part_ms})
        del idx, vals, count, states
        torch.cuda.empty_cache()


def build_variants(names):
    """name -> ctypes library of csrc/superscan.cu with the variant's edits,
    one nvcc per variant, all started together."""
    from flink_tpu_torch.ops import cuda_superscan as cs

    src = (cs.CSRC / "superscan.cu").read_text()
    procs = {}
    for name in names:
        out = REPO / "build" / "k1_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not in superscan.cu once")
            text = text.replace(old, new)
        (out / "superscan.cu").write_text(text)
        shutil.copy(cs.CSRC / "common.cuh", out / "common.cuh")
        lib = out / "libsuperscan.so"
        procs[name] = (subprocess.Popen([cs._nvcc(), *cs.NVCC_FLAGS, "-o", str(lib),
                                         str(out / "superscan.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{log}")
        libs[name] = cs.bind(ctypes.CDLL(str(lib)), "superscan")
    return libs


def variants(args):
    import torch
    from flink_tpu_torch.ops import cuda_superscan as cs

    device_split_us = _timing().device_split_us
    names = args.only or list(VARIANTS)
    libs = {"source": cs._library("superscan"), **build_variants(names)}
    order = list(libs)
    library = cs._library
    summary = {}
    try:
        for geo in args.geometries:
            agg_name, K = GEOMETRIES[geo]
            agg, idx, vals, plan, kw = dispatch_inputs(agg_name, K)
            rows = {}
            for name, lib in libs.items():              # one dispatch from fresh rings
                cs._library = lambda _n, lib=lib: lib
                count, states = rings(agg, K)
                out = cs.keyed_superscan(agg, count, states, idx, vals, plan, **kw)
                rows[name] = [count, out[0], *states, *out[1]]
            same = {n: all(torch.equal(a, b) for a, b in zip(r, rows["source"]))
                    for n, r in rows.items()}
            del rows
            times = {n: {} for n in libs}
            count, states = rings(agg, K)
            for r in range(args.rounds):
                for name in order[r % len(order):] + order[:r % len(order)]:
                    cs._library = lambda _n, lib=libs[name]: lib
                    split = device_split_us(lambda: cs.keyed_superscan(
                        agg, count, states, idx, vals, plan, **kw), reps=10)
                    # k1_ingest_tiled or k1_ingest_atomic, and k1_scan
                    us = {kern: sum(t for k, t in split.items() if k.startswith(kern))
                          for kern in ("k1_ingest", "k1_scan")}
                    for kern, t in us.items():
                        times[name].setdefault(kern, []).append(t)
                    emit({"geometry": geo, "round": r, "variant": name, "device_us": us})
            summary[geo] = {n: {"same_rows": same[n], **{
                k: {"median": float(np.median(v)), "min": min(v), "max": max(v)}
                for k, v in times[n].items()}} for n in libs}
            del idx, vals, count, states
            torch.cuda.empty_cache()
    finally:
        cs._library = library
    emit({"summary": summary, "rounds": args.rounds})
    if not all(s["same_rows"] for g in summary.values() for s in g.values()):
        raise SystemExit("a variant's rows differ from the source's")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("geometries", "variants"))
    ap.add_argument("--root", type=Path, default=REPO,
                    help="checkout whose flink_tpu_torch is measured (geometries)")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--only", nargs="*", help="geometries or variants to run")
    ap.add_argument("--geometries", nargs="*", default=["ysb_count", "ysb_sum"],
                    help="the geometries the variants run at")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("k1_ab: needs a CUDA device", file=sys.stderr)
        return 2
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit({"card": out.stdout.strip(), "torch": torch.__version__})
    (geometries if args.mode == "geometries" else variants)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
