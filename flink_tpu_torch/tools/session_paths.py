#!/usr/bin/env python3
"""The session paths of `chip_smoke.py` timed alone on one NVIDIA GPU,
from this checkout or another.

    python3 flink_tpu_torch/tools/session_paths.py [--root DIR] [--phases N]
        [--runs N] [--profile]

Imports `chip_smoke.py` and `flink_tpu_torch` from DIR (default: this
checkout; `--root` takes another commit unpacked with `git archive`, so
two commits run the same measurement in one call). Runs
`session_sum_phase` and `api_sessions_phase` `--phases` times each and
prints each phase's JSON line; then `--runs` more timed runs of
session_sum's superspans (`run_sessions`, a fresh operator each) with
their tuples/s; with `--profile`, the host functions that take one such
run (cProfile, by own time). A last line gives the medians, least and
largest.

PERF.md's session A/B comes from, in one call, with build/parent the
parent commit unpacked by `git archive`:

    for r in build/parent . . build/parent build/parent .; do
        session_paths.py --root $r --phases 2 --runs 5 [--profile]; done
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--phases", type=int, default=2)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    a = ap.parse_args()
    root = str(Path(a.root).resolve())
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("session_paths: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from flink_tpu_torch.testing import stream as st

    tag = {"root": a.root, "card": smoke.card_line()}
    rates = {"session_sum": [], "api_sessions": [], "session_sum_runs": []}
    for p in range(a.phases):
        for name, phase in (("session_sum", smoke.session_sum_phase),
                            ("api_sessions", smoke.api_sessions_phase)):
            line = phase()
            rates[name].append(line["tuples_per_s"])
            print(json.dumps({**tag, "round": p, **line}), flush=True)
            if not line["ok"]:
                return 1
    z = smoke.SESSIONS
    gen = st.make_session_gen(z["T"], z["B"], device=smoke.DEV, gap_ms=z["gap"],
                              num_slices=z["S"])
    events = z["spans"] * z["T"] * z["B"]
    smoke.run_sessions(gen, smoke.DEV, z, z["spans"])                       # warm
    for r in range(a.runs):
        secs = smoke.run_sessions(gen, smoke.DEV, z, z["spans"])[1]
        rates["session_sum_runs"].append(events / secs)
        print(json.dumps({**tag, "run": r, "seconds": secs, "tuples_per_s": events / secs}),
              flush=True)
    if a.profile:
        prof = cProfile.Profile()
        prof.enable()
        secs = smoke.run_sessions(gen, smoke.DEV, z, z["spans"])[1]
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(15)
        print(json.dumps({**tag, "profiled_seconds": secs,
                          "top": out.getvalue().splitlines()[-22:]}), flush=True)
    print(json.dumps({**tag, "summary": {
        k: {"median": float(np.median(v)), "min": min(v), "max": max(v), "n": len(v)}
        for k, v in rates.items() if v}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
