#!/usr/bin/env python3
"""What a cut of the smoke's second profiles would save, on one NVIDIA GPU.

    python3 smoke_cuts.py

Phase 7 of `chip_smoke.py` profiles some paths twice: under torch.profiler
(`profile_run`) and under cProfile (`host_profile`). For each such path
whose PERF.md row reads its host breakdown (api_ysb's two routes,
api_latency, api_correlated_shared, api_tiered zipf, api_chaos leg A), this
runs the device profile first, as the smoke does (which also warms the
path), then times the host profile. One JSON line a path, the card's name
and power limit first and last.
"""

from __future__ import annotations

import sys
import time

import chip_smoke as smoke


def profile_cuts():
    api, lat, cor, tie = smoke.API, smoke.API_LATENCY, smoke.API_CORRELATED, smoke.API_TIERED
    runs = {
        "api_ysb_fused": lambda: smoke.api_run(api["chain_events"], True, columnar=True)[1],
        "api_ysb_chain": lambda: smoke.api_run(api["chain_events"], False, columnar=True)[1],
        "api_latency": lambda: smoke.latency_run(lat["events"], True, lat)["seconds"],
        "api_correlated_shared": lambda: smoke.correlated_run(
            cor["timed_events"], True, columnar=True)["seconds"],
        "api_tiered_zipf": lambda: smoke.tiered_run(
            tie["events"] // 8, tie["keys"], True, tie, tiered=True, cap=tie["hot"])["seconds"],
        "api_chaos_a_device_error": smoke.chaos_main_thread_run,
    }
    for name, run in runs.items():
        t0 = time.perf_counter()
        smoke.profile_run(name, run)
        device_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        smoke.host_profile(name, run, top=16)
        yield {"cut": "host_profile", "path": name, "seconds": time.perf_counter() - t0,
               "device_profile_s": device_s}


def main() -> int:
    print(smoke.card_line(), flush=True)
    for line in profile_cuts():
        smoke.emit(line)
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
