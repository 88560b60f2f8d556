#!/usr/bin/env python3
"""What the smoke's cuts save, on one NVIDIA GPU.

    python3 smoke_cuts.py

Times what `chip_smoke.py` no longer runs or runs smaller: api_oracle's
SQL_MULTI host profile as phase 19 ran it (2^15 records under cProfile),
and api_checkpoint leg C at 2^18, 2^17 and 2^16 records (its seconds, its
incremental ratio against the 0.25 gate, its parity). One JSON line a
measurement, the card's name and power limit first and last.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
import time

import chip_smoke as smoke


def cuts():
    sz = smoke.API_ORACLE
    t0 = time.perf_counter()
    smoke.host_profile("api_oracle_sql_multi", lambda: smoke.timed_execute(
        smoke.sql_multi_job(sz["sql_events"] // 4, sz, smoke.DEV)[0], smoke.DEV), top=8)
    yield {"cut": "sql_multi_host_profile", "seconds": time.perf_counter() - t0}
    for n in (1 << 18, 1 << 17, 1 << 16):
        tmp = tempfile.mkdtemp(prefix="smoke-cuts-")
        t0 = time.perf_counter()
        try:
            leg = smoke.ckpt_leg_c(dict(smoke.API_CHECKPOINT, tiered_events=n), smoke.DEV, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        yield {"cut": "ckpt_leg_c", "leg_s": time.perf_counter() - t0,
               **{k: leg[k] for k in ("events", "seconds", "incremental_ratio",
                                      "interval_checkpoints", "parity_vs_oracle",
                                      "num_restarts", "k1_launches", "evictions", "ok")}}


def main() -> int:
    print(smoke.card_line(), flush=True)
    for line in cuts():
        smoke.emit(line)
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
