"""Run one cell of BENCHMARK.json once and print its result line.

    python streambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards. With
`--trace 0` the line's metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from the window's clocks, the
port's launch counters and a profile of a late part of the window.
The last line of standard output is the result (JSON); the numbers that
decide `correct` close it under `check`, and are the last lines of
standard error too. Exit codes: 0 a result was printed (`correct` may be
false), 2 no CUDA card (or too few), 3 the planner left the device route,
4 a module of JAX or of the JAX package was loaded; anything else, a
failure with its traceback.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # no library the port uses may pull JAX in by itself
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from streambench.core import runner
    from streambench.core.spec import load_cell

    cell = load_cell(args.workload)
    try:
        run = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except runner.NoDevice as e:
        print(f"streambench: {e}", file=sys.stderr)
        return 2
    except runner.WrongRoute as e:
        print(f"streambench: {e}", file=sys.stderr)
        return 3
    except runner.ForbiddenModules as e:
        print(f"streambench: {e}", file=sys.stderr)
        return 4
    print(json.dumps(run.result), flush=True)
    rec = run.record
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in rec["setup_parts"].items())
          + f" | window {rec['window_s']:.3f} s, {rec['window_records']} records, "
          f"{rec['records']} in all; check {rec['check_s']:.3f} s", file=sys.stderr)
    if rec["trace"]:
        print(f"traced part {rec['trace']['window_s']:.3f} s, its start took "
              f"{rec['trace_start_s']:.3f} s; K1 dispatches in it "
              f"{rec['trace_launches'].get('k1_superscan', 0)}", file=sys.stderr)
    t = [x - rec["t_open"] for x in rec["hand_t"] if x >= rec["t_open"]]
    per_s = [0] * (int(rec["seconds"]) + 1)
    for x in t:
        per_s[min(int(x), len(per_s) - 1)] += 1
    print("batches handed over by second of the window: " + " ".join(map(str, per_s)),
          file=sys.stderr)
    for name, value, limit in run.check:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(f"check correct {str(run.result['correct']).lower()}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
