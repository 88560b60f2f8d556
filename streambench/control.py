"""The readings that the limits of `correct` are set from.

    python streambench/control.py --workload <name> --seeds 1,2,3 --seconds <s>

runs the cell once a seed in one process (set-up is long) and prints, a
seed a line, the numbers the check compares for the program's rows (the
lower readings) and for the control's: the plain reference computed with
its counts in 16-bit floats (`precision="float16"`), put in the program's
place over the same records. Then the largest lower and the smallest upper
reading of each number. The benchmark's own runs do not run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(run, cell) -> dict:
    """The control's numbers over the records `run` handed over."""
    from streambench.core import check
    from streambench.core.spec import load_module

    ref = load_module("reference", cell.config_name)
    ctl, _data = ref.expected(run.gen, cell.config, run.record["records"], precision="float16")
    return check.compare_rows(ctl, run.want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from streambench.core import runner
    from streambench.core.spec import load_cell

    cell = load_cell(args.workload)
    lower, upper = {}, {}
    t0 = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        run = runner.run_cell(cell, seed, args.seconds, t_start=t0)
        t0 = None
        program = {k: v for k, v, _lim in run.check}
        control = readings(run, cell)
        for k, v in program.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in control.items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps({"seed": seed, "correct": run.result["correct"],
                          "rows": run.result["attempted"], "program": program,
                          "control": control,
                          "tuples_per_s": run.record["window_records"] / run.record["window_s"]}),
              flush=True)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
