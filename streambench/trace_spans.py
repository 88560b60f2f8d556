"""Run one cell traced, as `run.py --trace 1` does, and split the traced
part's idle device time by the port's `flink.*` spans.

    python streambench/trace_spans.py --workload <name> --seed <n> --seconds <s>

from the root of a checkout on a machine with the cell's CUDA cards.
Prints what run.py prints (its result line last on standard output), then
on standard error one line `spans {...}` (JSON): the idle seconds under
each span open on the job's thread (`(none)` under none), the unspanned
share of the idle time in %, the spans' counts, and the count of `flink.*`
events on the CUDA device (0: no span enclosed device work). Exit codes
are run.py's.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from streambench import run
    from streambench.core import spans, trace

    found = {}
    reduce_profile = trace.reduce_profile

    def reduce_and_split(prof, samples, t_open, top=10):
        found.update(spans.idle_by_span(prof))
        return reduce_profile(prof, samples, t_open, top)

    trace.reduce_profile = reduce_and_split
    argv = list(sys.argv[1:] if argv is None else argv)
    rc = run.main(argv + ["--trace", "1"])
    print("spans " + json.dumps(found), file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
