"""Each cell on the card for a short window: correct, on the device route,
with the result line's form. Skips without a CUDA card."""

import pytest

from streambench.core import runner
from streambench.core.spec import load_cell

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload", ["ysb.max"])
def test_a_short_run_on_the_card(workload, cuda_card):
    run = runner.run_cell(load_cell(workload), 2**31 + 99, 3.0)
    assert run.result["correct"], run.result["check"]
    dev = run.result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    assert run.result["metrics"]["tuples_per_s"]["value"] > 0
