"""Each cell's job through the port on the CPU at a tiny size, judged by
the harness against its reference; and with the timed path broken
underneath, judged not correct: a step that leaves its state unchanged,
half of a batch left out, and an answer altered where it is produced.
(The cell runs on one chip: there is no exchange between chips to leave
out.)"""

import numpy as np
import pytest

from streambench.core import runner
from streambench.tests.tiny import tiny_cell

CELLS = ["ysb.max"]
#: per cell: the operator class the window drives and its module
OPERATORS = {
    "ysb.max": ("flink_tpu_torch.runtime.fused_window_operator", "FusedWindowOperator",
                "process_raw_batch"),
}


def run_tiny(workload, seed=2**31 + 77, seconds=1.5, trace=False):
    cell, traffic = tiny_cell(workload)
    return runner.run_cell(cell, seed, seconds, trace, device="cpu", traffic=traffic)


@pytest.mark.parametrize("workload", CELLS)
def test_the_job_agrees_with_the_reference(workload):
    run = run_tiny(workload)
    assert run.result["correct"], run.result["check"]
    assert run.result["attempted"] > 100 and run.result["failed"] == 0
    assert list(run.result)[-1] == "check"
    assert set(run.result["metrics"]) == {"tuples_per_s", "setup_s"}


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reports_the_cells_per_layer_metrics(workload):
    cell, _traffic = tiny_cell(workload)
    run = run_tiny(workload, trace=True)
    assert run.result["correct"]
    # no device on the CPU: the device's metrics find nothing to read, and a
    # short window may close no window before the drain (fire lag)
    assert {"source_share_pct", "host_cpu_ns_per_rec"} <= set(run.result["metrics"]) <= {
        m["name"] for m in cell.per_layer}
    dev = run.result["device"]
    assert 0 < dev["window_s"] < run.record["window_s"] and "breakdown" in run.result
    # the traced part is a late share of the window
    assert run.record["trace_launches"] is not None


def _ingest_fault(kind):
    def wrap(orig):
        calls = {"n": 0}

        def fn(self, *args):
            calls["n"] += 1
            if kind == "unchanged" and calls["n"] % 5 == 0:
                return None                    # the step leaves the state as it was
            if kind == "half":
                n = len(args[-1]) // 2
                args = tuple(a[:n] for a in args)
            return orig(self, *args)
        return fn
    return wrap


def _altered(orig):
    def drain_output(self):
        out = orig(self)
        if out:
            k, w, r, t = out[0]
            out[0] = (k, w, r + 1, t)
        return out
    return drain_output


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch):
    import importlib

    mod, cls_name, ingest = OPERATORS[workload]
    cls = getattr(importlib.import_module(mod), cls_name)
    if fault == "altered":
        monkeypatch.setattr(cls, "drain_output", _altered(cls.drain_output))
    else:
        monkeypatch.setattr(cls, ingest, _ingest_fault(fault)(getattr(cls, ingest)))
    run = run_tiny(workload, seed=12345)
    assert not run.result["correct"]
    assert run.result["failed"] > 0


def test_the_planner_route_is_checked(monkeypatch):
    cell, traffic = tiny_cell("ysb.max")
    cell.config["device_route"] = "TpuSessionWindowOperator"
    with pytest.raises(runner.WrongRoute):
        runner.run_cell(cell, 1, 1.0, device="cpu", traffic=traffic)


def test_no_card_no_run(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell, traffic = tiny_cell("ysb.max")
    with pytest.raises(runner.NoDevice):
        runner.run_cell(cell, 1, 1.0, traffic=traffic)


def test_the_window_is_measured_from_its_first_batch():
    run = run_tiny("ysb.max", seconds=1.0)
    rec = run.record
    assert 1.0 <= rec["window_s"] < 30
    assert rec["window_records"] % (1 << 12) == 0 and rec["window_records"] < rec["records"]
    assert np.isclose(run.result["metrics"]["tuples_per_s"]["value"],
                      rec["window_records"] / rec["window_s"])
