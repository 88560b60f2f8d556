"""The feed's event clock, the row comparison and BENCHMARK.json's form."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from streambench.core.check import compare_rows, verdict
from streambench.core.feed import EventClock, event_times, warmup_records

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("n,t0,rate", [(1 << 12, 1_000_000, 10**7), (4096, 5, 10**6),
                                      (1024, 5, 2000), (7, 5, 3), (1000, 3, 999)])
def test_event_clock_is_event_times(n, t0, rate):
    clock, held = EventClock(n, t0, rate), []
    for lo in list(range(0, 40 * n, n)) + [12345, 10**9 + 7]:
        ts = clock(lo)
        assert np.array_equal(ts, event_times(lo, n, t0, rate))
        held.append(ts)                 # held buffers are never handed out again
    assert len({id(t) for t in held}) == len(held)


def test_event_clock_reuses_a_released_buffer():
    clock = EventClock(64, 0, 1000)
    a = clock(0)
    first = id(a)
    del a
    assert id(clock(64)) == first


def test_hooks_run_once_each_at_their_time_into_the_window():
    from streambench.core.feed import FeedSource

    class Gen:
        def batch(self, lo, n):
            return np.zeros((n, 2), np.int32)

    ran = []
    src = FeedSource(Gen(), batch=4, event_rate=1000, t0_ms=0, bound_ms=0, warm_records=8,
                     seconds=0.05, at=[(0.02, lambda: ran.append("b")),
                                       (0.0, lambda: ran.append("a"))])
    reader = src.create_reader()
    import time
    while reader.poll_batch(4) is not None:
        time.sleep(0.002)
    assert ran == ["a", "b"]
    assert src.state.window_records > 0


def test_warmup_records():
    assert warmup_records({"warmup_batches": 3}, 100, 10) == 300
    assert warmup_records({"warmup_event_s": 1.5}, 100, 1000) == 1500
    assert warmup_records({"warmup_event_s": 1.55}, 100, 1000) == 1600


def test_compare_rows():
    want = (np.array([1, 1, 2]), np.array([9, 19, 9]), np.array([3.0, 4.0, 5.0]))
    assert compare_rows(want, want) == {"rows_missing": 0, "rows_extra": 0,
                                        "rows_duplicated": 0, "result_mismatch": 0}
    got = (np.array([2, 1, 1, 7]), np.array([9, 9, 9, 9]), np.array([5.0, 3.5, 3.5, 1.0]))
    n = compare_rows(got, want)
    assert n == {"rows_missing": 1, "rows_extra": 1, "rows_duplicated": 1, "result_mismatch": 1}
    ok, rows = verdict(n)
    assert not ok and [r[0] for r in rows] == list(n)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contracts_form():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["streambench"] and isinstance(b["run_seconds"], int)
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
        cfg = json.loads((REPO / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"]) and all(k in cfg for k in c["reduced"])
    cells = {}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["config"] in configs
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert (REPO / "streambench" / "cells" / f"{w['traffic']}.json").is_file()
        cells[w["name"]] = w
    assert {w["config"] for w in b["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (REPO / "streambench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        layers.add(m["layer"])
    for name in cells:
        reported = [m for m in b["end_to_end"] if name in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(name in m.get("workloads", cells) for m in b["per_layer"])
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
