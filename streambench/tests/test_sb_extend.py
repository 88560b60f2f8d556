"""A configuration, a traffic mix and a metric added as files and
BENCHMARK.json entries alone, with no file of the harness edited: the
harness finds each by its name."""

import json
import shutil
from pathlib import Path

import pytest

from streambench.core import runner, spec

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "streambench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    monkeypatch.setattr(spec, "BENCH_DIR", root / "streambench")
    monkeypatch.setattr(spec, "ROOT", root)
    return root


def write(path, text):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def test_a_cell_config_and_metric_added_as_files(bench_copy):
    sb = bench_copy / "streambench"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((sb / "configs" / "ysb.json").read_text())
    cfg["name"], cfg["event_rate_per_s"] = "ysb_small", 20_000
    write(sb / "configs" / "ysb_small.json", json.dumps(cfg))
    for kind in ("jobs", "gens", "reference", "roofline"):
        write(sb / kind / "ysb_small.py",
              "from streambench.core.spec import load_module\n\n"
              f"_base = load_module({kind!r}, 'ysb')\n\n"
              "def __getattr__(name):\n    return getattr(_base, name)\n")
    write(sb / "cells" / "ysb_small.tiny.json", json.dumps(
        {"batch_size": 4096, "pool_records": 1 << 15,
         "warmup_batches": 4}))
    write(sb / "metrics" / "rows_per_s.py",
          "def read(rec):\n    return len(rec['rows']['keys']) / rec['window_s']\n")
    bench["configs"].append({"name": "ysb_small", "source": "https://example.org",
                             "file": "streambench/configs/ysb_small.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "ysb_small.tiny", "config": "ysb_small",
                               "traffic": "ysb_small.tiny", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "rows_per_s", "unit": "rows/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["ysb_small.tiny"]})
    write(bench_copy / "BENCHMARK.json", json.dumps(bench))

    cell = spec.load_cell("ysb_small.tiny")
    assert [m["name"] for m in cell.end_to_end] == ["tuples_per_s", "setup_s", "rows_per_s"]
    run = runner.run_cell(cell, 5, 1.0, device="cpu")
    assert run.result["correct"]
    assert run.result["metrics"]["rows_per_s"]["value"] > 0
    # the cells already there do not report the new metric
    assert "rows_per_s" not in [m["name"] for m in spec.load_cell("ysb.max").end_to_end]


def test_a_forbidden_module_loaded_by_a_reader_fails_the_run(bench_copy, monkeypatch):
    """The guard runs last: a module of JAX that a metric reader (or the
    reference, or a table) loads after the window still fails the run."""
    import sys

    sb = bench_copy / "streambench"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    write(sb / "metrics" / "loads_jax.py",
          "import sys, types\n\n"
          "def read(rec):\n    sys.modules['jax'] = types.ModuleType('jax')\n    return 1.0\n")
    bench["end_to_end"].append({"name": "loads_jax", "unit": "s", "better": "lower",
                                "bound": 0.25, "source": "host_clock"})
    write(bench_copy / "BENCHMARK.json", json.dumps(bench))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        cell = spec.load_cell("ysb.max")
        cell.config["event_rate_per_s"] = 20_000
        traffic = dict(cell.traffic, batch_size=4096, pool_records=1 << 15, warmup_batches=4)
        with pytest.raises(runner.ForbiddenModules, match="jax"):
            runner.run_cell(cell, 5, 0.5, device="cpu", traffic=traffic)
    finally:
        sys.modules.pop("jax", None)
