"""The port's rewritten rules, its baseline and its CLI.

DEV001-003 and EXON002 read torch and CUDA code where the JAX package's
read `jax.jit`. Each runs here over a seeded bad package and its good
twin, written under `tmp_path` from the strings below: the FULL registry
runs, the target rule fires in the bad modules only, and no other rule
fires. The baseline refuses TODO justifications and prunes entries that
can never match again; the CLI's three formats equal the JAX CLI's over
the same corpus, up to the program's name; importing and running the
analyzer loads none of torch, jax or flink_tpu.
"""

import contextlib
import io
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

import flink_tpu.lint.cli as jax_cli
import flink_tpu_torch.lint as port_lint
import flink_tpu_torch.lint.cli as port_cli
from flink_tpu_torch.lint.index import ModuleIndex
from flink_tpu_torch.lint.rules_device import dispatch_functions

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "tests" / "lint_corpus"
PARITY_RULES = ("ARCH001", "ARCH002", "CONC001", "CONC002", "CONC003", "CONC004",
                "CONC005", "DOC001", "EXON001", "EXON003", "WIRE001", "WIRE002")


def _package(root: pathlib.Path, files: dict) -> pathlib.Path:
    root.mkdir(parents=True)
    (root / "__init__.py").write_text("")
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.parent != root and not (path.parent / "__init__.py").exists():
            (path.parent / "__init__.py").write_text("")
        path.write_text(textwrap.dedent(src))
    return root


def _fired(root, rule_id):
    report = port_lint.run_lint(root)              # the full registry
    strays = [(v.rule_id, v.path, v.line) for v in report.violations
              if v.rule_id != rule_id]
    assert not strays, strays
    return report.by_rule(rule_id)


# ---------------------------------------------------------------------------
# DEV001: host syncs inside a device dispatch
# ---------------------------------------------------------------------------

DEV001_BAD = '''
    import numpy as np
    import torch

    from pkg.ops.library import _library


    def _launch(count, idx, n):
        lib = _library("superscan")
        steps = int(n[0])                       # SEEDED: a tensor read back
        lib.k1_superscan(count.data_ptr(), idx.data_ptr(), steps)


    def keyed_superscan(count, idx, n: torch.Tensor):
        if count.device.type == "cpu":
            return None
        total = idx.sum().item()                # SEEDED
        torch.cuda.synchronize()                # SEEDED
        plan = np.asarray(n)                    # SEEDED
        _launch(count, idx, n)
        return total, plan


    def session_merge(cnt, pos):
        # calls the dispatch two hops down: still on every dispatch
        return keyed_superscan(cnt, pos, pos)


    class Head:
        def __init__(self, cnt):
            self.lib = _library("session_superscan")
            self.cnt = cnt

        def merge(self, pos, event):
            bounds = pos.tolist()               # SEEDED
            self.lib.k4_session_merge(self.cnt.data_ptr(), pos.data_ptr())
            event.synchronize()                 # SEEDED
            return bounds

        def entry(self, pos, event):
            first = float(pos[-1])              # SEEDED: calls merge via self
            self.merge(pos, event)
            return first, pos.cpu(), pos.numpy()  # SEEDED x2


    def launch_by_name(entry, count, flag, lo_pos: np.ndarray):
        lib = _library("global_superscan")
        rc = getattr(lib, entry)(count.data_ptr(), int(lo_pos[-1]))  # SEEDED: no annotation is trusted
        return rc, bool(flag)                   # SEEDED
'''

DEV001_GOOD = '''
    from typing import Sequence

    import numpy as np
    import torch

    from pkg.ops.library import _library


    def _launch(count, idx, spws: Sequence[int], exact_flag):
        lib = _library("superscan")
        B = int(idx.shape[0])                   # static: a shape
        lib.k1_superscan(count.data_ptr(), idx.data_ptr(), B, exact_flag, len(spws),
                         int(4))


    def host_plan(lo_pos, wm_rel):
        # the host plan, converted before the dispatch: no kernel here
        return [int(p) for p in lo_pos], [int(w) for w in wm_rel]


    def session_superscan(cnt, kid, pos, wms):
        if cnt.device.type == "cpu":
            return None
        T = int(kid.shape[0])
        lib = _library("session_superscan")
        for t in range(T):
            lib.k4_session_merge(cnt.data_ptr(), pos[t], wms[t], pos[-1])


    def readback(out):
        # the step boundary: no kernel launched here, so no dispatch
        torch.cuda.synchronize()
        return out.cpu().numpy(), out.sum().item(), np.asarray(out.tolist())
'''


LIBRARY = '''
    import ctypes

    _libraries = {}


    def _library(name):
        lib = _libraries.get(name)
        if lib is None:
            lib = _libraries[name] = ctypes.CDLL(name)
        return lib
'''


def test_dev001_fires_on_host_syncs_in_a_dispatch(tmp_path):
    root = _package(tmp_path / "pkg", {"ops/library.py": LIBRARY,
                                       "ops/bad_launch.py": DEV001_BAD,
                                       "ops/good_launch.py": DEV001_GOOD})
    fired = _fired(root, "DEV001")
    assert {v.path for v in fired} == {"pkg/ops/bad_launch.py"}
    got = sorted((v.scope, v.symbol) for v in fired)
    assert got == sorted([
        ("_launch", "int()@_launch"),
        ("keyed_superscan", ".item()@keyed_superscan"),
        ("keyed_superscan", "torch.cuda.synchronize()@keyed_superscan"),
        ("keyed_superscan", "np.asarray()@keyed_superscan"),
        ("Head.merge", ".tolist()@merge"),
        ("Head.merge", ".synchronize()@merge"),
        ("Head.entry", "float()@entry"),
        ("Head.entry", ".cpu()@entry"),
        ("Head.entry", ".numpy()@entry"),
        ("launch_by_name", "int()@launch_by_name"),
        ("launch_by_name", "bool()@launch_by_name"),
    ]), got
    index = ModuleIndex(root)
    dispatch = [q for q, _fn in dispatch_functions(index.get("ops/bad_launch.py"))]
    assert dispatch == ["_launch", "keyed_superscan", "session_merge", "Head.__init__",
                        "Head.merge", "Head.entry", "launch_by_name"]
    assert [q for q, _fn in dispatch_functions(index.get("ops/good_launch.py"))] == \
        ["_launch", "session_superscan"]


def test_dev001_indexes_repeated_syncs_by_occurrence(tmp_path):
    root = _package(tmp_path / "pkg", {"ops/library.py": LIBRARY, "ops/bad_twice.py": '''
        from pkg.ops.library import _library


        def dispatch(a, b):
            lib = _library("superscan")
            lib.k1_superscan(a.data_ptr())
            return a.item(), b.item()
    '''})
    assert [v.symbol for v in _fired(root, "DEV001")] == [".item()@dispatch",
                                                          ".item()@dispatch#2"]


def test_dev001_reads_the_ports_launchers():
    """The real tree's dispatch functions are K1/K2's and K3/K4's."""
    index = ModuleIndex(ROOT / "flink_tpu_torch")
    found = {m.rel: [q for q, _fn in dispatch_functions(m)] for m in index.modules}
    found = {rel: qs for rel, qs in found.items() if qs}
    assert {"_launch", "keyed_superscan", "global_superscan",
            "keyed_superscan_partials"} <= set(found["ops/cuda_superscan.py"])
    assert {"_launch_k3", "_merge", "session_ingest", "session_merge",
            "session_superscan"} <= set(found["ops/cuda_session.py"])
    assert set(found) == {"ops/cuda_superscan.py", "ops/cuda_session.py",
                          "tools/k1_ab.py"}


# ---------------------------------------------------------------------------
# DEV002: kernel builds inside a loop
# ---------------------------------------------------------------------------

DEV002_BAD = '''
    import ctypes

    import torch
    import torch.utils.cpp_extension

    from pkg.ops import cuda_superscan as cs


    def per_batch(batches, fn):
        for batch in batches:
            lib = cs._library("superscan")        # SEEDED
            lib.k1_superscan(batch)
        n = 0
        while n < 3:
            ctypes.CDLL("libvariant.so")          # SEEDED
            n += 1
        for b in batches:
            torch.compile(fn)(b)                  # SEEDED
            torch.utils.cpp_extension.load(name="k", sources=["k.cu"])   # SEEDED
        for name in ("superscan",):
            cs.build([name])                      # SEEDED
'''

DEV002_GOOD = '''
    import ctypes

    import torch

    from pkg.ops import cuda_superscan as cs


    def per_batch(batches, fn):
        lib = cs._library("superscan")
        variant = ctypes.CDLL("libvariant.so")
        compiled = torch.compile(fn)
        for batch in batches:
            lib.k1_superscan(batch)
            compiled(batch)
        for name in ("a", "b"):
            def later(name=name):
                # a def inside a loop runs later: not a build per iteration
                return cs._library(name)
        return variant, later
'''


def test_dev002_fires_on_builds_in_loops(tmp_path):
    root = _package(tmp_path / "pkg", {"ops/cuda_superscan.py": LIBRARY,
                                       "ops/bad_driver.py": DEV002_BAD,
                                       "ops/good_driver.py": DEV002_GOOD})
    fired = _fired(root, "DEV002")
    assert {v.path for v in fired} == {"pkg/ops/bad_driver.py"}
    assert sorted(v.symbol for v in fired) == ["build-in-loop@per_batch"] + [
        f"build-in-loop@per_batch#{i}" for i in range(2, 6)]
    assert sorted(v.message.split(" inside")[0] for v in fired) == sorted([
        "_library(...)", "CDLL(...)", "torch.compile(...)", "cpp_extension.load(...)",
        "build(...)"])


def test_dev001_and_dev002_findings_on_the_port_are_the_baselined_host_values():
    """No annotation and no directory exempts a finding: on the real tree
    DEV001/DEV002 find the K4 and K1 launchers' conversions of host plan
    values and the A/B harness's library loads and timing summary, and
    each one stands in the port's baseline with a written reason."""
    index = ModuleIndex(ROOT / "flink_tpu_torch")
    found = sorted((v.rule_id, v.path, v.scope, v.symbol)
                   for rid in ("DEV001", "DEV002")
                   for v in port_lint.get_rule(rid).check(index))
    assert found == sorted(
        [("DEV001", "flink_tpu_torch/ops/cuda_session.py", "session_superscan",
          "int()@session_superscan" + n) for n in ("", "#2", "#3", "#4", "#5")] +
        [("DEV001", "flink_tpu_torch/ops/cuda_superscan.py", "keyed_superscan",
          "int()@keyed_superscan"),
         ("DEV001", "flink_tpu_torch/tools/k1_ab.py", "variants", "float()@variants"),
         ("DEV002", "flink_tpu_torch/tools/k1_ab.py", "build_variants",
          "build-in-loop@build_variants")])
    entries = json.loads((ROOT / "lint_baseline_torch.json").read_text())["entries"]
    baselined = {(e["rule"], e["path"], e["scope"], e["symbol"]): e["justification"]
                 for e in entries}
    for key in found:
        assert len(baselined[key]) > 40 and not baselined[key].startswith("TODO"), key


# ---------------------------------------------------------------------------
# DEV003: the torch-free control plane
# ---------------------------------------------------------------------------

def test_dev003_fires_on_module_level_torch_in_the_control_plane(tmp_path):
    bad = _package(tmp_path / "bad", {
        "runtime/cluster.py": '''
            import torch                              # SEEDED


            def sync(dev):
                torch.cuda.synchronize(dev)
        ''',
        "runtime/rpc.py": "from torch import cuda  # SEEDED\n",
        "security/transport.py": "import triton.language as tl  # SEEDED\n",
        # not on the control plane: the device path may import torch
        "runtime/executor.py": "import torch\n",
    })
    fired = _fired(bad, "DEV003")
    assert sorted((v.path, v.symbol) for v in fired) == [
        ("bad/runtime/cluster.py", "import:torch"),
        ("bad/runtime/rpc.py", "import:torch.cuda"),
        ("bad/security/transport.py", "import:triton.language"),
    ]
    good = _package(tmp_path / "good", {
        "runtime/cluster.py": '''
            def sync(dev):
                import torch

                torch.cuda.synchronize(dev)


            class TaskExecutor:
                def __init__(self, device=None):
                    from good.utils.device import resolve_device

                    self.device = resolve_device(device)
        ''',
        "utils/device.py": "import torch\n\n\ndef resolve_device(d):\n    return torch.device(d)\n",
    })
    assert port_lint.run_lint(good).violations == []


# ---------------------------------------------------------------------------
# EXON002: a cached torch program's key covers its device and dtype
# ---------------------------------------------------------------------------

EXON002_BAD = '''
    import functools

    import torch

    _DEVICE = "cuda"


    @functools.lru_cache(maxsize=None)
    def build_ring(K, S):
        # SEEDED: _DEVICE fixes where the program allocates but is not a
        # parameter — the functools cache key cannot see a device flip
        def step(idx):
            return torch.zeros((K, S), dtype=torch.int32, device=_DEVICE).index_add_(0, idx, idx)
        return step


    class BadProgramCache:
        def __init__(self, dtype, index):
            self._dtype = dtype
            self._index = index
            self._cache = {}

        def program(self, K):
            # SEEDED: key omits self._dtype (through _build) and self._index
            key = (K,)
            if key in self._cache:
                return self._cache[key]
            fn = self._cache[key] = self._build(K)
            return fn

        def _build(self, K):
            dt = self._dtype
            with torch.cuda.device(self._index):
                ring = torch.zeros(K)
            return lambda x: (x.to(dt), ring)
'''

EXON002_GOOD = '''
    import functools

    import torch


    @functools.lru_cache(maxsize=None)
    def build_ring_good(K, S, device, agg):
        dev = torch.device("cuda")        # a constant local: no input

        def step(idx, out_device):
            # the built program's own arguments are runtime inputs
            rows = torch.zeros((K, S), dtype=torch.int32, device=out_device)
            return rows.to(idx.device), torch.ones(1, device=dev)
        return step, torch.zeros(1, device=device, dtype=agg.result_dtype)


    class GoodProgramCache:
        def __init__(self, dtype, index):
            self._dtype = dtype
            self._index = index
            self._cache = {}

        def program(self, K):
            key = (K, self._dtype, self._index)
            if key in self._cache:
                return self._cache[key]
            fn = self._cache[key] = self._build(K)
            return fn

        def _build(self, K):
            dt = self._dtype
            with torch.cuda.device(self._index):
                ring = torch.zeros(K)
            return lambda x: (x.to(dt), ring)

        def gather(self, ring, spos, kid):
            # a tensor indexed by a tuple is no memo
            cell = (spos, kid)
            return ring[cell].to(self._dtype)
'''


def test_exon002_fires_on_keys_that_miss_device_or_dtype(tmp_path):
    root = _package(tmp_path / "pkg", {"ops/bad_builder.py": EXON002_BAD,
                                       "ops/good_builder.py": EXON002_GOOD})
    fired = _fired(root, "EXON002")
    assert {v.path for v in fired} == {"pkg/ops/bad_builder.py"}
    by_symbol = {v.symbol: v for v in fired}
    assert sorted(by_symbol) == ["key-incomplete:self._cache", "lru-key-incomplete"]
    assert "_DEVICE" in by_symbol["lru-key-incomplete"].message
    msg = by_symbol["key-incomplete:self._cache"].message
    assert "self._dtype" in msg and "self._index" in msg
    assert by_symbol["key-incomplete:self._cache"].scope == "BadProgramCache.program"


def test_exon002_reads_the_ports_cached_builders():
    """The builders of join_ring, cuda_session, lowering and spmd_step: their
    device and dtype come from their parameters or from the built program's
    own arguments, and `_prepare`'s device guard is keyed on its index."""
    from flink_tpu_torch.lint.dataflow import DataflowIndex

    index = ModuleIndex(ROOT / "flink_tpu_torch")
    dfi = DataflowIndex.shared(index)
    fns = {}
    for rel in ("ops/join_ring.py", "ops/cuda_session.py", "planner/lowering.py",
                "parallel/spmd_step.py"):
        for fs in dfi.module(index.get(rel)).functions.values():
            if fs.has_lru_cache:
                fns[f"{rel}::{fs.name}"] = fs.option_inputs
    assert {"ops/join_ring.py::build_join_ingest", "ops/join_ring.py::build_join_match",
            "ops/cuda_session.py::k3_plan", "planner/lowering.py::_columnarizer",
            "parallel/spmd_step.py::make_spmd_step"} <= set(fns)
    assert fns["ops/cuda_session.py::_prepare"] == {"index"}
    assert fns["parallel/spmd_step.py::make_spmd_step"] == {"agg.result_dtype"}
    assert list(port_lint.get_rule("EXON002").check(index)) == []


# ---------------------------------------------------------------------------
# baseline and CLI
# ---------------------------------------------------------------------------

def _entry(rule, path, scope, symbol, justification):
    return {"rule": rule, "path": path, "scope": scope, "symbol": symbol, "line": 0,
            "justification": justification}


def _write_baseline(path, entries):
    path.write_text(json.dumps({"version": 1, "entries": entries}))
    return path


def _run(main, argv):
    out = io.StringIO()
    err = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_the_baseline_refuses_todo_justifications(tmp_path):
    import shutil

    # the baseline beside the package: its paths are relative to that
    # directory (entries naming a missing file are pruned on load)
    corpus = shutil.copytree(CORPUS / "conc003", tmp_path / "conc003")
    report = port_lint.run_lint(corpus)
    (v,) = report.violations
    todo = _write_baseline(tmp_path / "b.json", [_entry(
        v.rule_id, v.path, v.scope, v.symbol, "TODO: justify or fix")])
    rc, _out, _err = _run(port_cli.main, [str(corpus), "--baseline", str(todo)])
    assert rc == 2
    bl = port_lint.Baseline.load(todo)
    again = port_lint.run_lint(corpus, baseline=bl)
    assert again.violations == [] and again.exit_code == 2
    assert "no written justification" in again.baseline_errors[0]
    ok = _write_baseline(tmp_path / "ok.json", [_entry(
        v.rule_id, v.path, v.scope, v.symbol, "the corpus seeds it")])
    assert _run(port_cli.main, [str(corpus), "--baseline", str(ok)])[0] == 0


def test_the_baseline_prunes_entries_that_cannot_match(tmp_path):
    import shutil

    corpus = shutil.copytree(CORPUS / "conc003", tmp_path / "conc003")
    (v,) = port_lint.run_lint(corpus).violations
    # the default baseline sits beside the package; its paths are relative
    # to that directory
    path = _write_baseline(tmp_path / "lint_baseline_torch.json", [
        _entry(v.rule_id, v.path, v.scope, v.symbol, "seeded"),
        _entry("CONC003", "conc003/gone.py", "X.y", "s", "a deleted file"),
        _entry("JIT001", v.path, "X.y", "s", "a retired rule"),
    ])
    rc, _out, err = _run(port_cli.main, [str(corpus), "--prune-baseline"])
    assert rc == 0, err
    assert "pruned stale entry CONC003::conc003/gone.py" in err
    assert "pruned stale entry JIT001" in err
    kept = json.loads(path.read_text())["entries"]
    assert [(e["rule"], e["path"]) for e in kept] == [(v.rule_id, v.path)]
    # fixed debt (a fingerprint no rule reports) is an engine error
    stale = port_lint.Baseline([port_lint.BaselineEntry(
        "CONC003", v.path, "Gone.scope", "s", "fixed since")])
    report = port_lint.run_lint(corpus, baseline=stale)
    assert report.exit_code == 2 and "stale baseline entry" in report.baseline_errors[0]


def test_write_baseline_seeds_todo_entries_the_engine_refuses(tmp_path):
    import shutil

    corpus = shutil.copytree(CORPUS / "wire002", tmp_path / "wire002")
    path = tmp_path / "seeded.json"
    rc, out, _err = _run(port_cli.main, [str(corpus), "--baseline", str(path),
                                         "--write-baseline"])
    assert rc == 0 and "wrote 2 new entries" in out
    assert all(e["justification"].startswith("TODO")
               for e in json.loads(path.read_text())["entries"])
    assert _run(port_cli.main, [str(corpus), "--baseline", str(path)])[0] == 2
    assert _run(port_cli.main, [str(corpus), "--no-baseline", "--write-baseline"])[0] == 2


def test_the_cli_exit_codes_and_catalog():
    rc, out, _err = _run(port_cli.main, ["--list-rules"])
    assert rc == 0 and len(out.splitlines()) == 16 and "DEV001  host-sync-in-dispatch" in out
    assert _run(port_cli.main, [str(CORPUS / "conc001"), "--no-baseline"])[0] == 1
    assert _run(port_cli.main, [str(CORPUS / "conc001"), "--rule", "NOPE1"])[0] == 2
    assert _run(port_cli.main, [str(CORPUS / "nowhere")])[0] == 2
    rc, out, _err = _run(port_cli.main, [])       # the port, its baseline
    assert rc == 0 and out.strip().endswith("16 rules: 0 violations, 9 baselined")
    rc, out, _err = _run(port_cli.main, ["--rule", "DEV001", "--rule",
                                            "executable-cache-key-completeness"])
    assert rc == 0 and "2 rules: 0 violations, 7 baselined" in out


_NAMES = (("flink_tpu_torch", "flink_tpu"), ("flink-tpu-torch-lint", "flink-tpu-lint"),
          ("configuration_torch.md", "configuration.md"),
          ("lint_baseline_torch.json", "lint_baseline.json"))


def _as_jax(text):
    for port, jax in _NAMES:
        text = text.replace(port, jax)
    return text


@pytest.mark.parametrize("fmt", ["text", "json", "sarif"])
@pytest.mark.parametrize("package", ["conc002", "doc001", "exon001", "wire001"])
def test_the_three_formats_equal_the_jax_clis(package, fmt):
    argv = [str(CORPUS / package), "--no-baseline", "--format", fmt]
    for rid in PARITY_RULES:
        argv += ["--rule", rid]
    jax_rc, jax_out, _e = _run(jax_cli.main, argv)
    port_rc, port_out, _e = _run(port_cli.main, argv)
    assert port_rc == jax_rc == 1
    if fmt == "sarif":
        port_doc, jax_doc = json.loads(_as_jax(port_out)), json.loads(jax_out)
        # the rationales are worded for each package's device (ARCH001's
        # import cost, DOC001's reference); everything else is equal
        for doc in (port_doc, jax_doc):
            (component,) = doc["runs"][0]["tool"].values()
            for meta in component["rules"]:
                assert meta.pop("fullDescription")["text"]
        assert port_doc == jax_doc
    else:
        assert _as_jax(port_out) == jax_out
    if fmt != "text":
        json.loads(port_out)


def test_importing_and_running_the_analyzer_loads_no_torch_jax_or_flink_tpu():
    code = textwrap.dedent("""
        import contextlib, io, sys
        from flink_tpu_torch.lint.cli import main
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = main(["--format", "json"])
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("torch", "jax", "jaxlib", "flink_tpu", "triton"))
        print(rc, loaded)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "0 []"
