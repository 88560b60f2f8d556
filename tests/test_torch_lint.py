"""The port's analyzer (`flink_tpu_torch.lint`) against the JAX package's.

The twelve rules that do not depend on jax (CONC001-005, ARCH001-002,
DOC001, WIRE001-002, EXON001, EXON003) are copies: over the seeded corpus,
over `flink_tpu/` and over `flink_tpu_torch/` they must report exactly
the JAX analyzer's (rule, path, line, scope, symbol) list. DOC001 reads
each package's own config reference (`docs/configuration.md` for the JAX
package, `docs/configuration_torch.md` for the port), so for the package
parities the port's rule is pointed at the JAX package's document.

Then the whole port tree: sixteen rules under the JAX ids, no active
violation against `lint_baseline_torch.json`, and the three faults the
port's lint found fixed (the failover boundary's contract, the torch-free
control plane, the committed config reference).
"""

import pathlib
import subprocess
import sys
import textwrap

import pytest

import flink_tpu.lint as jax_lint
import flink_tpu_torch
import flink_tpu_torch.lint as port_lint
from flink_tpu_torch.lint import contracts
from flink_tpu_torch.lint.rules_architecture import ConfigDocsCompleteRule
from flink_tpu_torch.lint.rules_device import CONTROL_PLANE

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "flink_tpu"
PORT_PKG = pathlib.Path(flink_tpu_torch.__file__).parent
CORPUS = ROOT / "tests" / "lint_corpus"
BASELINE = ROOT / "lint_baseline_torch.json"

#: the rules the port copies unchanged (imports and package names aside)
PARITY_RULES = ("ARCH001", "ARCH002", "CONC001", "CONC002", "CONC003", "CONC004",
                "CONC005", "DOC001", "EXON001", "EXON003", "WIRE001", "WIRE002")
#: the rules rewritten for torch and CUDA
REWRITTEN_RULES = ("DEV001", "DEV002", "DEV003", "EXON002")
CORPUS_PACKAGES = sorted(p.name for p in CORPUS.iterdir() if p.is_dir())


def _key(v):
    return (v.rule_id, v.path, v.line, v.scope, v.symbol)


@pytest.fixture(scope="module")
def jax_index_of_jax():
    return jax_lint.ModuleIndex(JAX_PKG)


@pytest.fixture(scope="module")
def port_index_of_jax():
    return port_lint.ModuleIndex(JAX_PKG)


@pytest.fixture(scope="module")
def jax_index_of_port():
    return jax_lint.ModuleIndex(PORT_PKG)


@pytest.fixture(scope="module")
def port_index_of_port():
    return port_lint.ModuleIndex(PORT_PKG)


@pytest.fixture
def port_doc001_reads_the_jax_doc(monkeypatch):
    monkeypatch.setattr(ConfigDocsCompleteRule, "doc", "docs/configuration.md")


def test_registry_holds_the_jax_ids():
    port_ids = [r.id for r in port_lint.all_rules()]
    assert port_ids == [r.id for r in jax_lint.all_rules()]
    assert len(port_ids) == 16
    assert sorted(PARITY_RULES + REWRITTEN_RULES) == port_ids
    # the ids are the labels; the rewritten device rules take torch names
    names = {r.id: r.name for r in port_lint.all_rules()}
    assert names["DEV001"] == "host-sync-in-dispatch"
    assert names["DEV002"] == "build-in-loop"
    assert names["DEV003"] == "torch-free-control-plane"
    jax_names = {r.id: r.name for r in jax_lint.all_rules()}
    assert all(names[rid] == jax_names[rid] for rid in PARITY_RULES)


@pytest.mark.parametrize("package", CORPUS_PACKAGES)
def test_parity_rules_match_the_jax_analyzer_on_the_corpus(package):
    jax_report = jax_lint.run_lint(
        CORPUS / package, rules=[jax_lint.get_rule(r) for r in PARITY_RULES])
    port_report = port_lint.run_lint(
        CORPUS / package, rules=[port_lint.get_rule(r) for r in PARITY_RULES])
    assert sorted(map(_key, port_report.violations)) == \
        sorted(map(_key, jax_report.violations))
    assert port_report.modules_scanned == jax_report.modules_scanned
    if package.upper() in PARITY_RULES:
        assert port_report.by_rule(package.upper()), "the seeded defect must fire"


@pytest.mark.parametrize("rule_id", PARITY_RULES)
def test_parity_rules_match_the_jax_analyzer_on_flink_tpu(
        rule_id, jax_index_of_jax, port_index_of_jax, port_doc001_reads_the_jax_doc):
    jax_found = sorted(map(_key, jax_lint.get_rule(rule_id).check(jax_index_of_jax)))
    port_found = sorted(map(_key, port_lint.get_rule(rule_id).check(port_index_of_jax)))
    assert port_found == jax_found
    if rule_id == "CONC003":
        # the JAX package's one baselined finding, found by both
        assert [k[:2] for k in port_found] == [("CONC003", "flink_tpu/runtime/rpc.py")]


@pytest.mark.parametrize("rule_id", PARITY_RULES)
def test_parity_rules_match_the_jax_analyzer_on_the_port(
        rule_id, jax_index_of_port, port_index_of_port, port_doc001_reads_the_jax_doc):
    """Before the fixes the JAX analyzer found EXON003 twice at the port's
    failover boundary (`MiniCluster._run_attempts`); now both analyzers
    find only the CONC003 the JAX package baselines too."""
    jax_found = sorted(map(_key, jax_lint.get_rule(rule_id).check(jax_index_of_port)))
    port_found = sorted(map(_key, port_lint.get_rule(rule_id).check(port_index_of_port)))
    assert port_found == jax_found
    want = ([("CONC003", "flink_tpu_torch/runtime/rpc.py", "RpcGateway._connect",
              "socket.create_connection@_connect")] if rule_id == "CONC003" else [])
    assert [(k[0], k[1], k[3], k[4]) for k in port_found] == want


@pytest.mark.parametrize("rule_id", PARITY_RULES + REWRITTEN_RULES)
def test_the_port_tree_has_no_active_violation(rule_id, port_index_of_port):
    baseline = port_lint.Baseline.load(BASELINE)
    found = list(port_lint.get_rule(rule_id).check(port_index_of_port))
    active = [v.render() for v in found if baseline.match(v) is None]
    assert not active, "\n".join(active)
    assert len(baseline) == 9


def test_the_whole_run_is_clean_against_the_baseline(port_index_of_port):
    """Every baseline entry is in use: the CONC003 the JAX package baselines
    too, with its justification, and the eight DEV001/DEV002 findings on
    host values (`test_torch_lint_rules.py`)."""
    baseline = port_lint.Baseline.load(BASELINE)
    report = port_lint.run_lint(PORT_PKG, baseline=baseline, index=port_index_of_port)
    assert len(report.rules) == 16
    assert report.violations == [] and report.baseline_errors == []
    assert report.exit_code == 0
    entries = {e.rule: [] for _v, e in report.suppressed}
    for _v, e in report.suppressed:
        entries[e.rule].append(e)
    assert {r: len(es) for r, es in entries.items()} == {"CONC003": 1, "DEV001": 7,
                                                         "DEV002": 1}
    (entry,) = entries["CONC003"]
    assert (entry.path, entry.scope) == ("flink_tpu_torch/runtime/rpc.py",
                                         "RpcGateway._connect")
    assert all(e.justified for _v, e in report.suppressed)
    assert entry.justification == \
        jax_lint.Baseline.load(ROOT / "lint_baseline.json").entries[0].justification
    assert report.modules_scanned == len(list(PORT_PKG.rglob("*.py")))


# ---------------------------------------------------------------------------
# the three faults the lint found in the port, fixed
# ---------------------------------------------------------------------------

def _jax_absorbs_reason(rel, cls_name, method):
    import ast

    tree = ast.parse((JAX_PKG / rel).read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls_name)
    fn = next(n for n in cls.body if getattr(n, "name", None) == method)
    return contracts.absorbs_reason(fn)


def test_the_failover_boundary_carries_the_jax_packages_contract():
    from flink_tpu_torch.runtime.minicluster import MiniCluster

    reason = _jax_absorbs_reason("runtime/minicluster.py", "MiniCluster", "_run_job_inner")
    assert reason and reason.startswith("driver failover boundary")
    assert getattr(MiniCluster._run_attempts, contracts.ABSORBS_ATTR) == reason


def test_exon003_finds_nothing_at_the_failover_boundary(port_index_of_port, tmp_path):
    assert list(port_lint.get_rule("EXON003").check(port_index_of_port)) == []
    # the contract is what silences it: in a copy of the port without the
    # decorator the attempt loop's two broad handlers fire again
    import shutil

    copy = tmp_path / "flink_tpu_torch"
    shutil.copytree(PORT_PKG, copy, ignore=shutil.ignore_patterns("__pycache__"))
    mc = copy / "runtime" / "minicluster.py"
    src = mc.read_text()
    line = next(ln for ln in src.splitlines(keepends=True)
                if ln.lstrip().startswith("@absorbs_faults('driver failover boundary"))
    mc.write_text(src.replace(line, "", 1))
    found = list(port_lint.get_rule("EXON003").check(port_lint.ModuleIndex(copy)))
    assert [(v.path, v.scope) for v in found] == \
        [("flink_tpu_torch/runtime/minicluster.py", "MiniCluster._run_attempts")] * 2


_IMPORT_PROBE = textwrap.dedent("""
    import importlib, sys
    importlib.import_module(sys.argv[1])
    print(sys.argv[2] in sys.modules)
""")


def _loads(module, heavy):
    return subprocess.Popen([sys.executable, "-c", _IMPORT_PROBE, module, heavy], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_the_control_plane_loads_torch_only_where_the_jax_one_loads_jax():
    """For each module of the JAX DEV003's control plane whose import loads
    no jax, the port's twin loads no torch (`runtime/cluster.py` imported
    torch at module level, for one synchronize and `resolve_device`).
    `runtime/rest.py` loads both in both packages (the MiniCluster)."""
    assert CONTROL_PLANE == __import__(
        "flink_tpu.lint.rules_device", fromlist=["CONTROL_PLANE"]).CONTROL_PLANE
    procs = {}
    for rel in CONTROL_PLANE:
        dotted = rel[:-3].replace("/", ".")
        procs[rel] = (_loads(f"flink_tpu.{dotted}", "jax"),
                      _loads(f"flink_tpu_torch.{dotted}", "torch"))
    loads = {}
    for rel, (jax_proc, port_proc) in procs.items():
        outs = []
        for proc in (jax_proc, port_proc):
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err
            outs.append(out.strip() == "True")
        loads[rel] = tuple(outs)
    jax_free = [rel for rel, (jax_loaded, _t) in loads.items() if not jax_loaded]
    assert "runtime/cluster.py" in jax_free and len(jax_free) == 11, loads
    assert [rel for rel in jax_free if loads[rel][1]] == [], loads
    assert loads["runtime/rest.py"] == (True, True)


def test_the_cluster_imports_torch_inside_the_functions_that_run_on_the_device():
    from flink_tpu_torch.lint.index import ModuleIndex

    index = ModuleIndex(PORT_PKG)
    mod = index.get("runtime/cluster.py")
    top = [name for name, _line in index.module_level_imports(mod)]
    assert not [n for n in top if n == "torch" or n.startswith("torch.")]
    assert "flink_tpu_torch.utils.device.resolve_device" not in top
    every = [name for name, _line in index.all_imports(mod)]
    assert "torch" in every and "flink_tpu_torch.utils.device.resolve_device" in every


def test_the_committed_config_reference_is_the_generators_output(tmp_path):
    from flink_tpu_torch.docs.generate import collect_options, main

    out = tmp_path / "configuration_torch.md"
    main([str(out)])
    committed = ROOT / "docs" / "configuration_torch.md"
    assert out.read_bytes() == committed.read_bytes()
    text = committed.read_text()
    assert all(f"`{opt.key}`" in text for _c, _a, opt in collect_options())
