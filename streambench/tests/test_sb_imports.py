"""Nothing under streambench/ imports JAX, Flax or the JAX package, top-level
names compared whole (`flink_tpu_torch` is not `flink_tpu`); the references
import nothing of the port; and the run's own guard."""

import ast
from pathlib import Path

import pytest

from streambench.core.guard import FORBIDDEN, forbidden_loaded

BENCH = Path(__file__).resolve().parents[1]


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert "flink_tpu_torch" not in set(imported_tops(path))


def test_the_guard_compares_top_level_names_whole():
    assert forbidden_loaded(["flink_tpu_torch", "flink_tpu_torch.ops", "jaxtyping"]) == []
    assert forbidden_loaded(["flink_tpu.ops.x", "jax", "jaxlib.xla", "flax.linen", "numpy"]) == [
        "flax.linen", "flink_tpu.ops.x", "jax", "jaxlib.xla"]


def test_the_harness_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); from streambench.core import runner; "
            "from streambench.core.guard import forbidden_loaded; import streambench.core.trace; "
            "import flink_tpu_torch.api.datastream; print(forbidden_loaded())" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
