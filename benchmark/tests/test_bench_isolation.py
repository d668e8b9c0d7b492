"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names are
compared whole (the port's name begins with the JAX package's)."""

import ast
import sys
import types
from pathlib import Path

import pytest

from benchmark import harness

BENCH = harness.ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "gdpathtracing_tpu"}
# The reference: its package and the configurations' plain descriptions.
REFERENCE = [*(BENCH / "reference").glob("*.py"),
             *(BENCH / "configs").glob("*.py")]


def imported_top_levels(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _builders() -> set[str]:
    import json
    out = set()
    for p in (BENCH / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        for k in ("scene", "camera"):
            out.add(c[k]["builder"].split(":")[0].split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported_top_levels(path) & FORBIDDEN


def test_builders_are_the_port():
    assert _builders() == {"gdpathtracing_torch"}


@pytest.mark.parametrize("path", sorted(REFERENCE),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    names = imported_top_levels(path)
    assert not names & (FORBIDDEN | {"gdpathtracing_torch"})
    assert names <= {"__future__", "math", "typing", "pathlib", "numpy",
                     "torch", "benchmark"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "benchmark"):
            assert node.module.startswith("benchmark.reference")


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gdpathtracing_tpux",
                        types.ModuleType("gdpathtracing_tpux"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like",
                        types.ModuleType("jaxtyping_like"))
    base = set(harness.forbidden_modules())
    assert not base & {"gdpathtracing_tpux", "jaxtyping_like"}
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "gdpathtracing_tpu.ops",
                        types.ModuleType("gdpathtracing_tpu.ops"))
    found = set(harness.forbidden_modules()) - base
    assert found == {"jax.numpy", "gdpathtracing_tpu.ops"}
