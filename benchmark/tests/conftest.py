"""Shared fixtures of the benchmark's tests: they run on the CPU at small
sizes; tests marked ``cuda`` need a card and skip without one."""

import json
import time

import pytest
import torch

from benchmark import harness

# The grid's configuration and limits are kept for a later cell
# (PERF.md §7); its tests run it from a root whose BENCHMARK.json has it.
GRID = {"name": "grid.interactive", "config": "grid", "traffic": "interactive",
        "chips": 1, "why": "a test"}


@pytest.fixture
def grid_root(tmp_path):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(GRID)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "demo.interactive" in m.get("workloads", []):
            m["workloads"].append(GRID["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark").symlink_to(harness.ROOT / "benchmark")
    return tmp_path


@pytest.fixture
def run_small():
    """Run a cell of BENCHMARK.json on the CPU at 16 x 12 for 0.3 s:
    ``run_small(cell, seed, traced=False, root=None)`` -> the result."""
    def run(name, seed=7, traced=False, root=harness.ROOT):
        cell = harness.load_cell(name, root)
        return harness.run_cell(cell, seed, 0.3, traced, torch.device("cpu"),
                                time.perf_counter(), width=16, height=12)
    return run


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided in the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)
