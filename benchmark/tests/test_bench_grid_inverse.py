"""The cell ``grid.inverse`` on the card: a short traced run of the
benchmark's own command exits 0 with a correct result on the GPU and
reports every per-layer metric the cell lists, the two epilogues' spans
above 0."""

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.cuda
def test_grid_inverse_cell_on_the_card(card):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "grid.inverse", "--seed", "2147484191",
                        "--seconds", "3", "--trace", "1"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    listed = harness.load_cell("grid.inverse").per_layer
    assert set(listed) <= set(out["metrics"])
    for name in ("epilogue_ms.step", "recompute_ms.step"):
        assert out["metrics"][name]["value"] > 0
