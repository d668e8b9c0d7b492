"""The cell ``grid.interactive`` on the card: a short untraced run of the
benchmark's own command exits 0 with a correct result on the GPU."""

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.cuda
def test_grid_cell_on_the_card(card):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "grid.interactive", "--seed", "2147484127",
                        "--seconds", "3", "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
