"""The cell ``demo.bvh`` on the card: a short traced run of the
benchmark's own command exits 0 with a correct result on the GPU and
reports every per-layer metric the cell lists, the BVH kernel's time above
0 and every lane of five 1080p bounces a frame handed to it."""

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.cuda
def test_demo_bvh_cell_on_the_card(card):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "demo.bvh", "--seed", "2147484269",
                        "--seconds", "3", "--trace", "1"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    listed = harness.load_cell("demo.bvh").per_layer
    assert set(listed) <= set(out["metrics"])
    assert out["metrics"]["bvh_kernel_ms.frame"]["value"] > 0
    assert out["metrics"]["bvh_lanes.frame"]["value"] == \
        pytest.approx(5 * 1920 * 1080 / 1e6, rel=1e-12)
