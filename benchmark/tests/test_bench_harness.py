"""The harness: found by name, its arithmetic, its result line."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness, trace

ROOT = harness.ROOT
CELLS = ("demo.interactive", "demo.inverse")


def _tree_hashes(root: Path) -> dict:
    files = [root / "BENCHMARK.json", *(root / "benchmark").rglob("*")]
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in files if p.is_file() and "__pycache__" not in p.parts
            and ".cache" not in p.parts}


def test_added_files_are_found_by_name(tmp_path, run_small):
    """A configuration, a traffic mix, a per-layer metric and a kernel
    symbol added as files of their own, with entries in BENCHMARK.json,
    run as a new cell with no file that was there edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _tree_hashes(tmp_path)
    b = tmp_path / "benchmark"
    conf = json.loads((b / "configs" / "demo.json").read_text())
    conf["camera"]["args"]["fov_deg"] = 79.5
    (b / "configs" / "demo_copy.json").write_text(json.dumps(conf))
    traffic = json.loads((b / "traffic" / "interactive.json").read_text())
    traffic["sampled_steps"] = 1
    (b / "traffic" / "viewer_one.json").write_text(json.dumps(traffic))
    (b / "metrics" / "steps_seen.frame.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    (b / "kernels" / "new_walk_kernel.json").write_text(
        json.dumps({"symbol": "new_walk_kernel", "source": "x.cu",
                    "traces": "a test"}))
    (b / "limits" / "demo_copy.viewer_one.json").write_text(
        (b / "limits" / "demo.interactive.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="demo_copy",
                                 file="benchmark/configs/demo_copy.json"))
    bench["workloads"].append({"name": "demo_copy.viewer_one",
                               "config": "demo_copy",
                               "traffic": "viewer_one", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "steps_seen.frame", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "frame_ms",
                               "workloads": ["demo_copy.viewer_one"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "frame_ms" in m["name"]:
            m["workloads"].append("demo_copy.viewer_one")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = run_small("demo_copy.viewer_one", traced=True, root=tmp_path)
    assert out["correct"]
    assert out["metrics"]["steps_seen.frame"]["value"] >= 1
    assert "new_walk_kernel" in trace.tracing_symbols(b / "kernels")
    after = _tree_hashes(tmp_path)
    assert {k: after[k] for k in before if k.name != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k.name != "BENCHMARK.json"}


def test_busy_is_the_union_of_device_intervals():
    events = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0),
              ("d", 3.2, 3.5), ("e", 6.0, 6.5)]
    assert trace.busy_seconds(events) == pytest.approx(3.5)
    gaps = trace.idle_gaps(events)
    assert [g[1] for g in gaps] == pytest.approx([2.0, 1.0])
    assert gaps[0][0] == "after c | before e"
    assert trace.top_ops(events)[0] == ["b", 1.5]


def test_idle_share_and_launch_readers():
    bdir = ROOT / "benchmark" / "metrics"
    ctx = {"events": [("a", 0.0, 1.0), ("b", 0.5, 2.0)], "busy_s": 2.0,
           "window_s": 8.0, "steps": 4}
    idle = harness.load_module(bdir / "idle_share.frame.py")
    launches = harness.load_module(bdir / "launches.step.py")
    assert idle.read(ctx) == pytest.approx(75.0)
    assert launches.read(ctx) == pytest.approx(0.5)
    assert idle.read(dict(ctx, events=[])) is None


def test_roofline_reads_nothing_without_its_kernels():
    reader = harness.load_module(ROOT / "benchmark" / "metrics"
                                 / "trace_roofline.frame.py")
    ctx = {"events": [("soft_occlusion_kernel(float)", 0.0, 2e-3),
                      ("closest_hit_rows_kernel(float)", 0.0, 1e-3)],
           "kernels": ["closest_hit_rows_kernel"], "ref_least_s": 1e-5,
           "steps": 2}
    assert reader.read(ctx) == pytest.approx(2.0)
    assert reader.read(dict(ctx, kernels=["occlusion_kernel"])) is None


def test_window_metrics_take_every_step():
    times = [0.1] * 95 + [0.5] * 5
    m = harness.end_to_end(times, 15.0, 3.0)
    assert m["frame_ms"] == pytest.approx(150.0)
    assert m["frame_ms_p95"] == pytest.approx(100.0)
    assert harness.end_to_end(times + [0.5], 15.5, 3.0)["frame_ms_p95"] == \
        pytest.approx(500.0)
    assert m["setup_s"] == 3.0


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(run_small, traced):
    out = run_small("demo.interactive", traced=traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(out["device"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    if traced:
        assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
        assert len(out["breakdown"]["device_ops"]) <= 10
        assert len(out["breakdown"]["idle_gaps"]) <= 10
        assert "launches.frame" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"frame_ms", "frame_ms_p95",
                                       "setup_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_benchmark_json_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert [w["name"] for w in bench["workloads"]] == list(CELLS)
    assert all(w["chips"] == 1 for w in bench["workloads"])
    names = {m["name"] for m in bench["end_to_end"]}
    assert names == {"frame_ms", "frame_ms_p95", "step_ms", "setup_s"}
    for m in bench["per_layer"]:
        assert m["moves"] in names and m["workloads"]
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for w in bench["workloads"]:
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()


def test_no_card_no_result():
    """Without a card the command fails and prints no result."""
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "demo.interactive", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    if r.returncode == 0:
        pytest.skip("a card is present")
    assert r.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        name, "--seed", "5", "--seconds", "3", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
