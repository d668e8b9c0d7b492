"""The benchmark of gdpathtracing_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json: set-up (the program's kernels loaded from
its build directory, the scene built on the card, one warm step), then the
cell's loop for ``--seconds`` (with ``--trace 1`` under the profiler, for
at most the traffic's ``trace_steps`` steps), then the check of the
window's outputs against the plain reference. The last line of standard
output is the result, as JSON; the numbers compared and their limits are
also the last lines of standard error. Without a card it exits with 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """perf_counter() at this process's start (Linux), or now."""
    now = time.perf_counter()
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return now - max(0.0, uptime - start)
    except (OSError, ValueError, IndexError):
        return now


def main() -> int:
    t_start = _process_start()
    root = Path(__file__).resolve().parents[1]
    cache = root / "benchmark" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[0] = str(root)  # the package, not this file's folder
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    import torch

    from benchmark import harness
    cell = harness.load_cell(args.workload, root)
    chips = cell.entry["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    try:
        import gdpathtracing_torch  # noqa: F401
    except ImportError as err:
        print(f"the program is not here: {err}", file=sys.stderr)
        return 3
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t_start)
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
