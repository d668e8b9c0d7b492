"""The controls of the check, at a cell's own size: the readings that set
the upper end of each limit in ``benchmark/limits/``.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

puts the reference computed with its path state in bfloat16 (the nearest
precision below the float32 the configurations state) in the program's
place and prints, per seed, the numbers the check compares; for an
``inverse`` cell also the faults of a training step that need a run: half
of the pixels left out of the loss (the mean over the rest), and one
pixel's radiance altered where it is produced. (A step that returns its
state unchanged reads 1 on ``update_gap`` by its definition.) Runs on the
card; ``--device cpu --size W H`` for a rehearsal. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":  # the package, not this file's folder
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import check, harness  # noqa: E402
from benchmark.reference import render as ref_render  # noqa: E402
from benchmark.reference.transport import display  # noqa: E402
from benchmark.traffic import InverseLoop  # noqa: E402


def engine_control(ref, seed: int, frames: int = 3) -> dict:
    """px_mismatch of the control over ``frames`` frames from the seed's
    first frame, each judged as a first step from a reset state."""
    f0 = int(np.random.default_rng([seed, 0]).integers(0, 1 << 20))
    bad = []
    for f in range(f0, f0 + frames):
        good, _ = ref_render.render(ref, f)
        ctl, _ = ref_render.render(ref, f, lowp=True)
        zero = torch.zeros_like(ctl)
        bad.append(check.pixel_mismatch(zero, ctl, display(ctl, 1), good,
                                        1).flatten())
    return {"px_mismatch": float(torch.cat(bad).float().mean())}


def _half(x, t):
    return x[0::2], t[0::2]


def _altered(x, t):
    x = x.clone()
    x[x.shape[0] // 2, x.shape[1] // 2] = x[x.shape[0] // 2,
                                            x.shape[1] // 2] + 1.0
    return x, t


def inverse_control(ref, cell, seed: int, desc) -> dict:
    loop = InverseLoop(None, cell.traffic, seed, {"albedo": desc.albedo()})
    dev = ref.camera.transform.device
    a0 = torch.as_tensor(loop.albedo0, device=dev)
    target, _ = ref_render.render(ref, loop.target_frame, albedo=torch.
                                  as_tensor(loop.albedo_target, device=dev))
    frames = [loop.first_frame + k for k in range(loop.n_checked)]
    good = ref_render.inverse_steps(ref, a0, target, frames, loop.lr)
    out = {}
    for name, kw in (("control", {"lowp": True}),
                     ("half_batch", {"pixels": _half}),
                     ("altered_answer", {"pixels": _altered})):
        losses, g1, p, _ = ref_render.inverse_steps(ref, a0, target, frames,
                                                    loop.lr, **kw)
        out[name] = {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, good[0])),
            "grad_gap": check.leaf_gap(g1, good[1], good[1]),
            "update_gap": check.leaf_gap(p - a0, good[2] - a0, good[1])}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", type=int, nargs=2, default=None)
    args = p.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    w, h = args.size or (None, None)
    desc, prepare = harness.reference_scene(cell, dev, w, h)
    ref = prepare()
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cell.traffic["loop"] == "engine":
            out = {"control": engine_control(ref, seed)}
        else:
            out = inverse_control(ref, cell, seed, desc)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
