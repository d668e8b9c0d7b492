"""The comparisons that decide ``correct``: each number the program's
outputs give against the plain reference's, and its limit.

A cell's limits are ``benchmark/limits/<cell>.json``: ``{number: limit}``.
A number is correct when it is finite and at most its limit.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from benchmark.reference.transport import display

# A pixel of a checked frame agrees when the radiance the program added
# to its accumulator is the reference's to these tolerances (a hundredth
# of the bfloat16 step, plus two ulps of the accumulator for the rounding
# of the sum), and its display value to ``DISPLAY_TOL``.
RAD_REL = 1e-4
RAD_ABS = 1e-6
DISPLAY_TOL = 1e-5


def limits(bdir: Path, cell: str) -> dict:
    """The limits of ``cell`` in the benchmark folder ``bdir``."""
    return json.loads((bdir / "limits" / f"{cell}.json").read_text())


def pixel_mismatch(prev: torch.Tensor, cur: torch.Tensor, out: torch.Tensor,
                   radiance: torch.Tensor, count: int) -> torch.Tensor:
    """(H, W) bool: pixels of one progressive step that disagree with the
    reference. ``prev``/``cur``: the accumulator before and after the step
    (the program's), ``out`` the display image the step returned,
    ``radiance`` the reference's frame, ``count`` the frames accumulated.
    NaN disagrees."""
    acc = prev + radiance
    q_prog, q_ref = cur - prev, acc - prev
    ulp = torch.nextafter(cur.abs(), torch.full_like(cur, torch.inf)) \
        - cur.abs()
    tol = RAD_REL * q_ref.abs() + 2.0 * ulp + RAD_ABS
    ok = ((q_prog - q_ref).abs() <= tol) & \
        ((out - display(acc, count)).abs() <= DISPLAY_TOL)
    return ~ok.all(dim=-1)


def leaf_gap(prog: torch.Tensor, ref: torch.Tensor,
             ref_grad: torch.Tensor) -> float:
    """The worst leaf's gap of norms: a leaf is a row of the (M, 3) albedo
    table (one material); the gap of the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone, and are left
    out."""
    gn = ref_grad.norm(dim=1)
    keep = gn >= 1e-3 * gn.median()
    pn, rn = prog.norm(dim=1)[keep], ref.norm(dim=1)[keep]
    scale = torch.clamp(rn, min=float(rn.median()))
    gap = (pn - rn).abs() / scale
    return float(gap.max()) if gap.numel() else float("nan")


def judge(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """(every number within its limit, {number: {value, limit}})."""
    out, ok = {}, True
    for name, limit in lim.items():
        value = float(numbers.get(name, float("nan")))
        out[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
    return ok, out
