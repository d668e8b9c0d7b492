"""Reading the device trace of a traced window, and the yardstick of the
roofline: the card's peaks and the least time the traced work needs.

The device trace is torch.profiler's, device activity only: every kernel,
copy and fill the card ran, as (name, start, end) in seconds.
"""

from __future__ import annotations

import json
import re
import subprocess
from pathlib import Path

# One NVIDIA H100 SXM (data sheet, dense, at its 700 W limit).
PEAK_FP32 = 67e12        # FLOP/s in float32 outside the tensor cores
PEAK_BYTES = 3.35e12     # bytes/s of HBM3
# The work of a ray: a slab test against a box and a ray-triangle test
# (the affine map to the triangle's unit space), in float32 operations.
OPS_PER_BOX = 25
OPS_PER_TRI = 45
# Bytes a traced ray needs moved once: origin and direction in, t, the
# triangle and two barycentrics out; a triangle's unit-space rows once.
BYTES_PER_RAY = 24 + 16
BYTES_PER_TRI = 48


def device_events(prof, device_type) -> list[tuple[str, float, float]]:
    return [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            for e in prof.events() if e.device_type == device_type]


def union(events) -> list[tuple[float, float, str, str]]:
    """The busy intervals: the union of the events' intervals, each with
    the names of its first and last event."""
    out = []
    for name, a, b in sorted(events, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b, out[-1][2], name)
        else:
            out.append((a, b, name, name))
    return out


def busy_seconds(events) -> float:
    return sum(b - a for a, b, _, _ in union(events))


def idle_gaps(events, top: int = 10) -> list[list]:
    """The longest gaps between busy intervals, each named by the device
    operations on either side of it (what the host launched last before
    the card went idle, and first after)."""
    u = union(events)
    gaps = [[f"after {p[3][:80]} | before {q[2][:80]}", q[0] - p[1]]
            for p, q in zip(u, u[1:])]
    return sorted(gaps, key=lambda g: -g[1])[:top]


def top_ops(events, top: int = 10) -> list[list]:
    by = {}
    for name, a, b in events:
        by[name] = by.get(name, 0.0) + (b - a)
    return [[n[:120], s] for n, s in sorted(by.items(), key=lambda x: -x[1])
            [:top]]


def tracing_symbols(kernels: Path) -> list[str]:
    """The device kernels that trace rays: ``kernels/*.json``."""
    return sorted(json.loads(p.read_text())["symbol"]
                  for p in kernels.glob("*.json"))


def kernel_seconds(events, symbols) -> float:
    """Device seconds of the events whose name holds one of ``symbols`` as
    a whole word (``occlusion_kernel`` is not ``soft_occlusion_kernel``)."""
    pats = [re.compile(rf"(?<![A-Za-z0-9_]){re.escape(s)}(?![A-Za-z0-9_])")
            for s in symbols]
    return sum(b - a for name, a, b in events
               if any(p.search(name) for p in pats))


def least_seconds(counts, n_tris: int) -> tuple[float, str]:
    """(the least seconds one card needs for the traversal work of
    ``counts`` (a frame's :class:`reference.render.Counts`), which bound
    sets it)."""
    t_ops = (counts.boxes * OPS_PER_BOX + counts.tris * OPS_PER_TRI) \
        / PEAK_FP32
    t_bytes = (counts.segments * BYTES_PER_RAY + n_tris * BYTES_PER_TRI) \
        / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"
