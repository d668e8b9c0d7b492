"""Agglomerative TLAS (top-level BVH) builder over BLAS instances.

Host-side NumPy, identical to gdpathtracing_tpu/bvh/tlas.py.

Walter-style agglomerative clustering, same algorithm as the reference
(src/bvh/bvh.cpp:264-340, which follows Bikker's "How to build a BVH, part
6"): one leaf per instance, then repeatedly merge mutually-best SAH pairs
(argmin of merged-AABB half-area) until one cluster remains; the final root
is copied into slot 0 so traversal always starts there (bvh.cpp:316).

Node encoding: ``left == 0`` ⇔ leaf (the reference packs left|right<<16 into
one uint and tests ``leftRight == 0`` — bvh.h:59, main.glsl:316; we keep two
int32 columns and lift its 65535-node limit).

Instance world AABBs transform the 8 corners of the BLAS root AABB with the
proper affine (the reference multiplies by 2/w, doubling the AABB —
bvh.h:110 — a quirk fixed here, not copied).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class TLASArrays:
    """Flat TLAS: ``node_min``/``node_max`` (L, 3) f32; ``node_left``/
    ``node_right``/``node_inst`` (L,) int32. Leaf ⇔ left == 0; ``node_inst``
    is the BLAS-instance index (analog of TLASNode.blas, bvh.h:56-62)."""

    node_min: np.ndarray
    node_max: np.ndarray
    node_left: np.ndarray
    node_right: np.ndarray
    node_inst: np.ndarray


def instance_world_aabb(transform: np.ndarray, bmin: np.ndarray,
                        bmax: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """World AABB of an instanced BLAS: transform the 8 local corners
    (correct 1/w version of bvh.h:90-115)."""
    t = np.asarray(transform, dtype=np.float32)
    xs = np.array([bmin[0], bmax[0]], dtype=np.float32)
    ys = np.array([bmin[1], bmax[1]], dtype=np.float32)
    zs = np.array([bmin[2], bmax[2]], dtype=np.float32)
    pts = np.array([[x, y, z] for x in xs for y in ys for z in zs],
                   dtype=np.float32)
    world = pts @ t[:, :3].T + t[:, 3]
    return world.min(axis=0), world.max(axis=0)


def build_tlas(inst_min: Sequence[np.ndarray],
               inst_max: Sequence[np.ndarray]) -> TLASArrays:
    """Build the TLAS from per-instance world AABBs."""
    n = len(inst_min)
    if n == 0:
        raise ValueError("no instances")
    cap = 2 * n
    node_min = np.zeros((cap, 3), dtype=np.float32)
    node_max = np.zeros((cap, 3), dtype=np.float32)
    node_left = np.zeros(cap, dtype=np.int32)
    node_right = np.zeros(cap, dtype=np.int32)
    node_inst = np.zeros(cap, dtype=np.int32)

    # Leaves occupy slots 1..n (slot 0 reserved for the root copy).
    for i in range(n):
        node_min[1 + i] = inst_min[i]
        node_max[1 + i] = inst_max[i]
        node_inst[1 + i] = i
    used = 1 + n

    active = list(range(1, 1 + n))

    def merged_half_area(a: int, b: int) -> float:
        lo = np.minimum(node_min[a], node_min[b])
        hi = np.maximum(node_max[a], node_max[b])
        e = hi - lo
        return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    def best_partner(a: int) -> int:
        """Node id of a's best merge partner (bvh.cpp:319-340)."""
        best, best_cost = -1, np.inf
        for nb in active:
            if nb == a:
                continue
            c = merged_half_area(a, nb)
            if c < best_cost:
                best_cost, best = c, nb
        return best

    if n == 1:
        root = 1
    else:
        a = active[0]
        b = best_partner(a)
        while len(active) > 1:
            c = best_partner(b)
            if c == a:
                # Mutually best: merge a and b into a new internal node.
                node_min[used] = np.minimum(node_min[a], node_min[b])
                node_max[used] = np.maximum(node_max[a], node_max[b])
                node_left[used] = a
                node_right[used] = b
                active.remove(a)
                active.remove(b)
                active.append(used)
                merged = used
                used += 1
                if len(active) > 1:
                    a = merged
                    b = best_partner(a)
            else:
                a, b = b, c
        root = active[0]

    # Copy root into slot 0 (bvh.cpp:316).
    node_min[0] = node_min[root]
    node_max[0] = node_max[root]
    node_left[0] = node_left[root]
    node_right[0] = node_right[root]
    node_inst[0] = node_inst[root]

    return TLASArrays(
        node_min=node_min[:used],
        node_max=node_max[:used],
        node_left=node_left[:used],
        node_right=node_right[:used],
        node_inst=node_inst[:used],
    )
