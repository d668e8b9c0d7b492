"""Ray-primitive intersection — port of ``moller_trumbore`` and
``intersect_aabb`` of gdpathtracing_tpu/render/intersect.py, the tests the
BVH traversal (render/traverse.py) runs at its leaves and inner nodes.

Every product and sum is an elementwise torch op in the reference's term
order, and ``torch.minimum`` / ``torch.maximum`` propagate NaN as
``jnp.minimum`` / ``jnp.maximum`` do, so a slab test that meets 0 · inf
(an axis-aligned ray on a box plane, through the unguarded ``Ray.rcp_d``)
misses here as it does there.
"""

from __future__ import annotations

import torch

from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.render.types import Ray

DET_EPS = 1e-5
AABB_MISS = 1e30


def moller_trumbore(ray: Ray, v0: Vec3, v1: Vec3, v2: Vec3, t_max):
    """Batched Möller–Trumbore, no backface cull, |det| epsilon 1e-5.
    Returns (valid, t, u, v, front): valid where 0 < t < ``t_max`` (both
    strict) inside the triangle; front where the geometric normal e1 × e2
    faces the ray."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = ray.d.cross(e2)
    det = e1.dot(pvec)
    inv_det = torch.where(torch.abs(det) < DET_EPS, 0.0, 1.0 / det)
    tvec = ray.o - v0
    u = tvec.dot(pvec) * inv_det
    qvec = tvec.cross(e1)
    v = ray.d.dot(qvec) * inv_det
    t = e2.dot(qvec) * inv_det
    valid = (torch.abs(det) >= DET_EPS) & (u >= 0.0) & (u <= 1.0) & \
        (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t < t_max)
    front = e1.cross(e2).dot(ray.d) < 0.0
    return valid, t, u, v, front


def intersect_aabb(o: Vec3, rcp_d: Vec3, bmin: Vec3, bmax: Vec3):
    """Slab test: the entry distance, or AABB_MISS (1e30) on a miss (a NaN
    on any axis is a miss)."""
    t1 = (bmin - o) * rcp_d
    t2 = (bmax - o) * rcp_d
    tmin = t1.minimum(t2).max_component()
    tmax = t1.maximum(t2).min_component()
    return torch.where((tmax >= tmin) & (tmax > 0.0), tmin, AABB_MISS)
