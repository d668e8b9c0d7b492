"""Ray-primitive intersection and the plain scene tracers — port of
gdpathtracing_tpu/render/intersect.py: ``moller_trumbore`` and
``intersect_aabb``, the tests the BVH traversal (render/traverse.py) runs
at its leaves and inner nodes; ``trace_brute`` (``Traversal.BRUTE``) and
``trace_unit`` (``Traversal.UNIT``), the exhaustive closest-hit oracles the
kernels are tested against; and ``occlusion_soft``, the soft shadow
visibility of BRUTE and UNIT. The reference runs these three in plain XLA,
outside any Pallas kernel, and so does the port in plain torch.

Every product and sum is an elementwise torch op in the reference's term
order, and ``torch.minimum`` / ``torch.maximum`` propagate NaN as
``jnp.minimum`` / ``jnp.maximum`` do, so a slab test that meets 0 · inf
(an axis-aligned ray on a box plane, through the unguarded ``Ray.rcp_d``)
misses here as it does there.
"""

from __future__ import annotations

import torch

from gdpathtracing_torch.core.math3d import affine_apply_dir, affine_apply_point
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.render.types import MISS_T, HitInfo, Ray
from gdpathtracing_torch.scene.scene import Scene

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


def _gather_tri(scene: Scene, idx: torch.Tensor):
    """Vertices of triangles ``idx`` (clamped into range, as the
    reference's gather clips) as three Vec3 of idx's shape."""
    v = scene.tri_pos[torch.clamp(idx, 0, scene.n_tris - 1)]  # (..., 3, 3)
    return (Vec3(v[..., 0, 0], v[..., 0, 1], v[..., 0, 2]),
            Vec3(v[..., 1, 0], v[..., 1, 1], v[..., 1, 2]),
            Vec3(v[..., 2, 0], v[..., 2, 1], v[..., 2, 2]))


def _pick(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Row i's entry k[i] of (N, C) ``x``."""
    return torch.gather(x, 1, k[:, None]).squeeze(1)


def trace_brute(scene: Scene, ray: Ray, active=None,
                tri_block: int = 512) -> HitInfo:
    """Closest hit by exhaustive search: every instance's triangles in
    blocks of ``tri_block``, Möller–Trumbore in the instance's object space
    (directions are not renormalised, so t stays comparable across
    instances). Within a block the first index of the smallest t wins
    (``torch.argmin``), and a block replaces the best only with a strictly
    smaller t, so the winner is the lowest (t, instance, triangle)
    whatever the block size. ``steps`` counts every triangle tested.
    Plain torch, differentiable by autograd: the oracle of every other
    traversal."""
    best = HitInfo.none_like(ray.o.x)
    dev = ray.o.x.device
    for inst in range(scene.n_instances):
        inv = scene.inst_inv_transform[inst]
        o, d = affine_apply_point(inv, ray.o), affine_apply_dir(inv, ray.d)
        rr = Ray(Vec3(o.x[:, None], o.y[:, None], o.z[:, None]),
                 Vec3(d.x[:, None], d.y[:, None], d.z[:, None]))
        first = scene.inst_tri_first[inst]
        count = scene.inst_tri_count[inst]
        for blk in range(-(-count // tri_block)):
            tri_idx = first + blk * tri_block + torch.arange(tri_block,
                                                             device=dev)
            tri_ok = tri_idx < first + count
            v0, v1, v2 = _gather_tri(scene, tri_idx)
            valid, t, u, v, front = moller_trumbore(rr, v0, v1, v2,
                                                    best.t[:, None])
            t = torch.where(valid & tri_ok, t, MISS_T)
            k = torch.argmin(t, dim=1)
            tk = _pick(t, k)
            better = tk < best.t

            def upd(new, old):
                return torch.where(better, new, old)

            best = HitInfo(
                t=upd(tk, best.t),
                tri=upd(tri_idx[k].to(torch.int32), best.tri),
                inst=upd(torch.full_like(best.inst, inst), best.inst),
                u=upd(_pick(u, k), best.u), v=upd(_pick(v, k), best.v),
                front=upd(_pick(front, k), best.front),
                steps=best.steps + tri_ok.sum().to(torch.int32),
                eidx=best.eidx)
    if active is not None:
        best = best._replace(t=torch.where(active, best.t, MISS_T))
    return best


def _unit_space(ray: Ray):
    """(N, 4) homogeneous origins (o, 1) and directions (d, 0)."""
    one = torch.ones_like(ray.o.x)
    return (torch.stack([ray.o.x, ray.o.y, ray.o.z, one], dim=1),
            torch.stack([ray.d.x, ray.d.y, ray.d.z, one * 0.0], dim=1))


def _unit_chunks(e: int, chunk: int) -> list[tuple[int, int]]:
    """[start, stop) of each chunk of the expanded triangles."""
    return [(s, min(s + chunk, e)) for s in range(0, e, chunk)]


def occlusion_soft(scene: Scene, ray: Ray, t_max, active=None,
                   edge_eps: float = 2e-2, chunk: int = 512) -> torch.Tensor:
    """Soft shadow-ray visibility in [0, 1]: the product over the expanded
    triangles the ray crosses in (1e-6, ``t_max``) of ``1 - sigmoid(
    margin / edge_eps)``, ``margin`` the hit's barycentric distance to the
    triangle's open (mesh-boundary) edges; an interior edge gates hard, so
    a seam hands its coverage to the neighbour. ``edge_eps -> 0`` gives
    hard visibility; a small one gives gradients of the shadow with
    respect to the blocker's geometry. Chunks of ``chunk`` expanded
    triangles (256 where E is no multiple of it: E is one of 256, and an
    overlap would count a triangle twice); 1 where not ``active``."""
    e = scene.isect_mu.shape[1]
    chunk = min(chunk, e)
    if e % chunk:
        chunk = 256
    eo = scene.tri_edge_open[scene.isect_tri.long()].T  # (3, E)
    o4, d4 = _unit_space(ray)
    vis = torch.ones_like(ray.o.x)
    for sl, stop in _unit_chunks(e, chunk):
        mu = scene.isect_mu[:, sl:stop]
        mv = scene.isect_mv[:, sl:stop]
        mw = scene.isect_mw[:, sl:stop]
        u_o, v_o, w_o = o4 @ mu, o4 @ mv, o4 @ mw
        u_d, v_d, w_d = d4 @ mu, d4 @ mv, d4 @ mw
        wd_ok = torch.abs(w_d) > 1e-12
        inv_wd = torch.where(wd_ok, 1.0 / torch.where(wd_ok, w_d, 1.0), 0.0)
        t = -w_o * inv_wd
        u = u_o + t * u_d
        v = v_o + t * v_d
        w_ = 1.0 - u - v
        ou, ov, ow = (eo[0, sl:stop][None, :] > 0, eo[1, sl:stop][None, :] > 0,
                      eo[2, sl:stop][None, :] > 0)
        m_open = torch.minimum(
            torch.minimum(torch.where(ou, u, 1.0), torch.where(ov, v, 1.0)),
            torch.where(ow, w_, 1.0))
        int_ok = torch.minimum(
            torch.minimum(torch.where(ou, 1.0, u), torch.where(ov, 1.0, v)),
            torch.where(ow, 1.0, w_)) > 0.0
        cov = torch.sigmoid(m_open / edge_eps)
        in_t = wd_ok & (t > 1e-6) & (t < t_max[:, None]) & int_ok
        cov = torch.where(in_t, cov, 0.0)
        vis = vis * torch.prod(1.0 - cov, dim=1)
    if active is not None:
        vis = torch.where(active, vis, 1.0)
    return vis


def trace_unit(scene: Scene, ray: Ray, active=None,
               chunk: int = 512) -> HitInfo:
    """Closest hit in unit-triangle space over the instance-expanded
    world-space triangles (``Scene.isect_*``): per chunk two (N, 4) ×
    (4, C) products (``torch.matmul``; TF32 is off package-wide) and an
    elementwise epilogue. Within a chunk the first index of the smallest t
    wins, and a chunk replaces the best only with a strictly smaller t, so
    the winner is the lowest (t, expanded index) whatever the chunking.
    ``steps`` is E for every ray; ``front`` where w_d < 0. The last chunk
    is the remainder, where the reference re-reads the final ``chunk``
    columns from a clamped start but reports its index from the unclamped
    one (ROADMAP §3)."""
    e = scene.isect_mu.shape[1]
    o4, d4 = _unit_space(ray)
    zero = ray.o.x * 0.0
    best_t = zero + MISS_T
    best_e = zero.to(torch.int32)
    best_u, best_v = zero, zero
    best_front = best_e.to(torch.bool)
    for sl, stop in _unit_chunks(e, min(chunk, e)):
        mu = scene.isect_mu[:, sl:stop]
        mv = scene.isect_mv[:, sl:stop]
        mw = scene.isect_mw[:, sl:stop]
        u_o, v_o, w_o = o4 @ mu, o4 @ mv, o4 @ mw
        u_d, v_d, w_d = d4 @ mu, d4 @ mv, d4 @ mw
        inv_wd = torch.where(torch.abs(w_d) > 1e-12, 1.0 / w_d, 0.0)
        t = -w_o * inv_wd
        u = u_o + t * u_d
        v = v_o + t * v_d
        valid = (torch.abs(w_d) > 1e-12) & (t > 0.0) & (u >= 0.0) & \
            (v >= 0.0) & (u + v <= 1.0) & (t < best_t[:, None])
        t = torch.where(valid, t, MISS_T)
        k = torch.argmin(t, dim=1)
        tk = _pick(t, k)
        better = tk < best_t
        best_t = torch.where(better, tk, best_t)
        best_e = torch.where(better, (sl + k).to(torch.int32), best_e)
        best_u = torch.where(better, _pick(u, k), best_u)
        best_v = torch.where(better, _pick(v, k), best_v)
        best_front = torch.where(better, _pick(w_d, k) < 0.0, best_front)
    hit = best_t < MISS_T
    idx = best_e.long()
    tri = torch.where(hit, scene.isect_tri[idx], 0)
    inst = torch.where(hit, scene.isect_inst[idx], 0)
    if active is not None:
        best_t = torch.where(active, best_t, MISS_T)
    return HitInfo(t=best_t, tri=tri, inst=inst, u=best_u, v=best_v,
                   front=best_front, steps=best_e * 0 + e, eidx=best_e)
