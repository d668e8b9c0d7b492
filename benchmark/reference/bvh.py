"""The reference's acceleration structure: an SAH BVH over the world-space
triangles with leaves of at most four, the structure of the upstream
builder (bvh.cpp:125), and its front-to-back closest-hit traversal, which
also counts the box and triangle tests it makes.

The build is level-synchronous and vectorised in torch: every open node
of a level bins its triangles' centroids (16 bins an axis), sweeps the
bins for the least surface-area cost, and partitions by a stable sort; a
node that no bin separates is split at its middle. The traversal pops one
node of every unfinished ray a round, tests its box (inflated by about a
hundred ulp, so that no hit the triangle test finds is culled) before the
ray's best t so far, tests a leaf's triangles, and pushes an inner node's
children far first, by the sign of the ray's direction on the split axis.
The winner is the least (t, triangle index), whatever the order of visits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

LEAF = 4
BINS = 16
STACK = 64
WD_EPS = 1e-12
MISS_T = 1e9


class BVH(NamedTuple):
    lo: torch.Tensor     # (K, 3) inflated node boxes
    hi: torch.Tensor
    left: torch.Tensor   # (K,) int64 children (inner nodes)
    right: torch.Tensor
    first: torch.Tensor  # (K,) int64 leaf range in ``order``
    count: torch.Tensor  # (K,) int64, 0 on an inner node
    axis: torch.Tensor   # (K,) int64 split axis
    order: torch.Tensor  # (E,) int64 triangle ids in leaf order


def _area(lo, hi):
    e = torch.clamp(hi - lo, min=0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + \
        e[..., 2] * e[..., 0]


def build(lo: torch.Tensor, hi: torch.Tensor) -> BVH:
    """SAH BVH over triangles with world bounds ``lo``/``hi`` (E, 3)."""
    dev = lo.device
    e = lo.shape[0]
    cen = (lo.double() + hi.double()) * 0.5
    order = torch.arange(e, device=dev)
    # Open nodes of the current level: id, start, count.
    ids = torch.zeros(1, dtype=torch.int64, device=dev)
    start = torch.zeros(1, dtype=torch.int64, device=dev)
    cnt = torch.full((1,), e, dtype=torch.int64, device=dev)
    n_nodes = 1
    recs = []  # (ids, start, count, left, axis, box lo, box hi) per level
    while ids.numel():
        k = ids.numel()
        seg = torch.repeat_interleave(torch.arange(k, device=dev), cnt)
        pos = torch.arange(seg.numel(), device=dev) - \
            torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        # Open ranges are disjoint and listed by start, so ``gpos`` rises.
        gpos = torch.repeat_interleave(start, cnt) + pos
        tri = order[gpos]
        # Node boxes and centroid bounds.
        blo = torch.full((k, 3), torch.inf, device=dev)
        bhi = torch.full((k, 3), -torch.inf, device=dev)
        blo = blo.scatter_reduce(0, seg[:, None].expand(-1, 3), lo[tri],
                                 "amin")
        bhi = bhi.scatter_reduce(0, seg[:, None].expand(-1, 3), hi[tri],
                                 "amax")
        c = cen[tri]
        clo = torch.full((k, 3), torch.inf, dtype=torch.float64, device=dev)
        chi = torch.full((k, 3), -torch.inf, dtype=torch.float64, device=dev)
        clo = clo.scatter_reduce(0, seg[:, None].expand(-1, 3), c, "amin")
        chi = chi.scatter_reduce(0, seg[:, None].expand(-1, 3), c, "amax")
        ext = chi - clo
        b = torch.where(ext[seg] > 0, (c - clo[seg]) / torch.where(
            ext[seg] > 0, ext[seg], 1.0) * BINS, 0.0)
        b = torch.clamp(b.to(torch.int64), 0, BINS - 1)        # (n, 3)
        # Per (node, axis, bin): count and bounds.
        key = (seg[:, None] * 3 + torch.arange(3, device=dev)) * BINS + b
        nb = k * 3 * BINS
        bcnt = torch.zeros(nb, dtype=torch.int64, device=dev).scatter_add(
            0, key.reshape(-1), torch.ones_like(key.reshape(-1)))
        key3 = key.reshape(-1)[:, None].expand(-1, 3)
        tlo = lo[tri][:, None, :].expand(-1, 3, -1).reshape(-1, 3)
        thi = hi[tri][:, None, :].expand(-1, 3, -1).reshape(-1, 3)
        bblo = torch.full((nb, 3), torch.inf, device=dev).scatter_reduce(
            0, key3, tlo, "amin").view(k, 3, BINS, 3)
        bbhi = torch.full((nb, 3), -torch.inf, device=dev).scatter_reduce(
            0, key3, thi, "amax").view(k, 3, BINS, 3)
        bcnt = bcnt.view(k, 3, BINS)
        # Sweep: split s puts bins < s on the left.
        lc = torch.cumsum(bcnt, 2)[..., :-1]
        rc = torch.flip(torch.cumsum(torch.flip(bcnt, [2]), 2), [2])[..., 1:]
        llo = torch.cummin(bblo, 2).values[..., :-1, :]
        lhi = torch.cummax(bbhi, 2).values[..., :-1, :]
        rlo = torch.flip(torch.cummin(torch.flip(bblo, [2]), 2).values,
                         [2])[..., 1:, :]
        rhi = torch.flip(torch.cummax(torch.flip(bbhi, [2]), 2).values,
                         [2])[..., 1:, :]
        cost = torch.where((lc > 0) & (rc > 0),
                           _area(llo, lhi).double() * lc
                           + _area(rlo, rhi).double() * rc, torch.inf)
        best = cost.view(k, -1).argmin(1)
        ok = torch.isfinite(cost.view(k, -1).gather(1, best[:, None])[:, 0])
        axis = torch.where(ok, best // (BINS - 1),
                           torch.argmax(ext, 1))
        split = best % (BINS - 1) + 1
        inner = cnt > LEAF
        # Children of the inner nodes.
        n_inner = int(inner.sum())
        left = torch.zeros(k, dtype=torch.int64, device=dev)
        left[inner] = n_nodes + 2 * torch.arange(n_inner, device=dev)
        recs.append((ids, start, cnt, left, axis, blo, bhi))
        n_nodes += 2 * n_inner
        if n_inner == 0:
            break
        # Partition each inner node's range: left side first, stably; a
        # node no bin separates splits at its middle.
        s_ok, s_ax, s_split = ok[seg], axis[seg], split[seg]
        side = torch.where(s_ok, b.gather(1, s_ax[:, None])[:, 0] >= s_split,
                           pos >= cnt[seg] // 2).to(torch.int64)
        side = torch.where(inner[seg], side, 0)
        perm = torch.argsort((gpos - pos) * 2 + side, stable=True)
        order[gpos] = tri[perm]
        nl = torch.zeros(k, dtype=torch.int64, device=dev).scatter_add(
            0, seg, (side == 0).to(torch.int64))
        ci = torch.nonzero(inner).squeeze(1)
        ids = torch.stack([left[ci], left[ci] + 1], 1).reshape(-1)
        start = torch.stack([start[ci], start[ci] + nl[ci]], 1).reshape(-1)
        cnt = torch.stack([nl[ci], cnt[ci] - nl[ci]], 1).reshape(-1)
    out = dict(lo=torch.zeros(n_nodes, 3, device=dev),
               hi=torch.zeros(n_nodes, 3, device=dev),
               left=torch.zeros(n_nodes, dtype=torch.int64, device=dev),
               first=torch.zeros(n_nodes, dtype=torch.int64, device=dev),
               count=torch.zeros(n_nodes, dtype=torch.int64, device=dev),
               axis=torch.zeros(n_nodes, dtype=torch.int64, device=dev))
    for nid, st, ct, lf, ax, blo, bhi in recs:
        leaf = ct <= LEAF
        out["lo"][nid], out["hi"][nid] = blo, bhi
        out["left"][nid] = lf
        out["axis"][nid] = ax
        out["first"][nid] = torch.where(leaf, st, 0)
        out["count"][nid] = torch.where(leaf, ct, 0)
    lo_n, hi_n = out["lo"], out["hi"]
    eps = 1e-5 * torch.maximum(torch.abs(lo_n), torch.abs(hi_n)) + 1e-6
    return BVH(lo=lo_n - eps, hi=hi_n + eps, left=out["left"],
               right=out["left"] + 1, first=out["first"],
               count=out["count"], axis=out["axis"], order=order)


class Hits(NamedTuple):
    t: torch.Tensor       # (N,) f32, MISS_T where nothing was hit
    e: torch.Tensor       # (N,) int64 triangle index (0 on a miss)
    u: torch.Tensor       # (N,) f32
    v: torch.Tensor
    w_d: torch.Tensor     # (N,) f32, < 0 where the front face was hit
    boxes: torch.Tensor   # (N,) int64 box tests made
    tris: torch.Tensor    # (N,) int64 triangle tests made


def _dot4(m, x, y, z, w):
    return x * m[..., 0] + y * m[..., 1] + z * m[..., 2] + w * m[..., 3]


@torch.no_grad()
def closest_hit(bvh: BVH, cols: torch.Tensor, o, d, active) -> Hits:
    """Closest hits of rays ``o``/``d`` (each (N, 3)) where ``active``,
    over the triangles' unit-space rows ``cols`` (E, 12)."""
    n = o.shape[0]
    dev = o.device
    rd = 1.0 / torch.where(torch.abs(d) < 1e-30, 1e-30, d)
    best_t = torch.full((n,), MISS_T, device=dev)
    best_e = torch.full((n,), cols.shape[0], dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    best_wd = torch.zeros(n, device=dev)
    boxes = torch.zeros(n, dtype=torch.int64, device=dev)
    tris = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, STACK), dtype=torch.int32, device=dev)
    sp = active.to(torch.int64)
    live = torch.nonzero(active).squeeze(1)
    while live.numel():
        s = sp[live] - 1
        node = stack[live, s].to(torch.int64)
        sp[live] = s
        ro, rr = o[live], rd[live]
        t1 = (bvh.lo[node] - ro) * rr
        t2 = (bvh.hi[node] - ro) * rr
        tmin = torch.minimum(t1, t2).amax(1)
        tmax = torch.maximum(t1, t2).amin(1)
        passed = (tmax >= tmin) & (tmax > 0.0) & (tmin <= best_t[live])
        boxes[live] += 1
        cnt = bvh.count[node]
        leaf = passed & (cnt > 0)
        rays, lnode = live[leaf], node[leaf]
        if rays.numel():
            lcnt = cnt[leaf]
            tris[rays] += lcnt
            k = torch.arange(LEAF, device=dev)
            take = k < lcnt[:, None]                          # (r, 4)
            tri = bvh.order[torch.where(take, bvh.first[lnode][:, None] + k,
                                        bvh.first[lnode][:, None])]
            m = cols[tri]                                     # (r, 4, 12)
            (ox, oy, oz), (dx, dy, dz) = (x[:, None] for x in
                                          o[rays].unbind(1)), \
                (x[:, None] for x in d[rays].unbind(1))
            one, zero = torch.ones_like(ox), torch.zeros_like(ox)
            w_d = _dot4(m[..., 8:12], dx, dy, dz, zero)
            w_o = _dot4(m[..., 8:12], ox, oy, oz, one)
            wd_ok = torch.abs(w_d) > WD_EPS
            t = -w_o / torch.where(wd_ok, w_d, 1.0)
            u = _dot4(m[..., 0:4], ox, oy, oz, one) + \
                t * _dot4(m[..., 0:4], dx, dy, dz, zero)
            v = _dot4(m[..., 4:8], ox, oy, oz, one) + \
                t * _dot4(m[..., 4:8], dx, dy, dz, zero)
            valid = take & wd_ok & (t > 0.0) & (u >= 0.0) & (v >= 0.0) & \
                (u + v <= 1.0)
            t = torch.where(valid, t, MISS_T)
            tk = t.amin(1)
            ek = torch.where(t == tk[:, None], tri, cols.shape[0]).amin(1)
            j = (tri == ek[:, None]).to(torch.int64).argmax(1)[:, None]
            bt, be = best_t[rays], best_e[rays]
            better = (tk < MISS_T) & ((tk < bt) | ((tk == bt) & (ek < be)))
            w = rays[better]
            best_t[w], best_e[w] = tk[better], ek[better]
            best_u[w] = u.gather(1, j)[better, 0]
            best_v[w] = v.gather(1, j)[better, 0]
            best_wd[w] = w_d.gather(1, j)[better, 0]
        inner = passed & (cnt == 0)
        rays, inode = live[inner], node[inner]
        pos_dir = d[rays].gather(1, bvh.axis[inode][:, None])[:, 0] > 0.0
        near = torch.where(pos_dir, bvh.left[inode], bvh.right[inode])
        far = torch.where(pos_dir, bvh.right[inode], bvh.left[inode])
        top = sp[rays]
        if top.numel() and int(top.max()) + 2 > STACK:
            raise RuntimeError("reference BVH stack overflow")
        stack[rays, top] = far.to(torch.int32)
        stack[rays, top + 1] = near.to(torch.int32)
        sp[rays] = top + 2
        live = live[sp[live] > 0]
    hit = best_t < MISS_T
    return Hits(t=best_t, e=torch.where(hit, best_e, 0), u=best_u, v=best_v,
                w_d=best_wd, boxes=boxes, tris=tris)
