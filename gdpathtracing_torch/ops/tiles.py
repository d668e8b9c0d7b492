"""The traversal kernels' check and timing tiles, built in one place:
chip_smoke.py phase 2 holds each kernel against its plain version on them,
and tools/two_level_turns.py times builds of the kernels in turns on the
same operands.

Every tile is cut from a 1920x1080 frame, 1 spp, around its middle (the
top rows see no geometry): the standard loop's tile of ``cfg.tile_rays``
rays (:func:`middle_tile`), or regen's wavefront of ``cfg.regen_wavefront``
shadow rays (:func:`wavefront_shadow_rays`). The rays are the camera's,
their hits those of the default traversal, a bounce is one BRDF sample
from a hit, and a shadow ray goes from a hit toward a sampled light point
(NEE's query; kernel 5 takes those of the middle tile over soft-inflated
boxes), as in a frame. The march rounds (:func:`march_rounds`) are
those of regen's frontier march: the lanes in its sort order, queued by
its own candidate scan and block queues. The BVH traversal's tiles
(:func:`bvh_tiles`) add rays that meet its corner cases: axis-aligned rays
on box planes (:func:`axis_aligned_rays`) and stacks too shallow for the
scene. :func:`unit_t_witness` holds the UNIT oracle's t to kernel 1's
on such tiles.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import fused as fu
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.render import brdf
from gdpathtracing_torch.render.integrator import sample_direct
from gdpathtracing_torch.render.regen import march_lane_key
from gdpathtracing_torch.render.shading import get_shading_data
from gdpathtracing_torch.render.traverse import trace_bvh_plain
from gdpathtracing_torch.render.types import Ray

W, H = 1920, 1080


def middle_tile(cfg: RenderConfig) -> int:
    """The first pixel of the standard loop's tile through the middle of
    the frame."""
    return (W * H // 2) // cfg.tile_rays * cfg.tile_rays


def camera_rays(cam, cfg: RenderConfig, n: int, first: int, device):
    """The camera rays of pixels [first, first + n) and their RNG streams
    after the pixel jitter: (Ray, seed)."""
    pids = torch.arange(n, device=device) + first
    seed = rng.prng_seed(pids % W, torch.div(pids, W, rounding_mode="floor"),
                         0)
    return cam.to(device).generate_rays(pids, seed, cfg)


def middle_rays(scene, cam, prep: ti.TracePrep, cfg: RenderConfig, n: int,
                first: int):
    """Primary rays of pixels [first, first + n), their hits (the default
    traversal), shading and RNG streams: (Ray, HitInfo, ShadingInfo,
    seed)."""
    ray, seed = camera_rays(cam, cfg, n, first, prep.mu.device)
    hit = ti.trace_pallas(scene, ray, None, prep)
    return ray, hit, get_shading_data(scene, hit, ray), seed


def bounce_rays(s, hit, seed, cfg: RenderConfig):
    """One BRDF-sampled bounce from the hits ``hit`` with shading ``s``:
    (Ray, active)."""
    (r1, r2), _ = rng.pcg2d(seed)
    return Ray(s.position + s.normal * cfg.ray_eps,
               brdf.sample_brdf(s, r1, r2)), hit.hit


def unit_t_witness(scene, ray: Ray, eidx, t):
    """For rays whose winner is expanded triangle ``eidx`` at kernel 1's
    ``t``: (t_w, bound), each (N,). t_w is the UNIT oracle's epilogue,
    -w_o * (1 / w_d), on w_o and w_d summed as the kernels sum them, each
    product and sum rounded: ((x m0 + y m1) + z m2) + m3, no fused
    multiply-add. bound (f64) is what two roundings of that K = 4
    contraction can put between two such t, to first order: each sum lies
    within 4 units of 2^-24 times the sum S of its terms' magnitudes, t =
    -w_o / w_d moves by (dw_o + t dw_d) / |w_d|, and 4 units of t cover the
    division's rounding."""
    m = scene.isect_mw[:, eidx.long()]
    to = (ray.o.x * m[0], ray.o.y * m[1], ray.o.z * m[2], m[3])
    td = (ray.d.x * m[0], ray.d.y * m[1], ray.d.z * m[2])
    w_o = ((to[0] + to[1]) + to[2]) + to[3]
    w_d = (td[0] + td[1]) + td[2]
    t_w = -w_o * torch.where(w_d.abs() > 1e-12, 1.0 / w_d, 0.0)
    s_o = sum(x.double().abs() for x in to)
    s_d = sum(x.double().abs() for x in td)
    t = t.double()
    return t_w, 2.0 ** -24 * (8.0 * (s_o + t * s_d) / w_d.double().abs()
                              + 4.0 * t)


def rows_tiles(scene, cam, prep: ti.TracePrep, cfg: RenderConfig
               ) -> dict[str, tuple]:
    """Kernel 1's tiles: the standard loop's middle tile, primary rays and
    one bounce from their hits, each as the operands of
    ``ti.closest_hit_rows``, by name."""
    primary, hit, s, seed = middle_rays(scene, cam, prep, cfg,
                                        cfg.tile_rays, middle_tile(cfg))
    bounce, active = bounce_rays(s, hit, seed, cfg)
    geo = (prep.bounds, prep.mu, prep.mv, prep.mw, prep.tab)
    return {"primary": (*ti.pack_rays(primary, None), *geo),
            "bounce 1": (*ti.pack_rays(bounce, active), *geo)}


def fused_operands(scene, cam, prep: ti.TracePrep, cfg: RenderConfig):
    """Kernel 11's tile: the camera paths of the middle tile (rays and
    PCG2D words as ``path_trace_fused`` packs them), as the operands of
    ``fused.fused_paths`` before its config."""
    ray, seed = camera_rays(cam, cfg, cfg.tile_rays, middle_tile(cfg),
                            prep.mu.device)
    return (*fu.pack_paths(ray, seed), prep.bounds, prep.mu, prep.mv,
            prep.mw, fu._build_table(scene), fu._build_mats(scene))


def shadow_queries(s, hit, seed, prep: ti.TracePrep, cfg: RenderConfig):
    """NEE's shadow queries from the hits toward sampled light points, at a
    throughput of 1: the pending record of ``sample_direct`` (``shadow``,
    ``active``, ``tmax``)."""
    pend, _ = sample_direct(s, s.position * 0.0 + 1.0, hit.hit, seed,
                            prep.lights, cfg)
    return pend


def wavefront_shadow_rays(scene, cam, prep: ti.TracePrep, cfg: RenderConfig,
                          n: int | None = None):
    """Kernel 2's tile: the shadow rays of regen's wavefront (``n`` rays,
    ``cfg.regen_wavefront`` by default) from the hits of the pixels around
    the middle of the frame: (the operands of ``ti.occluded``, the number
    of queries)."""
    n = cfg.regen_wavefront if n is None else n
    _, hit, s, seed = middle_rays(scene, cam, prep, cfg, n, (W * H - n) // 2)
    pend = shadow_queries(s, hit, seed, prep, cfg)
    o4t, d4t, tlim = ti.pack_shadow_rays(pend.shadow, pend.active, pend.tmax)
    return ((o4t, d4t, tlim, prep.bounds, prep.sub_bounds, prep.mu, prep.mv,
             prep.mw), int(pend.active.sum()))


def soft_shadow_operands(scene, cam, prep: ti.TracePrep, cfg: RenderConfig,
                         edge_eps: float):
    """Kernel 5's tile: the shadow rays of the middle tile's primary hits
    toward sampled light points (NEE's queries), over the scene's chunk
    boxes grown by ``edge_eps`` (soft shadows) and its triangles' edge
    openness: (the operands of ``ti.soft_occluded``, the number of
    queries)."""
    _, hit, s, seed = middle_rays(scene, cam, prep, cfg, cfg.tile_rays,
                                  middle_tile(cfg))
    pend = shadow_queries(s, hit, seed, prep, cfg)
    o4t, d4t, tmax = ti.pack_shadow_rays(pend.shadow, pend.active, pend.tmax)
    eo = scene.tri_edge_open[scene.isect_tri.long()].T.contiguous()
    return ((o4t, d4t, tmax, ti.soft_bounds(scene.isect_chunk_bounds,
                                            edge_eps),
             prep.mu, prep.mv, prep.mw, eo), int(pend.active.sum()))


def classic_tiles(scene, cam, prep: ti.TracePrep, cfg: RenderConfig
                  ) -> dict[str, tuple]:
    """Kernels 8 and 9's tiles: the standard loop's middle tile, primary
    rays and one bounce from their hits, by name, each as (Ray, active,
    the operands of ``ti.closest_hit_classic`` / ``closest_hit_loop``: the
    packed rays over the raw chunk boxes)."""
    primary, hit, s, seed = middle_rays(scene, cam, prep, cfg,
                                        cfg.tile_rays, middle_tile(cfg))
    bounce, active = bounce_rays(s, hit, seed, cfg)
    geo = (scene.isect_chunk_bounds.contiguous(), prep.mu, prep.mv, prep.mw)
    return {name: (ray, act, (*ti.pack_rays(ray, act), *geo))
            for name, ray, act in (("primary", primary, None),
                                   ("bounce 1", bounce, active))}


def rows_nee_operands(prep: ti.TracePrep, bounce: Ray, active, pend):
    """Kernel 4's operands: the bounce rays with the shadow queries ``pend``
    of the hits they leave (``ti.closest_hit_rows_nee``)."""
    o4t, d4t = ti.pack_rays(bounce, active)
    so4t, sd4t, stmax = ti.pack_shadow_rays(pend.shadow, pend.active,
                                             pend.tmax)
    return (o4t, d4t, so4t, sd4t, stmax, prep.bounds, prep.sub_bounds,
            prep.mu, prep.mv, prep.mw, prep.tab)


class MarchRound(NamedTuple):
    """One round of kernel 7: its name and the operands of
    ``ti.march_step_sc`` before the scene's."""
    what: str
    o4t: torch.Tensor
    d4t: torch.Tensor
    init: torch.Tensor   # (2, N): the carried best t and eidx
    queue: torch.Tensor  # (N/256 · QL,) int32


def march_rounds(prep: ti.TracePrep, primary: Ray, bounce: Ray, active,
                 cfg: RenderConfig) -> list[MarchRound]:
    """Kernel 7's rounds on a tile of a superchunk scene, the lanes sorted
    by regen's march key (next superchunk, the one after it, octant) and
    queued by the march's candidate scan and block queues (QL =
    ``cfg.regen_march_ql``; sentinels and repeats among the entries):
    primary rays from the spawn state (no winner, BIG_E); a second round
    from the first's carried best (its plain version's), the cursors past
    the first candidate; bounce-1 rays from the spawn state; and primary
    rays from no winner with every superchunk queued, kernel 3's walk
    entry by entry."""
    nsc = prep.sc_bounds.shape[1]
    dev = prep.mu_pad.device
    n = active.shape[0]
    ql = cfg.regen_march_ql

    def no_winner():
        return torch.stack([torch.full((n,), ti._MISS, device=dev),
                            torch.full((n,), float(ti.BIG_E), device=dev)])

    def candidates(ray, act, m_t=None, m_sc=None, b_t=None):
        return ti.march_next_candidates(
            prep, ray.o, ray.d, act,
            torch.full((n,), -torch.inf, device=dev) if m_t is None else m_t,
            torch.full((n,), -1, dtype=torch.int64, device=dev)
            if m_sc is None else m_sc,
            torch.full((n,), ti._MISS, device=dev) if b_t is None else b_t,
            k=cfg.regen_march_k)

    def sorted_lanes(ray, act):
        es, ss = candidates(ray, act)
        key = torch.where(act, march_lane_key(ray.d, ss[0], ss[1], nsc),
                          1 << 22)
        perm = torch.argsort(key, stable=True)
        ray = Ray(type(ray.o)(*(x[perm] for x in ray.o)),
                  type(ray.d)(*(x[perm] for x in ray.d)))
        return ray, act[perm], [x[perm] for x in es], [x[perm] for x in ss]

    def queue(ss):
        return ti.march_block_queue(ss, nsc, ql)[0]

    ray, act, es, ss = sorted_lanes(primary, torch.ones_like(active))
    o4t, d4t = ti.pack_rays(ray)
    spawn = MarchRound("primary rays, spawn", o4t, d4t, no_winner(),
                       queue(ss))
    first = ti.march_step_sc_plain(o4t, d4t, spawn.init, spawn.queue,
                                   prep.sc_bounds, prep.chunk_bounds,
                                   prep.mu_pad, prep.mv_pad, prep.mw_pad,
                                   prep.scc)
    moved = ss[0] < nsc
    _, ss2 = candidates(ray, act, torch.where(moved, es[0], -torch.inf),
                        torch.where(moved, ss[0], -1), first[0])
    bray, bact, _, bss = sorted_lanes(bounce, active)
    bo4t, bd4t = ti.pack_rays(bray, bact)
    every = torch.arange(nsc, dtype=torch.int32, device=dev).repeat(
        n // ti.BN)
    return [spawn,
            MarchRound("primary rays, carried", o4t, d4t,
                       first[:2].contiguous(), queue(ss2)),
            MarchRound("bounce-1 rays, spawn", bo4t, bd4t, no_winner(),
                       queue(bss)),
            MarchRound("primary rays, every superchunk queued", o4t, d4t,
                       no_winner(), every)]


class BvhTile(NamedTuple):
    """A tile of the BVH traversal: the arguments of
    ``render.traverse.trace_bvh`` after the scene."""
    ray: Ray
    active: torch.Tensor | None
    max_stack: int
    max_iters: int


def _subtree(left, right, count, root: int) -> list[int]:
    """The BLAS nodes under ``root`` (numpy node tables)."""
    out, todo = [], [root]
    while todo:
        k = todo.pop()
        out.append(k)
        if count[k] == 0:
            todo += [int(left[k]), int(right[k])]
    return out


def axis_aligned_rays(scene, n: int, seed: int = 0) -> Ray:
    """``n`` rays along +-x, +-y or +-z (the other two components exactly
    0), each starting outside a box on one of its planes: half the boxes
    TLAS nodes (world space), half BLAS nodes of instances whose inverse
    transform maps that axis to itself exactly (so the object-space origin
    lies on the plane too), from a numpy seed. The unguarded 1/d is inf
    there, (plane - o) * inf is 0 * inf = NaN, and the slab test must miss
    the box as the reference's does."""
    g = np.random.default_rng(seed)
    tmin, tmax = (x.detach().cpu().numpy() for x in (scene.tlas_min,
                                                       scene.tlas_max))
    nt = tmin.shape[0]
    boxes = [(np.repeat(tmin, 3, axis=0), np.repeat(tmax, 3, axis=0),
              np.tile(np.arange(3), nt))]
    inv = scene.inst_inv_transform.detach().cpu().numpy()
    left, right, count, nmin, nmax = (x.detach().cpu().numpy() for x in (
        scene.node_left, scene.node_right, scene.node_count, scene.node_min,
        scene.node_max))
    roots = scene.inst_root.detach().cpu().numpy()
    blas = [(nmin[ks], nmax[ks], np.full(len(ks), a))
            for i in range(inv.shape[0]) for a in range(3)
            if np.array_equal(inv[i, a], np.eye(3, 4)[a])
            for ks in [_subtree(left, right, count, int(roots[i]))]]
    pools = [tuple(np.concatenate(x) for x in zip(*p)) for p in
             (boxes, blas) if p]
    which = np.arange(n) % len(pools)  # TLAS, BLAS, TLAS, ...
    lo, hi = np.empty((n, 3)), np.empty((n, 3))
    a = np.empty(n, np.int64)
    for w, (plo, phi, pa) in enumerate(pools):
        sel = which == w
        k = g.integers(len(pa), size=int(sel.sum()))
        lo[sel], hi[sel], a[sel] = plo[k], phi[k], pa[k]
    b = (a + 1 + g.integers(2, size=n)) % 3
    c = 3 - a - b
    sign = g.choice([-1.0, 1.0], size=n)
    j = np.arange(n)
    o = np.zeros((3, n), np.float32)
    d = np.zeros((3, n), np.float32)
    o[a, j] = np.where(g.uniform(size=n) < 0.5, lo[j, a], hi[j, a])
    o[c, j] = g.uniform(lo[j, c], hi[j, c])
    o[b, j] = np.where(sign > 0, lo[j, b] - 1.0, hi[j, b] + 1.0)
    d[b, j] = sign
    dev = scene.tri_pos.device
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    return Ray(Vec3(*o.unbind(0)), Vec3(*d.unbind(0)))


def bvh_tiles(scene, cam, cfg: RenderConfig, n: int | None = None
              ) -> dict[str, BvhTile]:
    """The BVH traversal's tiles, by name: the camera rays of the ``n``
    pixels (``cfg.tile_rays`` by default) around the middle of the frame
    and one BRDF bounce from their hits (the traversal's own, shaded by
    triangle and instance), with ``cfg.max_stack``; those primary rays
    with stacks
    of 2 (overflowing: a pop past the stack re-reads its top entry, so
    rays may cycle to the iteration cap, 256 pops here) and of 96 (deeper
    than the kernel's local stack); and ``n`` axis-aligned rays on box
    planes (:func:`axis_aligned_rays`)."""
    n = cfg.tile_rays if n is None else n
    first = (H // 2) * W + W // 2 - n // 2  # the frame's centre pixel
    primary, seed = camera_rays(cam, cfg, n, first, scene.tri_pos.device)
    hit = trace_bvh_plain(scene, primary, None, cfg.max_stack)
    s = get_shading_data(scene, hit, primary, fast=False)
    bounce, active = bounce_rays(s, hit, seed, cfg)
    return {"primary": BvhTile(primary, None, cfg.max_stack, 1 << 20),
            "bounce 1": BvhTile(bounce, active, cfg.max_stack, 1 << 20),
            "primary, max_stack 2": BvhTile(primary, None, 2, 256),
            "primary, max_stack 96": BvhTile(primary, None, 96, 1 << 20),
            "axis-aligned": BvhTile(axis_aligned_rays(scene, n), None,
                                    cfg.max_stack, 1 << 20)}
