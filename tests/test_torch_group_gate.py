"""Kernel 3's group gate on the CPU: the 32-triangle group boxes of
``prepare_trace_inputs`` and the plain count of the groups the kernel
sweeps, on the mid-size sphere grid (``build_sphere_grid(n=4,
sphere_detail=12)``: 34 chunks padded to 40, 5 superchunks) with its
16x12 camera rays. The kernel itself runs only on the card
(tests/test_torch_cuda.py holds it against the plain version there)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                            build_sphere_grid, grid_camera)

torch.set_num_threads(1)
W, H = 16, 12


@pytest.fixture(scope="module")
def mid():
    scene = build_sphere_grid(n=4, sphere_detail=12, device="cpu")
    return scene, ti.prepare_trace_inputs(scene)


@pytest.fixture(scope="module")
def camera_rays():
    """(4, 256) o4, d4: the mid grid camera's 16x12 primary rays, the last
    64 columns parked."""
    cam = grid_camera(W, H, n=4)
    pids = torch.arange(W * H)
    ray, _ = cam.generate_rays(pids, rng.prng_seed(pids % W, pids // W, 1),
                               RenderConfig())
    return ti.pack_rays(ray, None)


def _world_vertices(scene):
    """(E, 3, 3) world-space vertices of every expanded triangle, and (E,)
    whether it is real (a non-zero unit-space column)."""
    tf = scene.inst_transform[scene.isect_inst.long()].double()
    tp = scene.tri_pos[scene.isect_tri.long()].double()
    world = torch.einsum("eij,ekj->eki", tf[:, :, :3], tp) + tf[:, None, :, 3]
    return world, torch.abs(scene.isect_mu).sum(dim=0) > 0.0


def test_group_bounds_shape_and_flat_scene(mid):
    _, tp = mid
    nc_pad = tp.mu_pad.shape[1] // ti.BT
    assert nc_pad == 40
    assert tp.group_bounds.shape == (8, ti.GROUPS * nc_pad)
    assert tp.group_bounds.dtype == torch.float32
    assert tp.group_bounds.is_contiguous()
    demo = ti.prepare_trace_inputs(build_demo_scene(
        texture_resolution=8, sphere_detail=6, device="cpu"))
    assert not demo.superchunks and demo.group_bounds.shape == (8, 0)


def test_group_boxes_hold_their_triangles(mid):
    """Each real triangle's world vertices lie inside its group's box, and
    each group's box inside its chunk's (both inflated)."""
    scene, tp = mid
    world, real = _world_vertices(scene)
    gb = tp.group_bounds.double()
    col = torch.arange(world.shape[0]) // ti.GW
    lo, hi = gb[0:3, col].T, gb[3:6, col].T  # (E, 3)
    assert (world[real] >= lo[real][:, None]).all()
    assert (world[real] <= hi[real][:, None]).all()
    nc = scene.isect_mu.shape[1] // ti.BT
    g = tp.group_bounds[:, :ti.GROUPS * nc].view(8, nc, ti.GROUPS)
    real_g = real.view(-1, ti.GW).any(dim=1).view(nc, ti.GROUPS)
    cb = tp.chunk_bounds[:, :nc, None].expand(-1, -1, ti.GROUPS)
    assert (g[0:3][:, real_g] >= cb[0:3][:, real_g]).all()
    assert (g[3:6][:, real_g] <= cb[3:6][:, real_g]).all()
    # Tighter than the chunks: the floor and the light stretch a chunk's
    # box, not every group's.
    vol = (g[3:6] - g[0:3]).prod(dim=0)[real_g]
    cvol = (cb[3:6] - cb[0:3]).prod(dim=0)[real_g]
    assert float(vol.sum()) < 0.5 * float(cvol.sum())


def test_empty_groups_are_far_point_boxes(mid):
    """A group with no real triangle, and every group of a pad chunk, is
    the pad chunk's inflated 1e30 point box, which no slab passes."""
    scene, tp = mid
    _, real = _world_vertices(scene)
    n_real = real.view(-1, ti.GW).any(dim=1)
    empty = torch.cat([~n_real, torch.ones(
        tp.group_bounds.shape[1] - n_real.shape[0], dtype=torch.bool)])
    assert int(empty[:n_real.shape[0]].sum()) > 0  # the last chunk's tail
    assert int(empty.sum()) > 6 * ti.GROUPS
    far = tp.chunk_bounds[:, -1]  # a pad chunk's box
    assert bool((tp.chunk_bounds[0:6, -1] > 1e29).all())
    assert torch.equal(tp.group_bounds[:, empty],
                       far[:, None].expand(-1, int(empty.sum())))
    assert torch.equal(tp.group_bounds[:, ~empty][0:6] > 1e29,
                       torch.zeros(6, int((~empty).sum()), dtype=torch.bool))


def test_sub_bounds_unchanged(mid):
    """Kernel 2's halves, now reduced from the groups on a superchunk
    scene, are bit for bit what the halves' own reduction of the
    world-space vertices gives."""
    scene, tp = mid
    tf = scene.inst_transform[scene.isect_inst.long()]
    tpos = scene.tri_pos[scene.isect_tri.long()]
    world = (tf[:, None, :, 0] * tpos[:, :, 0:1] + tf[:, None, :, 1]
             * tpos[:, :, 1:2] + tf[:, None, :, 2] * tpos[:, :, 2:3]
             + tf[:, None, :, 3])
    real = (torch.abs(scene.isect_mu).sum(dim=0) > 0.0)[:, None]
    vlo = torch.where(real, world.amin(dim=1), torch.inf)
    vhi = torch.where(real, world.amax(dim=1), -torch.inf)
    ns = vlo.shape[0] // ti.SW
    lo = vlo.view(ns, ti.SW, 3).amin(dim=1)
    hi = vhi.view(ns, ti.SW, 3).amax(dim=1)
    empty = ~torch.isfinite(lo[:, :1])
    lo = torch.where(empty, 1e30, lo)
    hi = torch.where(empty, 1e30, hi)
    want = ti._inflate_bounds(torch.cat([lo, hi, lo.new_zeros((ns, 2))],
                                        dim=1).T)
    assert torch.equal(tp.sub_bounds.view(torch.int32),
                       want.view(torch.int32))
    assert torch.equal(ti._sub_bounds(scene), want)


def _geo(tp, group_bounds):
    return (tp.sc_bounds, tp.chunk_bounds, tp.mu_pad, tp.mv_pad, tp.mw_pad,
            tp.scc), dict(group_bounds=group_bounds)


def test_group_count_culls_camera_rays(mid, camera_rays):
    """On the camera rays the groups swept keep under half of row 2's
    tests; never more than row 2 / 32 on any ray; none for a ray that
    sweeps no chunk."""
    _, tp = mid
    o4t, d4t = camera_rays
    args, kw = _geo(tp, tp.group_bounds)
    work = ti.walk_two_level_plain(o4t, d4t, *args, **kw)
    steps, groups = work.walk.steps, work.group_sweeps
    assert float(steps.sum()) > 0
    kept = float(groups.sum()) * ti.GW / float(steps.sum())
    assert 0.0 < kept < 0.5
    assert (groups * ti.GW <= steps).all()
    assert (groups[steps == 0] == 0).all()
    lite = ti.closest_hit_sc_lite(o4t, d4t, tp.sc_bounds, tp.chunk_bounds,
                                  tp.group_bounds, tp.mu_pad, tp.mv_pad,
                                  tp.mw_pad, tp.scc)
    assert torch.equal(lite[2], steps)


def test_group_count_is_row_2_with_chunk_boxes(mid, camera_rays):
    """With every group box set to its chunk's box, the group gate passes
    wherever the chunk gate does: 8 groups a chunk, row 2 / 32."""
    _, tp = mid
    o4t, d4t = camera_rays
    args, kw = _geo(tp, tp.chunk_bounds.repeat_interleave(ti.GROUPS, dim=1))
    work = ti.walk_two_level_plain(o4t, d4t, *args, **kw)
    assert torch.equal(work.group_sweeps * ti.GW, work.walk.steps)
    assert float(work.walk.steps.sum()) > 0


def test_winner_group_passes_its_gate(mid, camera_rays):
    """The gate's exactness on these rays and on cosine bounces from their
    hits: every winner lies in a group whose box the ray passes with tmin
    at most the winner's t, so the group gate never skips it."""
    _, tp = mid
    o4t, d4t = camera_rays
    first = ti.closest_hit_sc_lite(o4t, d4t, tp.sc_bounds, tp.chunk_bounds,
                                   tp.group_bounds, tp.mu_pad, tp.mv_pad,
                                   tp.mw_pad, tp.scc)
    hit = first[0] < ti._MISS
    g = np.random.default_rng(5)
    p = (o4t[:3] + first[0] * d4t[:3])[:, hit]
    d = torch.from_numpy(g.normal(size=(3, int(hit.sum()))).astype(
        np.float32))
    d = d / d.norm(dim=0, keepdim=True)
    d = torch.where((d * d4t[:3, hit]).sum(dim=0) > 0, -d, d)
    n = -(-d.shape[1] // ti.BN) * ti.BN
    o2 = torch.zeros(4, n)
    d2 = torch.zeros(4, n)
    o2[:3], o2[3] = 1e9, 1.0
    d2[:3] = 0.5773503
    o2[:3, :d.shape[1]] = p + 1e-3 * d
    d2[:3, :d.shape[1]] = d
    for o4, d4, out in ((o4t, d4t, first), (o2, d2, None)):
        if out is None:
            out = ti.closest_hit_sc_lite(o4, d4, tp.sc_bounds,
                                         tp.chunk_bounds, tp.group_bounds,
                                         tp.mu_pad, tp.mv_pad, tp.mw_pad,
                                         tp.scc)
        won = out[0] < ti._MISS
        assert int(won.sum()) > 20
        box = tp.group_bounds[:, out[1][won].long() // ti.GW]
        rd = [ti._rcp(x) for x in d4[:3, won]]
        tmin, tmax = ti._slab(box, *o4[:3, won], *rd)
        assert bool(((tmax >= tmin) & (tmax > 0.0)
                     & (tmin <= out[0][won])).all())
