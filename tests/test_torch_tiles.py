"""The kernel tiles of ops/tiles.py, which chip_smoke.py checks the kernels
on and tools/two_level_turns.py times them on, cut small on the CPU:

- ``march_rounds`` on the mid-size sphere grid (34 chunks, 5
  superchunks): four rounds over a permutation of the tile's lanes, the
  second carrying the first's plain winners, the last with every
  superchunk queued, which gives kernel 3's winners and counts;
- ``wavefront_shadow_rays`` on the same grid: the operands kernel 2
  takes, parked rays with limit 0, both answers among the queries;
- ``rows_nee_operands`` on the demo: kernel 4's rows equal kernel 1's on
  its bounce rays (the winners), its occlusion kernel 2's on its shadow
  rays;
- ``rows_tiles`` on the demo: kernel 1's primary and bounce-1 rays;
- ``fused_operands`` on the mid grid: kernel 11's camera paths, as FUSED's
  path tracer packs them;
- ``soft_shadow_operands`` on the mid grid: kernel 5's shadow rays over
  the soft-inflated boxes;
- ``classic_tiles`` on the mid grid: kernels 8 and 9's primary and
  bounce-1 rays over the raw chunk boxes;
- ``bvh_tiles`` and ``axis_aligned_rays`` on the demo: the BVH kernel's
  camera rays, their bounce, the stacks of 2 and 96, and the axis-aligned
  rays whose slab tests meet 0 * inf.

The tiles hold no kernel of their own, so nothing here runs JAX.
"""

from __future__ import annotations

import pytest
import torch

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.ops import fused as fu
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.ops import tiles as kt
from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                            build_sphere_grid, demo_camera,
                                            grid_camera)

torch.set_num_threads(1)
N = 512
CFG = RenderConfig(tile_rays=N, regen_wavefront=N)


def _columns(o4t, d4t):
    """The rays of packed (4, N) tensors as a sorted list of 8-tuples."""
    return sorted(map(tuple, torch.cat([o4t, d4t]).T.tolist()))


@pytest.fixture(scope="module")
def mid():
    scene = build_sphere_grid(n=4, sphere_detail=12, device="cpu")
    return scene, grid_camera(kt.W, kt.H, n=4), ti.prepare_trace_inputs(scene)


@pytest.fixture(scope="module")
def mid_rounds(mid):
    scene, cam, prep = mid
    primary, hit, s, seed = kt.middle_rays(scene, cam, prep, CFG, N,
                                           kt.middle_tile(CFG))
    bounce, active = kt.bounce_rays(s, hit, seed, CFG)
    return prep, primary, bounce, active, kt.march_rounds(
        prep, primary, bounce, active, CFG)


def test_middle_tile():
    assert kt.middle_tile(CFG) % N == 0
    assert kt.middle_tile(CFG) <= kt.W * kt.H // 2 < kt.middle_tile(CFG) + N


def test_march_rounds_lanes_and_queues(mid_rounds):
    prep, primary, bounce, active, rounds = mid_rounds
    nsc = prep.sc_bounds.shape[1]
    assert prep.superchunks and nsc == 5
    assert [r.what for r in rounds] == [
        "primary rays, spawn", "primary rays, carried", "bounce-1 rays, spawn",
        "primary rays, every superchunk queued"]
    # The lanes are the tile's rays in another order.
    assert _columns(rounds[0].o4t, rounds[0].d4t) == _columns(
        *ti.pack_rays(primary))
    assert _columns(rounds[2].o4t, rounds[2].d4t) == _columns(
        *ti.pack_rays(bounce, active))
    for r in rounds[:3]:
        assert r.queue.shape == (N // ti.BN * CFG.regen_march_ql,)
        assert r.queue.dtype == torch.int32
        assert int(r.queue.min()) >= 0 and int(r.queue.max()) <= nsc
        assert bool((r.queue < nsc).any())
    assert torch.equal(rounds[3].queue, torch.arange(
        nsc, dtype=torch.int32).repeat(N // ti.BN))
    for r in (rounds[0], rounds[2], rounds[3]):
        assert torch.equal(r.init[0], torch.full((N,), ti._MISS))
        assert torch.equal(r.init[1], torch.full((N,), float(ti.BIG_E)))


def test_march_rounds_carry_and_full_queue(mid_rounds):
    prep, _, _, _, rounds = mid_rounds
    geo = (prep.sc_bounds, prep.chunk_bounds, prep.mu_pad, prep.mv_pad,
           prep.mw_pad, prep.scc)
    spawn, carried, _, full = rounds
    first = ti.march_step_sc_plain(spawn.o4t, spawn.d4t, spawn.init,
                                   spawn.queue, *geo)
    assert torch.equal(carried.init, first[:2])
    assert torch.equal(carried.o4t, spawn.o4t)
    assert int((first[0] < ti._MISS).sum()) > N // 10
    got = ti.march_step_sc_plain(full.o4t, full.d4t, full.init, full.queue,
                                 *geo)
    lite = ti.closest_hit_sc_lite_plain(full.o4t, full.d4t, *geo[:2],
                                        prep.group_bounds, *geo[2:])
    hit = lite[0] < ti._MISS
    assert torch.equal(got[[0, 2, 3]], lite[[0, 2, 3]])
    assert torch.equal(got[1][hit], lite[1][hit])


def test_wavefront_shadow_rays(mid):
    scene, cam, prep = mid
    args, n_q = kt.wavefront_shadow_rays(scene, cam, prep, CFG)
    o4t, d4t, tlim = args[:3]
    assert o4t.shape == d4t.shape == (4, N) and tlim.shape == (N,)
    assert args[3:] == (prep.bounds, prep.sub_bounds, prep.mu, prep.mv,
                        prep.mw)
    assert 0 < n_q == int((tlim > 0).sum())
    occ = ti.occluded(*args)
    assert not bool(occ[tlim <= 0].any())
    assert 0 < int(occ.sum()) < n_q


def test_rows_nee_operands_on_demo():
    scene = build_demo_scene(device="cpu")
    prep = ti.prepare_trace_inputs(scene)
    # Pixels of row 300 that see the room (the middle row of a 512-ray
    # stripe sees none of it).
    _, hit, s, seed = kt.middle_rays(scene, demo_camera(kt.W, kt.H), prep,
                                     CFG, N, kt.W * 300 + 700)
    bounce, active = kt.bounce_rays(s, hit, seed, CFG)
    pend = kt.shadow_queries(s, hit, seed, prep, CFG)
    nee = kt.rows_nee_operands(prep, bounce, active, pend)
    assert len(nee) == 11 and nee[10] is prep.tab
    assert bool(pend.active.any()) and torch.equal(
        nee[4] > 0, torch.nn.functional.pad(
            pend.active, (0, nee[4].shape[0] - pend.active.shape[0])))
    rows, occ4 = ti.closest_hit_rows_nee(*nee)
    assert torch.equal(occ4, ti.occluded(*nee[2:10]))
    assert 0 < int(occ4.sum()) < int(pend.active.sum())
    # The winners (rows 0-44; 45-47 are the walks' counters).
    assert torch.equal(rows[:45], ti.closest_hit_rows(
        nee[0], nee[1], prep.bounds, prep.mu, prep.mv, prep.mw,
        prep.tab)[:45])


def test_rows_tiles_on_demo():
    """Kernel 1's tiles: the middle tile's primary rays and the bounce
    from their hits (the hits kernel 1 finds on the primary rays)."""
    scene = build_demo_scene(device="cpu")
    prep = ti.prepare_trace_inputs(scene)
    tiles = kt.rows_tiles(scene, demo_camera(kt.W, kt.H), prep, CFG)
    assert list(tiles) == ["primary", "bounce 1"]
    primary, hit, s, seed = kt.middle_rays(
        scene, demo_camera(kt.W, kt.H), prep, CFG, N, kt.middle_tile(CFG))
    assert torch.equal(torch.cat(tiles["primary"][:2]),
                       torch.cat(ti.pack_rays(primary, None)))
    assert torch.equal(torch.cat(tiles["bounce 1"][:2]), torch.cat(
        ti.pack_rays(*kt.bounce_rays(s, hit, seed, CFG))))
    for args in tiles.values():
        assert args[0].shape == (4, N)
        assert args[2:] == (prep.bounds, prep.mu, prep.mv, prep.mw, prep.tab)
    rows = ti.closest_hit_rows(*tiles["primary"])
    assert torch.equal(rows[40] < ti._MISS, hit.hit)


def test_fused_operands_on_mid(mid):
    """Kernel 11's tile: the middle tile's camera paths over the mid grid's
    34 chunks, walked flat; its 5 bounces equal FUSED's path tracer on the
    same rays."""
    scene, cam, prep = mid
    args = kt.fused_operands(scene, cam, prep, CFG)
    o4t, d4t, seeds = args[:3]
    assert o4t.shape == d4t.shape == (4, N) and seeds.shape == (2, N)
    assert seeds.dtype == torch.int32
    assert args[3:7] == (prep.bounds, prep.mu, prep.mv, prep.mw)
    assert prep.bounds.shape[1] == 34
    fcfg = CFG.replace(traversal=Traversal.FUSED, bounces=2)
    out, segs = fu.fused_paths(*args, fcfg)
    ray, seed = kt.camera_rays(cam, CFG, N, kt.middle_tile(CFG), "cpu")
    res = fu.path_trace_fused(scene, ray, seed, fcfg, prep)
    assert torch.equal(segs, res.segments)
    assert torch.equal(out[0], res.radiance.x)
    assert int((out[3] < ti._MISS).sum()) > N // 10


def test_soft_shadow_operands(mid):
    """Kernel 5's tile: the middle tile's NEE shadow rays over the chunk
    boxes grown by edge_eps and the triangles' edge openness; a parked ray
    (limit 0) finds no candidate, and some queries find one."""
    scene, cam, prep = mid
    args, n_q = kt.soft_shadow_operands(scene, cam, prep, CFG, 0.02)
    o4t, d4t, tmax, bounds = args[:4]
    assert o4t.shape == d4t.shape == (4, N) and tmax.shape == (N,)
    assert torch.equal(bounds, ti.soft_bounds(scene.isect_chunk_bounds,
                                              0.02))
    assert args[4:7] == (prep.mu, prep.mv, prep.mw)
    assert args[7].shape == (3, prep.mu.shape[1])
    assert 0 < n_q == int((tmax > 0).sum())
    margin, _ = ti.soft_occluded(*args)
    assert bool((margin[tmax <= 0] == -1e9).all())
    assert bool((margin > -1e8).any())


def test_classic_tiles_on_mid(mid):
    """Kernels 8 and 9's tiles: the middle tile's primary rays and the
    bounce from their hits, over the raw chunk boxes; kernel 8 finds the
    default traversal's winners on the primary rays."""
    scene, cam, prep = mid
    tiles = kt.classic_tiles(scene, cam, prep, CFG)
    assert list(tiles) == ["primary", "bounce 1"]
    primary, hit, s, seed = kt.middle_rays(scene, cam, prep, CFG, N,
                                           kt.middle_tile(CFG))
    ray, active, args = tiles["primary"]
    assert active is None
    assert torch.equal(torch.cat(args[:2]), torch.cat(ti.pack_rays(primary)))
    assert torch.equal(args[2], scene.isect_chunk_bounds)
    assert args[3:] == (prep.mu, prep.mv, prep.mw)
    t, idx = ti.closest_hit_classic(*args)
    assert int(hit.hit.sum()) > N // 10
    assert float(((t == hit.t) & (idx == hit.eidx)).float().mean()) >= 0.99
    bray, bactive, bargs = tiles["bounce 1"]
    assert torch.equal(bactive, hit.hit)
    assert torch.equal(torch.cat(bargs[:2]),
                       torch.cat(ti.pack_rays(bray, bactive)))


def test_bvh_tiles_on_demo():
    """The BVH tiles: N camera rays around the frame's centre that mostly
    hit; the bounce from their hits with the hits as its active mask; the
    same camera rays with stacks of 2 (capped at 256 pops: the stack
    overflows and some rays reach the cap) and of 96 (the same answer as
    64); and axis-aligned rays, two components exactly 0, origins on a
    box plane, so that some slab test of a TLAS box is NaN."""
    from gdpathtracing_torch.render.traverse import trace_bvh_plain
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6,
                             device="cpu")
    tiles = kt.bvh_tiles(scene, demo_camera(kt.W, kt.H), CFG)
    assert set(tiles) == {"primary", "bounce 1", "primary, max_stack 2",
                          "primary, max_stack 96", "axis-aligned"}
    hits = {}
    for name, bt in tiles.items():
        assert bt.ray.o.x.shape == (N,)
        hits[name] = trace_bvh_plain(scene, bt.ray, bt.active, bt.max_stack,
                                     bt.max_iters)
    assert int(hits["primary"].hit.sum()) > N // 2
    assert torch.equal(tiles["bounce 1"].active, hits["primary"].hit)
    assert tiles["primary, max_stack 2"].max_iters == 256
    assert int(hits["primary, max_stack 2"].steps.sum()) \
        != int(hits["primary"].steps.sum())
    for f in ("t", "tri", "inst", "steps"):
        assert torch.equal(getattr(hits["primary, max_stack 96"], f),
                           getattr(hits["primary"], f))
    ray = tiles["axis-aligned"].ray
    d = ray.d.to_array()
    assert ((d == 0.0).sum(dim=1) == 2).all() and (d.abs().sum(dim=1)
                                                   == 1.0).all()
    rw = ray.rcp_d()
    nan = torch.zeros(N, dtype=torch.bool)
    for k in range(scene.tlas_min.shape[0]):
        for b in (scene.tlas_min[k], scene.tlas_max[k]):
            for a, (o, r) in enumerate(zip(ray.o, rw)):
                nan |= torch.isnan((b[a] - o) * r)
    assert int(nan.sum()) > N // 4
    assert int(hits["axis-aligned"].hit.sum()) > N // 10
