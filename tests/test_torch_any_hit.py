"""Kernel 2 (any-hit occlusion) on a superchunk scene, and the thread-slot
counts of the block-cooperative walks of kernels 2 and 7.

- ``occluded_plain`` on the mid-size sphere grid (``build_sphere_grid(n=4,
  sphere_detail=12)``: 34 flat chunks, 2 emitters) against JAX's
  ``occluded_pallas`` in Pallas interpret mode, which visits the chunks of
  each block near to far, where the port visits them in index order: the
  answer is an OR over the gated tests, so the two agree exactly. The rays
  are the shadow rays a 16x12 frame posts toward sampled light points,
  random rays from above the grid and parked rays, from a numpy seed.
- ``any_hit_slots`` (csrc/trace_common.cuh ``walk_any_coop``) on
  hand-built per-ray test counts, and its sum in ``occluded_plain``;
  the slab tests ``occluded_plain`` counts (kernel 2's bound) for single
  rays, blocked and not, for a block of them and for parked rays.
- the slot counts ``march_step_sc_plain`` reports for kernel 7: with every
  superchunk queued, kernel 3's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gdpathtracing_tpu.ops.intersect_pallas as jip
from gdpathtracing_tpu.core.vec import Vec3 as JVec3
from gdpathtracing_tpu.render.types import Ray as JRay
from gdpathtracing_tpu.scene.demo import build_sphere_grid as jax_sphere_grid

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.render import lights
from gdpathtracing_torch.render.shading import get_shading_data
from gdpathtracing_torch.render.types import Ray
from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera

torch.set_num_threads(1)
N_GRID, DETAIL = 4, 12
W, H = 16, 12


@pytest.fixture(scope="module")
def mid():
    ts = build_sphere_grid(n=N_GRID, sphere_detail=DETAIL, device="cpu")
    return jax_sphere_grid(n=N_GRID, sphere_detail=DETAIL), ts, \
        ti.prepare_trace_inputs(ts)


@pytest.fixture(scope="module")
def shadow_rays(mid):
    """(o, d, tmax, active) numpy: the shadow rays of a 16x12 frame's hits
    toward sampled light points (limit just short of the light), 128
    random rays from above the grid with limits in (0, 8), and 64 parked
    (inactive) ones, in a seeded random order."""
    _, ts, prep = mid
    cam = grid_camera(W, H, n=N_GRID)
    pids = torch.arange(W * H)
    ray, _ = cam.generate_rays(pids, rng.prng_seed(pids % W, pids // W, 5),
                               RenderConfig())
    hit = ti.trace_pallas(ts, ray, None, prep)
    s = get_shading_data(ts, hit, ray)
    g = np.random.default_rng(8)
    r = torch.from_numpy(g.uniform(size=(3, W * H)).astype(np.float32))
    ls = lights.sample_light(prep.lights, s.position, r[0], r[1], r[2])
    active = hit.hit & (s.normal.dot(ls.wi) > 0.0) & \
        torch.isfinite(ls.pdf_solid)
    o = s.position + s.normal * 1e-3
    o_l = np.stack([c.numpy() for c in o])
    d_l = np.stack([c.numpy() for c in ls.wi])
    t_l = (ls.dist * (1.0 - 1e-3)).numpy()
    o_r = np.stack([g.uniform(-6, 6, 128), g.uniform(-0.5, 7.5, 128),
                    g.uniform(-6, 6, 128)])
    d_r = g.normal(size=(3, 128))
    d_r /= np.linalg.norm(d_r, axis=0, keepdims=True)
    o_all = np.concatenate([o_l, o_r, np.zeros((3, 64))], axis=1)
    d_all = np.concatenate([d_l, d_r, np.ones((3, 64))], axis=1)
    t_all = np.concatenate([t_l, g.uniform(0.0, 8.0, 128), np.full(64, 4.0)])
    act = np.concatenate([active.numpy(), np.ones(128, bool),
                          np.zeros(64, bool)])
    perm = g.permutation(act.size)
    return (o_all[:, perm].astype(np.float32),
            d_all[:, perm].astype(np.float32), t_all[perm].astype(np.float32),
            act[perm])


def test_occluded_plain_on_superchunk_scene_matches_jax(mid, shadow_rays):
    js, ts, prep = mid
    o, d, tmax, active = shadow_rays
    assert prep.superchunks and prep.bounds.shape[1] == 34
    got = ti.occluded_pallas(
        ts, Ray(Vec3(*map(torch.from_numpy, o)),
                Vec3(*map(torch.from_numpy, d))),
        torch.from_numpy(tmax), torch.from_numpy(active), prep).numpy()
    want = np.asarray(jip.occluded_pallas(
        js, JRay(JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d))),
        jnp.asarray(tmax), jnp.asarray(active), interpret=True))
    np.testing.assert_array_equal(got, want)
    assert not got[~active].any()
    assert 0.05 < got[active].mean() < 0.95  # both answers occur


def _tests(*warps):
    """(256,) f32 per-ray tests of one staged chunk: ``warps[w]`` is a list
    of the tests (128 or 256) of the first lanes of warp w; the other rays
    need none."""
    t = torch.zeros(ti.WARPS, 32)
    for w, lanes in enumerate(warps):
        t[w, :len(lanes)] = torch.tensor(lanes, dtype=torch.float32)
    return t.view(-1)


@pytest.mark.parametrize("warps, slots", [
    ((), 0),                       # no needing ray: the chunk is skipped
    (([128],), 8 * 128),           # one ray, one half: the 8 warps wait
    #                                for the one that tests it
    (([256],), 8 * 256),           # both halves
    (([128] * 8,), 8 * 128),       # entries 0-7 go to warps 0-7
    (([128] * 9,), 8 * 256),       # entry 8 to warp 0 again
    (([256, 128] * 4, [128]), 8 * 384),  # warp 0: entries 0 (256) and 8
    (([128] * 32,) * 8, 8 * 32 * 128),   # every ray: 32 rays a warp
])
def test_any_hit_slots(warps, slots):
    got = ti.any_hit_slots(_tests(*warps))
    assert got.shape == (1,)
    assert float(got[0]) == slots


def test_any_hit_slots_per_block():
    """Blocks are counted apart; a needing ray's entry follows ray order
    across warps (entry = its rank among the block's needing rays)."""
    tests = torch.cat([_tests([128]), _tests(), _tests([], [256] * 2)])
    np.testing.assert_array_equal(ti.any_hit_slots(tests).numpy(),
                                  [8 * 128, 0, 8 * 256])


def test_occluded_plain_counts_slots(mid, shadow_rays):
    """The slots ``occluded_plain`` reports are any_hit_slots summed over
    chunks, each at least the tests the chunk's rays need."""
    _, ts, prep = mid
    o, d, tmax, active = shadow_rays
    o4t, d4t, tlim = ti.pack_shadow_rays(
        Ray(Vec3(*map(torch.from_numpy, o)), Vec3(*map(torch.from_numpy, d))),
        torch.from_numpy(active), torch.from_numpy(tmax))
    counts = {}
    res = ti.occluded_plain(o4t, d4t, tlim, prep.bounds, prep.sub_bounds,
                            prep.mu, prep.mv, prep.mw, counts=counts)
    assert torch.equal(res.occ, ti.occluded_plain(
        o4t, d4t, tlim, prep.bounds, prep.sub_bounds, prep.mu, prep.mv,
        prep.mw).occ)
    need = float(res.tests.sum())
    assert need > 0
    assert need <= counts["slots"] <= ti.WARPS * need
    # A thread per ray spends every lane of a block on each chunk it needs.
    assert counts["slots"] < float(res.sweeps[::ti.BN].sum()) * ti.BN * ti.BT


def test_march_slots_with_every_superchunk_queued(mid, shadow_rays):
    """Kernel 7's slot counts with every superchunk queued from no winner
    are kernel 3's (walk_two_level_plain)."""
    _, _, prep = mid
    o, d, _, active = shadow_rays
    o4t, d4t = ti.pack_rays(Ray(Vec3(*map(torch.from_numpy, o)),
                                Vec3(*map(torch.from_numpy, d))),
                            torch.from_numpy(active))
    n, nsc = o4t.shape[1], prep.sc_bounds.shape[1]
    geo = (prep.sc_bounds, prep.chunk_bounds, prep.mu_pad, prep.mv_pad,
           prep.mw_pad)
    init = torch.stack([torch.full((n,), 1e9),
                        torch.full((n,), float(ti.BIG_E))])
    queue = torch.arange(nsc, dtype=torch.int32).repeat(n // ti.BN)
    counts = {}
    ti.march_step_sc_plain(o4t, d4t, init, queue, *geo, prep.scc,
                           counts=counts)
    work = ti.walk_two_level_plain(o4t, d4t, *geo, prep.scc)
    assert counts["slots"] == float(work.slots[::ti.BN].sum()) > 0
    assert counts["thread_slots"] == float(
        work.chunk_sweeps[::ti.BN].sum()) * ti.BN * ti.BT
    assert counts["slab_tests"] == float(work.slab_tests.sum())



def _block(o4t, d4t, tlim, idx):
    """Rays ``idx`` in the first lanes of one 256-ray block, the other
    lanes parked (as pack_shadow_rays parks an inactive ray)."""
    n = len(idx)
    o, d, t = ti.pack_shadow_rays(
        Ray(Vec3(*[torch.zeros(ti.BN)] * 3), Vec3(*[torch.ones(ti.BN)] * 3)),
        torch.zeros(ti.BN, dtype=torch.bool), torch.zeros(ti.BN))
    o[:, :n], d[:, :n], t[:n] = o4t[:, idx], d4t[:, idx], tlim[idx]
    return o, d, t


def test_occluded_plain_counts_slab_tests(mid, shadow_rays):
    """The slab tests ``occluded_plain`` reports are those the rays need in
    index order: none for a parked ray; for a ray nothing blocks, every
    chunk box and both half boxes of each chunk its gate passes; fewer for
    a blocked ray, which needs none past its blocker; and a ray's count
    does not depend on the other rays of its block."""
    _, _, prep = mid
    o, d, tmax, active = shadow_rays
    o4t, d4t, tlim = ti.pack_shadow_rays(
        Ray(Vec3(*map(torch.from_numpy, o)), Vec3(*map(torch.from_numpy, d))),
        torch.from_numpy(active), torch.from_numpy(tmax))
    geo = (prep.bounds, prep.sub_bounds, prep.mu, prep.mv, prep.mw)
    nc = prep.bounds.shape[1]
    res = ti.occluded_plain(o4t, d4t, tlim, *geo)
    g = np.random.default_rng(3)
    live = torch.nonzero(tlim > 0).squeeze(1).numpy()
    occ = res.occ[live].numpy() == 1
    picks = np.concatenate([g.choice(live[occ], 6, replace=False),
                            g.choice(live[~occ], 6, replace=False)])
    single = 0.0
    for i in picks:
        counts = {}
        alone = ti.occluded_plain(*_block(o4t, d4t, tlim, [i]), *geo,
                                  counts=counts)
        assert int(alone.occ[0]) == int(res.occ[i])
        gated = float(alone.sweeps[0])  # the chunks its gate passes
        if res.occ[i]:
            assert 1 <= counts["slab_tests"] < nc + 2 * gated
        else:
            assert counts["slab_tests"] == nc + 2 * gated
        single += counts["slab_tests"]
    together = {}
    ti.occluded_plain(*_block(o4t, d4t, tlim, picks), *geo, counts=together)
    assert together["slab_tests"] == single
    parked = {}
    o, d, t = _block(o4t, d4t, tlim, picks)
    ti.occluded_plain(o, d, torch.zeros_like(t), *geo, counts=parked)
    assert parked["slab_tests"] == 0.0
