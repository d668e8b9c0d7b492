"""The thread-slot count of kernel 5's block-cooperative walk
(csrc/soft_occlusion.cu), as ``ops.intersect.soft_occluded_plain`` reports
it in ``slots``, beside its ``tests`` and ``sweeps``.

Per chunk the CUDA walk lists the k rays of a 256-ray block whose gate
passes (the soft slab test with tmin < the query's tmax: it reads no best,
so the rays listed are exactly those that need the chunk) and sweeps the
chunk a warp per listed ray, or by the rays' own threads where the warps
holding them are more than 7/8 full (``ti.two_level_slots``). Here the
gates are built by hand (rays parked at 1e9, live, or with a limit of 0
inside a box; boxes every ray at the origin enters, or behind the rays),
and on the demo's shadow rays they are recounted with numpy, chunk by
chunk, block by block and warp by warp. Nothing here runs JAX: the counts
belong to the port's kernel alone.
"""

from __future__ import annotations

import numpy as np
import torch

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.ops import tiles as kt
from gdpathtracing_torch.render.shading import get_shading_data
from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera

torch.set_num_threads(1)
WARP_SWEEP = ti.BN * (ti.BT // 32)  # one round of 8 warps x 32 lanes x 8
THREADS = 32 * ti.BT                # one warp's threads, 256 triangles each
# The rays at the origin of each 256-ray block, by (warp, lanes), whether
# their limit is 0, and the slots its block spends on a chunk they enter.
BLOCKS = [({2: 1}, False, WARP_SWEEP),                      # k = 1
          ({w: 32 for w in range(8)}, False, 8 * THREADS),  # k = 256
          ({}, False, 0),                                   # all parked
          ({1: 29}, False, THREADS),                        # 29 in a warp
          ({0: 3, 4: 3, 7: 3}, False, 2 * WARP_SWEEP),      # k = 9
          ({5: 32}, True, THREADS)]  # limit 0, origin inside: tmin < 0
# Chunk boxes: 0 and 2 hold the origin, 1 lies behind the rays (-x).
BIG = (-1e3, -1e3, -1e3, 1e3, 1e3, 1e3, 0.0, 0.0)
BEHIND = (100.0, -1.0, -1.0, 101.0, 1.0, 1.0, 0.0, 0.0)
PASSES = 2  # chunks every ray at the origin needs


def test_soft_slots_hand_built():
    """Rays at the origin toward -x with limit 5 (or 0), the others parked
    at 1e9 with limit 0; three chunks (BIG, BEHIND, BIG) of triangles that
    never hit (all-zero rows): no candidate anywhere, and each block
    spends its BLOCKS slots on each of the two chunks its rays enter."""
    n = len(BLOCKS) * ti.BN
    live = torch.zeros(len(BLOCKS), ti.WARPS, 32, dtype=torch.bool)
    zero_lim = torch.zeros_like(live)
    for b, (warps, zero, _) in enumerate(BLOCKS):
        for w, k in warps.items():
            live[b, w, :k] = True
            zero_lim[b, w, :k] = zero
    live, zero_lim = live.view(-1), zero_lim.view(-1)
    o4t = torch.zeros(4, n)
    d4t = torch.zeros(4, n)
    o4t[3] = 1.0
    d4t[0] = -1.0
    o4t[:3, ~live] = 1e9
    d4t[:3, ~live] = 0.5773503
    tmax = torch.where(live & ~zero_lim, 5.0, 0.0)
    bounds = torch.tensor([BIG, BEHIND, BIG], dtype=torch.float32).T
    e = 3 * ti.BT
    rows = [torch.zeros(4, e) for _ in range(3)]
    eo = torch.ones(3, e)
    got = ti.soft_occluded_plain(o4t, d4t, tmax, bounds.contiguous(), *rows,
                                 eo)
    per_block = [PASSES * s for _, _, s in BLOCKS]
    assert torch.equal(got.slots, torch.tensor(
        per_block, dtype=torch.float32).repeat_interleave(ti.BN))
    np.testing.assert_array_equal(got.sweeps[::ti.BN].numpy(),
                                  [PASSES * bool(w) for w, _, _ in BLOCKS])
    assert torch.equal(got.tests, live.to(torch.float32) * PASSES * ti.BT)
    assert bool((got.margin == -1e9).all()) and not got.eidx.any()


def _slots_by_hand(o4t, d4t, tmax, bounds) -> np.ndarray:
    """Each block's cooperative thread-slots, from the gates recounted in
    numpy: per chunk, k rays with a passing gate in nw warps; their
    threads (nw x 32 x 256) where 8k > 7 x 32 x nw, else ceil(k / 8)
    rounds of 8 warps x 32 lanes x 8 triangles."""
    o, d = o4t.numpy()[:3], d4t.numpy()[:3]
    lim = tmax.numpy()
    b = bounds.numpy()
    with np.errstate(divide="ignore"):
        rd = np.float32(1.0) / np.where(np.abs(d) < 1e-30, np.float32(1e-30),
                                        d)
    slots = np.zeros(o.shape[1] // ti.BN)
    for c in range(b.shape[1]):
        t1 = (b[0:3, c:c + 1] - o) * rd
        t2 = (b[3:6, c:c + 1] - o) * rd
        tmin = np.minimum(t1, t2).max(axis=0)
        tmx = np.maximum(t1, t2).min(axis=0)
        gate = (tmx >= tmin) & (tmx > 0) & (tmin < lim)
        for blk, g in enumerate(gate.reshape(-1, ti.WARPS, 32)):
            k = int(g.sum())
            nw = int(g.any(axis=1).sum())
            if k == 0:
                continue
            slots[blk] += nw * 32 * ti.BT if 8 * k > 7 * 32 * nw \
                else -(-k // ti.WARPS) * ti.BN * (ti.BT // 32)
    return slots


def test_soft_slots_on_demo_shadow_rays():
    """The NEE shadow rays of a 64x32 demo frame's primary hits toward
    sampled light points, over the soft-inflated boxes of edge_eps 0.05:
    the plain version's slots equal the recount, and its needed tests fill
    a larger share of them than of a thread per ray's."""
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6,
                             device="cpu")
    prep = ti.prepare_trace_inputs(scene)
    cfg = RenderConfig(traversal=Traversal.PALLAS)
    w, h = 64, 32
    pids = torch.arange(w * h)
    ray, seed = demo_camera(w, h).generate_rays(
        pids, rng.prng_seed(pids % w, pids // w, 1), cfg)
    hit = ti.trace_pallas(scene, ray, None, prep)
    pend = kt.shadow_queries(get_shading_data(scene, hit, ray), hit, seed,
                             prep, cfg)
    o4t, d4t, tmax = ti.pack_shadow_rays(pend.shadow, pend.active, pend.tmax)
    bounds = ti.soft_bounds(scene.isect_chunk_bounds, 0.05)
    eo = scene.tri_edge_open[scene.isect_tri.long()].T.contiguous()
    got = ti.soft_occluded_plain(o4t, d4t, tmax, bounds, prep.mu, prep.mv,
                                 prep.mw, eo)
    want = _slots_by_hand(o4t, d4t, tmax, bounds)
    np.testing.assert_array_equal(got.slots[::ti.BN].numpy(), want)
    needed = float(got.tests.sum())
    per_ray = float(got.sweeps[::ti.BN].sum()) * ti.BN * ti.BT
    assert 0 < needed <= want.sum() < per_ray
    assert needed / want.sum() > needed / per_ray
