"""The thread-slot count of the block-cooperative flat walk of kernels 1 and
11 (csrc/trace_common.cuh ``walk_flat_coop``), as ``ops.intersect.
walk_flat_plain`` reports it and ``closest_hit_rows_plain`` and
``fused.fused_paths_plain`` sum it.

Per chunk the CUDA walk lists the k rays of a 256-ray block whose gate
passes and sweeps the chunk a warp per listed ray, or by the rays' own
threads where the warps holding them are more than 7/8 full
(``ti.two_level_slots``); the plain walk sums that over the chunks. Here
the gates are built by hand (rays parked or live, boxes every live ray
enters or none does, triangles that never hit), and on a demo tile they
are recounted from the prefix walks' best t, chunk by chunk, block by
block and warp by warp. Nothing here runs JAX: the counts belong to the
port's kernels alone.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.ops import fused as fu
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.ops import tiles as kt
from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera

torch.set_num_threads(1)
WARP_SWEEP = ti.BN * (ti.BT // 32)  # one round of 8 warps x 32 lanes x 8
THREADS = 32 * ti.BT                # one warp's threads, 256 triangles each
# The live rays of each 256-ray block, by (warp, lanes) and the slots its
# block spends on a chunk every live ray needs.
BLOCKS = [({2: 1}, WARP_SWEEP),                       # k = 1
          ({w: 32 for w in range(8)}, 8 * THREADS),   # k = 256: threads
          ({}, 0),                                    # no live ray
          ({1: 29}, THREADS),                         # 29 in one warp
          ({0: 3, 4: 3, 7: 3}, 2 * WARP_SWEEP)]       # k = 9: two rounds
# Chunk boxes: 0 and 2 hold every ray's origin, 1 lies behind the rays.
BIG = (-1e3, -1e3, -1e3, 1e3, 1e3, 1e3, 0.0, 0.0)
BEHIND = (100.0, -1.0, -1.0, 101.0, 1.0, 1.0, 0.0, 0.0)
PASSES = 2  # chunks every live ray needs


def _hand_built():
    """Operands of kernel 1 with gates set by hand: live rays at the
    origin toward -x, parked rays at 1e9, the BLOCKS pattern; three chunks
    (BIG, BEHIND, BIG) of triangles that never hit (all-zero rows)."""
    n = len(BLOCKS) * ti.BN
    live = torch.zeros(len(BLOCKS), ti.WARPS, 32, dtype=torch.bool)
    for b, (warps, _) in enumerate(BLOCKS):
        for w, k in warps.items():
            live[b, w, :k] = True
    live = live.view(-1)
    o4t = torch.zeros(4, n)
    d4t = torch.zeros(4, n)
    o4t[3] = 1.0
    d4t[0] = -1.0
    o4t[:3, ~live] = 1e9
    d4t[:3, ~live] = 0.5773503
    bounds = torch.tensor([BIG, BEHIND, BIG], dtype=torch.float32).T
    e = 3 * ti.BT
    rows = [torch.zeros(4, e) for _ in range(3)]
    return (o4t, d4t, bounds.contiguous(), *rows), live


def test_flat_walk_slots_hand_built():
    (o4t, d4t, bounds, mu, mv, mw), live = _hand_built()
    walk, sweeps, slots = ti.walk_flat_plain(o4t, d4t, bounds, mu, mv, mw)
    per_block = [PASSES * s for _, s in BLOCKS]
    np.testing.assert_array_equal(slots[::ti.BN].numpy(), per_block)
    assert torch.equal(slots, torch.tensor(
        per_block, dtype=torch.float32).repeat_interleave(ti.BN))
    np.testing.assert_array_equal(
        sweeps[::ti.BN].numpy(), [PASSES * bool(w) for w, _ in BLOCKS])
    assert torch.equal(walk.steps, live.to(torch.float32) * PASSES * ti.BT)
    assert bool((walk.best_t == ti._MISS).all())

    counts = {}
    tab = torch.zeros(ti.TAB_R, mu.shape[1])
    rows = ti.closest_hit_rows_plain(o4t, d4t, bounds, mu, mv, mw, tab,
                                     counts=counts)
    assert counts == {"slots": float(sum(per_block)),
                      "thread_slots": float(PASSES * 4 * ti.BN * ti.BT)}
    assert torch.equal(rows[46], sweeps)


def test_fused_counts_sum_over_bounces():
    """Kernel 11's counts over 3 bounces of the hand-built rays: nothing
    hits, so every path dies at bounce 0 and parks, and bounces 1 and 2
    need no chunk and spend no slot."""
    (o4t, d4t, bounds, mu, mv, mw), live = _hand_built()
    n, e = o4t.shape[1], mu.shape[1]
    table = torch.zeros(e, ti.TABLE_W)
    mats = torch.zeros(1, ti.MAT_W)
    seeds = torch.zeros(2, n, dtype=torch.int32)
    counts = {}
    out, segs = fu.fused_paths_plain(
        o4t, d4t, seeds, bounds, mu, mv, mw, table, mats,
        RenderConfig(traversal=Traversal.FUSED, bounces=3), counts=counts)
    assert bool((segs == 1).all()) and bool((out[3] == ti._MISS).all())
    assert counts == {
        "tests": float(int(live.sum()) * PASSES * ti.BT),
        "slots": float(sum(PASSES * s for _, s in BLOCKS)),
        "thread_slots": float(PASSES * 4 * ti.BN * ti.BT)}


def _slots_by_hand(o4t, d4t, bounds, mu, mv, mw) -> np.ndarray:
    """(N/256,) thread-slots of each block, counted chunk by chunk: each
    ray's gate from its best t over the chunks before (a plain walk of
    that prefix) and a slab test in numpy; then, per block, k and the
    warps holding a needing ray, and the rule of the cooperative walk."""
    o = o4t.numpy()
    d = d4t.numpy()
    n, nc = o.shape[1], bounds.shape[1]
    rd = np.float32(1.0) / np.where(np.abs(d[:3]) < 1e-30, np.float32(1e-30),
                                    d[:3])
    b = bounds.numpy()
    slots = np.zeros(n // ti.BN)
    for c in range(nc):
        best_t = ti.walk_flat_plain(o4t, d4t, bounds[:, :c],
                                    mu[:, :c * ti.BT], mv[:, :c * ti.BT],
                                    mw[:, :c * ti.BT]).walk.best_t.numpy()
        t1 = (b[0:3, c, None] - o[:3]) * rd
        t2 = (b[3:6, c, None] - o[:3]) * rd
        tmin = np.minimum(t1, t2).max(axis=0)
        tmax = np.maximum(t1, t2).min(axis=0)
        need = (tmax >= tmin) & (tmax > 0) & (tmin <= best_t)
        for blk in range(n // ti.BN):
            per_warp = [int(need[blk * ti.BN + 32 * w:
                                 blk * ti.BN + 32 * (w + 1)].sum())
                        for w in range(ti.WARPS)]
            k = sum(per_warp)
            nw = sum(1 for x in per_warp if x)
            if k == 0:
                continue
            if 8 * k > 7 * 32 * nw:
                slots[blk] += nw * 32 * ti.BT
            else:
                slots[blk] += -(-k // ti.WARPS) * WARP_SWEEP
    return slots


@pytest.mark.parametrize("rays", ["primary", "bounce 1"])
def test_flat_walk_slots_demo_tile(rays):
    """A 512-ray tile of the demo (pixels of row 300, which see the room),
    primary and bounce-1 rays: the slots walk_flat_plain reports equal
    the count by hand; the tests needed lie between them and a thread per
    ray's slots."""
    scene = build_demo_scene(texture_resolution=8, sphere_detail=6,
                             device="cpu")
    prep = ti.prepare_trace_inputs(scene)
    cfg = RenderConfig(tile_rays=512)
    primary, hit, s, seed = kt.middle_rays(scene, demo_camera(kt.W, kt.H),
                                           prep, cfg, 512, kt.W * 300 + 700)
    if rays == "primary":
        o4t, d4t = ti.pack_rays(primary, None)
    else:
        o4t, d4t = ti.pack_rays(*kt.bounce_rays(s, hit, seed, cfg))
    geo = (prep.bounds, prep.mu, prep.mv, prep.mw)
    walk, sweeps, slots = ti.walk_flat_plain(o4t, d4t, *geo)
    np.testing.assert_array_equal(slots[::ti.BN].numpy(),
                                  _slots_by_hand(o4t, d4t, *geo))
    needed = float(walk.steps.sum())
    assert int((walk.best_t < ti._MISS).sum()) > 100
    assert 0 < needed <= float(slots[::ti.BN].sum()) \
        <= float(sweeps[::ti.BN].sum()) * ti.BN * ti.BT
